"""k-selection (counterpart of faiss_tpu/ops/topk.py).

faiss_tpu selects through XLA's PartialReduce (``approx_min_k`` at recall
target 1.0, i.e. exact); here it is ``torch.topk``, sorted best-first."""

from __future__ import annotations

from typing import Tuple

import torch


def topk(
    scores: torch.Tensor, k: int, *, largest: bool
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top/bottom-k along the last axis: (values, int64 indices),
    best-first. ``k`` is clipped to the axis length."""
    k = min(k, scores.shape[-1])
    return torch.topk(scores, k, dim=-1, largest=largest, sorted=True)


def merge_topk(
    vals_a: torch.Tensor,
    ids_a: torch.Tensor,
    vals_b: torch.Tensor,
    ids_b: torch.Tensor,
    k: int,
    *,
    largest: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge two top-k result sets (faiss_tpu/ops/topk.py:49): concatenate
    the candidates along the last axis and reselect k, best-first. Inputs
    need not be sorted."""
    vals = torch.cat([vals_a, vals_b], dim=-1)
    ids = torch.cat([ids_a, ids_b], dim=-1)
    v, pos = topk(vals, k, largest=largest)
    return v, torch.gather(ids, -1, pos)


def merge_topk_many(
    vals: torch.Tensor,
    ids: torch.Tensor,
    k: int,
    *,
    largest: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge the results of S sources, ``vals``/``ids`` [..., S, k'], as one
    reselect over the flattened candidate axis (faiss_tpu/ops/topk.py:70;
    IndexShards::merge_tables). The shard merge of parallel/sharded.py."""
    flat_vals = vals.reshape(*vals.shape[:-2], -1)
    flat_ids = ids.reshape(*ids.shape[:-2], -1)
    v, pos = topk(flat_vals, k, largest=largest)
    return v, torch.gather(flat_ids, -1, pos)
