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
