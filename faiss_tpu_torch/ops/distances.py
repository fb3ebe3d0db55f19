"""Dense distances (counterpart of faiss_tpu/ops/distances.py).

Plain PyTorch: the L2 expansion ``||x||^2 + ||y||^2 - 2 x.y`` as float32
matrix products (TF32 is off, see the package ``__init__``), chunked so no
large distance matrix is materialised at once."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..metric import MetricType
from .topk import topk


def l2_norms(x: torch.Tensor, chunk: int = 1 << 20) -> torch.Tensor:
    """Row-wise squared L2 norms in float32 (fvec_norms_L2sqr). Chunked so
    an fp16 store is upcast one chunk at a time."""
    return torch.cat(
        [x[s : s + chunk].float().square().sum(-1) for s in range(0, len(x), chunk)]
        or [x.new_zeros((0,), dtype=torch.float32)]
    )


def assign_flat(
    x: torch.Tensor,  # [n, d]
    centroids: torch.Tensor,  # [nc, d] float32
    metric: MetricType = MetricType.L2,
    chunk: int = 1 << 14,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-1 assignment of a large batch against a flat centroid set, chunked
    over rows (faiss_tpu/ops/distances.py:323). Returns (dist [n] f32,
    assign [n] int64)."""
    if metric != MetricType.L2:
        raise NotImplementedError("assign_flat: only METRIC_L2 is ported")
    c_norms = l2_norms(centroids)
    dist, assign = [], []
    for s in range(0, len(x), chunk):
        xc = x[s : s + chunk].float()
        key = c_norms[None, :] - 2.0 * (xc @ centroids.T)
        best, a = key.min(dim=1)
        dist.append((best + xc.square().sum(-1)).clamp_min(0.0))
        assign.append(a)
    return torch.cat(dist), torch.cat(assign)


def rerank_exact(
    xq: torch.Tensor,  # [nq, d] float32
    xb: torch.Tensor,  # [nb, d] exact vectors (float32 or float16 store)
    cand: torch.Tensor,  # [nq, kc] candidate rows (-1 = missing)
    k: int,
    xb_n2: Optional[torch.Tensor] = None,  # [nb] precomputed ||xb||^2
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact L2 re-rank of per-query candidate lists (the IndexRefineFlat
    inner loop as one gather + batched contraction;
    faiss_tpu/ops/distances.py:372). The store is upcast after the gather
    and the products are exact float32 (elementwise multiply and sum).
    Returns (D [nq, min(k, kc)] f32, I int64), -1 where D is +inf."""
    safe = cand.clamp_min(0).long()
    cv = xb[safe].float()  # [nq, kc, d]
    ip = (xq[:, None, :] * cv).sum(-1)
    cn2 = xb_n2[safe] if xb_n2 is not None else cv.square().sum(-1)
    d = (xq.square().sum(-1)[:, None] + cn2 - 2.0 * ip).clamp_min(0.0)
    d = torch.where(cand >= 0, d, torch.full_like(d, float("inf")))
    vals, pos = topk(d, k, largest=False)
    ids = torch.gather(cand.long(), 1, pos)
    return vals, torch.where(torch.isinf(vals), torch.full_like(ids, -1), ids)
