"""Dense distances (counterpart of faiss_tpu/ops/distances.py).

Plain PyTorch: the L2 expansion ``||x||^2 + ||y||^2 - 2 x.y`` as float32
matrix products (TF32 is off, see the package ``__init__``), chunked so no
large distance matrix is materialised at once. faiss_tpu computes its
float32 products as six bf16 passes because the TPU's float32 matrix product
is slow; on the card a float32 ``torch.matmul`` is the plain form. These are
the large products the reference leaves to XLA outside any Pallas kernel.

The extra metrics (L1, Linf, Lp, Canberra, BrayCurtis, JensenShannon,
Jaccard, NaNEuclidean, ABS_INNER_PRODUCT, GOWER; faiss's
utils/extra_distances-inl.h) are elementwise float32 reductions over
broadcast [queries, rows, d] blocks, cut so that one block stays under
EXTRA_BLOCK_BYTES whatever the tile's size."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..metric import MetricType, is_similarity_metric
from .topk import merge_topk, topk

# Database rows per score tile of the chunked k-NN scan: a [2048, 2^17]
# float32 tile is 1 GiB (faiss_tpu/ops/distances.py:35).
DEFAULT_DB_CHUNK = 1 << 17

# Bytes of one broadcast [qb, yb, d] float32 block of the extra metrics; the
# elementwise terms of one block are a few such transients.
EXTRA_BLOCK_BYTES = 128 << 20


def l2_norms(x: torch.Tensor, chunk: int = 1 << 20) -> torch.Tensor:
    """Row-wise squared L2 norms in float32 (fvec_norms_L2sqr). Chunked so
    an fp16 store is upcast one chunk at a time."""
    return torch.cat(
        [x[s : s + chunk].float().square().sum(-1) for s in range(0, len(x), chunk)]
        or [x.new_zeros((0,), dtype=torch.float32)]
    )


def pairwise_inner_product(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """[nx, d] x [ny, d] -> [nx, ny] float32 inner products
    (faiss_tpu/ops/distances.py:101)."""
    return x.float() @ y.float().T


def pairwise_l2sqr(
    x: torch.Tensor,
    y: torch.Tensor,
    y_norms: Optional[torch.Tensor] = None,
    x_norms: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Squared L2 distances via the norm expansion, clamped at 0
    (faiss_tpu/ops/distances.py:126)."""
    ip = pairwise_inner_product(x, y)
    if x_norms is None:
        x_norms = l2_norms(x)
    if y_norms is None:
        y_norms = l2_norms(y)
    return (x_norms[:, None] + y_norms[None, :] - 2.0 * ip).clamp_min(0.0)


def _metric_reduce(xf, yf, metric: MetricType, metric_arg: float, d: int):
    """The extra metric of broadcastable float32 rows ``xf``, ``yf`` [..., d],
    reduced over the last axis (faiss_tpu/ops/distances.py:142-199, with its
    0/0 and NaN rules)."""
    if metric == MetricType.L1:
        return (xf - yf).abs().sum(-1)
    if metric == MetricType.Linf:
        return (xf - yf).abs().amax(-1)
    if metric == MetricType.Lp:
        return (xf - yf).abs().pow(metric_arg).sum(-1)
    if metric == MetricType.Canberra:
        num = (xf - yf).abs()
        den = xf.abs() + yf.abs()
        return torch.where(den > 0, num / den, 0.0).sum(-1)
    if metric == MetricType.BrayCurtis:
        num = (xf - yf).abs().sum(-1)
        den = (xf + yf).abs().sum(-1)
        return torch.where(den > 0, num / den, 0.0)
    if metric == MetricType.JensenShannon:
        # in float64: a near neighbour's terms a log(a / m) nearly cancel,
        # and float32 leaves ~1e-5 of the distance in rounding
        xd, yd = xf.double(), yf.double()
        m = 0.5 * (xd + yd)

        def kl(a, b):  # 0 log 0 = 0
            return torch.where(a > 0, a * torch.log(a / b), 0.0)

        return (0.5 * (kl(xd, m) + kl(yd, m))).sum(-1).float()
    if metric == MetricType.Jaccard:
        # 1 - sum min / sum max, as sum |x - y| / sum max (max - min =
        # |x - y|): no cancellation for near rows
        num = (xf - yf).abs().sum(-1)
        den = torch.maximum(xf, yf).sum(-1)
        return torch.where(den > 0, num / den, 1.0)
    if metric == MetricType.NaNEuclidean:
        # sklearn's nan_euclidean: scaled by d / the dimensions present
        present = ~torch.isnan(xf) & ~torch.isnan(yf)
        diff = torch.where(present, xf - yf, 0.0)
        npresent = present.sum(-1, dtype=torch.int32)
        s = diff.square().sum(-1)
        return torch.where(npresent > 0, d * s / npresent, float("inf"))
    if metric == MetricType.ABS_INNER_PRODUCT:
        return (xf * yf).abs().sum(-1)
    if metric == MetricType.GOWER:
        # numeric dimensions (both >= 0): |x - y|; a negative pair is
        # categorical: 0 if equal, else 1; NaN dimensions left out
        both_num = (xf >= 0) & (yf >= 0)
        valid = ~torch.isnan(xf) & ~torch.isnan(yf)
        per_dim = torch.where(both_num, (xf - yf).abs(),
                              torch.where(xf == yf, 0.0, 1.0))
        per_dim = torch.where(valid, per_dim, 0.0)
        nvalid = valid.sum(-1, dtype=torch.int32)
        return torch.where(nvalid > 0, per_dim.sum(-1) / nvalid, float("nan"))
    raise ValueError(f"unsupported extra metric {metric!r}")


def extra_metric_tile(x: torch.Tensor, y: torch.Tensor, metric: MetricType,
                      metric_arg: float = 0.0) -> torch.Tensor:
    """[nx, d] x [ny, d] -> [nx, ny] float32 distances of an extra metric,
    in broadcast blocks of at most EXTRA_BLOCK_BYTES."""
    x, y = x.float(), y.float()
    nx, ny, d = x.shape[0], y.shape[0], x.shape[1]
    out = torch.empty(nx, ny, device=x.device)
    yb = max(1, min(ny, EXTRA_BLOCK_BYTES // (4 * max(d, 1))))
    qb = max(1, EXTRA_BLOCK_BYTES // (4 * max(d, 1) * yb))
    for q0 in range(0, nx, qb):
        xf = x[q0 : q0 + qb, None, :]
        for y0 in range(0, ny, yb):
            out[q0 : q0 + qb, y0 : y0 + yb] = _metric_reduce(
                xf, y[None, y0 : y0 + yb, :], metric, metric_arg, d)
    return out


def _score_tile(x, y, metric, x_norms, y_norms, metric_arg=0.0):
    """Distances of a query block to a database tile
    (faiss_tpu/ops/distances.py:360)."""
    if metric == MetricType.L2:
        return pairwise_l2sqr(x, y, y_norms, x_norms)
    if metric == MetricType.INNER_PRODUCT:
        return pairwise_inner_product(x, y)
    return extra_metric_tile(x, y, metric, metric_arg)


def pairwise_distances(
    x: torch.Tensor, y: torch.Tensor, metric: MetricType = MetricType.L2,
    metric_arg: float = 0.0,
) -> torch.Tensor:
    """The full [nx, ny] distance matrix (faiss_tpu/ops/distances.py:202)."""
    return _score_tile(x, y, metric, None, None, metric_arg)


def knn(
    x: torch.Tensor,  # [nq, d]
    y: torch.Tensor,  # [nb, d]
    k: int,
    metric: MetricType = MetricType.L2,
    y_norms: Optional[torch.Tensor] = None,
    db_chunk: int = DEFAULT_DB_CHUNK,
    y_mask: Optional[torch.Tensor] = None,  # [nb] bool: rows that may match
    metric_arg: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact brute-force k-NN of x against y (faiss_tpu/ops/distances.py:
    220): score tiles of ``db_chunk`` rows, each reduced to its top-k and
    merged. The last tile is clamped to [nb - db_chunk, nb), and the rows the
    previous tile already scored are masked off (``col >= ci * db_chunk``).
    ``y_mask`` (an ID selector as a score mask) excludes rows the same way.
    Returns (D [nq, k] f32, I [nq, k] int64) best-first (largest first for
    the similarity metrics); where fewer than k rows qualify the tail is
    filled with -1 and +inf (-inf for a similarity)."""
    nq, nb = x.shape[0], y.shape[0]
    largest = is_similarity_metric(metric)
    sentinel = float("-inf") if largest else float("inf")
    kk = min(k, nb)
    if kk == 0:
        return (
            torch.full((nq, k), sentinel, device=x.device),
            torch.full((nq, k), -1, dtype=torch.int64, device=x.device),
        )
    if metric == MetricType.L2 and y_norms is None:
        y_norms = l2_norms(y)
    x_norms = l2_norms(x) if metric == MetricType.L2 else None

    if nb <= db_chunk:
        scores = _score_tile(x, y, metric, x_norms, y_norms, metric_arg)
        if y_mask is not None:
            scores = torch.where(y_mask[None, :], scores, sentinel)
        vals, ids = topk(scores, kk, largest=largest)
        if y_mask is not None:
            # an entry that picked a masked row (too few rows kept) is none
            ok = y_mask[ids]
            ids = torch.where(ok, ids, -1)
            vals = torch.where(ok, vals, sentinel)
    else:
        vals = torch.full((nq, kk), sentinel, device=x.device)
        ids = torch.full((nq, kk), -1, dtype=torch.int64, device=x.device)
        cols = torch.arange(db_chunk, device=x.device)
        for ci in range(-(-nb // db_chunk)):
            start = min(ci * db_chunk, nb - db_chunk)
            tile = slice(start, start + db_chunk)
            scores = _score_tile(
                x, y[tile], metric, x_norms,
                y_norms[tile] if metric == MetricType.L2 else None, metric_arg,
            )
            col = cols + start
            valid = col >= ci * db_chunk  # tail-overlap rows already scored
            if y_mask is not None:
                valid = valid & y_mask[tile]
            scores = torch.where(valid[None, :], scores, sentinel)
            cv, cp = topk(scores, kk, largest=largest)
            cids = torch.where(valid[cp], col[cp], -1)
            vals, ids = merge_topk(vals, ids, cv, cids, kk, largest=largest)

    if kk < k:
        vals = torch.cat(
            [vals, torch.full((nq, k - kk), sentinel, device=x.device)], dim=1
        )
        ids = torch.cat(
            [ids, torch.full((nq, k - kk), -1, dtype=ids.dtype, device=x.device)],
            dim=1,
        )
    return vals, ids.long()


def assign_flat(
    x: torch.Tensor,  # [n, d]
    centroids: torch.Tensor,  # [nc, d] float32
    metric: MetricType = MetricType.L2,
    chunk: int = 1 << 14,
    metric_arg: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-1 assignment of a large batch against a flat centroid set, chunked
    over rows (faiss_tpu/ops/distances.py:323). Returns (dist [n] f32,
    assign [n] int64): the nearest centroid by L2, the largest inner
    product for METRIC_INNER_PRODUCT, else the best by the extra metric
    (its exact k-NN at k = 1)."""
    if metric not in (MetricType.L2, MetricType.INNER_PRODUCT):
        dist, assign = zip(*(knn(x[s : s + chunk].float(), centroids, 1, metric,
                                 metric_arg=metric_arg)
                             for s in range(0, len(x), chunk)))
        return torch.cat(dist)[:, 0], torch.cat(assign)[:, 0]
    c_norms = l2_norms(centroids)
    dist, assign = [], []
    for s in range(0, len(x), chunk):
        xc = x[s : s + chunk].float()
        ip = xc @ centroids.T
        if metric == MetricType.INNER_PRODUCT:
            best, a = ip.max(dim=1)
            dist.append(best)
        else:
            best, a = (c_norms[None, :] - 2.0 * ip).min(dim=1)
            dist.append((best + xc.square().sum(-1)).clamp_min(0.0))
        assign.append(a)
    return torch.cat(dist), torch.cat(assign)


def rerank_exact(
    xq: torch.Tensor,  # [nq, d] float32
    xb: torch.Tensor,  # [nb, d] exact vectors (float32 or float16 store)
    cand: torch.Tensor,  # [nq, kc] candidate rows (-1 = missing)
    k: int,
    metric: MetricType = MetricType.L2,
    xb_n2: Optional[torch.Tensor] = None,  # [nb] precomputed ||xb||^2
    sq_scale: Optional[torch.Tensor] = None,  # [d]: xb holds SQ8 codes
    sq_off: Optional[torch.Tensor] = None,  # [d]
    metric_arg: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact re-rank of per-query candidate lists (the IndexRefineFlat
    inner loop as one gather + batched contraction;
    faiss_tpu/ops/distances.py:372). The store is upcast after the gather
    and the products are exact float32 (elementwise multiply and sum).
    With ``sq_scale``/``sq_off`` the store holds uint8 SQ8 codes
    (Refine(SQ8)): the gathered rows dequantize per dimension as
    ``row * sq_scale + sq_off`` after the gather, as faiss_tpu does.
    L2 ascending, inner product descending; an extra metric is scored
    exactly on the gathered rows (faiss_tpu scores it as an inner product
    here). Returns (D [nq, min(k, kc)] f32, I int64), -1 where D is the
    sentinel (+inf, or -inf for a similarity)."""
    largest = is_similarity_metric(metric)
    safe = cand.clamp_min(0).long()
    cv = xb[safe].float()  # [nq, kc, d]
    if sq_scale is not None:
        cv = cv * sq_scale + sq_off
    if metric not in (MetricType.L2, MetricType.INNER_PRODUCT):
        d = _metric_reduce(xq.float()[:, None, :], cv, metric, metric_arg,
                           cv.shape[-1])
        ip = None
    else:
        ip = (xq[:, None, :] * cv).sum(-1)
    if metric == MetricType.L2:
        cn2 = xb_n2[safe] if xb_n2 is not None else cv.square().sum(-1)
        d = (xq.square().sum(-1)[:, None] + cn2 - 2.0 * ip).clamp_min(0.0)
    elif ip is not None:
        d = ip
    sentinel = float("-inf") if largest else float("inf")
    d = torch.where(cand >= 0, d, torch.full_like(d, sentinel))
    vals, pos = topk(d, k, largest=largest)
    ids = torch.gather(cand.long(), 1, pos)
    return vals, torch.where(torch.isinf(vals), torch.full_like(ids, -1), ids)
