"""k-means on the device (counterpart of faiss_tpu/ops/kmeans_ops.py).

Lloyd iterations as plain PyTorch, chunked over the points so no [n, k]
distance matrix is materialised at once: the assignment is a float32 GEMM
(TF32 off) and an argmin, the update adds each point into its centroid's
sum. faiss_tpu runs the assignment as bf16 hi/lo passes (~2^-16 relative);
here it is exact float32, so objectives agree to that rounding.

uint8 points (the MNIST8m class of data) stay uint8 on the device: each
chunk is a view of the resident set, decoded to float32 in the chunk, with
its norms computed there. Nothing pads or copies the whole set (faiss_tpu
measured +6.8 GB for such a copy at 8.1M x 784), and the last chunk is
simply shorter, so no row is counted twice. The uint8 assignment keeps
faiss_tpu's split of the centroids into bf16 hi + lo planes (:341-347):
a uint8 value and a bf16 value multiply exactly in float32, so x.c_hi +
x.c_lo as two float32 products is faiss_tpu's arithmetic up to the order of
the float32 sums, and both packages assign the same points to the same
centroids. The sums are float32: ``index_add_``'s atomics add in no fixed
order, so once a centroid's sums pass 2^24 (integer-valued points stop
adding exactly there) two runs may differ in the last bits.

faiss_tpu's ``kmeans_fused_iter`` (one iteration as its own program) exists
only to keep its remote compiles short; eager PyTorch compiles nothing, so
the port has no counterpart."""

from __future__ import annotations

from typing import Optional

import torch

EPS = 1.0 / 1024.0  # centroid-split perturbation (ClusteringHelpers.h:99)


def _split_empty_clusters(new_c, counts, generator):
    """Empty-cluster split (split_clusters policy, impl/ClusteringHelpers.h:85;
    faiss_tpu/ops/kmeans_ops.py:106): each empty slot takes a donor sampled
    ~ (counts - 1), perturbed by (1 + EPS); a donor hit by >= 1 empty slot
    shrinks once by (1 - EPS). Donors come from ``generator``, so they do not
    match the JAX PRNG stream. Returns (centroids, nsplit)."""
    k = new_c.shape[0]
    empty = counts <= 0
    donors = torch.multinomial(
        (counts - 1.0).clamp_min(1e-30), k, replacement=True,
        generator=generator,
    )
    used = torch.zeros(k + 1, dtype=torch.bool, device=new_c.device)
    used[torch.where(empty, donors, k)] = True
    used = used[:k] & ~empty
    out = torch.where(empty[:, None], new_c[donors] * (1.0 + EPS), new_c)
    out = torch.where(used[:, None], out * (1.0 - EPS), out)
    return out, empty.sum()


def add_to_centroids(sums: torch.Tensor, assign: torch.Tensor,
                     xc: torch.Tensor) -> None:
    """sums[assign[i]] += xc[i], in place: the update of every loop here.
    ``index_add_`` takes 60 ms an iteration at BASELINE row 12's shape
    against 96-98 ms for a float32 one-hot product (chip_smoke.py phase H;
    NVIDIA H100 80GB HBM3, 700 W), at a float32 error of ~1.5e-4 of the
    largest sum there against ~2.5e-7."""
    sums.index_add_(0, assign, xc)


def _hi_lo(c: torch.Tensor):
    """float32 -> (hi, lo) float32 tensors holding bf16 values: hi = c
    rounded to bf16 (to nearest even), lo = (c - hi) rounded to bf16."""
    hi = c.to(torch.bfloat16).float()
    return hi, (c - hi).to(torch.bfloat16).float()


def _assign_chunk(xc: torch.Tensor, planes, c_norms: torch.Tensor):
    """(best squared distance clamped at 0, nearest centroid) of each row of
    the float32 chunk ``xc``; the inner products are the sum of its
    products with the centroid ``planes`` (c, or c's hi and lo)."""
    ip = xc @ planes[0].T
    for p in planes[1:]:
        ip += xc @ p.T
    d2 = xc.square().sum(-1)[:, None] + c_norms[None, :] - 2.0 * ip
    best, assign = d2.min(dim=1)
    return best.clamp_min(0.0), assign


def kmeans_assign_update(x: torch.Tensor, centroids: torch.Tensor):
    """One Lloyd iteration's reduction over the float32 points ``x`` [n, d]
    (faiss_tpu/ops/kmeans_ops.py:29), in chunks of 16,384 points (faiss_tpu's
    default), so no [n, k] matrix is held at once: (sums [k, d]
    float32, counts [k] float32, objective float32 scalar, assignment [n]
    int64). The objective is the sum of the squared distances to the nearest
    centroid, each clamped at 0. The reduction of
    parallel/sharded.sharded_kmeans_iter on each shard."""
    k, d = centroids.shape
    c_norms = centroids.square().sum(-1)
    sums = torch.zeros(k, d, device=x.device)
    counts = torch.zeros(k, device=x.device)
    obj = torch.zeros((), dtype=torch.float64, device=x.device)
    assign = []
    for s in range(0, len(x), 1 << 14):
        xc = x[s : s + (1 << 14)].float()
        best, a = _assign_chunk(xc, (centroids,), c_norms)
        add_to_centroids(sums, a, xc)
        counts += torch.bincount(a, minlength=k).float()
        obj += best.sum(dtype=torch.float64)
        assign.append(a)
    a = torch.cat(assign) if assign else torch.zeros(0, dtype=torch.int64,
                                                     device=x.device)
    return sums, counts, obj.float(), a


def _new_centroids(c, sums, counts, generator, *, spherical, int_centroids,
                   frozen, split):
    """The update of one iteration (faiss_tpu :283-296): means of the
    non-empty clusters, empty ones split from donors, then normalized and
    rounded as asked; ``frozen`` keeps ``c``. Returns (centroids, nsplit)."""
    nsplit = torch.zeros((), dtype=torch.int64, device=c.device)
    if frozen:
        return c, nsplit
    new_c = torch.where(
        (counts > 0)[:, None], sums / counts.clamp_min(1e-30)[:, None], c
    )
    if split:
        new_c, nsplit = _split_empty_clusters(new_c, counts, generator)
    if spherical:
        new_c = new_c / new_c.norm(dim=1, keepdim=True).clamp_min(1e-30)
    if int_centroids:
        new_c = torch.round(new_c)
    return new_c, nsplit


def _stack(v, dtype):
    return torch.stack(v) if v else torch.zeros(0, dtype=dtype)


def kmeans_fused_loop(
    x: torch.Tensor,  # [n, d] float32 or uint8 training points
    init: torch.Tensor,  # [k, d] float32 initial centroids
    generator: torch.Generator,  # empty-cluster donor sampling
    weights: Optional[torch.Tensor] = None,  # [n] float32 or None
    *,
    niter: int,
    chunk: int,
    spherical: bool = False,
    int_centroids: bool = False,
    frozen: bool = False,
    split: bool = True,
):
    """All Lloyd iterations of one k-means run (faiss_tpu's
    kmeans_fused_loop, :149, and its uint8 body ``_kmeans_fused_loop_u8``,
    :305). ``weights`` weight each point's share of the sums, the counts
    (exact float32 weights, as faiss_tpu's :257-265) and the objective; the
    uint8 path is unweighted, as in faiss_tpu. After each update the
    centroids are normalized (``spherical``; the assignment stays by L2) and
    rounded (``int_centroids``); ``frozen`` keeps them; ``split`` re-seeds
    empty clusters.

    Each iteration's objective is the (weighted) sum of squared distances of
    the points to their nearest centroid BEFORE the update
    (ClusteringIterationStats.obj, Clustering.cpp:331). Returns (centroids
    [k, d], objs [niter] f64, sumsq_counts [niter], tot_counts [niter],
    nsplits [niter], counts_last [k]), all on the device."""
    if x.dtype == torch.uint8 and weights is not None:
        raise NotImplementedError("the uint8 k-means path is unweighted")
    n, d = x.shape
    k = init.shape[0]
    c = init.clone()
    objs, sumsq, tots, nsplits = [], [], [], []
    counts = torch.zeros(k, device=x.device)
    for _ in range(niter):
        c_norms = c.square().sum(-1)
        planes = _hi_lo(c) if x.dtype == torch.uint8 else (c,)
        sums = torch.zeros(k, d, device=x.device)
        counts = torch.zeros(k, device=x.device)
        obj = torch.zeros((), dtype=torch.float64, device=x.device)
        for s in range(0, n, chunk):
            xc = x[s : s + chunk].float()  # the uint8 chunk decodes here
            best, assign = _assign_chunk(xc, planes, c_norms)
            if weights is None:
                add_to_centroids(sums, assign, xc)
                counts += torch.bincount(assign, minlength=k).float()
                obj += best.sum(dtype=torch.float64)
            else:
                wc = weights[s : s + chunk]
                add_to_centroids(sums, assign, xc * wc[:, None])
                counts.index_add_(0, assign, wc)
                obj += (best * wc).sum(dtype=torch.float64)
        c, nsplit = _new_centroids(
            c, sums, counts, generator, spherical=spherical,
            int_centroids=int_centroids, frozen=frozen, split=split,
        )
        objs.append(obj)
        sumsq.append(counts.double().square().sum())
        tots.append(counts.double().sum())
        nsplits.append(nsplit)
    return (
        c, _stack(objs, torch.float64), _stack(sumsq, torch.float64),
        _stack(tots, torch.float64), _stack(nsplits, torch.int64), counts,
    )


def superkm_assign_update(
    x: torch.Tensor,  # [n, d] float32, randomly rotated
    centroids: torch.Tensor,  # [k, d] float32
    coeff: float,  # chi2 threshold ratio at p dims (precompute_ad_thresholds)
    generator: torch.Generator,  # empty-cluster donor sampling
    p: int,
    keep: int,  # candidates re-ranked exactly per point
    chunk: int,
):
    """One SuperKMeans Lloyd iteration (super_kmeans_assign_iteration,
    faiss/SuperKMeans.cpp; faiss_tpu :430) in batch form. The screen is the
    partial distance over the first p dimensions; est = part / coeff is a
    high-confidence lower bound of the full distance, and the ``keep``
    best-bounded centroids (``torch.topk``) are re-ranked exactly at full d:
    k * p + keep * d products a point instead of k * d. The update and the
    split are kmeans_fused_loop's.

    Returns (new_centroids, tau [n] the exact distance to the assigned
    centroid, obj, sum(counts^2), sum(counts), the fraction of (point,
    centroid) pairs whose bound exceeds tau: those the screen prunes)."""
    n, d = x.shape
    k = centroids.shape[0]
    cn_p = centroids[:, :p].square().sum(-1)
    cn = centroids.square().sum(-1)
    sums = torch.zeros(k, d, device=x.device)
    counts = torch.zeros(k, device=x.device)
    obj = torch.zeros((), dtype=torch.float64, device=x.device)
    npruned = torch.zeros((), dtype=torch.float64, device=x.device)
    taus = []
    for s in range(0, n, chunk):
        xc = x[s : s + chunk]
        xp = xc[:, :p]
        part = (xp.square().sum(-1)[:, None] + cn_p[None, :]
                - 2.0 * (xp @ centroids[:, :p].T))
        est = part.clamp_min(0.0) / coeff
        _, cand = torch.topk(est, keep, dim=1, largest=False)
        full = (xc.square().sum(-1)[:, None] + cn[cand]
                - 2.0 * torch.einsum("nd,ncd->nc", xc, centroids[cand]))
        best, j = full.min(dim=1)
        best = best.clamp_min(0.0)
        assign = torch.gather(cand, 1, j[:, None])[:, 0]
        npruned += (est > best[:, None]).sum(dtype=torch.float64)
        add_to_centroids(sums, assign, xc)
        counts += torch.bincount(assign, minlength=k).float()
        obj += best.sum(dtype=torch.float64)
        taus.append(best)
    new_c, _ = _new_centroids(centroids, sums, counts, generator,
                              spherical=False, int_centroids=False,
                              frozen=False, split=True)
    return (
        new_c, torch.cat(taus), obj, counts.double().square().sum(),
        counts.double().sum(), npruned / (n * k),
    )


# elements of one batched_kmeans assignment tile
BATCHED_TILE = 1 << 28


def batched_kmeans(
    xs: torch.Tensor,  # [M, n, dsub] — M independent clustering problems
    init: torch.Tensor,  # [M, k, dsub] initial centroids
    niter: int = 25,
) -> torch.Tensor:
    """M independent Lloyd runs at once (PQ codebook training;
    faiss_tpu/ops/kmeans_ops.py:550). Empty clusters keep their previous
    centroid, as in faiss_tpu. Returns centroids [M, k, dsub]."""
    M, n, dsub = xs.shape
    k = init.shape[1]
    x_norms = xs.square().sum(-1)  # [M, n]
    c = init.clone()
    # rows of one assignment tile [M, rows, k] (PQ at up to 16 bits)
    rows = max(1, BATCHED_TILE // (M * k))
    assign = torch.empty(M, n, dtype=torch.int64, device=xs.device)
    for _ in range(niter):
        c_norms = c.square().sum(-1)[:, None, :]
        for r in range(0, n, rows):
            d2 = (
                x_norms[:, r : r + rows, None]
                + c_norms
                - 2.0 * torch.bmm(xs[:, r : r + rows], c.transpose(1, 2))
            )
            assign[:, r : r + rows] = d2.argmin(dim=-1)
        sums = torch.zeros_like(c).scatter_add_(
            1, assign[..., None].expand(M, n, dsub), xs
        )
        counts = torch.zeros(M, k, device=xs.device).scatter_add_(
            1, assign, torch.ones_like(x_norms)
        )
        c = torch.where(
            counts[..., None] > 0, sums / counts.clamp_min(1.0)[..., None], c
        )
    return c
