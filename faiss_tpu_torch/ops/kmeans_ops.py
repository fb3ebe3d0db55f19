"""k-means on the device (counterpart of faiss_tpu/ops/kmeans_ops.py).

Lloyd iterations as plain PyTorch: the assignment is a float32 GEMM + argmin
chunked over the points (a [200k, 4096] float32 distance matrix would be
3.2 GB), the update an ``index_add_`` of the points into their centroids.
faiss_tpu runs the assignment as three bf16 passes (~2^-16 relative);
here it is exact float32, so objectives agree to that rounding."""

from __future__ import annotations

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


def kmeans_fused_loop(
    x: torch.Tensor,  # [n, d] float32 training points
    init: torch.Tensor,  # [k, d] float32 initial centroids
    generator: torch.Generator,  # empty-cluster donor sampling
    *,
    niter: int,
    chunk: int,
    spherical: bool = False,
):
    """All Lloyd iterations of one k-means run (the float32, unweighted path
    of faiss_tpu's kmeans_fused_loop, :149). ``spherical`` normalizes the
    centroids after each update and split (faiss_tpu :290); the assignment
    stays by L2.

    Each iteration's objective is the sum of squared distances of the points
    to their nearest centroid BEFORE the update (ClusteringIterationStats.obj,
    Clustering.cpp:331). Returns (centroids [k, d], objs [niter] f64,
    sumsq_counts [niter], tot_counts [niter], nsplits [niter],
    counts_last [k]), all on the device."""
    n, d = x.shape
    k = init.shape[0]
    x_norm = x.square().sum(-1)
    c = init.clone()
    objs, sumsq, tots, nsplits = [], [], [], []
    counts = torch.zeros(k, device=x.device)
    for _ in range(niter):
        c_norms = c.square().sum(-1)
        sums = torch.zeros(k, d, device=x.device)
        counts = torch.zeros(k, device=x.device)
        obj = torch.zeros((), dtype=torch.float64, device=x.device)
        for s in range(0, n, chunk):
            xc = x[s : s + chunk]
            d2 = x_norm[s : s + chunk, None] + c_norms[None, :] - 2.0 * (xc @ c.T)
            best, assign = d2.min(dim=1)
            sums.index_add_(0, assign, xc)
            counts += torch.bincount(assign, minlength=k).float()
            obj += best.clamp_min(0.0).sum(dtype=torch.float64)
        new_c = torch.where(
            (counts > 0)[:, None], sums / counts.clamp_min(1e-30)[:, None], c
        )
        new_c, nsplit = _split_empty_clusters(new_c, counts, generator)
        if spherical:
            new_c = new_c / new_c.norm(dim=1, keepdim=True).clamp_min(1e-30)
        objs.append(obj)
        sumsq.append(counts.double().square().sum())
        tots.append(counts.double().sum())
        nsplits.append(nsplit)
        c = new_c

    def stack(v, dtype):
        return torch.stack(v) if v else torch.zeros(0, dtype=dtype)

    return (
        c, stack(objs, torch.float64), stack(sumsq, torch.float64),
        stack(tots, torch.float64), stack(nsplits, torch.int64), counts,
    )


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
    for _ in range(niter):
        d2 = (
            x_norms[..., None]
            + c.square().sum(-1)[:, None, :]
            - 2.0 * torch.bmm(xs, c.transpose(1, 2))
        )
        assign = d2.argmin(dim=-1)  # [M, n]
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
