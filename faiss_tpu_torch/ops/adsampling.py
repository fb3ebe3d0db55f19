"""ADSampling thresholds and the PDX layout (counterpart of
faiss_tpu/ops/adsampling.py; reference: faiss/impl/AdSampling.h,
faiss/impl/PdxLayout.h), the dimension-progressive pruning behind
SuperKMeans (Gao & Long, ADSampling, SIGMOD'23).

After a random rotation, the partial squared distance over the first p of d
dimensions is ~ (p / d) chi2_p-distributed relative to the full distance, so
partial / coeff[p] is a high-confidence lower bound of the full distance,
coeff[p] a chi-squared quantile over d. The thresholds and the layout
helpers are host numpy, copied from faiss_tpu so both packages hold the same
values; ``assign_adsampling`` runs on tensors: a partial-dimension screen,
then the exact distances of the ``keep`` best-bounded centroids."""

from __future__ import annotations

from statistics import NormalDist
from typing import Tuple

import numpy as np
import torch

_NORMAL = NormalDist()


def normal_quantile(p: float) -> float:
    """Inverse standard normal CDF (AdSampling.h:18)."""
    return _NORMAL.inv_cdf(p)


def chi2_quantile_wh(p: int, alpha: float) -> float:
    """Chi-squared quantile by the Wilson-Hilferty cube-root approximation
    (AdSampling.h:21): chi2_p(alpha) ~= p (1 - 2/(9p) + z sqrt(2/(9p)))^3,
    within ~2% for p >= 16 and alpha away from 1."""
    z = normal_quantile(alpha)
    a = 2.0 / (9.0 * p)
    return p * (1.0 - a + z * np.sqrt(a)) ** 3


def precompute_ad_thresholds(d: int, epsilon: float) -> np.ndarray:
    """coeff[p] = chi2_quantile_wh(p, 1 - epsilon) / d for p in [1, d],
    coeff[0] = 0 (AdSampling.h:26); float32 [d + 1]."""
    out = np.zeros(d + 1, np.float32)
    for p in range(1, d + 1):
        out[p] = chi2_quantile_wh(p, 1.0 - epsilon) / d
    return out


def pdxify(Y: np.ndarray, pdx_block_size: int) -> np.ndarray:
    """Row-major [k, d] -> PDX block-column-major (PdxLayout.h:19): within
    each block of dimensions, one dimension's values of all k rows are
    contiguous."""
    k, d = Y.shape
    out = np.empty(k * d, Y.dtype)
    pos = 0
    for b0 in range(0, d, pdx_block_size):
        blk = Y[:, b0 : b0 + pdx_block_size]
        out[pos : pos + blk.size] = blk.T.ravel()
        pos += blk.size
    return out


def de_pdxify(Y_pdx: np.ndarray, k: int, d: int, pdx_block_size: int):
    """Inverse of pdxify (PdxLayout.h:28)."""
    out = np.empty((k, d), Y_pdx.dtype)
    pos = 0
    for b0 in range(0, d, pdx_block_size):
        bs = min(pdx_block_size, d - b0)
        out[:, b0 : b0 + bs] = Y_pdx[pos : pos + k * bs].reshape(bs, k).T
        pos += k * bs
    return out


def compute_partial_norms(X: np.ndarray, p: int) -> np.ndarray:
    """norms[i] = sum_{m < p} X[i, m]^2 in float64, returned as float32
    (PdxLayout.h:36)."""
    return np.sum(np.square(X[:, :p].astype(np.float64)), axis=1).astype(
        np.float32
    )


def assign_adsampling(
    x: torch.Tensor,  # [n, d] float32 (randomly rotated)
    centroids: torch.Tensor,  # [k, d] float32
    d_prime: int = 32,
    epsilon: float = 1e-3,
    keep: int = 64,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Nearest-centroid assignment in the batch form of the SuperKMeans
    assign step (SuperKMeans.h:34; faiss_tpu :79): partial distances over
    the first p = clamp(d_prime, 16, d) dimensions, scaled by 1 / coeff[p]
    into lower bounds of the full distances; the ``keep`` best-bounded
    centroids are scored exactly. With epsilon small and ``keep`` sized for
    the data this equals the exact argmin w.h.p. Returns (dist [n] float32,
    clamped at 0, assign [n] int32), on the inputs' device."""
    x = x.float()
    centroids = centroids.float()
    d = x.shape[1]
    p = min(max(16, d_prime), d)
    coeff = float(precompute_ad_thresholds(d, epsilon)[p])
    xp, cp = x[:, :p], centroids[:, :p]
    part = (xp.square().sum(1)[:, None] + cp.square().sum(1)[None, :]
            - 2.0 * xp @ cp.T)
    est = part / max(coeff, 1e-12)
    _, cand = torch.topk(est, min(len(centroids), keep), dim=1, largest=False)
    g = centroids[cand]  # [n, keep, d]
    full = (x.square().sum(1)[:, None] + g.square().sum(-1)
            - 2.0 * torch.einsum("nd,ncd->nc", x, g))
    dist, j = full.min(dim=1)
    assign = torch.gather(cand, 1, j[:, None])[:, 0]
    return dist.clamp_min(0.0), assign.to(torch.int32)
