"""Polysemous training (a copy of faiss_tpu/codecs/polysemous.py, host
numpy; reference: faiss/impl/PolysemousTraining.{h,cpp}).

Reorders each PQ sub-quantizer's centroid indices so that the HAMMING
distance between code words correlates with the distance between their
centroids (Douze et al., "Polysemous codes", ECCV'16). Search can then
prefilter candidates by Hamming distance on the codes before running ADC
(IndexPQ search_type ST_polysemous, polysemous_ht threshold).

The permutation is optimized per sub-quantizer by simulated annealing over
pair swaps, minimizing the squared disagreement between scaled Hamming
distances and centroid distances (the reference's
ReproduceDistancesObjective with dis_weight_factor). The RandomState draws
and the float64 cost are faiss_tpu's, so the permutation is too.
"""

from __future__ import annotations

import numpy as np


def _hamming_table(nbits: int) -> np.ndarray:
    """[2^nbits, 2^nbits] int hamming distances between code indices."""
    k = 1 << nbits
    codes = np.arange(k)
    x = codes[:, None] ^ codes[None, :]
    return np.unpackbits(
        x.astype(">u4").view(np.uint8).reshape(k, k, 4), axis=2
    ).sum(2)


class SimulatedAnnealingParameters:
    """reference: PolysemousTraining.h:25."""

    def __init__(self):
        self.init_temperature = 0.7
        self.temperature_decay = 0.9997893011688015  # 0.9^(1/500)
        self.n_iter = 50000
        self.n_redo = 1
        self.seed = 123
        self.verbose = 0


class PolysemousTraining(SimulatedAnnealingParameters):
    """reference: PolysemousTraining.h:72."""

    OT_None = 0
    OT_ReproduceDistances_affine = 1
    OT_Ranking_weighted_diff = 2

    def __init__(self):
        super().__init__()
        self.optimization_type = self.OT_ReproduceDistances_affine
        self.dis_weight_factor = np.log(2)

    def _optimize_permutation(self, dcent: np.ndarray, nbits: int, rs):
        """SA over permutations of one sub-quantizer's centroids."""
        k = len(dcent)
        ham = _hamming_table(nbits).astype(np.float64)
        # affine scale between mean hamming and mean centroid distance
        scale = dcent.mean() / max(ham.mean(), 1e-12)
        target = ham * scale
        # weights decaying with hamming distance (close codes matter most)
        w = np.exp(-self.dis_weight_factor * ham)

        perm = rs.permutation(k)

        def cost(p):
            dp = dcent[np.ix_(p, p)]
            return float((w * (dp - target) ** 2).sum())

        cur = cost(perm)
        temp = self.init_temperature * cur / (k * k)
        # full vectorized cost per proposal; iteration count bounded so a
        # 256-entry codebook optimizes in seconds
        n_iter = min(self.n_iter, 3000)
        for it in range(n_iter):
            i, j = rs.randint(k), rs.randint(k)
            if i == j:
                continue
            newp = perm.copy()
            newp[i], newp[j] = newp[j], newp[i]
            c2 = cost(newp)
            accept = c2 < cur or rs.rand() < np.exp(-(c2 - cur) / max(temp, 1e-12))
            if accept:
                perm, cur = newp, c2
            temp *= self.temperature_decay
        return perm

    def optimize_pq_for_hamming(self, pq) -> None:
        """Permute pq.centroids in place (reference:
        PolysemousTraining::optimize_pq_for_hamming)."""
        rs = np.random.RandomState(self.seed)
        if self.optimization_type == self.OT_None:
            return
        for m in range(pq.M):
            c = pq.centroids[m]  # [ksub, dsub]
            d2 = (
                (c**2).sum(1)[:, None]
                + (c**2).sum(1)[None, :]
                - 2 * c @ c.T
            )
            perm = self._optimize_permutation(d2, pq.nbits, rs)
            # centroid that was at perm[i] gets code i
            pq.centroids[m] = c[perm]
        pq.set_centroids(pq.centroids)
