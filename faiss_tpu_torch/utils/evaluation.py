"""Result evaluation (counterpart of faiss_tpu/utils/evaluation.py)."""

from __future__ import annotations

import numpy as np


def knn_intersection_measure(I1: np.ndarray, I2: np.ndarray) -> float:
    """Fraction of shared ids per row (contrib/evaluation.py:17; faiss_tpu
    utils/evaluation.py:12)."""
    nq, k = I1.shape
    assert I2.shape == (nq, k)
    ninter = sum(
        len(np.intersect1d(I1[i], I2[i][I2[i] >= 0])) for i in range(nq)
    )
    return ninter / float(nq * k)


def recall_at_k(I: np.ndarray, gt: np.ndarray, k: int, rank: int = 1) -> float:
    """R@k of the true NN: fraction of queries whose gt[:, :rank] ids appear
    in the first k results (the `1-recall@R` criterion, AutoTune.h:56)."""
    nq = len(I)
    found = 0
    for i in range(nq):
        found += len(np.intersect1d(gt[i, :rank], I[i, :k])) > 0
    return found / nq


def ids_agree_tie_aware(D_a, I_a, D_b, I_b, tol) -> np.ndarray:
    """Per-row True where two ascending top-k lists hold the same ids up to
    ties at the cut.

    An id that one list holds and the other does not is accepted only when
    its distance lies within ``tol`` (scalar or per row) of the other list's
    last distance: a different tie break at the k-th rank could have kept it
    there. Every id clearly inside the other list's range must appear in
    both lists."""
    D_a, D_b = np.asarray(D_a, np.float64), np.asarray(D_b, np.float64)
    I_a, I_b = np.asarray(I_a), np.asarray(I_b)
    tol = np.broadcast_to(np.asarray(tol, np.float64), (len(D_a),))
    ok = np.ones(len(D_a), bool)
    for r in range(len(D_a)):
        for Dx, Ix, Dy, Iy in ((D_a, I_a, D_b, I_b), (D_b, I_b, D_a, I_a)):
            only = ~np.isin(Ix[r], Iy[r])
            if (Dx[r][only] < Dy[r][-1] - tol[r]).any():
                ok[r] = False
    return ok
