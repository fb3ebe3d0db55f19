"""k-means clustering (counterpart of faiss_tpu/clustering.py).

Training semantics of the reference (Clustering::train_encoded,
Clustering.cpp:60): NaN check, subsampling to <= k * max_points_per_centroid,
seeded random init, niter Lloyd iterations with empty-cluster splits, nredo
restarts keeping the best objective, per-iteration stats. Subsampling and
init draw from ``np.random.RandomState(seed)`` exactly as faiss_tpu does, so
both packages start from bit-identical centroids; the Lloyd loop runs on the
device (ops/kmeans_ops.kmeans_fused_loop). ``spherical`` normalizes the
centroids after the init and after each update, as faiss_tpu does
(clustering.py:177, ops/kmeans_ops.py:290). Only the "random" init is
ported (kmeans++, AFK-MC2, int and frozen centroids and weights are ROADMAP
queue 1 item 9)."""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from .ops.kmeans_ops import kmeans_fused_loop


@dataclass
class ClusteringIterationStats:
    """Per-iteration stats (reference: Clustering.h:82)."""

    obj: float
    time: float
    time_search: float
    imbalance_factor: float
    nsplit: int


@dataclass
class ClusteringParameters:
    """Training knobs (reference: Clustering.h:26-77)."""

    niter: int = 25
    nredo: int = 1
    verbose: bool = False
    min_points_per_centroid: int = 39
    max_points_per_centroid: int = 256
    seed: int = 1234
    check_input_data_for_NaNs: bool = True
    spherical: bool = False


class Clustering:
    """Lloyd's k-means (reference: faiss/Clustering.h:95)."""

    def __init__(
        self, d: int, k: int, cp: Optional[ClusteringParameters] = None, *,
        device,
    ):
        self.d = int(d)
        self.k = int(k)
        self.cp = cp or ClusteringParameters()
        self.device = torch.device(device)
        self.centroids: Optional[np.ndarray] = None
        self.iteration_stats: List[ClusteringIterationStats] = []

    def _prepare(self, x: np.ndarray, rs) -> np.ndarray:
        """Clustering.cpp:107 subsample_training_set (faiss_tpu :122)."""
        n = len(x)
        if self.cp.check_input_data_for_NaNs and not np.isfinite(x).all():
            raise ValueError("input contains NaN or Inf")
        if n < self.k:
            raise ValueError(f"need at least k={self.k} points, got {n}")
        max_n = self.k * self.cp.max_points_per_centroid
        if n > max_n:
            x = x[rs.permutation(n)[:max_n]]
            if self.cp.verbose:
                print(f"Sampling a subset of {max_n} / {n} for training")
        elif n < self.k * self.cp.min_points_per_centroid and self.cp.verbose:
            print(
                f"WARNING clustering {n} points to {self.k} centroids: please "
                f"provide at least {self.k * self.cp.min_points_per_centroid} "
                "training points"
            )
        return x

    def _init_centroids(self, x: np.ndarray, rs) -> np.ndarray:
        """Warm start or a random sample, then normalized if spherical
        (faiss_tpu :177)."""
        if self.centroids is not None and len(self.centroids) == self.k:
            c = np.array(self.centroids, dtype=np.float32)
        else:
            perm = rs.permutation(len(x))[: self.k]
            c = x[perm].astype(np.float32).copy()
        if self.cp.spherical:
            c = c / np.maximum(np.linalg.norm(c, axis=1, keepdims=True), 1e-30)
        return c

    def train(self, x) -> float:
        x = np.ascontiguousarray(x, dtype=np.float32)
        if x.ndim != 2 or x.shape[1] != self.d:
            raise ValueError(f"expected [n, {self.d}] training data")
        rs = np.random.RandomState(self.cp.seed)
        x = self._prepare(x, rs)
        xd = torch.from_numpy(x).to(self.device)
        # rows per assignment chunk: a [chunk, k] float32 distance block of
        # at most 512 MB
        chunk = max(1024, (1 << 27) // max(self.k, 1))
        best_obj, best_centroids, best_stats = np.inf, None, []
        for redo in range(self.cp.nredo):
            t0 = time.time()
            init = self._init_centroids(x, rs)
            gen = torch.Generator(device=self.device)
            gen.manual_seed(self.cp.seed + 7919 * redo)
            c, objs, sumsq, tots, nsplits, _ = kmeans_fused_loop(
                xd, torch.from_numpy(init).to(self.device), gen,
                niter=self.cp.niter, chunk=chunk, spherical=self.cp.spherical,
            )
            centroids = c.cpu().numpy()
            objs, sumsq, tots, nsplits = (
                t.cpu().numpy() for t in (objs, sumsq, tots, nsplits)
            )
            t_iter = (time.time() - t0) / max(1, self.cp.niter)
            stats = [
                ClusteringIterationStats(
                    obj=float(objs[it]),
                    time=t_iter,
                    time_search=t_iter,
                    imbalance_factor=float(
                        self.k * sumsq[it] / max(tots[it] ** 2, 1e-30)
                    ),
                    nsplit=int(nsplits[it]),
                )
                for it in range(self.cp.niter)
            ]
            if self.cp.verbose:
                for it, s in enumerate(stats):
                    print(
                        f"  Iteration {it}: objective={s.obj:g} "
                        f"imbalance={s.imbalance_factor:.3f} nsplit={s.nsplit}"
                    )
            obj = float(objs[-1]) if self.cp.niter else np.inf
            if obj < best_obj or best_centroids is None:
                best_obj, best_centroids, best_stats = obj, centroids, stats
            if self.cp.nredo > 1:
                self.centroids = None  # force re-init on next redo
        self.centroids = best_centroids
        self.iteration_stats = best_stats
        return best_obj
