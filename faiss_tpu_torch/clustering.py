"""k-means clustering (counterpart of faiss_tpu/clustering.py).

Training semantics of the reference (Clustering::train_encoded,
Clustering.cpp:60): NaN check, subsampling to <= k * max_points_per_centroid,
seeded init (random, k-means++ or AFK-MC2), niter Lloyd iterations with
empty-cluster splits, nredo restarts keeping the best objective, weights,
spherical, integer and frozen centroids, per-iteration stats. Subsampling
and the inits draw from ``np.random.RandomState(seed)`` exactly as faiss_tpu
does, on the host, so both packages start from bit-identical centroids; the
Lloyd loop runs on the device (ops/kmeans_ops.kmeans_fused_loop), and uint8
points stay uint8 there (faiss_tpu :198-202: no weights, random init).

Also here: ``SuperKMeans`` (ADSampling-pruned assignment after a random
rotation), ``kmeans_clustering``, the sklearn-style ``Kmeans`` (its
``assign`` goes through IndexFlatL2), the exact 1-D ``kmeans1d`` (host
numpy) and ``ProgressiveDimClustering`` (k-means over growing prefixes of
the PCA dimensions). Every class takes a ``device``, the card unless the
caller passes another."""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from .base import require_device
from .ops.kmeans_ops import kmeans_fused_loop, superkm_assign_update

EPS = 1.0 / 1024.0  # centroid-split perturbation (ClusteringHelpers.h:99)


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
    """Training knobs (reference: Clustering.h:26-77), in faiss_tpu's
    order."""

    niter: int = 25
    nredo: int = 1
    verbose: bool = False
    spherical: bool = False
    int_centroids: bool = False
    update_index: bool = True  # kept for API parity; always true here
    frozen_centroids: bool = False
    min_points_per_centroid: int = 39
    max_points_per_centroid: int = 256
    seed: int = 1234
    decode_block_size: int = 32768  # kept for API parity
    check_input_data_for_NaNs: bool = True
    init_method: str = "random"  # random | kmeans++ | afkmc2


def imbalance_factor(counts: np.ndarray) -> float:
    """n * sum(c^2) / (sum c)^2 (reference: utils/utils.cpp
    imbalance_factor)."""
    tot = counts.sum()
    if tot == 0:
        return float("nan")
    return float(len(counts) * (counts.astype(np.float64) ** 2).sum() / tot**2)


def _afk_mc2_init(
    x: np.ndarray, k: int, rs: np.random.RandomState, chain_length: int = 200
) -> np.ndarray:
    """AFK-MC^2 seeding (reference: impl/ClusteringInitialization.cpp;
    Bachem et al., NeurIPS'16): k-means++ approximated by a Metropolis chain
    over the proposal q = 0.5 d(x, c1) / sum + 0.5 / n. Host numpy, the
    calls of faiss_tpu (:63) on the same RandomState."""
    n = len(x)
    centroids = np.empty((k, x.shape[1]), np.float32)
    centroids[0] = x[rs.randint(n)]
    d1 = ((x - centroids[0]) ** 2).sum(1)
    q = 0.5 * d1 / max(d1.sum(), 1e-30) + 0.5 / n
    cum = np.cumsum(q)
    for i in range(1, k):
        cand = np.minimum(np.searchsorted(cum, rs.rand(chain_length)), n - 1)
        dc = ((x[cand][:, None, :] - centroids[None, :i, :]) ** 2).sum(-1).min(1)
        cur, cur_d = cand[0], dc[0]
        for j in range(1, chain_length):
            a = (dc[j] * q[cur]) / max(cur_d * q[cand[j]], 1e-30)
            if a >= 1 or rs.rand() < a:
                cur, cur_d = cand[j], dc[j]
        centroids[i] = x[cur]
    return centroids


def _kmeans_pp_init(x: np.ndarray, k: int, rs: np.random.RandomState) -> np.ndarray:
    """k-means++ seeding (reference: impl/ClusteringInitialization.cpp):
    host numpy, the calls of faiss_tpu (:91) on the same RandomState."""
    n = len(x)
    centroids = np.empty((k, x.shape[1]), dtype=np.float32)
    centroids[0] = x[rs.randint(n)]
    d2 = ((x - centroids[0]) ** 2).sum(1)
    for i in range(1, k):
        probs = d2 / max(d2.sum(), 1e-30)
        centroids[i] = x[rs.choice(n, p=probs)]
        d2 = np.minimum(d2, ((x - centroids[i]) ** 2).sum(1))
    return centroids


def _point_chunk(k: int, d: int, width: int = 1) -> int:
    """Rows per assignment chunk: a [chunk, k] float32 distance block, the
    chunk's decoded [chunk, d] float32 rows and a [chunk, width, d] gather
    each of at most 512 MB."""
    return max(1024, (1 << 27) // max(k, d * width, 1))


class Clustering:
    """Lloyd's k-means (reference: faiss/Clustering.h:95)."""

    def __init__(self, d: int, k: int, cp: Optional[ClusteringParameters] = None,
                 *, device="cuda"):
        self.d = int(d)
        self.k = int(k)
        self.cp = cp or ClusteringParameters()
        self.device = require_device(device)
        self.centroids: Optional[np.ndarray] = None
        self.iteration_stats: List[ClusteringIterationStats] = []

    def _prepare(self, x: np.ndarray, weights, rs):
        """Clustering.cpp:107 subsample_training_set (faiss_tpu :122): the
        same permutation subsamples the points and their weights. Integer
        points are finite by type and skip the NaN scan."""
        n = len(x)
        if (self.cp.check_input_data_for_NaNs and x.dtype.kind == "f"
                and not np.isfinite(x).all()):
            raise ValueError("input contains NaN or Inf")
        if n < self.k:
            raise ValueError(f"need at least k={self.k} points, got {n}")
        max_n = self.k * self.cp.max_points_per_centroid
        if n > max_n:
            perm = rs.permutation(n)[:max_n]
            x = x[perm]
            weights = weights[perm] if weights is not None else None
            if self.cp.verbose:
                print(f"Sampling a subset of {max_n} / {n} for training")
        elif n < self.k * self.cp.min_points_per_centroid and self.cp.verbose:
            print(
                f"WARNING clustering {n} points to {self.k} centroids: please "
                f"provide at least {self.k * self.cp.min_points_per_centroid} "
                "training points"
            )
        return x, weights

    def _init_centroids(self, x: np.ndarray, rs) -> np.ndarray:
        """A warm start, or the init of ``init_method`` (faiss_tpu :142)."""
        if self.centroids is not None and len(self.centroids) == self.k:
            return np.array(self.centroids, dtype=np.float32)
        if self.cp.init_method == "kmeans++":
            return _kmeans_pp_init(x, self.k, rs)
        if self.cp.init_method == "afkmc2":
            return _afk_mc2_init(x, self.k, rs)
        perm = rs.permutation(len(x))[: self.k]
        return x[perm].astype(np.float32)

    @staticmethod
    def _split_clusters(centroids, counts, rs):
        """Host re-seeding of empty clusters by splitting big ones, in place
        (impl/ClusteringHelpers.h:85; faiss_tpu :156). The device loop does
        its own splits; this is the reference's sequential form. Returns
        the number of splits."""
        k = len(centroids)
        nsplit = 0
        for ci in np.nonzero(counts == 0)[0]:
            probs = np.maximum(counts - 1, 0).astype(np.float64)
            probs /= max(probs.sum(), 1e-30)
            cj = rs.choice(k, p=probs)
            centroids[ci] = centroids[cj]
            centroids[ci] *= 1 + EPS
            centroids[cj] *= 1 - EPS
            counts[ci] = counts[cj] // 2
            counts[cj] -= counts[ci]
            nsplit += 1
        return nsplit

    def _postprocess(self, centroids: np.ndarray) -> np.ndarray:
        """Normalized (spherical) and rounded (int_centroids), as faiss_tpu
        treats the init (:176)."""
        if self.cp.spherical:
            norms = np.linalg.norm(centroids, axis=1, keepdims=True)
            centroids = centroids / np.maximum(norms, 1e-30)
        if self.cp.int_centroids:
            centroids = np.round(centroids)
        return centroids

    def train(self, x, weights=None) -> float:
        """Lloyd's k-means over ``x`` [n, d], optionally weighted by
        ``weights`` [n]; returns the best run's last objective. uint8
        points with no weights and the random init stay uint8 on the device
        (the k-means++ and AFK-MC2 inits do signed float arithmetic on x)."""
        u8 = (getattr(x, "dtype", None) == np.uint8 and weights is None
              and self.cp.init_method == "random")
        x = np.ascontiguousarray(x, dtype=np.uint8 if u8 else np.float32)
        if x.ndim != 2 or x.shape[1] != self.d:
            raise ValueError(f"expected [n, {self.d}] training data")
        if weights is not None:
            weights = np.ascontiguousarray(weights, dtype=np.float32)
        rs = np.random.RandomState(self.cp.seed)
        x, weights = self._prepare(x, weights, rs)
        xd = torch.from_numpy(x).to(self.device)
        wd = None if weights is None else torch.from_numpy(weights).to(self.device)
        chunk = _point_chunk(self.k, self.d)
        best_obj, best_centroids, best_stats = np.inf, None, []
        for redo in range(self.cp.nredo):
            t0 = time.time()
            init = self._postprocess(self._init_centroids(x, rs))
            gen = torch.Generator(device=self.device)
            gen.manual_seed(self.cp.seed + 7919 * redo)
            c, objs, sumsq, tots, nsplits, _ = kmeans_fused_loop(
                xd, torch.from_numpy(init).to(self.device), gen, wd,
                niter=self.cp.niter, chunk=chunk, spherical=self.cp.spherical,
                int_centroids=self.cp.int_centroids,
                frozen=self.cp.frozen_centroids,
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


@dataclass
class SuperKMeansParameters(ClusteringParameters):
    """SuperKMeans knobs (reference: SuperKMeans.h:26-58)."""

    d_prime_fraction: float = 0.125
    pruning_low: float = 0.5
    pruning_high: float = 0.9
    d_prime_adjust: float = 0.20
    d_prime_min: int = 16
    epsilon: float = 1e-3  # ADSampling chi-squared tail mass
    keep: int = 64  # candidates re-ranked exactly per point


class SuperKMeans:
    """k-means with ADSampling-pruned assignment (reference:
    faiss/SuperKMeans.{h,cpp}; Gao & Long SIGMOD'23; faiss_tpu :310).

    The points are randomly rotated (the chi-squared bound's assumption);
    iteration 0 is one exact Lloyd step, each later one screens all
    centroids on the first d' dimensions and re-ranks the ``keep``
    best-bounded exactly (ops/kmeans_ops.superkm_assign_update). The
    controller of SuperKMeans.cpp adapt_d_prime shrinks d' while the pruned
    share of (point, centroid) pairs is above the band and grows it below;
    the screen runs at d' rounded up to a multiple of 16. Weighted training
    runs the exact loop for every iteration, as the pruned update has no
    weighted form. Centroids come back in the original basis."""

    def __init__(self, d: int, k: int, cp: Optional[SuperKMeansParameters] = None,
                 *, device="cuda"):
        self.d = int(d)
        self.k = int(k)
        self.cp = cp or SuperKMeansParameters()
        self.device = require_device(device)
        self.centroids: Optional[np.ndarray] = None
        self.iteration_stats: List[ClusteringIterationStats] = []
        self.pruning_fractions: List[float] = []

    def train(self, x, weights=None) -> float:
        from .ops.adsampling import precompute_ad_thresholds
        from .transforms import RandomRotationMatrix

        cp = self.cp
        x = np.ascontiguousarray(x, np.float32)
        if weights is not None:
            weights = np.ascontiguousarray(weights, np.float32)
        rs = np.random.RandomState(cp.seed)
        base = Clustering(self.d, self.k, cp, device=self.device)
        x, weights = base._prepare(x, weights, rs)
        rot = RandomRotationMatrix(self.d, self.d, device=self.device)
        rot.train(x)
        xd = rot.apply_tensor(torch.from_numpy(x))
        init = torch.from_numpy(
            base._init_centroids(xd.cpu().numpy(), rs)).to(self.device)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(cp.seed)
        if weights is not None:
            c, objs, _, _, _, _ = kmeans_fused_loop(
                xd, init, gen, torch.from_numpy(weights).to(self.device),
                niter=cp.niter, chunk=_point_chunk(self.k, self.d),
                spherical=cp.spherical,
            )
            objs = objs.cpu().numpy()
            self.iteration_stats = [
                ClusteringIterationStats(obj=float(o), time=0.0, time_search=0.0,
                                         imbalance_factor=0.0, nsplit=0)
                for o in objs
            ]
            self.centroids = rot.reverse_transform(c.cpu().numpy())
            return float(objs[-1])
        # iteration 0: one exact Lloyd step (SuperKMeans.cpp:66)
        c, objs0, _, _, _, _ = kmeans_fused_loop(
            xd, init, gen, niter=1, chunk=_point_chunk(self.k, self.d),
            spherical=cp.spherical,
        )
        coeffs = precompute_ad_thresholds(self.d, cp.epsilon)
        keep = min(cp.keep, self.k)
        chunk = _point_chunk(self.k, self.d, keep)
        d_prime = max(cp.d_prime_min, int(self.d * cp.d_prime_fraction))
        d_prime = min(d_prime, max(cp.d_prime_min, self.d // 2))
        stats: List[ClusteringIterationStats] = []
        obj = float(objs0[0])
        t0 = time.time()
        for it in range(1, cp.niter):
            p = min(self.d, -(-d_prime // 16) * 16)
            c, _, obj_dev, sumsq, tot, pruned = superkm_assign_update(
                xd, c, float(coeffs[p]), gen, p, keep, chunk,
            )
            obj, frac = float(obj_dev), float(pruned)
            self.pruning_fractions.append(frac)
            if frac > cp.pruning_high:
                d_prime = max(cp.d_prime_min,
                              int(round(d_prime * (1 - cp.d_prime_adjust))))
            elif frac < cp.pruning_low:
                d_prime = min(self.d,
                              int(round(d_prime * (1 + cp.d_prime_adjust))))
            stats.append(ClusteringIterationStats(
                obj=obj, time=(time.time() - t0) / it, time_search=0.0,
                imbalance_factor=float(
                    self.k * float(sumsq) / max(float(tot) ** 2, 1e-30)),
                nsplit=0,
            ))
            if cp.verbose:
                print(f"  SuperKMeans it {it}: obj={obj:g} d'={d_prime} "
                      f"pruned={frac:.3f}")
        self.iteration_stats = stats
        self.centroids = rot.reverse_transform(c.cpu().numpy())
        return obj


def kmeans_clustering(d, k, x, niter=25, *, device="cuda", **kw) -> np.ndarray:
    """Centroids [k, d] of Lloyd's k-means over ``x`` (reference:
    Clustering.h kmeans_clustering:436)."""
    clus = Clustering(d, k, ClusteringParameters(niter=niter, **kw),
                      device=device)
    clus.train(x)
    return clus.centroids


class Kmeans:
    """sklearn-style wrapper (reference: python/extra_wrappers.py:484).
    Keyword arguments set ClusteringParameters fields; ``gpu`` is accepted
    and ignored, as faiss_tpu does: ``device`` says where the work runs."""

    def __init__(self, d: int, k: int, *, device="cuda", **kwargs):
        self.d, self.k = int(d), int(k)
        self.device = require_device(device)
        cp = ClusteringParameters()
        self.gpu = kwargs.pop("gpu", False)
        for name, val in kwargs.items():
            if not hasattr(cp, name):
                raise TypeError(f"unknown Kmeans parameter {name!r}")
            setattr(cp, name, val)
        self.cp = cp
        self.centroids: Optional[np.ndarray] = None
        self.obj: Optional[np.ndarray] = None
        self.iteration_stats = []
        self.index = None

    def train(self, x, weights=None, init_centroids=None) -> float:
        clus = Clustering(self.d, self.k, self.cp, device=self.device)
        if init_centroids is not None:
            clus.centroids = np.ascontiguousarray(init_centroids, np.float32)
        best = clus.train(x, weights=weights)
        self.centroids = clus.centroids
        self.iteration_stats = clus.iteration_stats
        self.obj = np.array([s.obj for s in clus.iteration_stats])
        self.index = None  # built at the next assign()
        return best

    def assign(self, x):
        """(D [n] squared distances, I [n] nearest centroid) through an
        IndexFlatL2 over the centroids on ``device``."""
        from .models.flat import IndexFlatL2

        if self.index is None:
            self.index = IndexFlatL2(self.d, device=self.device)
            self.index.add(self.centroids)
        D, I = self.index.search(np.ascontiguousarray(x, np.float32), 1)
        return D.ravel(), I.ravel()


def kmeans1d(x, k: int):
    """Optimal 1-D k-means by dynamic programming (reference:
    impl/kmeans1d.{h,cpp}; faiss_tpu :473, copied: the O(k n^2) DP, exact,
    host numpy). Returns (centroids [k] float32, assignment [n] of the
    SORTED values)."""
    x = np.sort(np.asarray(x, np.float64).ravel())
    n = len(x)
    k = min(k, n)
    ps = np.concatenate([[0.0], np.cumsum(x)])
    ps2 = np.concatenate([[0.0], np.cumsum(x * x)])
    INF = np.inf
    B = np.zeros((k + 1, n + 1), np.int64)
    # D[c, j] = min_{c-1 <= i < j} D[c-1, i] + cost(x[i:j]), vectorized over
    # (i, j) in column tiles
    ii = np.arange(n + 1)
    Dprev = np.full(n + 1, INF)
    Dprev[0] = 0.0
    chunk = max(1, (1 << 22) // (n + 1))  # ~32 MB of doubles per tile
    for c in range(1, k + 1):
        Dcur = np.full(n + 1, INF)
        lo = c - 1
        for j0 in range(1, n + 1, chunk):
            js = np.arange(j0, min(j0 + chunk, n + 1))
            m = js[None, :] - ii[lo:, None]
            s = ps[js][None, :] - ps[ii[lo:]][:, None]
            s2 = ps2[js][None, :] - ps2[ii[lo:]][:, None]
            with np.errstate(invalid="ignore", divide="ignore"):
                cst = s2 - s * s / m
            tot = np.where(m > 0, Dprev[lo:, None] + cst, INF)
            amin = np.argmin(tot, axis=0)
            Dcur[js] = tot[amin, np.arange(len(js))]
            B[c, js] = amin + lo
        Dprev = Dcur
    bounds = [n]
    for c in range(k, 0, -1):
        bounds.append(int(B[c, bounds[-1]]))
    bounds = bounds[::-1]
    centroids = np.empty(k, np.float32)
    assign = np.empty(n, np.int64)
    for c in range(k):
        i, j = bounds[c], bounds[c + 1]
        centroids[c] = x[i:j].mean() if j > i else (x[min(i, n - 1)])
        assign[i:j] = c
    return centroids, assign


@dataclass
class ProgressiveDimClusteringParameters(ClusteringParameters):
    """reference: Clustering.h ProgressiveDimClusteringParameters."""

    progressive_dim_steps: int = 10
    apply_pca: bool = True


class ProgressiveDimClustering:
    """k-means over growing prefixes of the dimensions (reference:
    Clustering.h ProgressiveDimClustering; faiss_tpu :555): after a PCA
    (the port's PCAMatrix), step s of progressive_dim_steps clusters the
    first round(d^(s / steps)) dimensions for niter / steps + 2 iterations,
    warm-started from the previous step's centroids with the new dimensions
    at the data mean."""

    def __init__(self, d: int, k: int, cp=None, *, device="cuda"):
        self.d, self.k = int(d), int(k)
        self.cp = cp or ProgressiveDimClusteringParameters()
        self.device = require_device(device)
        self.centroids = None
        self.iteration_stats = []

    def train(self, x) -> float:
        from .transforms import PCAMatrix

        x = np.ascontiguousarray(x, np.float32)
        pca = None
        if self.cp.apply_pca:
            pca = PCAMatrix(self.d, self.d, device=self.device)
            pca.train(x)
            x = pca.apply(x)
        steps = self.cp.progressive_dim_steps
        centroids = None
        obj = np.inf
        for s in range(1, steps + 1):
            dprefix = min(max(1, int(round(self.d ** (s / steps)))), self.d)
            cp = ClusteringParameters(niter=self.cp.niter // steps + 2,
                                      seed=self.cp.seed)
            clus = Clustering(dprefix, self.k, cp, device=self.device)
            if centroids is not None:
                clus.centroids = centroids[:, :dprefix].copy()
            obj = clus.train(x[:, :dprefix])
            grown = np.zeros((self.k, self.d), np.float32)
            grown[:, :dprefix] = clus.centroids
            if dprefix < self.d:
                grown[:, dprefix:] = x[:, dprefix:].mean(0)[None]
            centroids = grown
        if pca is not None:
            centroids = pca.reverse_transform(centroids)
        self.centroids = centroids
        return obj
