"""Distributed-style clustering building blocks (counterpart of
faiss_tpu/contrib/clustering.py; the reference's contrib/clustering.py:
DatasetAssign and a Python k-means driver).

The assignment and the per-centroid sums run on the DatasetAssign's
``device`` (the card unless the caller passes another): the exact k-NN of
extra.knn and one ``index_add_``; the driver's sampling stays in numpy with
faiss_tpu's seeds. The centroids may differ from those of faiss_tpu in the last
bits of a float32 sum; the objective is what compares."""

from __future__ import annotations

import numpy as np
import torch

from ..base import require_device
from ..extra import knn as knn_fn


class DatasetAssign:
    """Wraps a dataset for k-means: get_subset / assign_to
    (contrib/clustering.py DatasetAssign)."""

    def __init__(self, x, *, device="cuda"):
        self.x = np.ascontiguousarray(x, np.float32)
        self.device = require_device(device)
        self._xd = None

    def count(self):
        return len(self.x)

    def dim(self):
        return self.x.shape[1]

    def get_subset(self, indices):
        return self.x[indices]

    def perform_search(self, centroids):
        return knn_fn(self.x, centroids, 1, device=self.device)

    def assign_to(self, centroids, weights=None):
        """(assignment [n], distance [n], sums [k, d], counts [k]) of the
        points to their nearest centroid."""
        D, I = self.perform_search(centroids)
        I = I.ravel()
        if self._xd is None:
            self._xd = torch.from_numpy(self.x).to(self.device)
        k, d = len(centroids), self.x.shape[1]
        idx = torch.from_numpy(I).to(self.device)
        w = (torch.ones(len(I), device=self.device) if weights is None
             else torch.from_numpy(np.asarray(weights, np.float32)).to(self.device))
        sums = torch.zeros(k, d, device=self.device).index_add_(0, idx, self._xd * w[:, None])
        counts = torch.zeros(k, device=self.device).index_add_(0, idx, w)
        return I, D.ravel(), sums.cpu().numpy(), counts.cpu().numpy()


def kmeans(k, data: DatasetAssign, niter=25, seed=1234, verbose=False):
    """Lloyd's iterations over a DatasetAssign (contrib/clustering.py
    kmeans): the building block the distributed recipe shards over
    workers. Empty centroids restart on random points."""
    rs = np.random.RandomState(seed)
    n = data.count()
    centroids = data.get_subset(rs.permutation(n)[:k]).copy()
    for it in range(niter):
        _, dis, sums, counts = data.assign_to(centroids)
        nz = counts > 0
        centroids[nz] = sums[nz] / counts[nz, None]
        nempty = int((~nz).sum())
        if nempty:
            centroids[~nz] = data.get_subset(rs.permutation(n)[:nempty])
        if verbose:
            print(f"iter {it}: obj {dis.sum():.3f}, {nempty} empty")
    return centroids


def two_level_clustering(xt, nc1, nc2, rebalance=True, *, device="cuda", **kwargs):
    """Cluster into nc1 groups, then into nc2 centroids in all by clustering
    each group (contrib/clustering.py two_level_clustering): the recipe for
    a very large nlist. Each Clustering trains on ``device``."""
    from ..clustering import Clustering, ClusteringParameters

    cp = ClusteringParameters(niter=kwargs.get("niter", 25))
    clus1 = Clustering(xt.shape[1], nc1, cp, device=device)
    clus1.train(xt)
    _, assign = DatasetAssign(xt, device=device).perform_search(clus1.centroids)
    assign = assign.ravel()
    # share nc2 among the groups by their sizes
    sizes = np.bincount(assign, minlength=nc1)
    if rebalance:
        quota = np.maximum(1, np.round(sizes / sizes.sum() * nc2).astype(int))
    else:
        quota = np.full(nc1, -(-nc2 // nc1))
    out = []
    for g in range(nc1):
        pts = xt[assign == g]
        kg = int(min(quota[g], max(1, len(pts))))
        if len(pts) == 0:
            continue
        if len(pts) <= kg:
            out.append(pts)
            continue
        cg = Clustering(xt.shape[1], kg, cp, device=device)
        cg.train(pts)
        out.append(cg.centroids)
    return np.concatenate(out)[:nc2]
