"""Datasets and vector-file IO (counterpart of faiss_tpu/utils/datasets.py;
the reference's contrib/datasets.py + vecs_io.py).

SyntheticDataset draws faiss_tpu's Gaussian mixture bit for bit: the same
RandomState calls in the same order. A dataset's exact ground truth
(``get_groundtruth``) is searched by the port's IndexFlat on the dataset's
``device`` (the card unless the caller sets another). The loaders read the
standard layouts from disk (numpy memmaps); nothing is downloaded.
"""

from __future__ import annotations

import numpy as np


class Dataset:
    """Base dataset (contrib/datasets.py:40)."""

    d: int
    nt: int
    nb: int
    nq: int
    device = "cuda"  # where get_groundtruth searches

    def get_train(self, maxtrain=None) -> np.ndarray:
        raise NotImplementedError

    def get_database(self) -> np.ndarray:
        raise NotImplementedError

    def get_queries(self) -> np.ndarray:
        raise NotImplementedError

    def get_groundtruth(self, k=100) -> np.ndarray:
        from ..metric import MetricType
        from ..models.flat import IndexFlat

        index = IndexFlat(self.d, getattr(self, "metric", MetricType.L2),
                          device=self.device)
        index.add(self.get_database())
        _, gt = index.search(self.get_queries(), k)
        return gt

    def database_iterator(self, bs=128, split=(1, 0)):
        """Yield database blocks of ``bs`` rows; ``split=(nsplit, rank)``
        restricts to this rank's contiguous shard (contrib/datasets.py:46)."""
        xb = self.get_database()
        nsplit, rank = split
        i0 = self.nb * rank // nsplit
        i1 = self.nb * (rank + 1) // nsplit
        for j0 in range(i0, i1, bs):
            yield sanitize(xb[j0 : min(j0 + bs, i1)])

    def check_sizes(self):
        """Sanity-check declared sizes against the on-disk files
        (contrib/datasets.py:74)."""
        assert self.get_queries().shape == (self.nq, self.d)
        if self.nb <= 10**7:
            assert self.get_database().shape == (self.nb, self.d)
        gt = self.get_groundtruth(k=10)
        assert gt.shape[0] == self.nq
        return True

    def __str__(self):
        return "dataset in dimension %d, with %d vectors, %d queries, %d train" % (
            self.d, self.nb, self.nq, self.nt,
        )


class SyntheticDataset(Dataset):
    """Gaussian-mixture synthetic data (contrib/datasets.py:84).

    d dims, nt train / nb database / nq query points drawn from a mixture of
    1024-ish clusters with decaying per-dimension scales, seeded — matches the
    reference construction closely enough for threshold parity tests.
    """

    def __init__(self, d, nt, nb, nq, metric="L2", seed=1338, *, device="cuda"):
        from ..base import require_device
        from ..metric import MetricType

        self.d, self.nt, self.nb, self.nq = d, nt, nb, nq
        self.device = require_device(device)
        self.metric = (
            MetricType.L2 if str(metric).upper() in ("L2", "METRICTYPE.L2") else MetricType.INNER_PRODUCT
        )
        rs = np.random.RandomState(seed)
        n = nb + nt + nq
        n_centroids = 10 * int(np.sqrt(max(nb, 1))) or 1
        centroids = rs.rand(n_centroids, d).astype(np.float32)
        scales = (1.0 / (np.arange(d) + 1.0)).astype(np.float32)
        assign = rs.randint(n_centroids, size=n)
        x = centroids[assign] + (rs.randn(n, d).astype(np.float32) * 0.03 * scales)
        self._xt = x[:nt]
        self._xb = x[nt : nt + nb]
        self._xq = x[nt + nb :]

    def get_train(self, maxtrain=None):
        if maxtrain is None:
            return self._xt
        return self._xt[:maxtrain]

    def get_database(self):
        return self._xb

    def get_queries(self):
        return self._xq


# --- real-dataset loaders (contrib/datasets.py:155-280) ---------------------
#
# Standard ANN benchmark layouts on local disk. No downloads happen here;
# point FAISS_TPU_DATA (or set_dataset_basedir) at a directory holding the
# usual sift1M/ bigann/ deep1b/ gist1M/ subtrees.

import os as _os



def _dirname(path):
    return path if path.endswith("/") else path + "/"


# FAISS_TPU_DATA, the variable faiss_tpu reads, with its trailing slash
# (faiss_tpu keeps the variable's value as it is, and a value without one
# joins the subdirectory's name onto the last component)
dataset_basedir = _dirname(_os.environ.get("FAISS_TPU_DATA", "data/"))


def set_dataset_basedir(path):
    """Override the root directory real datasets load from."""
    global dataset_basedir
    dataset_basedir = _dirname(path)


def _narrow(gt, k):
    """The first ``k`` ground-truth neighbours; a file holding fewer than
    ``k`` raises (faiss_tpu narrows to what there is)."""
    if k is None:
        return gt
    if k > gt.shape[1]:
        raise ValueError(f"the ground truth holds {gt.shape[1]} neighbours "
                         f"per query, {k} asked")
    return gt[:, :k]


def sanitize(x):
    """Contiguous float32 view of any vector block (contrib/datasets.py:184)."""
    return np.ascontiguousarray(x, dtype="float32")


class DatasetSIFT1M(Dataset):
    """ANN_SIFT1M (corpus-texmex.irisa.fr) from ``<basedir>/sift1M/``
    (contrib/datasets.py:155)."""

    def __init__(self, basedir=None):
        self.d, self.nt, self.nb, self.nq = 128, 100_000, 1_000_000, 10_000
        self.basedir = (basedir or dataset_basedir + "sift1M/")

    def get_queries(self):
        return fvecs_read(self.basedir + "sift_query.fvecs")

    def get_train(self, maxtrain=None):
        xt = fvecs_read(self.basedir + "sift_learn.fvecs")
        return xt if maxtrain is None else xt[:maxtrain]

    def get_database(self):
        return fvecs_read(self.basedir + "sift_base.fvecs")

    def get_groundtruth(self, k=None):
        gt = ivecs_read(self.basedir + "sift_groundtruth.ivecs")
        return _narrow(gt, k)


class DatasetGIST1M(Dataset):
    """ANN_GIST1M from ``<basedir>/gist1M/`` (contrib/datasets.py:351)."""

    def __init__(self, basedir=None):
        self.d, self.nt, self.nb, self.nq = 960, 500_000, 1_000_000, 1_000
        self.basedir = (basedir or dataset_basedir + "gist1M/")

    def get_queries(self):
        return fvecs_read(self.basedir + "gist_query.fvecs")

    def get_train(self, maxtrain=None):
        xt = fvecs_read(self.basedir + "gist_learn.fvecs")
        return xt if maxtrain is None else xt[:maxtrain]

    def get_database(self):
        return fvecs_read(self.basedir + "gist_base.fvecs")

    def get_groundtruth(self, k=None):
        gt = ivecs_read(self.basedir + "gist_groundtruth.ivecs")
        return _narrow(gt, k)


class DatasetBigANN(Dataset):
    """ANN_SIFT1B uint8 vectors from ``<basedir>/bigann/``; ``nb_M`` picks
    the 1M..1000M prefix with its matching ground truth
    (contrib/datasets.py:188)."""

    _SIZES = (1, 2, 5, 10, 20, 50, 100, 200, 500, 1000)

    def __init__(self, nb_M=1000, basedir=None):
        assert nb_M in self._SIZES, f"nb_M must be one of {self._SIZES}"
        self.nb_M = nb_M
        self.d, self.nt, self.nb, self.nq = 128, 10**8, nb_M * 10**6, 10_000
        self.basedir = (basedir or dataset_basedir + "bigann/")

    def get_queries(self):
        return sanitize(bvecs_mmap(self.basedir + "bigann_query.bvecs")[:])

    def get_train(self, maxtrain=None):
        mt = self.nt if maxtrain is None else maxtrain
        return sanitize(bvecs_mmap(self.basedir + "bigann_learn.bvecs")[:mt])

    def get_groundtruth(self, k=None):
        gt = ivecs_read(self.basedir + "gnd/idx_%dM.ivecs" % self.nb_M)
        return _narrow(gt, k)

    def get_database(self):
        assert self.nb_M < 100, "dataset too large, use database_iterator"
        return sanitize(bvecs_mmap(self.basedir + "bigann_base.bvecs")[: self.nb])

    def database_iterator(self, bs=128, split=(1, 0)):
        xb = bvecs_mmap(self.basedir + "bigann_base.bvecs")
        nsplit, rank = split
        i0 = self.nb * rank // nsplit
        i1 = self.nb * (rank + 1) // nsplit
        for j0 in range(i0, i1, bs):
            yield sanitize(xb[j0 : min(j0 + bs, i1)])


class DatasetDeep1B(Dataset):
    """Yandex Deep1B from ``<basedir>/deep1b/``; ``nb`` picks the
    100k..1B prefix (contrib/datasets.py:232)."""

    _NAMES = {10**5: "100k", 10**6: "1M", 10**7: "10M",
              10**8: "100M", 10**9: "1B"}

    def __init__(self, nb=10**9, basedir=None):
        assert nb in self._NAMES, f"nb must be one of {sorted(self._NAMES)}"
        self.d, self.nt, self.nb, self.nq = 96, 358_480_000, nb, 10_000
        self.basedir = (basedir or dataset_basedir + "deep1b/")
        self.gt_fname = "%sdeep%s_groundtruth.ivecs" % (
            self.basedir, self._NAMES[nb],
        )

    def get_queries(self):
        return sanitize(fvecs_read(self.basedir + "deep1B_queries.fvecs"))

    def get_train(self, maxtrain=None):
        mt = self.nt if maxtrain is None else maxtrain
        return sanitize(fvecs_mmap(self.basedir + "learn.fvecs")[:mt])

    def get_groundtruth(self, k=None):
        gt = ivecs_read(self.gt_fname)
        return _narrow(gt, k)

    def get_database(self):
        assert self.nb <= 10**8, "dataset too large, use database_iterator"
        return sanitize(fvecs_mmap(self.basedir + "base.fvecs")[: self.nb])

    def database_iterator(self, bs=128, split=(1, 0)):
        xb = fvecs_mmap(self.basedir + "base.fvecs")
        nsplit, rank = split
        i0 = self.nb * rank // nsplit
        i1 = self.nb * (rank + 1) // nsplit
        for j0 in range(i0, i1, bs):
            yield sanitize(xb[j0 : min(j0 + bs, i1)])


# --- fvecs/ivecs/bvecs IO (contrib/vecs_io.py) ------------------------------


def ivecs_read(fname: str) -> np.ndarray:
    a = np.fromfile(fname, dtype="int32")
    if a.size == 0:
        return np.empty((0, 0), dtype="int32")
    d = a[0]
    return a.reshape(-1, d + 1)[:, 1:].copy()


def fvecs_read(fname: str) -> np.ndarray:
    return ivecs_read(fname).view("float32")


def bvecs_mmap(fname: str) -> np.ndarray:
    x = np.memmap(fname, dtype="uint8", mode="r")
    d = x[:4].view("int32")[0]
    return x.reshape(-1, d + 4)[:, 4:]


def fvecs_mmap(fname: str) -> np.ndarray:
    x = np.memmap(fname, dtype="int32", mode="r")
    d = x[0]
    return x.reshape(-1, d + 1)[:, 1:].view("float32")


def ivecs_write(fname: str, m: np.ndarray) -> None:
    m = np.ascontiguousarray(m, dtype="int32")
    n, d = m.shape
    m1 = np.empty((n, d + 1), dtype="int32")
    m1[:, 0] = d
    m1[:, 1:] = m
    m1.tofile(fname)


def fvecs_write(fname: str, m: np.ndarray) -> None:
    ivecs_write(fname, np.ascontiguousarray(m, dtype="float32").view("int32"))
