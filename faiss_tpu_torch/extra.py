"""Standalone numpy-facing ops (counterpart of faiss_tpu/extra.py; the
reference's faiss/python/extra_wrappers.py).

``knn``, ``pairwise_distances`` and ``knn_hamming`` compute on an explicit
``device`` (the card unless the caller passes another) through the port's
plain PyTorch distances (ops/distances.py, ops/hamming.py): faiss_tpu's are
XLA products outside any Pallas kernel. The rest (k-selection of host
tables, result merges, bucket sorts, the diversity filter, bitstring
packing, seeded random arrays) works on host arrays in numpy and returns
what faiss_tpu returns, ties broken alike (the lower position first)."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .base import require_device
from .metric import MetricType
from .ops import distances as dops
from .ops import hamming as hops


def knn(xq, xb, k: int, metric=MetricType.L2, metric_arg: float = 0.0, *,
        device="cuda") -> Tuple[np.ndarray, np.ndarray]:
    """Brute-force k-NN on ``device`` (extra_wrappers.py:363; faiss_tpu
    extra.py:21). Returns (D float32 [nq, k], I int64 [nq, k])."""
    dev = require_device(device)
    xq = torch.from_numpy(np.ascontiguousarray(xq, np.float32)).to(dev)
    xb = torch.from_numpy(np.ascontiguousarray(xb, np.float32)).to(dev)
    D, I = dops.knn(xq, xb, k, metric=MetricType(metric), metric_arg=metric_arg)
    return D.cpu().numpy(), I.cpu().numpy().astype(np.int64)


def knn_hamming(xq, xb, k: int, *, device="cuda") -> Tuple[np.ndarray, np.ndarray]:
    """Hamming k-NN of packed uint8 codes (extra_wrappers.py:422)."""
    return hops.hamming_knn_host(np.ascontiguousarray(xq, np.uint8),
                                 np.ascontiguousarray(xb, np.uint8), k,
                                 device=require_device(device))


def pairwise_distances(xq, xb, metric=MetricType.L2, metric_arg: float = 0.0, *,
                       device="cuda") -> np.ndarray:
    """The full [nq, nb] distance matrix (extra_wrappers.py:61)."""
    dev = require_device(device)
    return dops.pairwise_distances(
        torch.from_numpy(np.ascontiguousarray(xq, np.float32)).to(dev),
        torch.from_numpy(np.ascontiguousarray(xb, np.float32)).to(dev),
        MetricType(metric), metric_arg,
    ).cpu().numpy()


def pairwise_distance_gpu(*a, **kw):  # API parity with gpu_wrappers
    return pairwise_distances(*a, **kw)


knn_gpu = knn  # API parity: the work runs on ``device`` either way


def _kselect(D, k: int, largest: bool):
    """Row-wise best k of a host table, best first, the lower column first
    among equal values (faiss_tpu's top-k order)."""
    D = np.ascontiguousarray(D, np.float32)
    order = np.argsort(-D if largest else D, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(D, order, axis=1), order.astype(np.int64)


def kmin(D, k: int) -> Tuple[np.ndarray, np.ndarray]:
    """Row-wise k smallest (extra_wrappers.py:25)."""
    return _kselect(D, k, largest=False)


def kmax(D, k: int) -> Tuple[np.ndarray, np.ndarray]:
    return _kselect(D, k, largest=True)


def merge_knn_results(Dall, Iall, keep_max: bool = False):
    """Merge [nshard, nq, k] result tables (extra_wrappers.py:294): the best
    k of each row's nshard * k candidates, the earlier shard first among
    equal distances."""
    Dall = np.ascontiguousarray(Dall, np.float32)
    Iall = np.ascontiguousarray(Iall, np.int64)
    nshard, nq, k = Dall.shape
    flatD = np.moveaxis(Dall, 0, 1).reshape(nq, nshard * k)
    flatI = np.moveaxis(Iall, 0, 1).reshape(nq, nshard * k)
    v, p = _kselect(flatD, k, largest=keep_max)
    return v, np.take_along_axis(flatI, p, axis=1)


def diversity_select(D, I, id_to_group, k: int, max_per_group: int):
    """Group-capped top-k from sorted candidate lists (faiss_tpu extra.py:85;
    demos/diversity_filter/diversity_result_handler.h:21): keep the best
    ``k`` results per query with at most ``max_per_group`` from any group.

    ``D``/``I`` are distance-sorted candidate tables [nq, kc] (kc >= k);
    ``id_to_group`` maps database ids to int group labels. A missing
    candidate (id -1) belongs to no group: each one is a run of its own, so
    it never counts against a real group, whatever its label (faiss_tpu
    files missing candidates under group -1, where they count against a
    real group -1).

    Returns (D_out [nq, k], I_out [nq, k], n_valid [nq]); unfilled slots
    hold inf/-1."""
    D = np.ascontiguousarray(D, np.float32)
    I = np.ascontiguousarray(I, np.int64)
    nq, kc = I.shape
    id_to_group = np.asarray(id_to_group)
    valid = I >= 0
    pos = np.broadcast_to(np.arange(kc), (nq, kc))
    none = np.iinfo(np.int64).min + pos  # one label per missing candidate
    g = np.where(valid, id_to_group[np.maximum(I, 0)].astype(np.int64), none)
    # per-row running count of each group along the sorted order:
    # stable-sort columns by group, cumcount within runs, scatter back
    ordg = np.argsort(g, axis=1, kind="stable")
    gs = np.take_along_axis(g, ordg, axis=1)
    run_start = np.where(
        np.concatenate([np.ones((nq, 1), bool), gs[:, 1:] != gs[:, :-1]], axis=1),
        pos, 0,
    )
    run_start = np.maximum.accumulate(run_start, axis=1)
    cumcount = np.empty((nq, kc), np.int64)
    np.put_along_axis(cumcount, ordg, pos - run_start, axis=1)
    keep = (cumcount < max_per_group) & valid
    rank = np.cumsum(keep, axis=1) - 1
    take = keep & (rank < k)
    D_out = np.full((nq, k), np.inf, np.float32)
    I_out = np.full((nq, k), -1, np.int64)
    r, c = np.nonzero(take)
    D_out[r, rank[r, c]] = D[r, c]
    I_out[r, rank[r, c]] = I[r, c]
    return D_out, I_out, np.minimum(np.sum(keep, axis=1), k)


def diversity_search(index, xq, k: int, id_to_group, max_per_group: int,
                     fetch_factor: int = 4):
    """Exact group-capped search (faiss_tpu extra.py:134): over-fetch
    ``fetch_factor * k`` candidates from ``index`` and apply
    :func:`diversity_select`, doubling the over-fetch for any query that
    could not fill k slots until it can or the whole database is ranked.
    The searches run on the index's device."""
    xq = np.ascontiguousarray(xq, np.float32)
    kc = min(max(k, fetch_factor * k), max(index.ntotal, 1))
    D, I = index.search(xq, kc)
    D_out, I_out, n_valid = diversity_select(D, I, id_to_group, k, max_per_group)
    while kc < index.ntotal:
        short = np.nonzero(n_valid < k)[0]
        if len(short) == 0:
            break
        kc = min(kc * 2, index.ntotal)
        Ds, Is = index.search(xq[short], kc)
        Do, Io, nv = diversity_select(Ds, Is, id_to_group, k, max_per_group)
        D_out[short], I_out[short], n_valid[short] = Do, Io, nv
    return D_out, I_out


def bucket_sort(tab, nbucket: Optional[int] = None, nt: int = 0):
    """Counting sort: returns (lims, perm) (extra_wrappers.py:154)."""
    tab = np.asarray(tab).ravel()
    if nbucket is None:
        nbucket = int(tab.max()) + 1 if len(tab) else 0
    lims = np.zeros(nbucket + 1, np.int64)
    np.add.at(lims[1:], tab, 1)
    np.cumsum(lims, out=lims)
    perm = np.argsort(tab, kind="stable").astype(np.int64)
    return lims, perm


def matrix_bucket_sort_inplace(tab, nbucket: Optional[int] = None, nt: int = 0):
    """Row-id bucket sort (extra_wrappers.py matrix_bucket_sort_inplace):
    returns lims; ``tab`` is overwritten with row indices grouped by
    value."""
    tab = np.asarray(tab)
    nrow, ncol = tab.shape
    vals = tab.ravel()
    if nbucket is None:
        nbucket = int(vals.max()) + 1
    order = np.argsort(vals, kind="stable")
    rows = (order // ncol).astype(tab.dtype)
    lims = np.zeros(nbucket + 1, np.int64)
    np.add.at(lims[1:], vals, 1)
    np.cumsum(lims, out=lims)
    tab.ravel()[:] = rows
    return lims


class ResultHeap:
    """Accumulate k-NN results over database chunks
    (extra_wrappers.py:231)."""

    def __init__(self, nq: int, k: int, keep_max: bool = False):
        self.nq, self.k, self.keep_max = nq, k, keep_max
        fill = -np.inf if keep_max else np.inf
        self.D = np.full((nq, k), fill, np.float32)
        self.I = np.full((nq, k), -1, np.int64)

    def add_result(self, D, I) -> None:
        Dc = np.concatenate([self.D, D.astype(np.float32)], axis=1)
        Ic = np.concatenate([self.I, I.astype(np.int64)], axis=1)
        order = np.argsort(-Dc if self.keep_max else Dc, axis=1, kind="stable")
        order = order[:, : self.k]
        self.D = np.take_along_axis(Dc, order, axis=1)
        self.I = np.take_along_axis(Ic, order, axis=1)

    def finalize(self) -> None:
        pass  # results kept sorted incrementally


def pack_bitstrings(a, nbit: int) -> np.ndarray:
    """[n, M] ints -> packed bitstrings, LSB first (extra_wrappers.py:715)."""
    a = np.ascontiguousarray(a, np.uint64)
    n, M = a.shape
    out = np.zeros((n, (M * nbit + 7) // 8), np.uint8)
    bit = 0
    for m in range(M):
        for b in range(nbit):
            byte, off = divmod(bit, 8)
            out[:, byte] |= (((a[:, m] >> np.uint64(b)) & np.uint64(1))
                             << np.uint64(off)).astype(np.uint8)
            bit += 1
    return out


def unpack_bitstrings(codes, M: int, nbit: int) -> np.ndarray:
    codes = np.ascontiguousarray(codes, np.uint8)
    out = np.zeros((len(codes), M), np.uint64)
    bit = 0
    for m in range(M):
        for b in range(nbit):
            byte, off = divmod(bit, 8)
            out[:, m] |= ((codes[:, byte] >> off) & 1).astype(np.uint64) << np.uint64(b)
            bit += 1
    return out


def rand(n, seed: int = 12345) -> np.ndarray:
    return np.random.RandomState(seed).rand(n).astype(np.float32)


def randn(n, seed: int = 12345) -> np.ndarray:
    return np.random.RandomState(seed).randn(n).astype(np.float32)


def randint(n, seed: int = 12345, vmax: int = 2**31 - 1) -> np.ndarray:
    return np.random.RandomState(seed).randint(vmax, size=n).astype(np.int64)
