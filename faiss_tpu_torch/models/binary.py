"""Binary indexes (counterpart of faiss_tpu/models/binary.py; reference:
faiss/IndexBinary*.{h,cpp}).

IndexBinary: d is in bits, codes are uint8 [n, d / 8], distances int32
Hamming (IndexBinary.h:29). IndexBinaryFlat keeps its codes on the device
and searches them with ops/hamming.hamming_knn; IndexBinaryIVF keeps host
lists and scans each query's probed lists on the device, probe by probe,
over a padded layout of int32 words; IndexBinaryFromFloat wraps a float
index of the port over the 0/1 unpacked bits; IndexBinaryHash and
IndexBinaryMultiHash keep their buckets on the host (a CSR over the sorted
keys) and count the candidates' bits there, as faiss_tpu and faiss do;
IndexBinaryHNSW walks an HNSW graph of the port over the unpacked bits on
the host."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..base import Index, range_result, require_device
from ..metric import MetricType
from ..ops import hamming as hops
from ..ops.ivf_ops import SCAN_GATHER_BYTES
from ..ops.topk import merge_topk

_MISSING = hops.HAMMING_MISSING
# set bits of every byte value
_POPCOUNT8 = np.unpackbits(np.arange(256, dtype=np.uint8)[:, None], axis=1).sum(1)


def _missing(nq: int, k: int):
    return (np.full((nq, k), _MISSING, np.int32), np.full((nq, k), -1, np.int64))


class IndexBinary:
    """Base binary index (reference: IndexBinary.h:29)."""

    def __init__(self, d: int, *, device="cuda"):
        if d % 8:
            raise ValueError("binary dimension must be a multiple of 8")
        self.d = int(d)
        self.code_size = d // 8
        self.device = require_device(device)
        self.ntotal = 0
        self.is_trained = True
        self.verbose = False
        self.metric_type = MetricType.L2  # Hamming, kept for API parity

    def _check(self, x) -> np.ndarray:
        x = np.ascontiguousarray(x, np.uint8)
        if x.ndim != 2 or x.shape[1] != self.code_size:
            raise ValueError(f"expected [n, {self.code_size}] uint8 codes")
        return x

    def _to_device(self, x) -> torch.Tensor:
        return torch.from_numpy(self._check(x)).to(self.device)

    def train(self, x) -> None:
        del x

    def add(self, x) -> None:
        raise NotImplementedError

    def search(self, x, k):
        raise NotImplementedError

    def reset(self) -> None:
        raise NotImplementedError

    def reconstruct(self, key: int) -> np.ndarray:
        raise NotImplementedError


class IndexBinaryFlat(IndexBinary):
    """Exhaustive Hamming search (reference: IndexBinaryFlat.h:22)."""

    # rows of one range_search tile
    RANGE_TILE_ROWS = 1 << 16

    def __init__(self, d: int, *, device="cuda"):
        super().__init__(d, device=device)
        self._xb = torch.zeros(0, self.code_size, dtype=torch.uint8,
                               device=self.device)

    @property
    def xb(self) -> np.ndarray:
        """The stored codes [ntotal, d / 8] (faiss_tpu's ``xb``)."""
        return self._xb.cpu().numpy()

    def add(self, x) -> None:
        self._xb = torch.cat([self._xb, self._to_device(x)])
        self.ntotal = len(self._xb)

    def search(self, x, k: int):
        x = self._check(x)
        if self.ntotal == 0:
            return _missing(len(x), k)
        D, I = hops.hamming_knn(self._to_device(x), self._xb, k)
        return D.cpu().numpy(), I.cpu().numpy()

    def range_search(self, x, radius: int):
        """Every code at Hamming distance below ``radius`` (faiss_tpu :75),
        counted in tiles on the device; a query's hits in ascending id
        order, distances int32."""
        x = self._check(x)
        parts = []
        if self.ntotal and len(x):
            qw = hops.to_words(self._to_device(x))
            for c0 in range(0, self.ntotal, self.RANGE_TILE_ROWS):
                dt = hops.hamming_words(
                    qw, hops.to_words(self._xb[c0 : c0 + self.RANGE_TILE_ROWS]))
                qi, ci = torch.nonzero(dt < radius, as_tuple=True)
                parts.append((qi.cpu().numpy(), dt[qi, ci].cpu().numpy(),
                              (ci + c0).cpu().numpy()))
        res = range_result(parts, len(x))
        res.distances = res.distances.astype(np.int32)  # exact: counts <= d
        return res

    def reconstruct(self, key: int) -> np.ndarray:
        return self._xb[key].cpu().numpy()

    def reset(self) -> None:
        self._xb = self._xb[:0]
        self.ntotal = 0


class IndexBinaryFlat1Bit(IndexBinaryFlat):
    pass


class IndexBinaryIVF(IndexBinary):
    """IVF over binary codes (reference: IndexBinaryIVF.h:33; faiss_tpu
    :101). The coarse quantizer is an IndexBinaryFlat of centroid codes;
    training runs the port's float k-means on the unpacked bits (10
    iterations) and binarizes the centroids at 0.5. ``search`` scans each
    query's ``nprobe`` nearest lists on the device; the candidates are
    faiss_tpu's (every code of the probed lists), the order among equal
    distances the select's."""

    def __init__(self, quantizer: Optional[IndexBinaryFlat], d: int, nlist: int,
                 *, device="cuda"):
        super().__init__(d, device=device)
        self.nlist = int(nlist)
        self.quantizer = quantizer or IndexBinaryFlat(d, device=self.device)
        self.nprobe = 1
        self.is_trained = self.quantizer.ntotal == self.nlist
        self._codes = np.empty((0, self.code_size), np.uint8)
        self._listnos = np.empty(0, np.int32)
        self._ids = np.empty(0, np.int64)
        self._layout = None  # the padded per-probe layout, built at first use

    def train(self, x) -> None:
        from ..clustering import Clustering, ClusteringParameters

        x = self._check(x)
        xf = np.unpackbits(x, axis=1, bitorder="little").astype(np.float32)
        clus = Clustering(self.d, self.nlist, ClusteringParameters(niter=10),
                          device=self.device)
        clus.train(xf)
        self.quantizer.reset()
        self.quantizer.add(hops.pack_bits(clus.centroids - 0.5))
        self.is_trained = True

    def add(self, x) -> None:
        self.add_with_ids(x, None)

    def add_with_ids(self, x, ids) -> None:
        x = self._check(x)
        _, assign = self.quantizer.search(x, 1)
        if ids is None:
            ids = np.arange(self.ntotal, self.ntotal + len(x), dtype=np.int64)
        self.add_encoded(x, assign.ravel(), ids)

    def add_encoded(self, codes, listnos, ids) -> None:
        """Append codes with their list numbers and ids."""
        self._codes = np.concatenate([self._codes, self._check(codes)])
        self._listnos = np.concatenate(
            [self._listnos, np.asarray(listnos, np.int32).ravel()])
        self._ids = np.concatenate([self._ids, np.asarray(ids, np.int64).ravel()])
        self.ntotal = len(self._ids)
        self._layout = None

    def _build_layout(self):
        """Per list its slots in add order and their int32 words, padded to
        the longest list: words [nlist, max_len, w], slots [nlist, max_len]
        (-1 on pads)."""
        if self._layout is not None:
            return self._layout
        n, dev = self.ntotal, self.device
        lengths = np.bincount(self._listnos, minlength=self.nlist)
        max_len = max(1, int(lengths.max()) if n else 1)
        order = np.argsort(self._listnos, kind="stable")
        ln = self._listnos[order].astype(np.int64)
        offsets = np.concatenate([[0], np.cumsum(lengths)[:-1]])
        slots = np.full((self.nlist, max_len), -1, np.int64)
        slots[ln, np.arange(n) - offsets[ln]] = order
        sd = torch.from_numpy(slots).to(dev)
        words = hops.to_words(torch.from_numpy(self._codes).to(dev)) if n else \
            torch.zeros(1, (self.code_size + 3) // 4, dtype=torch.int32, device=dev)
        self._layout = (torch.where((sd >= 0)[..., None], words[sd.clamp_min(0)], 0), sd)
        return self._layout

    def search(self, x, k: int):
        x = self._check(x)
        nq = len(x)
        if self.ntotal == 0 or nq == 0:
            return _missing(nq, k)
        nprobe = min(self.nprobe, self.nlist)
        _, probes = self.quantizer.search(x, nprobe)
        words, slots = self._build_layout()
        qw_all = hops.to_words(self._to_device(x))
        pr_all = torch.from_numpy(probes).to(self.device)
        max_len, w = words.shape[1], words.shape[2]
        rows = max(1, SCAN_GATHER_BYTES // (max_len * w * 4))
        D, S = [], []
        for r in range(0, nq, rows):
            qw, pr = qw_all[r : r + rows], pr_all[r : r + rows]
            vals = torch.full((len(qw), k), _MISSING, dtype=torch.int32,
                              device=self.device)
            sl = torch.full((len(qw), k), -1, dtype=torch.int64, device=self.device)
            for p in range(nprobe):
                ln = pr[:, p]
                safe = ln.clamp_min(0)
                cs = torch.where((ln >= 0)[:, None], slots[safe], -1)
                d = hops.popcount32(qw[:, None, :] ^ words[safe]).sum(
                    -1, dtype=torch.int32)
                d = torch.where(cs >= 0, d, _MISSING)
                vals, sl = merge_topk(vals, sl, d, cs, k, largest=False)
            D.append(vals.cpu().numpy())
            S.append(sl.cpu().numpy())
        D, S = np.concatenate(D), np.concatenate(S)
        I = np.where(S >= 0, self._ids[np.maximum(S, 0)], -1)
        return D, I

    def reconstruct(self, key: int) -> np.ndarray:
        pos = np.nonzero(self._ids == key)[0]
        if len(pos) == 0:
            raise KeyError(key)
        return self._codes[pos[0]].copy()

    def reset(self) -> None:
        self._codes = np.empty((0, self.code_size), np.uint8)
        self._listnos = np.empty(0, np.int32)
        self._ids = np.empty(0, np.int64)
        self.ntotal = 0
        self._layout = None


class IndexBinaryFromFloat(IndexBinary):
    """A float index of the port over the 0/1 unpacked bits
    (IndexBinaryFromFloat.h): squared L2 between 0/1 vectors is the
    Hamming distance."""

    def __init__(self, index: Index):
        super().__init__(index.d, device=index.device)
        self.index = index
        self.is_trained = index.is_trained

    def _to_float(self, x):
        return np.unpackbits(self._check(x), axis=1, bitorder="little").astype(
            np.float32)

    def train(self, x) -> None:
        self.index.train(self._to_float(x))
        self.is_trained = True

    def add(self, x) -> None:
        self.index.add(self._to_float(x))
        self.ntotal = self.index.ntotal

    def search(self, x, k: int):
        D, I = self.index.search(self._to_float(x), k)
        return np.round(D).astype(np.int32), I

    def reset(self) -> None:
        self.index.reset()
        self.ntotal = 0


class IndexBinaryHash(IndexBinary):
    """Buckets keyed by the first ``b`` bits (reference:
    IndexBinaryHash.h:26; faiss_tpu :206), probed within Hamming radius
    ``nflip`` of the query's key. The buckets are a CSR over the keys
    sorted stably, so a bucket lists its codes in add order and each
    query's candidates come in faiss_tpu's order."""

    def __init__(self, d: int, b: int, *, device="cuda"):
        super().__init__(d, device=device)
        self.b = int(b)
        self.nflip = 0
        self._codes = np.empty((0, self.code_size), np.uint8)
        self._ids = np.empty(0, np.int64)
        self._csr = None

    def _keys(self, codes: np.ndarray, h: int = 0) -> np.ndarray:
        """The integer of bits [h * b, (h + 1) * b) of each code."""
        bits = np.unpackbits(codes, axis=1, bitorder="little")[
            :, h * self.b : (h + 1) * self.b]
        return bits.astype(np.int64) @ (1 << np.arange(bits.shape[1], dtype=np.int64))

    def add(self, x) -> None:
        x = self._check(x)
        base = self.ntotal
        self._codes = np.concatenate([self._codes, x])
        self._ids = np.concatenate(
            [self._ids, np.arange(base, base + len(x), dtype=np.int64)])
        self.ntotal += len(x)
        self._csr = None

    @staticmethod
    def _bucket_csr(keys: np.ndarray):
        """(unique keys, starts, ends, members) of the stable key order."""
        order = np.argsort(keys, kind="stable")
        uniq, starts, counts = np.unique(keys[order], return_index=True,
                                         return_counts=True)
        return uniq, starts, starts + counts, order

    def _tables(self):
        if self._csr is None:
            self._csr = [self._bucket_csr(self._keys(self._codes))]
        return self._csr

    def _probe_keys(self, key: int):
        keys = [key]
        if self.nflip >= 1:
            keys += [key ^ (1 << i) for i in range(self.b)]
        if self.nflip >= 2:
            keys += [key ^ (1 << i) ^ (1 << j)
                     for i in range(self.b) for j in range(i + 1, self.b)]
        return keys

    @staticmethod
    def _members(table, keys) -> np.ndarray:
        uniq, starts, ends, order = table
        keys = np.asarray(keys, np.int64)
        pos = np.clip(np.searchsorted(uniq, keys), 0, max(len(uniq) - 1, 0))
        hit = (uniq[pos] == keys) if len(uniq) else np.zeros(len(keys), bool)
        return np.concatenate([order[starts[p] : ends[p]] for p in pos[hit]]
                              or [np.empty(0, np.int64)])

    def _candidates(self, xq_row: np.ndarray) -> np.ndarray:
        table = self._tables()[0]
        return self._members(table, self._probe_keys(int(self._keys(xq_row[None])[0])))

    def search(self, x, k: int):
        x = self._check(x)
        D, I = _missing(len(x), k)
        for q in range(len(x)):
            cand = self._candidates(x[q])
            if not len(cand):
                continue
            d = _POPCOUNT8[x[q][None] ^ self._codes[cand]].sum(1)
            order = np.argsort(d, kind="stable")[:k]
            D[q, : len(order)] = d[order]
            I[q, : len(order)] = self._ids[cand[order]]
        return D, I

    def reset(self) -> None:
        self._codes = np.empty((0, self.code_size), np.uint8)
        self._ids = np.empty(0, np.int64)
        self.ntotal = 0
        self._csr = None


class IndexBinaryMultiHash(IndexBinaryHash):
    """``nhash`` tables on disjoint ``b``-bit ranges (IndexBinaryHash.h:77;
    faiss_tpu :275): a query's candidates are the sorted union of its
    buckets in every table."""

    def __init__(self, d: int, nhash: int, b: int, *, device="cuda"):
        super().__init__(d, b, device=device)
        self.nhash = int(nhash)

    def _tables(self):
        if self._csr is None:
            self._csr = [self._bucket_csr(self._keys(self._codes, h))
                         for h in range(self.nhash)]
        return self._csr

    def _candidates(self, xq_row: np.ndarray) -> np.ndarray:
        tables = self._tables()
        return np.unique(np.concatenate([
            self._members(tables[h], [int(self._keys(xq_row[None], h)[0])])
            for h in range(self.nhash)]))


class IndexBinaryHNSW(IndexBinary):
    """HNSW over binary codes (reference: IndexBinaryHNSW.h:21; faiss_tpu
    binary.py:329): the bits unpack to 0/1 floats, whose squared L2 is the
    Hamming distance, and an IndexHNSWFlat of the port builds and walks the
    graph over them on the host; distances come back rounded to int32."""

    def __init__(self, d: int, M: int = 16, *, device="cuda"):
        super().__init__(d, device=device)
        from .hnsw import IndexHNSWFlat

        self._impl = IndexHNSWFlat(d, M, device=self.device)
        self.hnsw = self._impl.hnsw
        self._codes = np.empty((0, self.code_size), np.uint8)

    def _to_float(self, x):
        return np.unpackbits(self._check(x), axis=1,
                             bitorder="little").astype(np.float32)

    def add(self, x) -> None:
        x = self._check(x)
        self._impl.add(self._to_float(x))
        self._codes = np.concatenate([self._codes, x])
        self.ntotal = self._impl.ntotal

    def search(self, x, k: int):
        D, I = self._impl.search(self._to_float(x), k)
        return np.round(D).astype(np.int32), I

    def reconstruct(self, key: int) -> np.ndarray:
        return self._codes[key].copy()

    def reset(self) -> None:
        self._impl.reset()
        self._codes = self._codes[:0]
        self.ntotal = 0
