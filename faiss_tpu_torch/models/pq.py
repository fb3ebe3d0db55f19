"""IndexPQ and IndexPQFastScan, the flat product-quantizer indexes
(counterpart of faiss_tpu/models/pq.py; reference: faiss/IndexPQ.{h,cpp},
faiss/IndexPQFastScan.h).

The unpacked codes [ntotal, M] live on the device (uint8, int32 above 8
bits); a search builds its tables there and runs ops/pq_ops: the ADC scan
(``ST_PQ``: at ksub <= 16 the bf16 LUTs against a one-hot of the codes, the
FastScan arithmetic; above, float32 table gathers), the same scan over
rows of the symmetric table (``ST_SDC``) or the Hamming-filtered scan
(``ST_polysemous``). No kernel: faiss_tpu runs these through XLA."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..base import (Index, add_page_rows, query_buckets, range_result,
                    require_device, sel_mask)
from ..codecs.pq import ProductQuantizer, codes_numpy, codes_tensor
from ..metric import MetricType, is_similarity_metric
from ..ops import distances as dops
from ..ops import pq_ops


class IndexPQ(Index):
    """reference: faiss/IndexPQ.h:24 (faiss_tpu models/pq.py:24)."""

    # search_type values (IndexPQ.h:56)
    ST_PQ = 0
    ST_SDC = 1
    ST_polysemous = 2
    # rows of one decode tile of range_search
    RANGE_TILE_ROWS = 1 << 16

    def __init__(self, d: int, M: int, nbits: int = 8, metric=MetricType.L2,
                 *, device="cuda"):
        super().__init__(d, metric, device=require_device(device))
        self.pq = ProductQuantizer(d, M, nbits, device=self.device)
        self.is_trained = False
        self.do_polysemous_training = False
        self.polysemous_training = None  # a PolysemousTraining
        self.polysemous_ht = 0  # Hamming threshold (0 = M * nbits / 2)
        self.search_type = self.ST_PQ
        self.code_size = self.pq.code_size
        self._codes: Optional[torch.Tensor] = None  # [ntotal, M] on the device
        self._sdc = None  # the symmetric table [M, ksub, ksub] on the device

    def train(self, x) -> None:
        x = self._check_input(x)
        self.pq.verbose = self.verbose
        self.pq.train(x)
        if self.do_polysemous_training:
            from ..codecs.polysemous import PolysemousTraining

            pt = self.polysemous_training or PolysemousTraining()
            pt.optimize_pq_for_hamming(self.pq)
        self.is_trained = True
        self._sdc = None

    def add(self, x) -> None:
        x = self._check_input(x)
        self._check_trained()
        page = add_page_rows(self.d)
        for s in range(0, len(x), page):
            self._append(self.pq.compute_codes_dev(x[s : s + page]))

    def add_codes_int(self, codes_int) -> None:
        """Append rows already encoded, as unpacked codes [n, M]."""
        c = np.asarray(codes_int)
        if c.ndim != 2 or c.shape[1] != self.pq.M:
            raise ValueError(f"expected [n, {self.pq.M}] codes, got {c.shape}")
        self._append(codes_tensor(c, self.device))

    def _append(self, codes: torch.Tensor) -> None:
        codes = codes.to(torch.uint8 if self.pq.nbits <= 8 else torch.int32)
        self._codes = codes if self._codes is None else torch.cat([self._codes, codes])
        self.ntotal = len(self._codes)

    def reset(self) -> None:
        self._codes = None
        self.ntotal = 0

    @property
    def codes_host(self) -> np.ndarray:
        """The unpacked codes [ntotal, M], uint8 or uint16 (faiss_tpu's
        ``_codes_host``)."""
        if self._codes is None:
            return np.empty((0, self.pq.M), np.uint8 if self.pq.nbits <= 8 else np.uint16)
        return codes_numpy(self._codes, self.pq.nbits)

    def _tables(self, xq: torch.Tensor, search_type: int) -> torch.Tensor:
        """The search's [nq, M, ksub] tables: rows of the symmetric table
        for ST_SDC (L2 only, faiss_tpu :99-110), else the ADC tables of
        the metric."""
        cb = self.pq._dev()
        if search_type == self.ST_SDC:
            if self._sdc is None:
                self._sdc = torch.from_numpy(self.pq.compute_sdc_table()).to(self.device)
            qcodes = pq_ops.pq_encode(xq, cb)
            m = torch.arange(self.pq.M, device=self.device)[None, :]
            return self._sdc[m, qcodes]
        if self.metric_type == MetricType.L2:
            return pq_ops.pq_distance_tables(xq, cb)
        return pq_ops.pq_ip_tables(xq, cb)

    def search(self, x, k: int, *, params=None):
        """faiss_tpu :74. An ID selector keeps its rows before the select
        (faiss_tpu filters after its top-k, ROADMAP queue 3)."""
        x = self._check_input(x)
        self._check_trained()
        st = self.search_type
        if st == self.ST_SDC and self.metric_type != MetricType.L2:
            raise ValueError("SDC search is defined for L2")
        if st == self.ST_polysemous and self.metric_type != MetricType.L2:
            # the Hamming-filtered scan ranks ascending (faiss_tpu would
            # feed it inner-product tables, ROADMAP queue 3)
            raise ValueError("polysemous search is defined for L2")
        nq = len(x)
        largest = is_similarity_metric(self.metric_type)
        D = np.full((nq, k), -np.inf if largest else np.inf, np.float32)
        I = np.full((nq, k), -1, np.int64)
        if self.ntotal == 0 or nq == 0:
            return D, I
        codes, id_of = self._codes, None
        mask = sel_mask(params, np.arange(self.ntotal, dtype=np.int64), self.device)
        if mask is not None:
            id_of = mask.nonzero()[:, 0]
            codes = codes[id_of]
            if not len(codes):
                return D, I
        ht = self.polysemous_ht or (self.pq.M * self.pq.nbits // 2)
        x_dev = torch.from_numpy(x).to(self.device)
        for start, _, real in query_buckets(nq):
            xq = x_dev[start : start + real]
            luts = self._tables(xq, st)
            if st == self.ST_polysemous:
                d, i = pq_ops.pq_polysemous_knn(
                    luts, pq_ops.pq_encode(xq, self.pq._dev()), codes, k, ht)
            else:
                d, i = pq_ops.pq_adc_knn(luts, codes, k, largest=largest)
            if id_of is not None:
                i = torch.where(i >= 0, id_of[i.clamp_min(0)], -1)
            D[start : start + real, : d.shape[1]] = d.cpu().numpy()
            I[start : start + real, : d.shape[1]] = i.cpu().numpy()
        return D, I

    def range_search(self, x, radius: float, *, params=None):
        """Every row whose decoded vector lies within ``radius`` (L2 below
        it, inner product above it; faiss_tpu :134), scored in tiles of
        decoded rows on the device; a query's hits in ascending id order."""
        x = self._check_input(x)
        nq = len(x)
        parts = []
        if self.ntotal and nq:
            largest = is_similarity_metric(self.metric_type)
            mask = sel_mask(params, np.arange(self.ntotal, dtype=np.int64),
                            self.device)
            xq = torch.from_numpy(x).to(self.device)
            for c0 in range(0, self.ntotal, self.RANGE_TILE_ROWS):
                rows = pq_ops.pq_decode(self._codes[c0 : c0 + self.RANGE_TILE_ROWS],
                                        self.pq._dev())
                dt = dops.pairwise_distances(xq, rows, self.metric_type)
                hit = dt > radius if largest else dt < radius
                if mask is not None:
                    hit &= mask[None, c0 : c0 + len(rows)]
                qi, ci = torch.nonzero(hit, as_tuple=True)
                parts.append((qi.cpu().numpy(), dt[qi, ci].cpu().numpy(),
                              (ci + c0).cpu().numpy()))
        return range_result(parts, nq)

    # -- reconstruction and codec ---------------------------------------------
    def reconstruct_n(self, n0: int, ni: int) -> np.ndarray:
        if self._codes is None:
            return np.empty((0, self.d), np.float32)
        return pq_ops.pq_decode(self._codes[n0 : n0 + ni], self.pq._dev()).cpu().numpy()

    def reconstruct_batch(self, keys) -> np.ndarray:
        keys = torch.from_numpy(np.asarray(keys, np.int64).ravel()).to(self.device)
        return pq_ops.pq_decode(self._codes[keys], self.pq._dev()).cpu().numpy()

    def sa_code_size(self) -> int:
        return self.pq.code_size

    def sa_encode(self, x) -> np.ndarray:
        return self.pq.compute_codes(self._check_input(x))

    def sa_decode(self, codes) -> np.ndarray:
        return self.pq.decode(codes)

    def merge_from(self, other: "IndexPQ", add_id: int = 0) -> None:
        """Append ``other``'s codes (same codebooks) and empty it."""
        del add_id
        if (not isinstance(other, IndexPQ) or other.d != self.d
                or other.pq.M != self.pq.M or other.pq.nbits != self.pq.nbits):
            raise ValueError("incompatible indexes for merge")
        if other.ntotal:
            self._append(other._codes.to(self.device))
        other.reset()


class IndexPQFastScan(IndexPQ):
    """4-bit PQ (reference: faiss/IndexPQFastScan.h:26; faiss_tpu :188):
    the ADC scan's one-hot branch. ``bbs``, the reference's code block
    size, is kept for the factory string and the index file."""

    def __init__(self, d: int, M: int, nbits: int = 4, metric=MetricType.L2,
                 bbs: int = 32, *, device="cuda"):
        if nbits != 4:
            raise ValueError("FastScan requires nbits=4")
        super().__init__(d, M, nbits, metric, device=device)
        self.bbs = int(bbs)
