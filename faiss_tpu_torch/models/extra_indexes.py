"""Index2Layer (counterpart of faiss_tpu/models/extra_indexes.py:19-100;
reference: faiss/Index2Layer.{h,cpp}): IVF-structured codes stored flat."""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..base import Index
from ..codecs.pq import ProductQuantizer
from ..metric import MetricType
from .flat import IndexFlat


class Index2Layer(Index):
    """Per vector its coarse id and the PQ code of its residual, without
    inverted lists (reference: Index2Layer.h:22): the storage of
    IndexHNSW2Level. The coarse quantizer is the port's (flat, or an IMI
    that trains itself); the PQ trains and encodes on its device. Search
    decodes every row and scans them exactly."""

    def __init__(self, quantizer, nlist: int, M: int, nbits: int = 8,
                 metric=MetricType.L2):
        super().__init__(quantizer.d, metric, device=quantizer.device)
        self.q1_quantizer = quantizer
        self.nlist = int(nlist)
        self.pq = ProductQuantizer(self.d, M, nbits, device=self.device)
        self.is_trained = False
        self._listnos: Optional[np.ndarray] = None
        self._codes: Optional[np.ndarray] = None
        self.code_size = self.pq.code_size + 4  # coarse id stored as int32

    def _centroids(self) -> np.ndarray:
        return self.q1_quantizer.vectors()

    def train(self, x) -> None:
        """The coarse quantizer (k-means of nlist centroids, or the IMI's own
        training), then the PQ on the residuals (faiss_tpu :40)."""
        x = self._check_input(x)
        if self.q1_quantizer.ntotal != self.nlist:
            from .imi import MultiIndexQuantizer

            if isinstance(self.q1_quantizer, MultiIndexQuantizer):
                self.q1_quantizer.train(x)
            else:
                from ..clustering import Clustering

                clus = Clustering(self.d, self.nlist, device=self.device)
                clus.train(x)
                self.q1_quantizer.reset()
                self.q1_quantizer.add(clus.centroids)
        _, assign = self.q1_quantizer.search(x, 1)
        self.pq.train(x - self._centroids()[assign.ravel()])
        self.is_trained = True

    def add(self, x) -> None:
        x = self._check_input(x)
        _, assign = self.q1_quantizer.search(x, 1)
        assign = assign.ravel().astype(np.int32)
        codes = self.pq.compute_codes_int(x - self._centroids()[assign])
        self._listnos = (assign if self._listnos is None
                         else np.concatenate([self._listnos, assign]))
        self._codes = (codes if self._codes is None
                       else np.concatenate([self._codes, codes]))
        self.ntotal += len(x)

    def reconstruct_n(self, n0: int, ni: int) -> np.ndarray:
        recon = self.pq.decode_int(self._codes[n0 : n0 + ni])
        return recon + self._centroids()[self._listnos[n0 : n0 + ni]]

    def search(self, x, k: int, *, params=None):
        """Exact search over the decoded rows (the reference mainly uses the
        class as HNSW storage)."""
        flat = IndexFlat(self.d, self.metric_type, device=self.device)
        flat.add(self.reconstruct_n(0, self.ntotal))
        return flat.search(x, k, params=params)

    def reset(self) -> None:
        self._listnos = None
        self._codes = None
        self.ntotal = 0

    def _truncate(self, n: int) -> None:
        """Drop rows n.. (the interrupt rollback of IndexHNSW2Level)."""
        if n <= 0:
            self.reset()
            return
        self._listnos = self._listnos[:n]
        self._codes = self._codes[:n]
        self.ntotal = n
