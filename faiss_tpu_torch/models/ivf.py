"""IVF base index (counterpart of faiss_tpu/models/ivf.py:60-203).

The inverted lists are a host-side flat entry store (codes / listnos / ids
per slot; the ArrayInvertedLists + DirectMap analogue), from which the
search layout of a subclass is built. Training is k-means of the coarse
quantizer on the device; adds are paged, assigned on the device against the
flat quantizer and encoded by the subclass. The per-probe scan of faiss_tpu
(ops/ivf_ops.py) is ROADMAP queue 1 item 5."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..base import Index, add_page_rows
from ..clustering import Clustering, ClusteringParameters
from ..metric import MetricType
from ..ops import distances as dops
from .flat import IndexFlat


class Level1Quantizer:
    """Coarse-quantizer management (reference: IndexIVF.h:30)."""

    def __init__(self, quantizer: Optional[Index], nlist: int, d: int, metric, *,
                 device):
        self.nlist = int(nlist)
        self.quantizer = (
            quantizer if quantizer is not None
            else IndexFlat(d, metric, device=device)
        )
        self.cp = ClusteringParameters()

    def train_q1(self, x: np.ndarray, verbose: bool) -> None:
        """faiss_tpu/models/ivf.py:77."""
        if self.quantizer.ntotal == self.nlist:
            return  # already trained (quantizer provided pre-populated)
        self.cp.verbose = verbose
        clus = Clustering(x.shape[1], self.nlist, self.cp, device=self.device)
        clus.train(x)
        self.quantizer.reset()
        self.quantizer.add(clus.centroids)


class IndexIVF(Index, Level1Quantizer):
    """Base IVF index (reference: IndexIVF.h:194). Subclasses implement
    the codec (encode_vectors)."""

    def __init__(self, quantizer: Optional[Index], d: int, nlist: int,
                 metric=MetricType.L2, *, device):
        Index.__init__(self, d, metric, device=device)
        if self.metric_type != MetricType.L2:
            raise NotImplementedError("IndexIVF: only METRIC_L2 is ported")
        Level1Quantizer.__init__(
            self, quantizer, nlist, d, self.metric_type, device=device
        )
        if not isinstance(self.quantizer, IndexFlat):
            raise NotImplementedError("only a flat coarse quantizer is ported")
        self.nprobe = 1
        self.is_trained = self.quantizer.ntotal == self.nlist
        self._codes_host: Optional[np.ndarray] = None  # [ntotal, code width]
        self._listnos_host = np.empty(0, np.int32)
        self._ids_host = np.empty(0, np.int64)

    def train_encoder(self, x: torch.Tensor, assign: torch.Tensor) -> None:
        del x, assign

    def encode_vectors(self, x: torch.Tensor, listnos: torch.Tensor) -> np.ndarray:
        raise NotImplementedError

    def _assign(self, x: torch.Tensor) -> torch.Tensor:
        """Top-1 coarse assignment on the device (assign_flat)."""
        return dops.assign_flat(x, self.quantizer._consolidate())[1]

    def train(self, x) -> None:
        x = self._check_input(x)
        self.train_q1(x, self.verbose)
        xd = torch.from_numpy(x).to(self.device)
        self.train_encoder(xd, self._assign(xd))
        self.is_trained = True

    def add(self, x) -> None:
        self.add_with_ids(x, None)

    def add_with_ids(self, x, ids) -> None:
        x = self._check_input(x)
        self._check_trained()
        page = add_page_rows(self.d)
        for s in range(0, len(x), page):
            xd = torch.from_numpy(x[s : s + page]).to(self.device)
            self.add_core(
                xd, None if ids is None else np.asarray(ids)[s : s + page],
                self._assign(xd),
            )

    def add_core(self, x, ids, listnos) -> None:
        """Add with precomputed coarse assignment (IndexIVF.h add_core)."""
        x = torch.as_tensor(x, device=self.device)
        listnos = torch.as_tensor(listnos, device=self.device).long().ravel()
        codes = self.encode_vectors(x, listnos)
        self.add_encoded(codes, listnos.to(torch.int32).cpu().numpy(), ids)

    def add_encoded(self, codes: np.ndarray, listnos: np.ndarray, ids=None) -> None:
        """Append already-encoded entries to the host lists."""
        n = len(codes)
        listnos = np.asarray(listnos, np.int32).ravel()
        if ids is None:
            ids = np.arange(self.ntotal, self.ntotal + n, dtype=np.int64)
        ids = np.asarray(ids, np.int64).ravel()
        if len(ids) != n or len(listnos) != n:
            raise ValueError("codes, listnos and ids differ in length")
        self._codes_host = (
            codes if self._codes_host is None
            else np.concatenate([self._codes_host, codes])
        )
        self._listnos_host = np.concatenate([self._listnos_host, listnos])
        self._ids_host = np.concatenate([self._ids_host, ids])
        self.ntotal += n

    def reset(self) -> None:
        self._codes_host = None
        self._listnos_host = np.empty(0, np.int32)
        self._ids_host = np.empty(0, np.int64)
        self.ntotal = 0
