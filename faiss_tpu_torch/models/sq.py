"""Scalar-quantizer indexes (counterpart of faiss_tpu/models/sq.py;
reference: faiss/IndexScalarQuantizer.{h,cpp}).

Both keep the compressed codes on the host (the index's footprint, what
index files hold) and search decoded rows on the device, as faiss_tpu does:

  - IndexScalarQuantizer is an IndexFlat over the decoded rows, so its
    search is the flat search with its kernel paths (the hi/lo screen, K2,
    for k <= 100 over 16,384 rows or more; K3 beyond);
  - IndexIVFScalarQuantizer is an IndexIVF whose padded per-probe layout
    holds the decoded rows (plus the list centroid when coding residuals),
    searched by probe exactly, L2 or inner product. QT_0bit forces residual
    coding: each vector is represented by its list centroid.

Codes come from the host codec (codecs/sq.py), bit for bit faiss_tpu's."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..base import require_device
from ..codecs.sq import QuantizerType, ScalarQuantizer
from ..metric import MetricType
from .flat import IndexFlat
from .ivf import IndexIVF


class IndexScalarQuantizer(IndexFlat):
    """Flat SQ index (reference: IndexScalarQuantizer.h:26; faiss_tpu :24):
    codes on the host, their decoded rows in the flat store."""

    def __init__(self, d: int, qtype=QuantizerType.QT_8bit,
                 metric=MetricType.L2, *, device="cuda"):
        if QuantizerType(qtype) == QuantizerType.QT_0bit:
            # sq-dispatch.h:408: a centroid-only distance needs an IVF
            raise ValueError(
                "QT_0bit does not support standalone quantization, "
                "use IndexIVFScalarQuantizer"
            )
        super().__init__(d, metric, device=require_device(device))
        self.sq = ScalarQuantizer(d, qtype)
        self.is_trained = self.sq.is_trained
        self.code_size = self.sq.code_size
        self._codes: Optional[np.ndarray] = None  # [ntotal, code_size]

    def train(self, x) -> None:
        self.sq.train(self._check_input(x))
        self.is_trained = True

    def add(self, x) -> None:
        x = self._check_input(x)
        self._check_trained()
        self.add_codes(self.sq.compute_codes(x))

    def add_codes(self, codes) -> None:
        """Append rows already encoded by this index's quantizer."""
        codes = np.ascontiguousarray(codes, np.uint8).reshape(-1, self.code_size)
        self._codes = (codes.copy() if self._codes is None
                       else np.concatenate([self._codes, codes]))
        super().add(self.sq.decode(codes))

    def reset(self) -> None:
        super().reset()
        self._codes = None

    def remove_ids(self, sel) -> int:
        """IndexFlat.remove_ids, keeping the codes aligned with the rows."""
        keep = ~sel.mask_for_ids(np.arange(self.ntotal, dtype=np.int64))
        nremoved = super().remove_ids(sel)
        if nremoved:
            self._codes = self._codes[keep]
        return nremoved

    def merge_from(self, other: "IndexScalarQuantizer", add_id: int = 0) -> None:
        """Append ``other``'s codes (encoded with its own trained ranges,
        decoded here with this index's: both must share them) and empty
        ``other``."""
        del add_id
        if (not isinstance(other, IndexScalarQuantizer) or other.d != self.d
                or other.metric_type != self.metric_type
                or other.sq.qtype != self.sq.qtype):
            raise ValueError("incompatible indexes for merge")
        if other.ntotal:
            self.add_codes(other._codes)
        other.reset()

    def sa_code_size(self) -> int:
        return self.sq.code_size

    def sa_encode(self, x) -> np.ndarray:
        return self.sq.compute_codes(self._check_input(x))

    def sa_decode(self, codes) -> np.ndarray:
        return self.sq.decode(codes)


class IndexIVFScalarQuantizer(IndexIVF):
    """IVF with SQ codes (reference: IndexScalarQuantizer.h:61; faiss_tpu
    :72); searched by probe over the decoded rows."""

    def __init__(self, quantizer, d: int, nlist: int,
                 qtype=QuantizerType.QT_8bit, metric=MetricType.L2,
                 by_residual: bool = False, *, device="cuda"):
        super().__init__(quantizer, d, nlist, metric,
                         device=require_device(device))
        self.sq = ScalarQuantizer(d, qtype)
        # QT_0bit reconstructs each vector as its list centroid: meaningful
        # with residual coding only (scanners.h:162)
        self.by_residual = (
            True if self.sq.qtype == QuantizerType.QT_0bit else by_residual
        )
        self.code_size = self.sq.code_size

    def _residual(self, x: np.ndarray, listnos: np.ndarray) -> np.ndarray:
        """x minus its list centroid, as faiss_tpu subtracts it (host
        float32)."""
        if not self.by_residual:
            return x
        return x - self._centroids_host()[listnos]

    def train_encoder(self, x: torch.Tensor, assign: torch.Tensor) -> None:
        self.sq.train(self._residual(x.float().cpu().numpy(),
                                     assign.cpu().numpy()))

    def encode_vectors(self, x: torch.Tensor, listnos: torch.Tensor) -> np.ndarray:
        return self.sq.compute_codes(self._residual(
            x.float().cpu().numpy(), listnos.cpu().numpy()))

    def decode_vectors(self, codes: np.ndarray, listnos: np.ndarray) -> np.ndarray:
        out = self.sq.decode(codes)
        if self.by_residual:
            out = out + self._centroids_host()[listnos]
        return out

    def _stage_rows(self) -> np.ndarray:
        return self.decode_vectors(self._codes_host, self._listnos_host)

    # -- standalone codes (IndexIVF::sa_encode): the list number in
    # coarse_code_size little-endian bytes, then the vector's code
    def coarse_code_size(self) -> int:
        """Bytes of a list number (Level1Quantizer::coarse_code_size)."""
        nbytes, nl = 0, self.nlist - 1
        while nl > 0:
            nbytes, nl = nbytes + 1, nl >> 8
        return nbytes

    def sa_code_size(self) -> int:
        return self.coarse_code_size() + self.sq.code_size

    def sa_encode(self, x) -> np.ndarray:
        x = self._check_input(x)
        self._check_trained()
        listnos = self._assign(torch.from_numpy(x).to(self.device)).cpu().numpy()
        nc = self.coarse_code_size()
        coarse = listnos.astype("<u8").view(np.uint8).reshape(len(x), 8)[:, :nc]
        return np.concatenate(
            [coarse, self.encode_vectors(torch.from_numpy(x),
                                         torch.from_numpy(listnos))], axis=1)

    def sa_decode(self, codes) -> np.ndarray:
        codes = np.ascontiguousarray(codes, np.uint8).reshape(-1, self.sa_code_size())
        nc = self.coarse_code_size()
        wide = np.zeros((len(codes), 8), np.uint8)
        wide[:, :nc] = codes[:, :nc]
        listnos = wide.view("<u8").ravel().astype(np.int64)
        return self.decode_vectors(codes[:, nc:], listnos)
