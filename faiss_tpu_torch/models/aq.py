"""Additive-quantizer indexes (counterpart of faiss_tpu/models/aq.py;
reference: faiss/IndexAdditiveQuantizer.{h,cpp},
IndexAdditiveQuantizerFastScan.h, IndexIVFAdditiveQuantizer.{h,cpp},
IndexIVFAdditiveQuantizerFastScan.h).

The flat indexes keep the unpacked codes [ntotal, M] and a norm per code on
the device and rank by the ST_norm_float decomposition

    d(q, y) = |q|^2 - 2 sum_m LUT[q, m, code_m] + |y|^2

with float32 tables (``compute_LUT``, one product a search) summed in order
of m by gathers, then an exact chunked top-k (ops/pq_ops.aq_lut_knn); inner
product ranks by the table sum alone. A one-byte norm code ranks with the
norm it decodes to. An ID selector masks codes before the select (faiss_tpu
ignores ``params`` here, ROADMAP queue 3). The FastScan classes are the
nbits = 4 configuration plus ``bbs``, on the same scan.

The IVF indexes encode the residual to the list centroid; their per-probe
layout holds the decoded float rows (centroid added) and, under L2, their
norms, searched by IndexIVF's exact scan by probe, as IVF-SQ's are. No
kernel: faiss_tpu computes all of this in XLA."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..base import Index, query_buckets, require_device, sel_mask
from ..codecs.aq import (
    AdditiveQuantizer,
    LocalSearchQuantizer,
    ProductAdditiveQuantizer,
    ProductLocalSearchQuantizer,
    ProductResidualQuantizer,
    ResidualQuantizer,
)
from ..codecs.pq import codes_numpy, codes_tensor
from ..metric import MetricType, is_similarity_metric
from ..ops import pq_ops
from .ivf import IndexIVF


class IndexAdditiveQuantizer(Index):
    """Flat AQ index (reference: IndexAdditiveQuantizer.h:27; faiss_tpu
    :87)."""

    def __init__(self, d: int, aq: AdditiveQuantizer, metric=MetricType.L2, *,
                 device=None):
        super().__init__(d, metric, device=require_device(device or aq.device))
        self.aq = aq
        self.is_trained = aq.is_trained
        self._codes: Optional[torch.Tensor] = None  # [ntotal, M] on the device
        self._norms_dev: Optional[torch.Tensor] = None  # [ntotal] float32

    def train(self, x) -> None:
        self.aq.train(self._check_input(x))
        self.is_trained = True

    def add(self, x) -> None:
        x = self._check_input(x)
        self._check_trained()
        codes = self.aq.compute_codes_dev(self.aq._x_dev(x))
        norms = self.aq.decode_dev(codes).square().sum(-1)
        if self.aq._NORM_BYTES.get(self.aq.search_type, 0) == 1:
            norms = torch.from_numpy(self.aq.stored_norms(norms.cpu().numpy())
                                     ).to(self.device)
        self._append(codes, norms)

    def add_codes_int(self, codes_int, norms) -> None:
        """Append rows already encoded: unpacked codes [n, M] and the norms
        the search ranks them with [n]."""
        c = np.asarray(codes_int)
        if c.ndim != 2 or c.shape[1] != self.aq.M:
            raise ValueError(f"expected [n, {self.aq.M}] codes, got {c.shape}")
        n = torch.from_numpy(np.ascontiguousarray(norms, np.float32).ravel())
        self._append(codes_tensor(c, self.device), n.to(self.device))

    def _append(self, codes: torch.Tensor, norms: torch.Tensor) -> None:
        codes = codes.to(torch.uint8 if self.aq.nbits <= 8 else torch.int32)
        if self._codes is None:
            self._codes, self._norms_dev = codes, norms.float()
        else:
            self._codes = torch.cat([self._codes, codes])
            self._norms_dev = torch.cat([self._norms_dev, norms.float()])
        self.ntotal = len(self._codes)

    @property
    def _codes_int(self) -> Optional[np.ndarray]:
        """The unpacked codes on the host (faiss_tpu's ``_codes_int``)."""
        return None if self._codes is None else codes_numpy(self._codes, self.aq.nbits)

    @property
    def _norms(self) -> Optional[np.ndarray]:
        return None if self._norms_dev is None else self._norms_dev.cpu().numpy()

    def search(self, x, k: int, *, params=None):
        """faiss_tpu :122; an ID selector keeps its codes before the
        select."""
        x = self._check_input(x)
        nq = len(x)
        largest = is_similarity_metric(self.metric_type)
        D = np.full((nq, k), -np.inf if largest else np.inf, np.float32)
        I = np.full((nq, k), -1, np.int64)
        if self.ntotal == 0 or nq == 0:
            return D, I
        keep = sel_mask(params, np.arange(self.ntotal, dtype=np.int64), self.device)
        x_dev = torch.from_numpy(x).to(self.device)
        for start, _, real in query_buckets(nq):
            xq = x_dev[start : start + real]
            d, i = pq_ops.aq_lut_knn(self.aq.lut_dev(xq), self._codes,
                                     self._norms_dev, k, largest, keep)
            if not largest:
                d = (d + xq.square().sum(-1)[:, None]).clamp_min(0.0)
            D[start : start + real, : d.shape[1]] = d.cpu().numpy()
            I[start : start + real, : d.shape[1]] = i.cpu().numpy()
        return D, I

    def reconstruct_n(self, n0: int, ni: int) -> np.ndarray:
        if self._codes is None:
            return np.empty((0, self.d), np.float32)
        return self.aq.decode_dev(self._codes[n0 : n0 + ni]).cpu().numpy()

    def sa_code_size(self) -> int:
        return self.aq.code_size

    def sa_encode(self, x) -> np.ndarray:
        return self.aq.compute_codes(self._check_input(x))

    def sa_decode(self, codes) -> np.ndarray:
        return self.aq.decode(codes)

    def reset(self) -> None:
        self._codes = self._norms_dev = None
        self.ntotal = 0


class IndexResidualQuantizer(IndexAdditiveQuantizer):
    """reference: IndexAdditiveQuantizer.h IndexResidualQuantizer."""

    def __init__(self, d: int, M: int, nbits: int = 8, metric=MetricType.L2, *,
                 device="cuda"):
        super().__init__(d, ResidualQuantizer(d, M, nbits, device=device), metric)
        self.rq = self.aq


class IndexLocalSearchQuantizer(IndexAdditiveQuantizer):
    def __init__(self, d: int, M: int, nbits: int = 8, metric=MetricType.L2, *,
                 device="cuda"):
        super().__init__(d, LocalSearchQuantizer(d, M, nbits, device=device), metric)
        self.lsq = self.aq


class IndexProductResidualQuantizer(IndexAdditiveQuantizer):
    def __init__(self, d, nsplits, Msub, nbits=8, metric=MetricType.L2, *,
                 device="cuda"):
        super().__init__(d, ProductResidualQuantizer(d, nsplits, Msub, nbits,
                                                     device=device), metric)


class IndexProductLocalSearchQuantizer(IndexAdditiveQuantizer):
    def __init__(self, d, nsplits, Msub, nbits=8, metric=MetricType.L2, *,
                 device="cuda"):
        super().__init__(d, ProductLocalSearchQuantizer(d, nsplits, Msub, nbits,
                                                        device=device), metric)


class IndexAdditiveQuantizerFastScan(IndexAdditiveQuantizer):
    """4-bit AQ (reference: IndexAdditiveQuantizerFastScan.h:29; faiss_tpu
    :258): the nbits = 4 constraint and ``bbs``, on the same scan."""

    def __init__(self, d, aq, metric=MetricType.L2, bbs: int = 32, *, device=None):
        if aq.nbits != 4:
            raise ValueError("FastScan requires nbits=4")
        super().__init__(d, aq, metric, device=device)
        self.bbs = bbs


class IndexResidualQuantizerFastScan(IndexAdditiveQuantizerFastScan):
    """reference: IndexAdditiveQuantizerFastScan.h:98."""

    def __init__(self, d, M, nbits=4, metric=MetricType.L2, bbs=32, *,
                 device="cuda"):
        super().__init__(d, ResidualQuantizer(d, M, nbits, device=device), metric, bbs)


class IndexLocalSearchQuantizerFastScan(IndexAdditiveQuantizerFastScan):
    """reference: IndexAdditiveQuantizerFastScan.h:121."""

    def __init__(self, d, M, nbits=4, metric=MetricType.L2, bbs=32, *,
                 device="cuda"):
        super().__init__(d, LocalSearchQuantizer(d, M, nbits, device=device),
                         metric, bbs)


class IndexProductResidualQuantizerFastScan(IndexAdditiveQuantizerFastScan):
    """reference: IndexAdditiveQuantizerFastScan.h:143."""

    def __init__(self, d, nsplits, Msub, nbits=4, metric=MetricType.L2, bbs=32,
                 *, device="cuda"):
        super().__init__(d, ProductAdditiveQuantizer(
            d, nsplits, Msub, nbits, ResidualQuantizer, device=device), metric, bbs)


class IndexProductLocalSearchQuantizerFastScan(IndexAdditiveQuantizerFastScan):
    """reference: IndexAdditiveQuantizerFastScan.h:166."""

    def __init__(self, d, nsplits, Msub, nbits=4, metric=MetricType.L2, bbs=32,
                 *, device="cuda"):
        super().__init__(d, ProductAdditiveQuantizer(
            d, nsplits, Msub, nbits, LocalSearchQuantizer, device=device),
            metric, bbs)


class IndexIVFAdditiveQuantizer(IndexIVF):
    """IVF over AQ codes of the residuals (reference:
    IndexIVFAdditiveQuantizer.h; faiss_tpu :191): the lists hold unpacked
    codes [n, M]; the per-probe layout their decoded rows."""

    def __init__(self, quantizer, d, nlist, aq: AdditiveQuantizer,
                 metric=MetricType.L2, *, device=None):
        super().__init__(quantizer, d, nlist, metric,
                         device=require_device(device or aq.device))
        self.aq = aq
        self.by_residual = True
        self.code_size = aq.code_size

    def _residual(self, x: np.ndarray, listnos: np.ndarray) -> np.ndarray:
        if not self.by_residual:
            return x
        return x - self._centroids_host()[listnos]

    def train_encoder(self, x: torch.Tensor, assign: torch.Tensor) -> None:
        self.aq.train(self._residual(x.float().cpu().numpy(), assign.cpu().numpy()))

    def encode_vectors(self, x: torch.Tensor, listnos: torch.Tensor) -> np.ndarray:
        return self.aq.compute_codes_int(self._residual(
            x.float().cpu().numpy(), listnos.cpu().numpy()))

    def decode_vectors(self, codes: np.ndarray, listnos: np.ndarray) -> np.ndarray:
        out = self.aq.decode_int(codes)
        if self.by_residual:
            out = out + self._centroids_host()[listnos]
        return out

    def _stage_rows(self) -> np.ndarray:
        return self.decode_vectors(self._codes_host, self._listnos_host)

    def sa_code_size(self) -> int:
        return self.aq.code_size


class IndexIVFResidualQuantizer(IndexIVFAdditiveQuantizer):
    def __init__(self, quantizer, d, nlist, M, nbits=8, metric=MetricType.L2, *,
                 device="cuda"):
        super().__init__(quantizer, d, nlist,
                         ResidualQuantizer(d, M, nbits, device=device), metric)


class IndexIVFLocalSearchQuantizer(IndexIVFAdditiveQuantizer):
    def __init__(self, quantizer, d, nlist, M, nbits=8, metric=MetricType.L2, *,
                 device="cuda"):
        super().__init__(quantizer, d, nlist,
                         LocalSearchQuantizer(d, M, nbits, device=device), metric)


class IndexIVFAdditiveQuantizerFastScan(IndexIVFAdditiveQuantizer):
    """4-bit IVF AQ (reference: IndexIVFAdditiveQuantizerFastScan.h:33):
    the nbits = 4 constraint and ``bbs``."""

    def __init__(self, quantizer, d, nlist, aq, metric=MetricType.L2, bbs=32, *,
                 device=None):
        if aq.nbits != 4:
            raise ValueError("FastScan requires nbits=4")
        super().__init__(quantizer, d, nlist, aq, metric, device=device)
        self.bbs = bbs


class IndexIVFResidualQuantizerFastScan(IndexIVFAdditiveQuantizerFastScan):
    """reference: IndexIVFAdditiveQuantizerFastScan.h:130."""

    def __init__(self, quantizer, d, nlist, M, nbits=4, metric=MetricType.L2,
                 bbs=32, *, device="cuda"):
        super().__init__(quantizer, d, nlist,
                         ResidualQuantizer(d, M, nbits, device=device), metric, bbs)


class IndexIVFLocalSearchQuantizerFastScan(IndexIVFAdditiveQuantizerFastScan):
    """reference: IndexIVFAdditiveQuantizerFastScan.h:145."""

    def __init__(self, quantizer, d, nlist, M, nbits=4, metric=MetricType.L2,
                 bbs=32, *, device="cuda"):
        super().__init__(quantizer, d, nlist,
                         LocalSearchQuantizer(d, M, nbits, device=device), metric, bbs)


class IndexIVFProductResidualQuantizer(IndexIVFAdditiveQuantizer):
    """reference: IndexIVFAdditiveQuantizer.h:141."""

    def __init__(self, quantizer, d, nlist, nsplits, Msub, nbits=8,
                 metric=MetricType.L2, *, device="cuda"):
        super().__init__(quantizer, d, nlist, ProductAdditiveQuantizer(
            d, nsplits, Msub, nbits, ResidualQuantizer, device=device), metric)


class IndexIVFProductLocalSearchQuantizer(IndexIVFAdditiveQuantizer):
    """reference: IndexIVFAdditiveQuantizer.h:171."""

    def __init__(self, quantizer, d, nlist, nsplits, Msub, nbits=8,
                 metric=MetricType.L2, *, device="cuda"):
        super().__init__(quantizer, d, nlist, ProductAdditiveQuantizer(
            d, nsplits, Msub, nbits, LocalSearchQuantizer, device=device), metric)


class IndexIVFProductResidualQuantizerFastScan(IndexIVFAdditiveQuantizerFastScan):
    """reference: IndexIVFAdditiveQuantizerFastScan.h:166."""

    def __init__(self, quantizer, d, nlist, nsplits, Msub, nbits=4,
                 metric=MetricType.L2, bbs=32, *, device="cuda"):
        super().__init__(quantizer, d, nlist, ProductAdditiveQuantizer(
            d, nsplits, Msub, nbits, ResidualQuantizer, device=device), metric, bbs)


class IndexIVFProductLocalSearchQuantizerFastScan(IndexIVFAdditiveQuantizerFastScan):
    """reference: IndexIVFAdditiveQuantizerFastScan.h:147."""

    def __init__(self, quantizer, d, nlist, nsplits, Msub, nbits=4,
                 metric=MetricType.L2, bbs=32, *, device="cuda"):
        super().__init__(quantizer, d, nlist, ProductAdditiveQuantizer(
            d, nsplits, Msub, nbits, LocalSearchQuantizer, device=device), metric, bbs)


# -- construction by class name (index files and converted state) ------------

_FLAT = {
    "IndexResidualQuantizer": (IndexResidualQuantizer, False),
    "IndexLocalSearchQuantizer": (IndexLocalSearchQuantizer, False),
    "IndexResidualQuantizerFastScan": (IndexResidualQuantizerFastScan, False),
    "IndexLocalSearchQuantizerFastScan": (IndexLocalSearchQuantizerFastScan, False),
    "IndexProductResidualQuantizer": (IndexProductResidualQuantizer, True),
    "IndexProductLocalSearchQuantizer": (IndexProductLocalSearchQuantizer, True),
    "IndexProductResidualQuantizerFastScan": (IndexProductResidualQuantizerFastScan, True),
    "IndexProductLocalSearchQuantizerFastScan":
        (IndexProductLocalSearchQuantizerFastScan, True),
}
_IVF = {
    "IndexIVFResidualQuantizer": (IndexIVFResidualQuantizer, False),
    "IndexIVFLocalSearchQuantizer": (IndexIVFLocalSearchQuantizer, False),
    "IndexIVFResidualQuantizerFastScan": (IndexIVFResidualQuantizerFastScan, False),
    "IndexIVFLocalSearchQuantizerFastScan": (IndexIVFLocalSearchQuantizerFastScan, False),
    "IndexIVFProductResidualQuantizer": (IndexIVFProductResidualQuantizer, True),
    "IndexIVFProductLocalSearchQuantizer": (IndexIVFProductLocalSearchQuantizer, True),
    "IndexIVFProductResidualQuantizerFastScan":
        (IndexIVFProductResidualQuantizerFastScan, True),
    "IndexIVFProductLocalSearchQuantizerFastScan":
        (IndexIVFProductLocalSearchQuantizerFastScan, True),
}
AQ_FLAT_CLASSES = frozenset(_FLAT) | {"IndexAdditiveQuantizer"}
AQ_IVF_CLASSES = (frozenset(_IVF) | {"IndexIVFAdditiveQuantizer",
                                      "IndexIVFAdditiveQuantizerFastScan"})


def aq_codec(cls_name: str, d: int, M: int, nbits: int, nsplits: int = 0, *,
             device) -> AdditiveQuantizer:
    """A codec by faiss_tpu's class name (io.py:638): the product codecs
    take (d, nsplits, M / nsplits, nbits)."""
    from ..codecs import aq as aqc

    cls = getattr(aqc, cls_name)
    if nsplits:
        return cls(d, nsplits, M // nsplits, nbits, device=device)
    return cls(d, M, nbits, device=device)


def aq_index(cls_name: str, d: int, M: int, nbits: int, metric, *, nsplits=0,
             bbs=32, aq_class="ResidualQuantizer", quantizer=None, nlist=0,
             device):
    """An untrained AQ index of faiss_tpu's class name ``cls_name``, flat
    or (with ``quantizer`` and ``nlist``) IVF; the generic classes take
    their codec from ``aq_class``."""
    metric = MetricType(metric)
    table = _IVF if cls_name in AQ_IVF_CLASSES else _FLAT
    ivf = table is _IVF
    head = (quantizer, d, nlist) if ivf else (d,)
    if cls_name in table:
        cls, product = table[cls_name]
        shape = (nsplits, M // nsplits, nbits) if product else (M, nbits)
        fs = (bbs,) if "FastScan" in cls_name else ()
        return cls(*head, *shape, metric, *fs, device=device)
    aq = aq_codec(aq_class, d, M, nbits, nsplits, device=device)
    cls = {"IndexAdditiveQuantizer": IndexAdditiveQuantizer,
           "IndexIVFAdditiveQuantizer": IndexIVFAdditiveQuantizer,
           "IndexIVFAdditiveQuantizerFastScan": IndexIVFAdditiveQuantizerFastScan,
           }[cls_name]
    fs = (bbs,) if "FastScan" in cls_name else ()
    return cls(*head, aq, metric, *fs, device=device)


def set_aq_state(aq: AdditiveQuantizer, codebooks=None, search_type=None,
                 norm_min=None, norm_max=None, qnorm=None, norm_tabs=None):
    """A codec's trained state as faiss_tpu holds it: ``codebooks``
    [M, K, d] (the embedded full-d ones for a product codec, whose
    sub-codebooks are cut from them), the search type and the norm
    codec's range and tables."""
    if search_type is not None:
        aq.set_search_type(int(search_type))
    if norm_min is not None:
        aq.norm_min, aq.norm_max = float(norm_min), float(norm_max)
    if qnorm is not None:
        aq.qnorm = np.ascontiguousarray(qnorm, np.float32)
    if norm_tabs is not None:
        aq.norm_tabs = np.ascontiguousarray(norm_tabs, np.float32)
    if codebooks is not None:
        aq.codebooks = codebooks
        if isinstance(aq, ProductAdditiveQuantizer):
            aq.set_sub_codebooks()
