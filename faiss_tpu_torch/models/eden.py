"""IndexEDEN and IndexIVFEDEN (counterpart of faiss_tpu/models/eden.py;
reference: faiss/IndexEDEN.{h,cpp}, faiss/IndexIVFEDEN.{h,cpp}).

The EDEN L2 estimator

    D(x, i) = ||x - c||^2 + l2_i - 2 scale_i <x - c, q_i>

is an L2 scan against the scaled codes y_i = scale_i q_i whose norm term is
replaced by l2_i (unbiased EDEN stores the true residual norm there: D is an
unbiased estimate of the distance, not the distance to the reconstruction).
The flat index runs ops/distances.knn with those norms; inner product scans
the reconstructions c + y_i. The IVF index folds each list's centroid in,
z_i = c_l + y_i and t_i = ||c_l||^2 + 2 <c_l, y_i> + l2_i, and scans by probe
with ``code_norms`` = t_i (IndexIVF's padded layout and
ops/ivf_ops.ivf_flat_scan). Codes and factors live on the index's device."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..base import Index, sel_mask
from ..codecs.eden import EDENQuantizer, EDENScaleType
from ..metric import MetricType
from ..ops import distances as dops
from .ivf import IndexIVF


def _check_metric(metric):
    if MetricType(metric) not in (MetricType.L2, MetricType.INNER_PRODUCT):
        raise ValueError("EDEN supports only L2 and inner product")


class IndexEDEN(Index):
    """Flat EDEN index (reference: IndexEDEN.h:15)."""

    def __init__(self, d: int, metric=MetricType.L2, nb_bits: int = 1,
                 scale_type: EDENScaleType = EDENScaleType.UNBIASED, *,
                 device="cuda"):
        _check_metric(metric)
        super().__init__(d, metric, device=device)
        self.eden = EDENQuantizer(d, nb_bits, scale_type, device=self.device)
        self.center = np.zeros(d, np.float32)
        self.code_size = self.eden.code_size
        self.is_trained = False
        self._codes: Optional[torch.Tensor] = None  # [n, d] uint8
        self._factors: Optional[torch.Tensor] = None  # [n, 2] float32
        self._dev = None  # (scanned rows, their norm terms or None)

    def train(self, x) -> None:
        x = self._check_input(x)
        if len(x):
            self.center = x.mean(0).astype(np.float32)
        self.is_trained = True

    def _center_dev(self) -> torch.Tensor:
        return torch.from_numpy(self.center).to(self.device)

    def add(self, x) -> None:
        x = self._check_input(x)
        self._check_trained()
        codes, factors = self.eden.encode(torch.from_numpy(x).to(self.device),
                                          self._center_dev())
        self.add_codes(codes, factors)

    def add_codes(self, codes, factors) -> None:
        """Append unpacked codes [n, d] uint8 and factors [n, 2] float32
        (tensors, or host arrays)."""
        codes = torch.as_tensor(codes, device=self.device).to(torch.uint8)
        factors = torch.as_tensor(factors, device=self.device).float()
        self._codes = codes if self._codes is None else torch.cat([self._codes, codes])
        self._factors = (factors if self._factors is None
                         else torch.cat([self._factors, factors]))
        self.ntotal += len(codes)
        self._dev = None

    def reset(self) -> None:
        self._codes = self._factors = self._dev = None
        self.ntotal = 0

    @property
    def codes_host(self) -> np.ndarray:
        return self._codes.cpu().numpy()

    @property
    def factors_host(self) -> np.ndarray:
        return self._factors.cpu().numpy()

    def _device_rows(self):
        """(y [n, d], l2 [n]) for L2, (c + y, None) for inner product."""
        if self._dev is None:
            y = self.eden.scaled(self._codes, self._factors)
            if self.metric_type == MetricType.L2:
                self._dev = (y, self._factors[:, 0].contiguous())
            else:
                self._dev = (y + self._center_dev(), None)
        return self._dev

    def search(self, x, k: int, *, params=None):
        """The estimator's k-NN over every code (faiss_tpu eden.py:96)."""
        x = self._check_input(x)
        nq = len(x)
        largest = self.metric_type == MetricType.INNER_PRODUCT
        if self.ntotal == 0:
            return (np.full((nq, k), -np.inf if largest else np.inf, np.float32),
                    np.full((nq, k), -1, np.int64))
        y, l2 = self._device_rows()
        mask = sel_mask(params, np.arange(self.ntotal, dtype=np.int64), self.device)
        xq = torch.from_numpy(x).to(self.device)
        if self.metric_type == MetricType.L2:
            xq = xq - self._center_dev()
        D, I = dops.knn(xq, y, k, metric=self.metric_type, y_norms=l2, y_mask=mask)
        return D.cpu().numpy(), I.cpu().numpy().astype(np.int64)

    def reconstruct_n(self, n0: int, ni: int) -> np.ndarray:
        return self.eden.decode(self._codes[n0 : n0 + ni],
                                self._factors[n0 : n0 + ni],
                                self._center_dev()).cpu().numpy()

    def reconstruct(self, key: int) -> np.ndarray:
        return self.reconstruct_n(key, 1)[0]

    def sa_code_size(self) -> int:
        return self.eden.code_size

    def sa_encode(self, x) -> np.ndarray:
        x = torch.from_numpy(self._check_input(x)).to(self.device)
        codes, factors = self.eden.encode(x, self._center_dev())
        return self.eden.pack(codes.cpu().numpy(), factors.cpu().numpy())

    def sa_decode(self, data) -> np.ndarray:
        codes, factors = self.eden.unpack(np.asarray(data, np.uint8))
        return self.eden.decode(torch.from_numpy(codes).to(self.device),
                                torch.from_numpy(factors).to(self.device),
                                self._center_dev()).cpu().numpy()


class IndexIVFEDEN(IndexIVF):
    """IVF with EDEN codes of the residuals (reference: IndexIVFEDEN.h:18);
    the lists hold faiss_tpu's packed bytes, searched by probe."""

    def __init__(self, quantizer, d: int, nlist: int, metric=MetricType.L2,
                 nb_bits: int = 1,
                 scale_type: EDENScaleType = EDENScaleType.UNBIASED, *,
                 device="cuda"):
        _check_metric(metric)
        super().__init__(quantizer, d, nlist, metric, device=device)
        self.eden = EDENQuantizer(d, nb_bits, scale_type, device=self.device)
        self.by_residual = True
        self.code_size = self.eden.code_size

    def encode_vectors(self, x: torch.Tensor, listnos: torch.Tensor) -> np.ndarray:
        codes, factors = self.eden.encode(x, self._centroids_dev()[listnos.long()])
        return self.eden.pack(codes.cpu().numpy(), factors.cpu().numpy())

    def decode_vectors(self, codes: np.ndarray, listnos: np.ndarray) -> np.ndarray:
        c, f = self.eden.unpack(codes)
        cents = self._centroids_dev()[torch.from_numpy(
            np.asarray(listnos, np.int64)).to(self.device)]
        return self.eden.decode(torch.from_numpy(c).to(self.device),
                                torch.from_numpy(f).to(self.device),
                                cents).cpu().numpy()

    def _stage_codes(self, order, offsets, lengths, max_len):
        """The padded layout of the by-probe scan over z = c_l + y and, for
        L2, code_norms t = ||c_l||^2 + 2 <c_l, y> + l2 (faiss_tpu
        eden.py:180)."""
        sid = self._slot_ids(order, offsets, max_len)
        dev = self.device
        if self.ntotal:
            c, f = self.eden.unpack(self._codes_host)
            f = torch.from_numpy(f).to(dev)
            cents = self._centroids_dev()[torch.from_numpy(
                self._listnos_host.astype(np.int64)).to(dev)]
            y = self.eden.scaled(torch.from_numpy(c).to(dev), f)
            z = cents + y
            t = (cents * cents).sum(1) + 2.0 * (cents * y).sum(1) + f[:, 0]
        else:
            z = torch.zeros(0, self.d, device=dev)
            t = torch.zeros(0, device=dev)
        return {
            "codes": self._padded(sid, z, 0.0),
            "slot_ids": sid,
            "lengths": torch.from_numpy(lengths).to(dev),
            "code_norms": (self._padded(sid, t, float("inf"))
                           if self.metric_type == MetricType.L2 else None),
        }

    def sa_code_size(self) -> int:
        return self.eden.code_size
