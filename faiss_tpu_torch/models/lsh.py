"""IndexLSH, binary codes of (rotated) projections searched by Hamming
distance (counterpart of faiss_tpu/models/lsh.py; reference:
faiss/IndexLSH.{h,cpp}).

Vectors are projected by a random rotation (whenever ``rotate_data`` is set
or nbits != d, as faiss_tpu does), shifted by the trained per-bit
thresholds, and their signs packed ``bitorder="little"``; the codes live on
the device and a search is ops/hamming.hamming_knn there."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..base import Index, require_device
from ..metric import MetricType
from ..ops import hamming as hops
from ..transforms import RandomRotationMatrix


class IndexLSH(Index):
    """reference: IndexLSH.h:21 (faiss_tpu models/lsh.py:21)."""

    def __init__(self, d: int, nbits: int, rotate_data: bool = True,
                 train_thresholds: bool = False, *, device="cuda"):
        super().__init__(d, MetricType.L2, device=require_device(device))
        self.nbits = int(nbits)
        self.rotate_data = rotate_data
        self.train_thresholds = train_thresholds
        self.thresholds: Optional[np.ndarray] = None  # [nbits] float32
        if rotate_data or nbits != d:
            self.rrot = RandomRotationMatrix(d, nbits, device=self.device)
            self.rrot.init()
        else:
            self.rrot = None
        self.is_trained = not train_thresholds
        self.code_size = (self.nbits + 7) // 8
        self._codes = torch.zeros(0, self.code_size, dtype=torch.uint8,
                                  device=self.device)

    def _project(self, x: np.ndarray) -> torch.Tensor:
        xd = torch.from_numpy(self._check_input(x)).to(self.device)
        return self.rrot.apply_tensor(xd) if self.rrot is not None else xd

    def apply_preprocess(self, x) -> np.ndarray:
        """The projections minus the thresholds [n, nbits] float32."""
        return self._preprocess(x).cpu().numpy()

    def _preprocess(self, x) -> torch.Tensor:
        y = self._project(x)
        if self.train_thresholds and self.thresholds is not None:
            y = y - torch.from_numpy(self.thresholds).to(self.device)
        return y

    def train(self, x) -> None:
        """Per-bit thresholds = the median of the training projections,
        taken on the host by ``np.median`` (the mean of the two middle
        values; faiss_tpu :53)."""
        if self.train_thresholds:
            xt = self._project(x).cpu().numpy()
            self.thresholds = np.median(xt, axis=0).astype(np.float32)
        self.is_trained = True

    def _encode(self, x) -> torch.Tensor:
        return hops.pack_bits_tensor(self._preprocess(x) > 0)

    def sa_encode(self, x) -> np.ndarray:
        return self._encode(x).cpu().numpy()

    def sa_code_size(self) -> int:
        return self.code_size

    def add(self, x) -> None:
        self._check_trained()
        self.add_codes(self._encode(x))

    def add_codes(self, codes) -> None:
        """Append rows already encoded [n, code_size] uint8."""
        if isinstance(codes, np.ndarray):
            codes = torch.from_numpy(np.ascontiguousarray(codes, np.uint8))
        codes = codes.to(self.device, torch.uint8).reshape(-1, self.code_size)
        self._codes = torch.cat([self._codes, codes])
        self.ntotal = len(self._codes)

    @property
    def codes_host(self) -> np.ndarray:
        return self._codes.cpu().numpy()

    def search(self, x, k: int, *, params=None):
        """Hamming k-NN of the query codes, as float32 distances."""
        del params
        self._check_trained()
        q = self._encode(x)
        if self.ntotal == 0:
            return (np.full((len(q), k), np.inf, np.float32),
                    np.full((len(q), k), -1, np.int64))
        D, I = hops.hamming_knn(q, self._codes, k)
        return D.cpu().numpy().astype(np.float32), I.cpu().numpy()

    def reset(self) -> None:
        self._codes = self._codes[:0]
        self.ntotal = 0
