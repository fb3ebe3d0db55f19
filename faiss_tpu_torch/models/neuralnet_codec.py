"""IndexNeuralNetCodec and IndexQINCo (counterpart of
faiss_tpu/models/neuralnet_codec.py; reference: faiss/IndexNeuralNetCodec.h).

A neural codec as an index: codes at ``add``, and a search that decodes the
codes once into the port's IndexFlat and runs its exact search (kept until
the next ``add`` or ``reset``). The net is a ``nn.Module`` on the index's
device whose ``encode`` takes float32 rows and ``decode`` int64 codes, as
utils/neuralnet.QINCo does. ``sa_encode`` packs the codes as PQ codes of
``nbits`` bits (faiss_tpu's bytes)."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..base import Index
from ..codecs.pq import ProductQuantizer
from ..metric import MetricType
from ..utils.neuralnet import QINCo, train_qinco
from .flat import IndexFlat


class IndexNeuralNetCodec(Index):
    """reference: IndexNeuralNetCodec.h:20."""

    def __init__(self, d: int, M: int, nbits: int = 8, net=None, *,
                 device="cuda"):
        super().__init__(d, MetricType.L2, device=device)
        self.M = int(M)
        self.nbits = int(nbits)
        self.net = net
        self.is_trained = net is not None
        self._codes: Optional[torch.Tensor] = None  # [n, M] int32
        self._flat: Optional[IndexFlat] = None  # the decoded rows

    def set_net(self, net) -> None:
        self.net = net
        self.is_trained = True
        self._flat = None

    def train(self, x) -> None:
        raise RuntimeError(
            "neural codecs are trained externally; call set_net() with a "
            "trained model (the reference IndexNeuralNetCodec has the same "
            "contract), or use IndexQINCo.train()"
        )

    def _packer(self) -> ProductQuantizer:
        """The PQ bit packing of M codes of nbits each (only its packing is
        used)."""
        pq = ProductQuantizer.__new__(ProductQuantizer)
        pq.M, pq.nbits, pq.code_size = self.M, self.nbits, self.sa_code_size()
        return pq

    def sa_code_size(self) -> int:
        return (self.M * self.nbits + 7) // 8

    def _encode(self, x: np.ndarray) -> torch.Tensor:
        return self.net.encode(torch.from_numpy(x).to(self.device))

    def _decode(self, codes: torch.Tensor) -> torch.Tensor:
        return self.net.decode(codes.to(self.device).long()).float()

    def sa_encode(self, x) -> np.ndarray:
        codes = self._encode(self._check_input(x)).cpu().numpy()
        return self._packer().pack_codes(codes.astype(np.uint16))

    def sa_decode(self, codes) -> np.ndarray:
        unpacked = self._packer().unpack_codes(np.ascontiguousarray(codes, np.uint8))
        return self._decode(torch.from_numpy(unpacked.astype(np.int64))).cpu().numpy()

    def add(self, x) -> None:
        x = self._check_input(x)
        self._check_trained()
        codes = self._encode(x).to(torch.int32)
        self._codes = codes if self._codes is None else torch.cat([self._codes, codes])
        self.ntotal += len(x)
        self._flat = None

    def search(self, x, k: int, *, params=None):
        if self._flat is None:
            self._flat = IndexFlat(self.d, self.metric_type, device=self.device)
            if self.ntotal:
                self._flat.add(self._decode(self._codes).cpu().numpy())
        return self._flat.search(x, k, params=params)

    def reconstruct_n(self, n0: int, ni: int) -> np.ndarray:
        return self._decode(self._codes[n0 : n0 + ni]).cpu().numpy()

    def reset(self) -> None:
        self._codes = self._flat = None
        self.ntotal = 0


class IndexQINCo(IndexNeuralNetCodec):
    """reference: IndexNeuralNetCodec.h IndexQINCo."""

    def __init__(self, d: int, M: int, nbits: int, L: int = 2, h: int = 256, *,
                 device="cuda"):
        super().__init__(d, M, nbits, device=device)
        self.qinco = QINCo(d, 1 << nbits, L, M, h).to(self.device)
        self.net = self.qinco
        self.is_trained = False  # until weights are loaded

    def load_state(self, state) -> None:
        self.qinco.load_state(state)
        self.is_trained = True
        self._flat = None

    def train(self, x, epochs: int = 30, batch: int = 1024, lr: float = 1e-3,
              verbose: bool = False) -> None:
        """QINCo training on the device (utils/neuralnet.train_qinco)."""
        x = self._check_input(x)
        self.qinco = train_qinco(x, K=1 << self.nbits, M=self.M, L=self.qinco.L,
                                 h=self.qinco.h, epochs=epochs, batch=batch, lr=lr,
                                 verbose=verbose, device=self.device)
        self.set_net(self.qinco)
