"""Exact flat index (counterpart of faiss_tpu/models/flat.py, plain path).

Serves as the IVF coarse quantizer and as the refine store of
IndexRefineFlat. ``storage_dtype = np.float16`` keeps the device copy in fp16
(GpuIndexFlatConfig.useFloat16); the cached norms are those of the
fp16-rounded rows, as in faiss_tpu (flat.py:320-339). The fused, screened and
striped search paths of faiss_tpu (kernels K2 and K3) are ROADMAP queue 1
item 6, and so is search."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..base import Index
from ..metric import MetricType
from ..ops import distances as dops

_TORCH_DTYPE = {np.dtype(np.float32): torch.float32, np.dtype(np.float16): torch.float16}


class IndexFlat(Index):
    """Exact exhaustive index (reference: faiss/IndexFlat.h:23)."""

    def __init__(self, d: int, metric=MetricType.L2, *, device):
        super().__init__(d, metric, device=device)
        if self.metric_type != MetricType.L2:
            raise NotImplementedError("IndexFlat: only METRIC_L2 is ported")
        self._pending = []  # host-side adds not yet on the device
        self._xb = None  # consolidated device tensor [ntotal, d]
        self._norms = None  # float32 norms of the stored rows
        self.storage_dtype = np.float32

    def add(self, x) -> None:
        x = self._check_input(x)
        if len(x):
            self._pending.append(x)
            self.ntotal += len(x)

    def reset(self) -> None:
        self._pending = []
        self._xb = None
        self._norms = None
        self.ntotal = 0

    def _consolidate(self) -> Optional[torch.Tensor]:
        """Upload pending rows in the storage dtype; refresh the norms."""
        if self._pending:
            dt = _TORCH_DTYPE[np.dtype(self.storage_dtype)]
            new = [
                torch.from_numpy(np.require(p, requirements="W")).to(self.device, dt)
                for p in self._pending
            ]
            self._xb = torch.cat(([self._xb] if self._xb is not None else []) + new)
            self._pending = []
            self._norms = None
        if self._xb is not None and self._norms is None:
            self._norms = dops.l2_norms(self._xb)
        return self._xb

    def vectors(self) -> np.ndarray:
        """All stored vectors as numpy float32 [ntotal, d]."""
        xb = self._consolidate()
        if xb is None:
            return np.empty((0, self.d), np.float32)
        return xb.float().cpu().numpy()

    def search(self, x, k: int, *, params=None):
        raise NotImplementedError(
            "IndexFlat.search (exact k-NN, kernels K2/K3) is ROADMAP queue 1 "
            "item 6"
        )


class IndexFlatL2(IndexFlat):
    def __init__(self, d: int, *, device):
        super().__init__(d, MetricType.L2, device=device)
