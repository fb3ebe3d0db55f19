"""Index base class of the PyTorch port (counterpart of faiss_tpu/base.py).

Indexes are Python objects holding tensors on one explicit ``device`` plus
small config; the numerical work is plain PyTorch or a hand-written kernel.
The API boundary is numpy: vectors in as float32 arrays, results out as
(D float32 [nq, k], I int64 [nq, k]).

Semantics kept from the reference (faiss/Index.h:95-430):
  - "no result" is id -1 with distance +inf (min metrics);
  - METRIC_L2 returns *squared* L2;
  - ``add`` assigns sequential ids ntotal..ntotal+n-1.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .metric import MetricType

# Queries are searched in padded power-of-two batches. The zero-padded rows
# take part in the home-group sort and the per-tile worklists of the
# dynamic-chunk scan, so padding the same way as faiss_tpu is part of parity.
MIN_QUERY_BUCKET = 128
MAX_QUERY_BATCH = 8192

# Max bytes of one add page's f32 working set (gpu/GpuIndex.cu:474
# kAddPageSize analogue): bulk adds are paged so the device-side assign and
# encode chain stays bounded whatever the caller hands to add().
ADD_PAGE_BYTES = 512 << 20


def add_page_rows(d: int) -> int:
    """Rows per add page so one page's f32 copy is <= ADD_PAGE_BYTES."""
    return max(1 << 10, ADD_PAGE_BYTES // (4 * max(int(d), 1)))


def query_buckets(nq: int, max_batch: int = MAX_QUERY_BATCH):
    """Split nq into (start, padded_len, real_len) power-of-two buckets
    (faiss_tpu/base.py:93)."""
    out = []
    start = 0
    while start < nq:
        real = min(nq - start, max_batch)
        padded = MIN_QUERY_BUCKET
        while padded < real:
            padded *= 2
        out.append((start, padded, real))
        start += real
    return out


class SearchParameters:
    """Per-call search options (reference: faiss/Index.h:88)."""

    def __init__(self, sel=None):
        self.sel = sel  # IDSelector (not supported by the port yet)


class Index:
    """Abstract index over float32 vectors (reference: faiss/Index.h:101).

    ``device`` is required: every tensor the index owns lives there."""

    def __init__(self, d: int, metric_type, *, device):
        self.d = int(d)
        self.metric_type = MetricType(metric_type)
        self.device = torch.device(device)
        self.ntotal = 0
        self.is_trained = True
        self.verbose = False

    def train(self, x) -> None:
        """Train on representative vectors; default no-op (Index.h:148)."""
        del x
        self.is_trained = True

    def add(self, x) -> None:
        raise NotImplementedError

    def search(
        self, x, k: int, *, params: Optional[SearchParameters] = None
    ) -> Tuple[np.ndarray, np.ndarray]:
        raise NotImplementedError

    def search_submit(self, x, k: int, *, params=None):
        """Enqueue a search without waiting for its results; pair with
        :meth:`search_collect`. Indexes with a device path override this;
        the default runs the search at once."""
        return ("eager", self.search(x, k, params=params))

    def search_collect(self, handle):
        """Wait for and return (D, I) of a :meth:`search_submit` handle."""
        tag, st = handle
        if tag != "eager":
            raise ValueError(f"unknown search handle {tag!r}")
        return st

    def reset(self) -> None:
        raise NotImplementedError

    def _check_input(self, x) -> np.ndarray:
        x = np.ascontiguousarray(x, dtype=np.float32)
        if x.ndim == 1:
            if x.size % self.d != 0:
                raise ValueError(
                    f"vector size {x.size} not multiple of d={self.d}"
                )
            x = x.reshape(-1, self.d)
        if x.ndim != 2 or x.shape[1] != self.d:
            raise ValueError(f"expected [n, {self.d}] array, got {x.shape}")
        return x

    def _check_trained(self):
        if not self.is_trained:
            raise RuntimeError(
                f"{type(self).__name__} is not trained; call train() first"
            )

    def __repr__(self):
        return (
            f"{type(self).__name__}(d={self.d}, ntotal={self.ntotal}, "
            f"metric={self.metric_type.name}, device={self.device})"
        )
