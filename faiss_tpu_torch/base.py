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


def require_device(device) -> torch.device:
    """``device`` as a torch.device. A CUDA device needs a card: the port's
    entry points never fall back to the CPU on their own."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA card; pass device='cpu' to build the index on the CPU"
        )
    return dev


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
        self.sel = sel  # IDSelector


class Index:
    """Abstract index over float32 vectors (reference: faiss/Index.h:101).

    ``device`` is required: every tensor the index owns lives there.
    ``metric_arg`` is the metric's parameter (p of METRIC_Lp;
    faiss_tpu/base.py:118)."""

    def __init__(self, d: int, metric_type, metric_arg: float = 0.0, *, device):
        self.d = int(d)
        self.metric_type = MetricType(metric_type)
        self.metric_arg = float(metric_arg)
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

    def add_with_ids(self, x, ids) -> None:
        raise NotImplementedError(
            f"{type(self).__name__} does not support add_with_ids; "
            "wrap with IndexIDMap"
        )

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

    def range_search(self, x, radius: float, *, params=None):
        """All stored vectors within ``radius`` of each query, as a
        RangeSearchResult; indexes that support it override this."""
        raise NotImplementedError(
            f"{type(self).__name__} does not support range_search"
        )

    # -- reconstruction (faiss_tpu/base.py:179-190) ---------------------------
    def reconstruct(self, key: int) -> np.ndarray:
        return self.reconstruct_n(key, 1)[0]

    def reconstruct_n(self, n0: int, ni: int) -> np.ndarray:
        raise NotImplementedError(
            f"{type(self).__name__} does not support reconstruct_n"
        )

    def reconstruct_batch(self, keys) -> np.ndarray:
        keys = np.asarray(keys, dtype=np.int64)
        out = np.empty((len(keys), self.d), dtype=np.float32)
        for i, key in enumerate(keys):
            out[i] = self.reconstruct(int(key))
        return out

    # -- mutation -----------------------------------------------------------
    def reset(self) -> None:
        raise NotImplementedError

    def remove_ids(self, sel) -> int:
        raise NotImplementedError(
            f"{type(self).__name__} does not support remove_ids"
        )

    def merge_from(self, other: "Index", add_id: int = 0) -> None:
        raise NotImplementedError(
            f"{type(self).__name__} does not support merge_from"
        )

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


def sel_mask(params, ids: np.ndarray, device) -> Optional[torch.Tensor]:
    """The keep-mask of ``params.sel`` over the id array ``ids`` (the
    index's ids in slot order), made once on the host and moved to
    ``device`` once; None without a selector."""
    if params is None or getattr(params, "sel", None) is None:
        return None
    return torch.from_numpy(
        np.ascontiguousarray(params.sel.mask_for_ids(ids), bool)
    ).to(device)


# -- ID selectors (faiss_tpu/base.py:234-325, impl/IDSelector.h) -------------
# A selector renders to a boolean keep-mask over an id array (numpy), made
# once per search and applied on the device as a score mask.


class IDSelector:
    """Subset-of-ids predicate (reference: faiss/impl/IDSelector.h)."""

    def mask_for_ids(self, ids: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def is_member(self, i: int) -> bool:
        return bool(self.mask_for_ids(np.array([i], dtype=np.int64))[0])


class IDSelectorRange(IDSelector):
    """Keep ids in [imin, imax) (IDSelector.h:23)."""

    def __init__(self, imin: int, imax: int):
        self.imin, self.imax = int(imin), int(imax)

    def mask_for_ids(self, ids):
        return (ids >= self.imin) & (ids < self.imax)


class IDSelectorArray(IDSelector):
    """Keep an explicit id list (IDSelector.h:45)."""

    def __init__(self, ids):
        self.ids = np.unique(np.asarray(ids, dtype=np.int64))

    def mask_for_ids(self, ids):
        if len(self.ids) == 0:
            return np.zeros(np.shape(ids), bool)
        pos = np.clip(np.searchsorted(self.ids, ids), 0, len(self.ids) - 1)
        return self.ids[pos] == ids


class IDSelectorBatch(IDSelectorArray):
    """Hash-set selector (IDSelector.h:60); the same mask semantics here."""


class IDSelectorBitmap(IDSelector):
    """Bitmap over [0, 8 * len(bitmap)), bit i of byte i >> 3 little-endian
    (IDSelector.h:88)."""

    def __init__(self, bitmap: np.ndarray):
        self.bitmap = np.asarray(bitmap, dtype=np.uint8)

    def mask_for_ids(self, ids):
        byte = self.bitmap[np.clip(ids >> 3, 0, len(self.bitmap) - 1)]
        ok = (byte >> (ids & 7).astype(np.uint8)) & 1
        in_range = (ids >= 0) & ((ids >> 3) < len(self.bitmap))
        return (ok == 1) & in_range


class IDSelectorNot(IDSelector):
    def __init__(self, sel: IDSelector):
        self.sel = sel

    def mask_for_ids(self, ids):
        return ~self.sel.mask_for_ids(ids)


class IDSelectorAnd(IDSelector):
    def __init__(self, lhs: IDSelector, rhs: IDSelector):
        self.lhs, self.rhs = lhs, rhs

    def mask_for_ids(self, ids):
        return self.lhs.mask_for_ids(ids) & self.rhs.mask_for_ids(ids)


class IDSelectorOr(IDSelector):
    def __init__(self, lhs: IDSelector, rhs: IDSelector):
        self.lhs, self.rhs = lhs, rhs

    def mask_for_ids(self, ids):
        return self.lhs.mask_for_ids(ids) | self.rhs.mask_for_ids(ids)


class IDSelectorXOr(IDSelector):
    def __init__(self, lhs: IDSelector, rhs: IDSelector):
        self.lhs, self.rhs = lhs, rhs

    def mask_for_ids(self, ids):
        return self.lhs.mask_for_ids(ids) ^ self.rhs.mask_for_ids(ids)


class IDSelectorAll(IDSelector):
    def mask_for_ids(self, ids):
        return np.ones(np.shape(ids), dtype=bool)


class RangeSearchResult:
    """CSR range search result (reference: impl/AuxIndexStructures.h:35):
    ``lims`` has nq + 1 entries and query i's results are
    ``labels[lims[i]:lims[i + 1]]`` with their ``distances``."""

    def __init__(self, lims: np.ndarray, distances: np.ndarray,
                 labels: np.ndarray):
        self.lims = lims
        self.distances = distances
        self.labels = labels

    @property
    def nq(self):
        return len(self.lims) - 1


def range_result(parts, nq: int) -> RangeSearchResult:
    """Assemble a RangeSearchResult on the host from per-tile hits
    ``parts``: (query rows int64, distances float32, labels int64) each.
    Within a query, hits keep the order in which the tiles were scanned."""
    if parts:
        q = np.concatenate([p[0] for p in parts])
        dist = np.concatenate([p[1] for p in parts]).astype(np.float32)
        lab = np.concatenate([p[2] for p in parts]).astype(np.int64)
    else:
        q = np.empty(0, np.int64)
        dist, lab = np.empty(0, np.float32), np.empty(0, np.int64)
    order = np.argsort(q, kind="stable")
    lims = np.zeros(nq + 1, np.uint64)
    lims[1:] = np.cumsum(np.bincount(q, minlength=nq)).astype(np.uint64)
    return RangeSearchResult(lims, dist[order], lab[order])
