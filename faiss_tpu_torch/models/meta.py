"""Refinement meta-index (counterpart of faiss_tpu/models/meta.py:248-459)."""

from __future__ import annotations

import numpy as np

from ..base import Index
from .flat import IndexFlat
from .ivf_pq import IndexIVFPQ


class IndexRefine(Index):
    """Re-rank base-index candidates with a refinement index
    (reference: IndexRefine.h:24).

    Ported path: an IndexIVFPQ base with a flat refine store, nq at or above
    the base's big_batch_threshold, k * k_factor <= 128 and no selector. The
    base search and the exact re-rank of its top k * k_factor candidates then
    run in one device pass per sub-batch (IndexIVFPQ._sbbr_submit), at any
    nprobe, strict or soft, over the decoded store or the codes. Every other
    case raises NotImplementedError naming its ROADMAP item."""

    def __init__(self, base_index: Index, refine_index: Index):
        super().__init__(
            base_index.d, base_index.metric_type, device=base_index.device
        )
        self.base_index = base_index
        self.refine_index = refine_index
        self.k_factor = 1.0
        self.ntotal = base_index.ntotal
        self.is_trained = base_index.is_trained and refine_index.is_trained

    def train(self, x) -> None:
        self.base_index.train(x)
        self.refine_index.train(x)
        self.is_trained = True

    def add(self, x) -> None:
        x = self._check_input(x)
        self.base_index.add(x)
        self.refine_index.add(x)
        self.ntotal = self.base_index.ntotal

    def reset(self) -> None:
        self.base_index.reset()
        self.refine_index.reset()
        self.ntotal = 0

    def _fused_refined_nprobe(self, x, kc, params) -> int:
        """nprobe of the fused search + re-rank path (faiss_tpu :295)."""
        base = self.base_index
        if not (isinstance(self.refine_index, IndexFlat)
                and isinstance(base, IndexIVFPQ)):
            raise NotImplementedError(
                "IndexRefine: only a flat refine store over IndexIVFPQ is "
                "ported (ROADMAP queue 1 items 5-10)"
            )
        if not (base.big_batch_threshold and len(x) >= base.big_batch_threshold):
            raise NotImplementedError(
                f"nq={len(x)} is below big_batch_threshold="
                f"{base.big_batch_threshold}: the per-probe scan is ROADMAP "
                "queue 1 item 5"
            )
        if kc > 128:
            raise NotImplementedError(
                f"k * k_factor = {kc} > 128 candidates: larger K1 outputs "
                "are ROADMAP queue 2"
            )
        if params is not None and params.sel is not None:
            raise NotImplementedError("ID selectors are ROADMAP queue 1 item 1")
        if not self.refine_index.ntotal:
            raise RuntimeError("the index is empty")
        nprobe = base.nprobe
        if params is not None and getattr(params, "nprobe", 0):
            nprobe = params.nprobe
        return min(nprobe, base.nlist)

    def search_submit(self, x, k, *, params=None):
        """Enqueue the search of every sub-batch on the device; the matching
        :meth:`search_collect` waits for and returns (D, I)."""
        x = self._check_input(x)
        kc = max(k, int(round(k * self.k_factor)))
        nprobe = self._fused_refined_nprobe(x, kc, params)
        xb = self.refine_index._consolidate()
        return (
            "fused",
            self.base_index._sbbr_submit(
                x, k, kc, xb, nprobe, self.refine_index._norms
            ),
        )

    def search_collect(self, handle):
        tag, st = handle
        if tag == "fused":
            return self.base_index._sbbr_collect(st)
        return super().search_collect(handle)

    def search(self, x, k, *, params=None):
        return self.search_collect(self.search_submit(x, k, params=params))


class IndexRefineFlat(IndexRefine):
    """Refine against exact vectors (IndexRefine.h:82).

    ``store_float16`` keeps the refine store in fp16 (the
    GpuIndexFlatConfig.useFloat16 analogue): half the device memory at
    ~2^-11 rounding, immaterial for re-ranking a candidate set."""

    def __init__(self, base_index: Index, xb=None, store_float16: bool = False):
        refine = IndexFlat(base_index.d, base_index.metric_type,
                           device=base_index.device)
        if store_float16:
            refine.storage_dtype = np.float16
        if xb is not None:
            refine.add(xb)
        super().__init__(base_index, refine)
