"""Refinement meta-index (counterpart of faiss_tpu/models/meta.py:248-459)."""

from __future__ import annotations

import numpy as np
import torch

from ..base import Index, query_buckets
from ..ops.distances import rerank_exact
from .flat import IndexFlat
from .ivf_pq import IndexIVFPQ


class IndexRefine(Index):
    """Re-rank base-index candidates with a refinement index
    (reference: IndexRefine.h:24).

    Ported: an IndexIVFPQ base with a flat refine store and no selector.
    With nq at or above the base's big_batch_threshold, k * k_factor <= 128,
    a by-residual base and a store its kernels read (the decoded store, or
    4-bit codes), the base search and the exact re-rank of its top
    k * k_factor candidates run in one device pass per sub-batch
    (IndexIVFPQ._sbbr_submit), at any nprobe, strict or soft, over the
    decoded store or the codes. Otherwise the base's own search returns
    k * k_factor candidates, which are re-ranked exactly on the device
    (faiss_tpu :401). Other bases, refine stores and selectors raise
    NotImplementedError naming their ROADMAP item."""

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

    def _fused_refined_nprobe(self, x, kc, params):
        """nprobe of the fused search + re-rank path (faiss_tpu :295), or
        None where the base searches on its own first."""
        base = self.base_index
        if not (isinstance(self.refine_index, IndexFlat)
                and isinstance(base, IndexIVFPQ)):
            raise NotImplementedError(
                "IndexRefine: only a flat refine store over IndexIVFPQ is "
                "ported (ROADMAP queue 1 items 8-10)"
            )
        if params is not None and params.sel is not None:
            raise NotImplementedError("ID selectors are ROADMAP queue 1 item 1")
        if not self.refine_index.ntotal:
            raise RuntimeError("the index is empty")
        if not (base.big_batch_threshold and len(x) >= base.big_batch_threshold
                and base.by_residual and kc <= 128):
            return None
        if base.pq.ksub > 16 and base._build_brute()["yT"] is None:
            return None  # 8-bit codes with no decoded store: no kernel
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
        if nprobe is None:
            return ("eager", self._search_rerank(x, k, kc, params))
        xb = self.refine_index._consolidate()
        return (
            "fused",
            self.base_index._sbbr_submit(
                x, k, kc, xb, nprobe, self.refine_index._norms
            ),
        )

    def _search_rerank(self, x, k, kc, params):
        """The base's search for ``kc`` candidates, then their exact re-rank
        against the refine store, per query bucket on the device."""
        _, Ic = self.base_index.search(x, kc, params=params)
        xb = self.refine_index._consolidate()
        D = np.full((len(x), k), np.inf, np.float32)
        I = np.full((len(x), k), -1, np.int64)
        for start, _, real in query_buckets(len(x)):
            sl = slice(start, start + real)
            d, i = rerank_exact(
                torch.from_numpy(x[sl]).to(self.device), xb,
                torch.from_numpy(Ic[sl]).to(self.device), k,
                xb_n2=self.refine_index._norms,
            )
            D[sl, : d.shape[1]] = d.cpu().numpy()
            I[sl, : d.shape[1]] = i.cpu().numpy()
        return D, I

    def search_collect(self, handle):
        tag, st = handle
        if tag == "fused":
            return self.base_index._sbbr_collect(st)
        return st

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
