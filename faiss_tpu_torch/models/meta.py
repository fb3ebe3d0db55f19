"""The id-map and refinement meta-indexes (counterpart of
faiss_tpu/models/meta.py:157-459)."""

from __future__ import annotations

import numpy as np
import torch

from ..base import IDSelectorArray, Index, query_buckets
from ..metric import MetricType, is_similarity_metric
from ..ops.distances import rerank_exact
from .flat import IndexFlat
from .ivf import IndexIVF
from .ivf_pq import IndexIVFPQ


class IndexIDMap(Index):
    """Arbitrary 64-bit ids over an index that numbers its rows 0..n-1
    (reference: IndexIDMap.h:21; faiss_tpu meta.py:157). ``id_map[i]`` is
    the id of the inner index's row i; results are translated through it,
    and a selector of the search parameters sees the translated ids."""

    def __init__(self, index: Index):
        super().__init__(index.d, index.metric_type, device=index.device)
        self.index = index
        self.id_map = np.empty(0, np.int64)
        self.is_trained = index.is_trained

    def train(self, x) -> None:
        self.index.train(x)
        self.is_trained = True

    def add(self, x) -> None:
        raise RuntimeError("add_with_ids required for IndexIDMap")

    def add_with_ids(self, x, ids) -> None:
        ids = np.asarray(ids, np.int64).ravel()
        x = self._check_input(x)
        if len(ids) != len(x):
            raise ValueError("ids and x differ in length")
        self.index.add(x)
        self.id_map = np.concatenate([self.id_map, ids])
        self.ntotal = self.index.ntotal

    def _translate(self, I: np.ndarray) -> np.ndarray:
        return np.where(I >= 0, self.id_map[np.maximum(I, 0)], -1)

    def search(self, x, k, *, params=None):
        if params is not None and params.sel is not None:
            params = _TranslatedParams(params, self.id_map)
        D, I = self.index.search(x, k, params=params)
        return D, self._translate(I)

    def range_search(self, x, radius, *, params=None):
        if params is not None and params.sel is not None:
            params = _TranslatedParams(params, self.id_map)
        res = self.index.range_search(x, radius, params=params)
        res.labels = self._translate(res.labels)
        return res

    def reset(self) -> None:
        self.index.reset()
        self.id_map = np.empty(0, np.int64)
        self.ntotal = 0

    def remove_ids(self, sel) -> int:
        """Remove the rows whose ids ``sel`` selects. The inner index then
        numbers its rows 0..n-1 again: flat indexes move their rows up, and
        an IVF index, whose lists keep their ids, is renumbered here."""
        keep = ~sel.mask_for_ids(self.id_map)
        removed = self.index.remove_ids(
            IDSelectorArray(np.nonzero(~keep)[0].astype(np.int64)))
        if isinstance(self.index, IndexIVF):
            self.index._ids_host = np.arange(self.index.ntotal, dtype=np.int64)
        self.id_map = self.id_map[keep]
        self.ntotal = self.index.ntotal
        return removed


class _TranslatedParams:
    """Search parameters whose selector sees external ids
    (IDSelectorTranslated, IndexIDMap.cpp)."""

    def __init__(self, params, id_map):
        self.__dict__.update(vars(params))
        self.sel = _TranslatedSelector(params.sel, id_map)


class _TranslatedSelector:
    def __init__(self, sel, id_map):
        self.sel = sel
        self.id_map = id_map

    def mask_for_ids(self, ids):
        ids = np.asarray(ids, np.int64)
        ext = np.where(
            (ids >= 0) & (ids < len(self.id_map)),
            self.id_map[np.clip(ids, 0, max(len(self.id_map) - 1, 0))],
            -1,
        )
        return self.sel.mask_for_ids(ext)


class IndexIDMap2(IndexIDMap):
    """IndexIDMap that also reconstructs by id (IndexIDMap.h:78)."""

    def reconstruct(self, key):
        pos = np.nonzero(self.id_map == key)[0]
        if len(pos) == 0:
            raise KeyError(f"id {key} not found")
        return self.index.reconstruct(int(pos[0]))

    def reconstruct_batch(self, keys) -> np.ndarray:
        keys = np.asarray(keys, np.int64).ravel()
        order = np.argsort(self.id_map, kind="stable")
        pos = np.searchsorted(self.id_map, keys, sorter=order)
        pos = order[np.clip(pos, 0, max(len(order) - 1, 0))]
        bad = self.id_map[pos] != keys if len(order) else np.ones(len(keys), bool)
        if bad.any():
            raise KeyError(f"id {keys[bad][0]} not found")
        return self.index.reconstruct_batch(pos)


class IndexRefine(Index):
    """Re-rank base-index candidates with a refinement index
    (reference: IndexRefine.h:24).

    Ported: an IndexIVFPQ base with a flat refine store (float32, fp16 or
    SQ8 codes: IndexFlatSQ8, Refine(SQ8)). With nq at or above the base's
    big_batch_threshold, k * k_factor <= 128, an L2 by-residual base, no
    selector and a store its kernels read (the decoded store, or 4-bit
    codes), the base search and the exact re-rank of its top k * k_factor
    candidates run in one device pass per sub-batch
    (IndexIVFPQ._sbbr_submit), at any nprobe, strict or soft, over the
    decoded store or the codes. Otherwise (a selector among them) the
    base's own search returns k * k_factor candidates, which are re-ranked
    exactly on the device (faiss_tpu :365-392). An SQ8 store dequantizes
    the gathered rows after the gather on both paths. Other bases and
    refine stores raise NotImplementedError naming their ROADMAP item."""

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
                "IndexRefine: only a flat or SQ8 flat refine store over "
                "IndexIVFPQ is ported (ROADMAP queue 1 item 8)"
            )
        if not self.refine_index.ntotal:
            raise RuntimeError("the index is empty")
        if not (base.big_batch_threshold and len(x) >= base.big_batch_threshold
                and base.by_residual and kc <= 128
                and base.metric_type == MetricType.L2
                and (params is None or params.sel is None)):
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
                x, k, kc, xb, nprobe, self.refine_index._norms,
                refine_sq=self._refine_sq(),
            ),
        )

    def _refine_sq(self):
        """(scale, off) on the device where the refine store holds SQ8 codes
        (decode = row * scale + off), else None (faiss_tpu :343)."""
        fn = getattr(self.refine_index, "_sq_params", None)
        return fn() if fn is not None else None

    def _search_rerank(self, x, k, kc, params):
        """The base's search for ``kc`` candidates, then their exact re-rank
        against the refine store, per query bucket on the device."""
        _, Ic = self.base_index.search(x, kc, params=params)
        xb = self.refine_index._consolidate()
        sq = self._refine_sq() or (None, None)
        largest = is_similarity_metric(self.metric_type)
        D = np.full((len(x), k), -np.inf if largest else np.inf, np.float32)
        I = np.full((len(x), k), -1, np.int64)
        for start, _, real in query_buckets(len(x)):
            sl = slice(start, start + real)
            d, i = rerank_exact(
                torch.from_numpy(x[sl]).to(self.device), xb,
                torch.from_numpy(Ic[sl]).to(self.device), k,
                metric=self.metric_type, xb_n2=self.refine_index._norms,
                sq_scale=sq[0], sq_off=sq[1],
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

    def reconstruct(self, key):
        return self.refine_index.reconstruct(key)

    def reconstruct_batch(self, keys):
        return self.refine_index.reconstruct_batch(keys)


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
