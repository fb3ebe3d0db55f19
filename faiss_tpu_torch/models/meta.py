"""The meta-indexes (counterpart of faiss_tpu/models/meta.py:21-704):
IndexPreTransform, the id maps, the refinement indexes, IndexShards,
IndexReplicas, IndexSplitVectors, IndexRandom and IndexShardsIVF.

The shard and replica compositions are host compositions of independently
built indexes, each searched by its own ``search`` (so an IndexShards of
refined IVF-PQ shards runs their fused kernels); their results merge by the
k-select of :func:`_merge_result_tables`. The sharded indexes over a mesh of
devices are parallel/sharded.py."""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import List

import numpy as np
import torch

from ..base import IDSelectorArray, Index, add_page_rows, query_buckets
from ..metric import MetricType, is_similarity_metric
from ..ops.distances import rerank_exact
from ..ops.topk import topk
from .flat import IndexFlat, IndexFlatSQ8
from .ivf import IndexIVF
from .ivf_pq import IndexIVFPQ


def _merge_result_tables(D_list, I_list, k, largest):
    """Merge per-shard result tables [nq, k_s] (numpy arrays or torch
    tensors) into the best k of each row (IndexShards.h:84 merge_tables;
    faiss_tpu meta.py:21): a partition to the k survivors first, then a
    stable sort of those only."""
    if isinstance(D_list[0], torch.Tensor):
        D, I = torch.cat(D_list, dim=1), torch.cat(I_list, dim=1)
        key = -D if largest else D
        if k < key.shape[1]:
            part = torch.topk(key, k, dim=1, largest=False).indices
            key, D, I = key.gather(1, part), D.gather(1, part), I.gather(1, part)
        order = torch.sort(key, dim=1, stable=True).indices[:, :k]
        return D.gather(1, order), I.gather(1, order)
    D = np.concatenate(D_list, axis=1)
    I = np.concatenate(I_list, axis=1)
    key = -D if largest else D
    n = key.shape[1]
    if k < n:
        part = np.argpartition(key, k - 1, axis=1)[:, :k]
        key = np.take_along_axis(key, part, axis=1)
        D = np.take_along_axis(D, part, axis=1)
        I = np.take_along_axis(I, part, axis=1)
    order = np.argsort(key, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(D, order, axis=1), np.take_along_axis(I, order, axis=1)


class IndexPreTransform(Index):
    """A chain of VectorTransforms in front of an index
    (IndexPreTransform.h:25; faiss_tpu meta.py:41). Constructed as
    ``IndexPreTransform(index)`` or ``IndexPreTransform(vt, index)``, then
    ``prepend_transform``. The chain runs on the device; the inner index
    takes numpy, so transformed vectors come back to the host once per call.
    ``search_submit`` returns the inner index's handle.

    Attribute reads that this class does not answer go to the inner index
    (``pre.nprobe`` reads it), but writes do not: set search knobs such as
    ``nprobe``, ``k_factor`` or ``strict_probe`` on the inner index itself,
    as in faiss_tpu."""

    def __init__(self, *args):
        if len(args) == 1:
            index, chain = args[0], []
        elif len(args) == 2:
            chain, index = [args[0]], args[1]
        else:
            raise TypeError("IndexPreTransform(vt?, index)")
        super().__init__(chain[0].d_in if chain else index.d,
                         index.metric_type, device=index.device)
        self.index = index
        self.chain = chain
        self.ntotal = index.ntotal
        self.is_trained = index.is_trained and all(t.is_trained for t in chain)

    def prepend_transform(self, vt) -> None:
        if vt.d_out != self.d:
            raise ValueError("transform d_out must match index input d")
        self.chain.insert(0, vt)
        self.d = vt.d_in
        self.is_trained = self.is_trained and vt.is_trained

    def apply_chain(self, x) -> np.ndarray:
        """The chain over float32 rows, on the device; numpy out."""
        xd = torch.from_numpy(np.ascontiguousarray(x, np.float32))
        for vt in self.chain:
            xd = vt.apply_tensor(xd)
        return xd.cpu().numpy()

    def reverse_chain(self, y) -> np.ndarray:
        yd = torch.from_numpy(np.ascontiguousarray(y, np.float32))
        for vt in reversed(self.chain):
            yd = vt.reverse_tensor(yd)
        return yd.cpu().numpy()

    def train(self, x) -> None:
        x = self._check_input(x)
        for vt in self.chain:
            if not vt.is_trained:
                vt.train(x)
            x = vt.apply(x)
        self.index.train(x)
        self.is_trained = True

    def add(self, x) -> None:
        self.add_with_ids(x, None)

    def add_with_ids(self, x, ids) -> None:
        """Paged through the chain (add_page_rows), so neither the
        transforms nor the inner add see an unbounded batch."""
        x = self._check_input(x)
        page = add_page_rows(self.d)
        for s in range(0, len(x), page):
            xt = self.apply_chain(x[s : s + page])
            if ids is None:
                self.index.add(xt)
            else:
                self.index.add_with_ids(xt, np.asarray(ids)[s : s + page])
        self.ntotal = self.index.ntotal

    def search(self, x, k, *, params=None):
        return self.index.search(self.apply_chain(self._check_input(x)), k,
                                 params=params)

    def search_submit(self, x, k, *, params=None):
        return self.index.search_submit(
            self.apply_chain(self._check_input(x)), k, params=params)

    def search_collect(self, handle):
        return self.index.search_collect(handle)

    def range_search(self, x, radius, *, params=None):
        return self.index.range_search(
            self.apply_chain(self._check_input(x)), radius, params=params)

    def reset(self) -> None:
        self.index.reset()
        self.ntotal = 0

    def remove_ids(self, sel) -> int:
        n = self.index.remove_ids(sel)
        self.ntotal = self.index.ntotal
        return n

    def reconstruct(self, key):
        return self.reverse_chain(self.index.reconstruct(key)[None])[0]

    def reconstruct_n(self, n0, ni):
        return self.reverse_chain(self.index.reconstruct_n(n0, ni))

    def reconstruct_batch(self, keys):
        return self.reverse_chain(self.index.reconstruct_batch(keys))

    def sa_code_size(self):
        return self.index.sa_code_size()

    def sa_encode(self, x):
        return self.index.sa_encode(self.apply_chain(self._check_input(x)))

    def sa_decode(self, codes):
        return self.reverse_chain(self.index.sa_decode(codes))

    def __getattr__(self, name):
        # reads only: the runtime knobs of the wrapped index
        index = self.__dict__.get("index")
        if index is None or name.startswith("_") or name == "chain":
            raise AttributeError(name)
        return getattr(index, name)


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
    (reference: IndexRefine.h:24; faiss_tpu meta.py:248).

    Any base and any refine store. The fused path, for an IndexIVFPQ base
    with a flat refine store (float32, fp16 or SQ8 codes: IndexFlatSQ8,
    Refine(SQ8)): with nq at or above the base's big_batch_threshold,
    k * k_factor <= 128, an L2 by-residual base, no selector and a store its
    kernels read (the decoded store, or 4-bit codes), the base search and
    the exact re-rank of its top k * k_factor candidates run in one device
    pass per sub-batch (IndexIVFPQ._sbbr_submit), at any nprobe, strict or
    soft, over the decoded store or the codes. Every other call takes the
    eager path (faiss_tpu :365-419): the base's own search returns
    k * k_factor candidates, re-ranked on the device exactly against a flat
    store (an SQ8 store dequantizes the gathered rows), or against the
    reconstructions of any other store (``reconstruct_batch``)."""

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
                and isinstance(base, IndexIVFPQ) and self.refine_index.ntotal
                and base.big_batch_threshold
                and len(x) >= base.big_batch_threshold
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
        largest = is_similarity_metric(self.metric_type)
        D = np.full((len(x), k), -np.inf if largest else np.inf, np.float32)
        I = np.full((len(x), k), -1, np.int64)
        flat = isinstance(self.refine_index, IndexFlat)
        xb = self.refine_index._consolidate() if flat else None
        if flat and xb is None:
            return D, I
        sq = self._refine_sq() or (None, None)
        for start, _, real in query_buckets(len(x)):
            sl = slice(start, start + real)
            xq = torch.from_numpy(x[sl]).to(self.device)
            if flat:
                d, i = rerank_exact(
                    xq, xb, torch.from_numpy(Ic[sl]).to(self.device), k,
                    metric=self.metric_type, xb_n2=self.refine_index._norms,
                    sq_scale=sq[0], sq_off=sq[1],
                )
            else:
                d, i = self._rerank_reconstructed(xq, Ic[sl], k, largest)
            D[sl, : d.shape[1]] = d.cpu().numpy()
            I[sl, : d.shape[1]] = i.cpu().numpy()
        return D, I

    def _rerank_reconstructed(self, xq, cand, k, largest):
        """Re-rank against a store that is not flat: the candidates'
        reconstructions (one ``reconstruct_batch``), scored in float32 on
        the device, L2 ascending or inner product descending; -1 where the
        base returned none."""
        valid = cand >= 0
        rows = np.zeros(cand.shape + (self.d,), np.float32)
        if valid.any():
            rows[valid] = self.refine_index.reconstruct_batch(cand[valid])
        y = torch.from_numpy(rows).to(self.device)
        if largest:
            d = (y * xq[:, None, :]).sum(-1)
        else:
            d = (y - xq[:, None, :]).square().sum(-1)
        ok = torch.from_numpy(valid).to(self.device)
        d = torch.where(ok, d, float("-inf") if largest else float("inf"))
        vals, pos = topk(d, k, largest=largest)
        ids = torch.gather(torch.from_numpy(cand).to(self.device), 1, pos)
        return vals, torch.where(torch.isinf(vals), -1, ids)

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
    """Refine against a flat store of the vectors (IndexRefine.h:82;
    faiss_tpu meta.py:425). ``store``: "f32"; "f16" (``store_float16``,
    the GpuIndexFlatConfig.useFloat16 analogue: half the device memory at
    ~2^-11 rounding, immaterial for re-ranking a candidate set); or "sq8",
    an IndexFlatSQ8 store of one byte a dimension (Refine(SQ8))."""

    def __init__(self, base_index: Index, xb=None, store_float16: bool = False,
                 store: str = "f32"):
        if store_float16:
            store = "f16"
        d, metric, dev = base_index.d, base_index.metric_type, base_index.device
        if store == "sq8":
            refine = IndexFlatSQ8(d, metric, device=dev)
        elif store in ("f16", "f32"):
            refine = IndexFlat(d, metric, device=dev)
            if store == "f16":
                refine.storage_dtype = np.float16
        else:
            raise ValueError(f"unknown refine store {store!r}")
        if xb is not None:
            refine.add(xb)
        super().__init__(base_index, refine)
        self.store_float16 = store == "f16"
        self.store = store


class IndexShards(Index):
    """Vector-split sharding over independently built indexes
    (IndexShards.h:20; faiss_tpu meta.py:462). Queries fan out to every
    shard, serially or, with ``threaded``, from a thread pool (each shard's
    search waits on its device with the interpreter lock released); the
    results merge by k-select. With ``successive_ids`` shard i's ids are
    shifted by the sizes of the shards before it. The metric and the
    device are the first shard's."""

    def __init__(self, d: int, threaded: bool = False, successive_ids: bool = True):
        self.shards: List[Index] = []
        self.threaded = threaded
        self.successive_ids = successive_ids
        self._d = int(d)
        self._initialized = False

    def _init_from(self, index: Index):
        if not self._initialized:
            Index.__init__(self, self._d, index.metric_type, index.metric_arg,
                           device=index.device)
            self._initialized = True

    def add_shard(self, index: Index) -> None:
        if index.d != self._d:
            raise ValueError("shard dimension mismatch")
        self._init_from(index)
        self.shards.append(index)
        self.ntotal = sum(s.ntotal for s in self.shards)
        self.is_trained = all(s.is_trained for s in self.shards)

    def count(self) -> int:
        return len(self.shards)

    def at(self, i: int) -> Index:
        return self.shards[i]

    def train(self, x) -> None:
        for s in self.shards:
            s.train(x)
        self.is_trained = True

    def add(self, x) -> None:
        """Split the batch evenly across the shards, in order
        (IndexShards::add_with_ids)."""
        x = self._check_input(x)
        n, ns = len(x), len(self.shards)
        at = 0
        for i, s in enumerate(self.shards):
            cnt = n // ns + (1 if i < n % ns else 0)
            if cnt:
                s.add(x[at : at + cnt])
                at += cnt
        self.ntotal += n

    def search(self, x, k, *, params=None):
        x = self._check_input(x)
        offsets = np.cumsum([0] + [s.ntotal for s in self.shards])[:-1]

        def one(i_s):
            i, s = i_s
            D, I = s.search(x, k, params=params)
            if self.successive_ids:
                I = np.where(I >= 0, I + offsets[i], -1)
            return D, I

        if self.threaded and len(self.shards) > 1:
            with ThreadPoolExecutor(len(self.shards)) as ex:
                results = list(ex.map(one, enumerate(self.shards)))
        else:
            results = [one(p) for p in enumerate(self.shards)]
        return _merge_result_tables([r[0] for r in results],
                                    [r[1] for r in results], k,
                                    is_similarity_metric(self.metric_type))

    def reset(self) -> None:
        for s in self.shards:
            s.reset()
        self.ntotal = 0


class IndexReplicas(Index):
    """Full replicas of one index; the queries are split across them in
    order (IndexReplicas.h:42; faiss_tpu meta.py:549)."""

    def __init__(self, d: int):
        self.replicas: List[Index] = []
        self._d = int(d)
        self._initialized = False

    def add_replica(self, index: Index) -> None:
        if not self._initialized:
            Index.__init__(self, self._d, index.metric_type, index.metric_arg,
                           device=index.device)
            self._initialized = True
        self.replicas.append(index)
        self.ntotal = index.ntotal
        self.is_trained = index.is_trained

    def count(self) -> int:
        return len(self.replicas)

    def at(self, i: int) -> Index:
        return self.replicas[i]

    def train(self, x) -> None:
        for r in self.replicas:
            r.train(x)
        self.is_trained = True

    def add(self, x) -> None:
        for r in self.replicas:
            r.add(x)
        self.ntotal = self.replicas[0].ntotal if self.replicas else 0

    def search(self, x, k, *, params=None):
        x = self._check_input(x)
        nq, nr = len(x), len(self.replicas)
        largest = is_similarity_metric(self.metric_type)
        D = np.full((nq, k), -np.inf if largest else np.inf, np.float32)
        I = np.full((nq, k), -1, np.int64)
        at = 0
        for i, r in enumerate(self.replicas):
            cnt = nq // nr + (1 if i < nq % nr else 0)
            if cnt:
                D[at : at + cnt], I[at : at + cnt] = r.search(
                    x[at : at + cnt], k, params=params)
                at += cnt
        return D, I

    def reset(self) -> None:
        for r in self.replicas:
            r.reset()
        self.ntotal = 0


class IndexSplitVectors(Index):
    """Dimension-sliced composition, inner product only (MetaIndexes.h:24;
    faiss_tpu meta.py:605): sub-index i answers for its slice of the
    dimensions, and a vector's score is the sum of its slices' scores. As in
    faiss_tpu, each sub-index returns every stored row's score
    (k = ntotal) and the sums are exact; they are summed and selected on
    the device."""

    def __init__(self, d: int, threaded: bool = False, *, device):
        super().__init__(d, MetricType.INNER_PRODUCT, device=device)
        self.threaded = threaded  # kept for the API; the fan-out is serial
        self.sub_indexes: List[Index] = []
        self.sum_d = 0

    def add_sub_index(self, index: Index) -> None:
        self.sub_indexes.append(index)
        self.sum_d += index.d
        self.ntotal = index.ntotal
        self.is_trained = all(s.is_trained for s in self.sub_indexes)

    def search(self, x, k, *, params=None):
        if self.sum_d != self.d:
            raise RuntimeError("sub-index dims must sum to d")
        x = self._check_input(x)
        total = torch.zeros((len(x), self.ntotal), device=self.device)
        d0 = 0
        for s in self.sub_indexes:
            Dk, Ik = s.search(np.ascontiguousarray(x[:, d0 : d0 + s.d]),
                              self.ntotal, params=params)
            ok = torch.from_numpy(Ik >= 0).to(self.device)
            ids = torch.from_numpy(Ik).to(self.device).clamp_min(0)
            vals = torch.from_numpy(Dk).to(self.device)
            total.scatter_add_(1, ids, torch.where(ok, vals, 0.0))
            d0 += s.d
        D, I = topk(total, k, largest=True)
        return D.cpu().numpy(), I.cpu().numpy()


class IndexRandom(Index):
    """Deterministic random results (MetaIndexes.h:55; faiss_tpu
    meta.py:642), a placeholder storage in tests: ids drawn from a
    RandomState of ``seed`` as faiss_tpu draws them, distances 0..k-1."""

    def __init__(self, d: int, ntotal: int = 0, seed: int = 1234, *, device):
        super().__init__(d, MetricType.L2, device=device)
        self.ntotal = int(ntotal)
        self.seed = seed

    def add(self, x) -> None:
        self.ntotal += len(self._check_input(x))

    def search(self, x, k, *, params=None):
        nq = len(self._check_input(x))
        rs = np.random.RandomState(self.seed)
        I = rs.randint(0, max(self.ntotal, 1), size=(nq, k)).astype(np.int64)
        D = np.arange(k, dtype=np.float32)[None].repeat(nq, 0)
        return D, I

    def reconstruct(self, key):
        rs = np.random.RandomState(self.seed + int(key))
        return rs.rand(self.d).astype(np.float32)


class IndexShardsIVF(IndexShards):
    """IVF shards sharing one coarse quantizer (IndexShardsIVF.h:19;
    faiss_tpu meta.py:668): the coarse assignment is computed once and each
    shard scans its lists by ``search_preassigned``. The results keep the
    shards' own ids (``successive_ids`` is not applied, as in faiss_tpu):
    the shards of ``ivflib.shard_ivf_index_centroids`` carry the global
    ones."""

    def __init__(self, quantizer, d: int, nlist: int, nprobe: int = 1):
        super().__init__(d)
        self.quantizer = quantizer
        self.nlist = int(nlist)
        self.nprobe = nprobe

    def add_shard(self, index) -> None:
        if not isinstance(index, IndexIVF):
            raise TypeError("IndexShardsIVF shards must be IndexIVF")
        if index.nlist != self.nlist:
            raise ValueError("shard nlist mismatch")
        super().add_shard(index)

    def search(self, x, k, *, params=None):
        x = self._check_input(x)
        nprobe = self.nprobe
        if params is not None and getattr(params, "nprobe", 0):
            nprobe = params.nprobe
        coarse_dis, assign = self.quantizer.search(x, nprobe)
        Ds, Is = [], []
        for s in self.shards:
            D, I = s.search_preassigned(x, k, assign, coarse_dis, params=params)
            Ds.append(D)
            Is.append(I)
        return _merge_result_tables(Ds, Is, k,
                                    is_similarity_metric(self.metric_type))
