"""IVF base index (counterpart of faiss_tpu/models/ivf.py:60-480).

The inverted lists are a host-side flat entry store (codes / listnos / ids
per slot; the ArrayInvertedLists + DirectMap analogue), from which the
search layouts of a subclass are built. Training is k-means of the coarse
quantizer on the device; adds are paged, assigned by the coarse quantizer
(on the device where it is flat or an IMI) and encoded by the subclass.

Search by probe (``search``, ``search_preassigned``): the coarse quantizer
gives each query its nprobe nearest lists (a flat quantizer by its exact
k-NN on the device, an IMI by its table merge on the device, any other,
such as an HNSW graph, by its own search), and
ops/ivf_ops.ivf_flat_scan scans them over a padded ``[nlist, max_len, d]``
copy of the vectors, built at first use and dropped by ``add``/``reset``.
That scan reads raw vectors: it serves IndexIVFFlat. A subclass replaces the
layout (``_stage_codes``; IVF-PQ's is a CSR), the scan (``_scan``) and the
probe step of ``range_search`` (``_probe_step``); the scan receives each
probe's coarse distance (||q - c||^2, or q . c for inner product:
IndexIVFPQ's bias term; IVF-Flat's scan ignores it).

Every metric is served; inner product trains the coarse quantizer by
spherical k-means, as faiss_tpu does, and the others by L2 k-means. A flat
coarse quantizer assigns and probes by its own metric (and ``metric_arg``);
the IVF-Flat scan scores the index's metric over the gathered list rows. A coarse quantizer
other than flat is trained by k-means and then filled with the centroids
(an HNSW graph is built over them), or, with ``quantizer_trains_alone``
(the IMI), trains itself; the codecs read its centroids through one device
copy of its ``vectors()`` (``_centroids_dev``). An ID selector
(``params.sel``) renders once per search to a mask over the slots, on the
device, that the scans apply. ``remove_ids``, ``merge_from`` and
``update_vectors`` edit the host entry store; unlike faiss_tpu, each then
calls one hook, ``_drop_caches``, that drops every device layout built from
the lists (faiss_tpu leaves its big-batch layout stale after ``remove_ids``
and ``merge_from``; see ROADMAP queue 3)."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..base import (
    Index,
    SearchParameters,
    add_page_rows,
    query_buckets,
    range_result,
    sel_mask,
)
from ..clustering import Clustering, ClusteringParameters
from ..metric import MetricType, is_similarity_metric
from ..ops import distances as dops
from ..ops.ivf_ops import (
    SCAN_GATHER_BYTES,
    flat_probe_dists,
    ivf_flat_scan,
    probe_slots,
)
from .flat import IndexFlat


class IndexIVFStats:
    """Search statistics (reference: IndexIVF.h:583; faiss_tpu ivf.py:33).
    As in faiss_tpu, only ``nq`` is counted, by the search by probe."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.nq = 0
        self.nlist = 0
        self.ndis = 0
        self.nheap_updates = 0
        self.quantization_time = 0.0
        self.search_time = 0.0


indexIVF_stats = IndexIVFStats()


class SearchParametersIVF(SearchParameters):
    """reference: IndexIVF.h:68."""

    def __init__(self, nprobe: int = 0, max_codes: int = 0, sel=None):
        super().__init__(sel=sel)
        self.nprobe = int(nprobe)
        self.max_codes = int(max_codes)


class Level1Quantizer:
    """Coarse-quantizer management (reference: IndexIVF.h:30)."""

    def __init__(self, quantizer: Optional[Index], nlist: int, d: int, metric, *,
                 device, metric_arg: float = 0.0):
        self.nlist = int(nlist)
        self.quantizer = (
            quantizer if quantizer is not None
            else IndexFlat(d, metric, metric_arg, device=device)
        )
        self.cp = ClusteringParameters()
        # 1: the quantizer trains itself on the data (the IMI; faiss_tpu
        # ivf.py:75, IndexIVF.h:39)
        self.quantizer_trains_alone = 0

    def train_q1(self, x: np.ndarray, verbose: bool, metric) -> None:
        """faiss_tpu/models/ivf.py:77: the quantizer's own training, or
        k-means (spherical for inner product) whose centroids fill the
        quantizer."""
        if self.quantizer.ntotal == self.nlist:
            return  # already trained (quantizer provided pre-populated)
        if self.quantizer_trains_alone == 1:
            self.quantizer.train(x)
            return
        self.cp.verbose = verbose
        self.cp.spherical = (self.cp.spherical
                             or metric == MetricType.INNER_PRODUCT)
        clus = Clustering(x.shape[1], self.nlist, self.cp, device=self.device)
        clus.train(x)
        self.quantizer.reset()
        self.quantizer.add(clus.centroids)


class IndexIVF(Index, Level1Quantizer):
    """Base IVF index (reference: IndexIVF.h:194). Subclasses implement
    the codec (encode_vectors, decode_vectors)."""

    def __init__(self, quantizer: Optional[Index], d: int, nlist: int,
                 metric=MetricType.L2, *, device, metric_arg: float = 0.0):
        Index.__init__(self, d, metric, metric_arg, device=device)
        Level1Quantizer.__init__(
            self, quantizer, nlist, d, self.metric_type, device=device,
            metric_arg=metric_arg,
        )
        self.nprobe = 1
        self.max_codes = 0
        self.is_trained = self.quantizer.ntotal == self.nlist
        self._codes_host: Optional[np.ndarray] = None  # [ntotal, code width]
        self._listnos_host = np.empty(0, np.int32)
        self._ids_host = np.empty(0, np.int64)
        self._device = None  # the per-probe layout
        self._brute = None  # the group-packed big-batch layout (subclasses)
        self._cent_dev = None  # (quantizer, its ntotal, centroids on the device)

    def train_encoder(self, x: torch.Tensor, assign: torch.Tensor) -> None:
        del x, assign

    def encode_vectors(self, x: torch.Tensor, listnos: torch.Tensor) -> np.ndarray:
        raise NotImplementedError

    def decode_vectors(self, codes: np.ndarray, listnos: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def _centroids_dev(self) -> torch.Tensor:
        """The coarse centroids [nlist, d] on the device: a flat quantizer's
        own store; for any other quantizer its ``vectors()`` (decoded graph
        rows, the IMI's product table), uploaded once and kept while the
        quantizer and its ntotal stay the same."""
        q = self.quantizer
        if isinstance(q, IndexFlat):
            return q._consolidate()
        c = self._cent_dev
        if c is None or c[0] is not q or c[1] != q.ntotal:
            cent = self._centroids_host()
            self._cent_dev = c = (q, q.ntotal,
                                  torch.from_numpy(cent).to(self.device))
        return c[2]

    def _centroids_host(self) -> np.ndarray:
        """The coarse centroids [nlist, d] float32 on the host: the
        quantizer's ``vectors()``, or its ``reconstruct_n`` where it has none
        (an IndexPQ inside ``IVFn(PQm)``)."""
        q = self.quantizer
        cent = (q.vectors() if hasattr(q, "vectors")
                else q.reconstruct_n(0, q.ntotal))
        return np.ascontiguousarray(cent, np.float32)

    def _quantizer_search(self, xq: torch.Tensor, k: int):
        """(distances [nq, k], list numbers int64 [nq, k], -1 = none) of the
        coarse quantizer for device queries: a flat quantizer's exact k-NN on
        the device, else the quantizer's own search (faiss_tpu ivf.py:322):
        on the device where it has one (``_search_dev``: the IMI), else
        through numpy (an HNSW graph walks on the host)."""
        q = self.quantizer
        if isinstance(q, IndexFlat):
            return dops.knn(xq, q._consolidate(), k, metric=q.metric_type,
                            y_norms=q._norms, metric_arg=q.metric_arg)
        if hasattr(q, "_search_dev"):
            d, i = q._search_dev(xq, k)
        else:
            d, i = q.search(xq.cpu().numpy(), k)
            d, i = torch.from_numpy(d), torch.from_numpy(i)
        return d.to(self.device, torch.float32), i.to(self.device, torch.int64)

    def _assign(self, x: torch.Tensor) -> torch.Tensor:
        """Top-1 coarse assignment: on the device (assign_flat) by a flat
        quantizer's metric, else the quantizer's search at k = 1, as
        faiss_tpu assigns (ivf.py:133-144)."""
        q = self.quantizer
        if isinstance(q, IndexFlat):
            return dops.assign_flat(x, q._consolidate(), metric=q.metric_type,
                                    metric_arg=q.metric_arg)[1]
        return self._quantizer_search(x, 1)[1][:, 0]

    def train(self, x) -> None:
        x = self._check_input(x)
        self.train_q1(x, self.verbose, self.metric_type)
        self._cent_dev = None  # an IMI retrains in place: same ntotal
        xd = torch.from_numpy(x).to(self.device)
        self.train_encoder(xd, self._assign(xd))
        self.is_trained = True

    def add(self, x) -> None:
        self.add_with_ids(x, None)

    def add_with_ids(self, x, ids) -> None:
        x = self._check_input(x)
        self._check_trained()
        page = add_page_rows(self.d)
        for s in range(0, len(x), page):
            xd = torch.from_numpy(x[s : s + page]).to(self.device)
            self.add_core(
                xd, None if ids is None else np.asarray(ids)[s : s + page],
                self._assign(xd),
            )

    def add_core(self, x, ids, listnos) -> None:
        """Add with precomputed coarse assignment (IndexIVF.h add_core)."""
        x = torch.as_tensor(x, device=self.device)
        listnos = torch.as_tensor(listnos, device=self.device).long().ravel()
        codes = self.encode_vectors(x, listnos)
        self.add_encoded(codes, listnos.to(torch.int32).cpu().numpy(), ids)

    def add_encoded(self, codes: np.ndarray, listnos: np.ndarray, ids=None) -> None:
        """Append already-encoded entries to the host lists; the device
        layouts are rebuilt at the next search."""
        n = len(codes)
        listnos = np.asarray(listnos, np.int32).ravel()
        if ids is None:
            ids = np.arange(self.ntotal, self.ntotal + n, dtype=np.int64)
        ids = np.asarray(ids, np.int64).ravel()
        if len(ids) != n or len(listnos) != n:
            raise ValueError("codes, listnos and ids differ in length")
        self._codes_host = (  # a copy: update_vectors writes into it
            np.array(codes) if self._codes_host is None
            else np.concatenate([self._codes_host, codes])
        )
        self._listnos_host = np.concatenate([self._listnos_host, listnos])
        self._ids_host = np.concatenate([self._ids_host, ids])
        self.ntotal += n
        self._drop_caches()

    def reset(self) -> None:
        self._codes_host = None
        self._listnos_host = np.empty(0, np.int32)
        self._ids_host = np.empty(0, np.int64)
        self.ntotal = 0
        self._drop_caches()

    def _drop_caches(self) -> None:
        """Drop every device layout built from the lists: the per-probe
        layout, the big-batch layout (its stores, planes and norms) and the
        worklist bucket sized on it. Every change to the lists calls this;
        subclasses with more caches extend it."""
        self._device = self._brute = None
        self._dyn_bucket = None

    # -- mutation (faiss_tpu :212-279) ----------------------------------------
    def _keep_entries(self, keep: np.ndarray) -> None:
        """Keep the entries (slots) where ``keep`` is True, in order."""
        self._codes_host = self._codes_host[keep]
        self._listnos_host = self._listnos_host[keep]
        self._ids_host = self._ids_host[keep]
        self.ntotal = len(self._ids_host)

    def remove_ids(self, sel) -> int:
        """Remove the entries whose ids ``sel`` selects; the others keep
        their ids. Returns the number removed."""
        keep = ~sel.mask_for_ids(self._ids_host)
        nremoved = int((~keep).sum())
        if nremoved:
            self._keep_entries(keep)
            self._drop_caches()
        return nremoved

    def check_compatible_for_merge(self, other) -> None:
        if (type(other) is not type(self) or other.d != self.d
                or other.nlist != self.nlist
                or other.metric_type != self.metric_type):
            raise ValueError("incompatible indexes for merge")

    def merge_from(self, other, add_id: int = 0) -> None:
        """Append ``other``'s entries (their ids shifted by ``add_id``) and
        empty ``other``. Both must share the coarse quantizer."""
        self.check_compatible_for_merge(other)
        if other.ntotal:
            self._merge_entries(other, add_id)
        other.reset()

    def _merge_entries(self, other, add_id: int) -> None:
        self.add_encoded(other._codes_host.copy(), other._listnos_host,
                         other._ids_host + add_id)

    def update_vectors(self, ids, x) -> None:
        """Replace the vectors of existing ids (IndexIVF.h:375): each is
        assigned and encoded anew, possibly into another list, and keeps its
        id and slot."""
        x = self._check_input(x)
        self._check_trained()
        ids = np.asarray(ids, np.int64).ravel()
        if len(ids) != len(x):
            raise ValueError("ids/x length mismatch")
        try:
            slots = self._slots_of_ids(ids)
        except KeyError:
            raise ValueError("did not find all entries to update") from None
        xd = torch.from_numpy(x).to(self.device)
        listnos = self._assign(xd)
        self._write_entries(slots, xd, listnos)
        self._drop_caches()

    def _write_entries(self, slots, x, listnos) -> None:
        """Encode ``x`` into the entries ``slots`` with lists ``listnos``."""
        self._codes_host[slots] = self.encode_vectors(x, listnos)
        self._listnos_host[slots] = listnos.to(torch.int32).cpu().numpy()

    # -- range search (faiss_tpu :1155-1216) -----------------------------------
    def _probe_step(self, xq, dev, sel):
        """A function (ln [nq] list numbers, cd [nq] their coarse distances)
        -> (dist, valid, slots), each [nq, W], of one probe step: the
        distances of each query to the slots of its list, which of them are
        valid (in the list, kept by the selector mask ``sel``) and the slots
        (-1 where not valid). IVF-Flat's default over the padded layout:
        exact float32, as its scan computes them."""
        xn = xq.square().sum(-1) if self.metric_type == MetricType.L2 else None

        def step(ln, cd):
            del cd
            dist = flat_probe_dists(xq, ln, dev["codes"], self.metric_type, xn,
                                    dev["code_norms"], self.metric_arg)
            return (dist,) + probe_slots(ln, dev["slot_ids"], dev["lengths"], sel)

        return step

    def _probe_row_bytes(self, dev) -> int:
        """Bytes of one query's per-probe gather of the padded layout."""
        return dev["codes"][0].numel() * 4

    def range_search(self, x, radius: float, *, params=None):
        """Every entry of each query's nprobe nearest lists within
        ``radius`` (L2 below it, inner product above it), by probe over the
        per-probe layout: the codec's distances thresholded on the device (and
        masked by an ID selector), only the hits read back, the CSR
        assembled on the host (IndexIVF::range_search). Within a query the
        hits come probe by probe."""
        x = self._check_input(x)
        self._check_trained()
        nprobe = self.nprobe
        if params is not None and getattr(params, "nprobe", 0):
            nprobe = params.nprobe
        nprobe = min(max(1, nprobe), self.nlist)
        nq = len(x)
        parts = []
        if self.ntotal and nq:
            largest = is_similarity_metric(self.metric_type)
            dev = self._build_device()
            mask = sel_mask(params, self._ids_host, self.device)
            x_dev = torch.from_numpy(x).to(self.device)
            rows = max(1, SCAN_GATHER_BYTES // max(1, self._probe_row_bytes(dev)))
            for q0 in range(0, nq, rows):
                xq = x_dev[q0 : q0 + rows]
                coarse_dis, probes = self._coarse_search(xq, nprobe)
                step = self._probe_step(xq, dev, mask)
                for p in range(nprobe):
                    dist, valid, sl = step(probes[:, p], coarse_dis[:, p])
                    hit = valid & (dist > radius if largest else dist < radius)
                    qi, ci = torch.nonzero(hit, as_tuple=True)
                    parts.append((
                        (qi + q0).cpu().numpy(), dist[qi, ci].cpu().numpy(),
                        self._ids_host[sl[qi, ci].cpu().numpy()],
                    ))
        return range_result(parts, nq)

    # -- the per-probe layout (faiss_tpu :281-319) ----------------------------
    def _pad_to(self, n: int) -> int:
        return max(128, -(-n // 128) * 128)

    def _build_device(self):
        """The per-probe layout, built at first use by the codec's
        ``_stage_codes`` from the lists in list order: ``order`` (the slots
        sorted by list, add order within a list), each list's ``offsets``
        and ``lengths``, and ``max_len`` (the longest, padded to a multiple
        of 128)."""
        if self._device is not None:
            return self._device
        n = self.ntotal
        lengths = np.bincount(self._listnos_host,
                              minlength=self.nlist).astype(np.int64)
        max_len = self._pad_to(int(lengths.max()) if n else 1)
        order = np.argsort(self._listnos_host, kind="stable")
        offsets = np.zeros(self.nlist, np.int64)
        np.cumsum(lengths[:-1], out=offsets[1:])
        self._device = self._stage_codes(order, offsets, lengths, max_len)
        return self._device

    def _stage_rows(self) -> np.ndarray:
        """The float32 rows [ntotal, d] of the padded layout, in slot order:
        IVF-Flat's vectors (a codec that scans decoded rows overrides
        this)."""
        return self._codes_host

    def _stage_codes(self, order, offsets, lengths, max_len):
        """Device tensors of the per-probe scan; the default, the padded
        layout: for every list its slots (input positions, -1 on pads) in
        add order [nlist, max_len], and the rows of ``_stage_rows``
        [nlist, max_len, d] float32 (zeros on pads) gathered on the device
        through them, and their norms."""
        sid = self._slot_ids(order, offsets, max_len)
        rows = self._stage_rows() if self.ntotal else np.zeros((0, self.d))
        codes = self._padded(sid, torch.from_numpy(
            np.ascontiguousarray(rows, np.float32)).to(self.device), 0.0)
        return {
            "codes": codes,
            "slot_ids": sid,
            "lengths": torch.from_numpy(lengths).to(self.device),
            "code_norms": (codes.square().sum(-1)
                           if self.metric_type == MetricType.L2 else None),
        }

    def _slot_ids(self, order, offsets, max_len) -> torch.Tensor:
        """[nlist, max_len] int32 on the device: every list's slots (input
        positions) in add order, -1 on pads."""
        sorted_ln = self._listnos_host[order].astype(np.int64)
        ranks = np.arange(self.ntotal, dtype=np.int64) - offsets[sorted_ln]
        slot_ids = np.full((self.nlist, max_len), -1, np.int32)
        slot_ids[sorted_ln, ranks] = order
        return torch.from_numpy(slot_ids).to(self.device)

    @staticmethod
    def _padded(sid: torch.Tensor, rows: torch.Tensor, fill) -> torch.Tensor:
        """Per-slot device rows [ntotal, ...] gathered through ``sid`` into
        the padded layout [nlist, max_len, ...], ``fill`` (a scalar or a
        row) on pads."""
        if rows.shape[0] == 0:
            rows = rows.new_zeros((1,) + tuple(rows.shape[1:]))
        shape = tuple(sid.shape) + (1,) * (rows.dim() - 1)
        return torch.where((sid >= 0).view(shape), rows[sid.clamp_min(0).long()], fill)

    # -- search by probe (faiss_tpu :322-444) ---------------------------------
    def _coarse_search(self, xq: torch.Tensor, nprobe: int):
        """The nprobe nearest lists of each query by the coarse quantizer
        (:meth:`_quantizer_search`): (distances [nq, nprobe], list numbers
        int64, -1 = none)."""
        return self._quantizer_search(xq, nprobe)

    def _scan(self, xq, probes, coarse_dis, k, dev, sel):
        """The codec's list scan: (dists, slots). IVF-Flat's default, which
        does not need the coarse distances ``coarse_dis`` [nq, nprobe];
        ``sel`` is the selector's slot mask or None."""
        del coarse_dis
        return ivf_flat_scan(
            xq, probes, dev["codes"], dev["slot_ids"], dev["lengths"], k,
            metric=self.metric_type, code_norms=dev["code_norms"],
            sel_mask=sel, metric_arg=self.metric_arg,
        )

    def _search_params(self, params):
        """(nprobe, max_codes) of a search: the index's, overridden by
        non-zero ``params`` fields."""
        nprobe, max_codes = self.nprobe, self.max_codes
        if params is not None:
            nprobe = getattr(params, "nprobe", 0) or nprobe
            max_codes = getattr(params, "max_codes", 0) or max_codes
        return nprobe, max_codes

    def _results(self, nq, k):
        largest = is_similarity_metric(self.metric_type)
        return (np.full((nq, k), -np.inf if largest else np.inf, np.float32),
                np.full((nq, k), -1, np.int64))

    def _ids_of(self, slots: np.ndarray) -> np.ndarray:
        return np.where(slots >= 0, self._ids_host[np.maximum(slots, 0)], -1)

    def search(self, x, k: int, *, params=None):
        """Exact scan of each query's nprobe nearest lists; ``max_codes``
        stops probing once the lists probed so far hold that many codes
        (SearchParametersIVF::max_codes, IndexIVF.h:68); ``params.sel``
        keeps the entries an ID selector selects."""
        x = self._check_input(x)
        self._check_trained()
        nprobe, max_codes = self._search_params(params)
        nprobe = min(max(1, nprobe), self.nlist)
        nq = len(x)
        D, I = self._results(nq, k)
        if self.ntotal == 0 or nq == 0:
            return D, I
        dev = self._build_device()
        sel = sel_mask(params, self._ids_host, self.device)
        indexIVF_stats.nq += nq
        lengths = dev["lengths"]
        x_dev = torch.from_numpy(x).to(self.device)
        for start, padded, real in query_buckets(nq):
            xq = torch.zeros(padded, self.d, device=self.device)
            xq[:real] = x_dev[start : start + real]
            coarse_dis, probes = self._coarse_search(xq, nprobe)
            if max_codes:
                cum = torch.cumsum(
                    torch.where(probes >= 0, lengths[probes.clamp_min(0)], 0),
                    dim=1,
                )
                keep = torch.cat([
                    torch.ones_like(cum[:, :1], dtype=torch.bool),
                    cum[:, :-1] < max_codes,
                ], dim=1)
                probes = torch.where(keep, probes, -1)
            dists, slots = self._scan(xq, probes, coarse_dis, k, dev, sel)
            D[start : start + real] = dists[:real].cpu().numpy()
            I[start : start + real] = self._ids_of(slots[:real].cpu().numpy())
        return D, I

    def search_preassigned(self, x, k: int, assign, centroid_dis, *,
                           params=None):
        """Search with an externally computed coarse assignment
        (IndexIVF.h:301): ``assign`` [nq, nprobe] list numbers (-1 = none)
        and ``centroid_dis`` [nq, nprobe] their coarse distances, which the
        codec's scan receives (IVF-PQ adds them, IVF-Flat ignores them);
        ``params.sel`` keeps the entries an ID selector selects."""
        x = self._check_input(x)
        nq = len(x)
        D, I = self._results(nq, k)
        if self.ntotal == 0 or nq == 0:
            return D, I
        dev = self._build_device()
        sel = sel_mask(params, self._ids_host, self.device)
        assign = torch.from_numpy(np.asarray(assign, np.int64)).to(self.device)
        cdis = torch.from_numpy(
            np.ascontiguousarray(centroid_dis, np.float32)
        ).to(self.device).reshape(assign.shape)
        x_dev = torch.from_numpy(x).to(self.device)
        for start, padded, real in query_buckets(nq):
            xq = torch.zeros(padded, self.d, device=self.device)
            xq[:real] = x_dev[start : start + real]
            pr = torch.full((padded, assign.shape[1]), -1, dtype=torch.int64,
                            device=self.device)
            pr[:real] = assign[start : start + real]
            cd = torch.zeros(pr.shape, device=self.device)
            cd[:real] = cdis[start : start + real]
            dists, slots = self._scan(xq, pr, cd, k, dev, sel)
            D[start : start + real] = dists[:real].cpu().numpy()
            I[start : start + real] = self._ids_of(slots[:real].cpu().numpy())
        return D, I

    # -- reconstruction and list introspection (faiss_tpu :447-480) -----------
    def make_direct_map(self, new_maintain: bool = True) -> None:
        """The host entry store always maps ids to slots: nothing to do."""
        del new_maintain

    def _slots_of_ids(self, keys: np.ndarray) -> np.ndarray:
        """Vectorized id -> slot lookup (DirectMap analogue); raises on any
        missing id."""
        order = np.argsort(self._ids_host, kind="stable")
        pos = np.searchsorted(self._ids_host, keys, sorter=order)
        slots = order[np.clip(pos, 0, len(order) - 1)]
        bad = self._ids_host[slots] != keys
        if bad.any():
            raise KeyError(f"id {keys[bad][0]} not found")
        return slots

    def reconstruct(self, key: int) -> np.ndarray:
        return self.reconstruct_batch(np.array([key], np.int64))[0]

    def reconstruct_batch(self, keys) -> np.ndarray:
        slots = self._slots_of_ids(np.asarray(keys, np.int64).ravel())
        return self.decode_vectors(self._codes_host[slots],
                                   self._listnos_host[slots])

    def reconstruct_n(self, n0: int, ni: int) -> np.ndarray:
        return self.reconstruct_batch(np.arange(n0, n0 + ni, dtype=np.int64))

    def get_list_size(self, list_no: int) -> int:
        return int((self._listnos_host == list_no).sum())

    def invlists_ids(self, list_no: int) -> np.ndarray:
        return self._ids_host[self._listnos_host == list_no]
