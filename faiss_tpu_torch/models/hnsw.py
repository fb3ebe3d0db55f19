"""HNSW indexes (counterpart of faiss_tpu/models/hnsw.py; reference:
faiss/IndexHNSW.{h,cpp} and impl/HNSW.{h,cpp}).

The graph is built and walked on the host, in C++ (csrc/host/hnsw.cpp, the
port's copy of faiss_tpu's native/hnsw.cpp, built by host_build.py), as in
faiss_tpu and faiss: construction and traversal chase pointers one node at
a time. The storage index (flat, PQ or SQ) is the port's and lives on the
device, where its codec trains and encodes; the graph keeps the raw float32
rows it was given on the host and ranks by exact float distance over them,
as faiss_tpu's does. ``search`` takes the queries (numpy or a tensor on
the device) to the host once and returns numpy.

efConstruction/efSearch semantics follow impl/HNSW.h:139-142; the seed
(1234) and the insertion order are faiss_tpu's, so both packages build the
same graph from the same rows."""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from ..base import Index, require_device
from ..callbacks import InterruptCallback, InterruptedException
from ..host_build import build_host_lib
from ..metric import MetricType

_LIB = None
_SEED = 1234  # faiss_tpu/models/hnsw.py:171


def _load_lib():
    """The host HNSW library with its C signatures (built at first use)."""
    global _LIB
    if _LIB is not None:
        return _LIB
    c = ctypes
    lib = build_host_lib("hnsw")
    lib.hnsw_new.restype = c.c_void_p
    lib.hnsw_new.argtypes = [c.c_int, c.c_int, c.c_int, c.c_int, c.c_uint64]
    lib.hnsw_free.argtypes = [c.c_void_p]
    lib.hnsw_ntotal.restype = c.c_int64
    lib.hnsw_ntotal.argtypes = [c.c_void_p]
    lib.hnsw_add.argtypes = [c.c_void_p, c.POINTER(c.c_float), c.c_int64]
    lib.hnsw_add.restype = c.c_int64
    lib.hnsw_stats_get.argtypes = [c.POINTER(c.c_longlong)]
    lib.hnsw_stats_reset.argtypes = []
    lib.hnsw_set_interrupt.argtypes = [c.c_int]
    lib.hnsw_search.argtypes = [
        c.c_void_p, c.POINTER(c.c_float), c.c_int64, c.c_int64, c.c_int,
        c.POINTER(c.c_float), c.POINTER(c.c_int64),
    ]
    lib.hnsw_max_level.restype = c.c_int
    lib.hnsw_max_level.argtypes = [c.c_void_p]
    lib.hnsw_entry_point.restype = c.c_int64
    lib.hnsw_entry_point.argtypes = [c.c_void_p]
    lib.hnsw_get_levels.argtypes = [c.c_void_p, c.POINTER(c.c_int)]
    lib.hnsw_neighbor_bytes.restype = c.c_int64
    lib.hnsw_neighbor_bytes.argtypes = [c.c_void_p]
    lib.hnsw_get_neighbors.argtypes = [c.c_void_p, c.POINTER(c.c_int64)]
    lib.hnsw_get_vecs.argtypes = [c.c_void_p, c.POINTER(c.c_float)]
    lib.hnsw_import.argtypes = [
        c.c_void_p, c.POINTER(c.c_float), c.c_int64, c.POINTER(c.c_int),
        c.POINTER(c.c_int64), c.c_int64, c.c_int,
    ]
    lib.hnsw_set_pano.argtypes = [c.c_void_p, c.c_int]
    _LIB = lib
    return lib


def _fp(arr):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _ip64(arr):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _host_queries(x, d: int) -> np.ndarray:
    """Queries as contiguous float32 [n, d] on the host: a tensor (on any
    device) is copied over once."""
    if isinstance(x, torch.Tensor):
        x = x.detach().to("cpu", torch.float32).numpy()
    x = np.ascontiguousarray(x, np.float32)
    if x.ndim == 1:
        x = x.reshape(-1, d)
    if x.ndim != 2 or x.shape[1] != d:
        raise ValueError(f"expected [n, {d}] array, got {x.shape}")
    return x


class HNSW:
    """Parameter bag mirroring impl/HNSW.h's knobs."""

    def __init__(self, M: int = 32):
        self.M = M
        self.efConstruction = 40
        self.efSearch = 16
        self.max_level = -1
        self.entry_point = -1


class HNSWStats:
    """Search counters (reference: impl/HNSW.h:260 HNSWStats; the global
    ``hnsw_stats`` mirrors faiss.cvar.hnsw_stats). The counters live in the
    host library; ``sync()`` copies them into the fields."""

    def __init__(self):
        self.n1 = 0  # searches run
        self.ndis = 0  # distance evaluations (level-0 beam visits)
        self.nhops = 0  # beam-search expansions

    def sync(self) -> "HNSWStats":
        if _LIB is not None:
            buf = (ctypes.c_longlong * 3)()
            _LIB.hnsw_stats_get(buf)
            self.n1, self.ndis, self.nhops = int(buf[0]), int(buf[1]), int(buf[2])
        return self

    def reset(self) -> None:
        if _LIB is not None:
            _LIB.hnsw_stats_reset()
        self.n1 = self.ndis = self.nhops = 0


hnsw_stats = HNSWStats()


def watch_interrupt(set_fn, call):
    """Run ``call()`` (a ctypes call, which releases the GIL) while a
    watchdog thread polls InterruptCallback and forwards an interruption
    into the native loop through ``set_fn(1)`` (faiss_tpu hnsw.py:118; the
    reference polls InterruptCallback::check() in its loops,
    AuxIndexStructures.h:138)."""
    stop = threading.Event()

    def watch():
        while not stop.wait(0.05):
            if InterruptCallback.is_interrupted():
                set_fn(1)
                return

    t = threading.Thread(target=watch, daemon=True)
    t.start()
    try:
        return call()
    finally:
        stop.set()
        t.join(timeout=0.5)
        set_fn(0)


class IndexHNSW(Index):
    """HNSW over a storage index of the port (reference: IndexHNSW.h:24)."""

    def __init__(self, storage: Index, M: int = 32):
        super().__init__(storage.d, storage.metric_type, device=storage.device)
        self.storage = storage
        self.hnsw = HNSW(M)
        self.own_fields = False
        self.is_trained = storage.is_trained
        self._graph = None
        self._lib = None

    def __del__(self):
        if getattr(self, "_graph", None) is not None and self._lib is not None:
            self._lib.hnsw_free(self._graph)
            self._graph = None

    def _ensure_graph(self):
        if self._graph is None:
            self._lib = _load_lib()
            metric = 1 if self.metric_type == MetricType.L2 else 0
            self._graph = self._lib.hnsw_new(
                self.d, self.hnsw.M, self.hnsw.efConstruction, metric, _SEED)
        return self._graph

    def train(self, x) -> None:
        self.storage.train(x)
        self.is_trained = True

    def add(self, x) -> None:
        """Link the rows into the graph (in faiss_tpu's order: highest
        level first), then encode them into the storage. An interruption
        rolls the graph back to before the call; the storage keeps what the
        graph kept."""
        x = self._check_input(x)
        self._check_trained()
        g = self._ensure_graph()
        added = watch_interrupt(
            self._lib.hnsw_set_interrupt,
            lambda: self._lib.hnsw_add(g, _fp(x), len(x)),
        )
        if added < len(x):
            self.storage.add(x[:added])
            self.ntotal = self.storage.ntotal
            raise InterruptedException(
                f"HNSW add interrupted after {added}/{len(x)} nodes")
        self.storage.add(x)
        self.ntotal = self.storage.ntotal

    def search(self, x, k: int, *, params=None):
        """(D float32 [nq, k], I int64 [nq, k]) from the graph walk:
        ``params.efSearch`` overrides ``hnsw.efSearch``."""
        x = _host_queries(x, self.d)
        ef = self.hnsw.efSearch
        if params is not None and getattr(params, "efSearch", 0):
            ef = params.efSearch
        nq = len(x)
        D = np.empty((nq, k), np.float32)
        I = np.empty((nq, k), np.int64)
        if self.ntotal == 0:
            D.fill(np.inf if self.metric_type == MetricType.L2 else -np.inf)
            I.fill(-1)
            return D, I
        self._lib.hnsw_search(self._graph, _fp(x), nq, k, max(ef, k), _fp(D),
                              _ip64(I))
        hnsw_stats.sync()
        return D, I

    def reconstruct(self, key: int) -> np.ndarray:
        return self.storage.reconstruct(key)

    def reconstruct_n(self, n0, ni):
        return self.storage.reconstruct_n(n0, ni)

    def vectors(self) -> np.ndarray:
        """The stored vectors (decoded by the storage): what an IVF coarse
        quantizer ``IVFn_HNSWm`` exposes as its centroids."""
        return np.ascontiguousarray(self.reconstruct_n(0, self.ntotal),
                                    np.float32)

    def reset(self) -> None:
        if self._graph is not None:
            self._lib.hnsw_free(self._graph)
            self._graph = None
        self.storage.reset()
        self.ntotal = 0

    # -- the graph as arrays (index files, faiss_tpu hnsw.py:269-321) --------
    def graph_state(self):
        """The graph as numpy: the rows it ranks by, each node's level, the
        neighbour slots of every node and level concatenated, the entry
        point and max level, and the parameters. None without a graph."""
        if self._graph is None or self.ntotal == 0:
            return None
        lib = self._lib
        levels = np.empty(self.ntotal, np.int32)
        lib.hnsw_get_levels(self._graph,
                            levels.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
        neigh = np.empty(lib.hnsw_neighbor_bytes(self._graph) // 8, np.int64)
        lib.hnsw_get_neighbors(self._graph, _ip64(neigh))
        vecs = np.empty((self.ntotal, self.d), np.float32)
        lib.hnsw_get_vecs(self._graph, _fp(vecs))
        return {
            "vecs": vecs,
            "levels": levels,
            "neighbors": neigh,
            "entry_point": int(lib.hnsw_entry_point(self._graph)),
            "max_level": int(lib.hnsw_max_level(self._graph)),
            "M": self.hnsw.M,
            "efConstruction": self.hnsw.efConstruction,
            "efSearch": self.hnsw.efSearch,
        }

    def restore_graph(self, state, xb: np.ndarray) -> None:
        """Load a graph of :meth:`graph_state`'s form over the rows ``xb``
        (the storage is loaded separately)."""
        self.hnsw.M = int(state["M"])
        self.hnsw.efConstruction = int(state["efConstruction"])
        self.hnsw.efSearch = int(state["efSearch"])
        g = self._ensure_graph()
        xb = np.ascontiguousarray(xb, np.float32)
        levels = np.ascontiguousarray(state["levels"], np.int32)
        neigh = np.ascontiguousarray(state["neighbors"], np.int64)
        self._lib.hnsw_import(
            g, _fp(xb), len(xb),
            levels.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), _ip64(neigh),
            int(state["entry_point"]), int(state["max_level"]))
        self.ntotal = len(xb)


class IndexHNSWFlat(IndexHNSW):
    """reference: IndexHNSW.h IndexHNSWFlat."""

    def __init__(self, d: int, M: int = 32, metric=MetricType.L2, *,
                 device="cuda"):
        from .flat import IndexFlat

        super().__init__(IndexFlat(d, metric, device=require_device(device)), M)


class IndexHNSWFlatPanorama(IndexHNSWFlat):
    """HNSW with Panorama progressive distance refinement (reference:
    IndexHNSW.h:171): level-0 beam distances are evaluated block by block
    and a candidate is dropped once the Cauchy-Schwarz bound on its other
    dimensions exceeds the beam threshold. As the reference says, recall
    may differ from plain HNSW."""

    def __init__(self, d: int, M: int = 32, num_panorama_levels: int = 8,
                 metric=MetricType.L2, *, device="cuda"):
        super().__init__(d, M, metric, device=device)
        self.num_panorama_levels = int(num_panorama_levels)

    def _ensure_graph(self):
        fresh = self._graph is None
        g = super()._ensure_graph()
        if fresh:
            self._lib.hnsw_set_pano(g, self.num_panorama_levels)
        return g

    def graph_state(self):
        state = super().graph_state()
        if state is not None:
            state["pano_levels"] = self.num_panorama_levels
        return state

    def restore_graph(self, state, xb) -> None:
        self.num_panorama_levels = int(state.get("pano_levels", 8))
        super().restore_graph(state, xb)


class IndexHNSWPQ(IndexHNSW):
    """HNSW graph over PQ storage (reference: IndexHNSW.h IndexHNSWPQ)."""

    def __init__(self, d: int, M: int = 32, pq_m: int = 8, pq_nbits: int = 8,
                 *, device="cuda"):
        from .pq import IndexPQ

        super().__init__(IndexPQ(d, pq_m, pq_nbits, device=device), M)
        self.is_trained = False


class IndexHNSWSQ(IndexHNSW):
    """HNSW graph over SQ storage (reference: IndexHNSW.h IndexHNSWSQ)."""

    def __init__(self, d: int, qtype, M: int = 32, metric=MetricType.L2, *,
                 device="cuda"):
        from .sq import IndexScalarQuantizer

        super().__init__(IndexScalarQuantizer(d, qtype, metric, device=device), M)
        self.is_trained = self.storage.is_trained


class SearchParametersHNSW:
    """reference: IndexHNSW.h SearchParametersHNSW."""

    def __init__(self, efSearch: int = 16, sel=None):
        self.efSearch = efSearch
        self.sel = sel


class IndexHNSW2Level(IndexHNSW):
    """HNSW graph over 2-level codes, coarse id + PQ of the residual
    (reference: IndexHNSW.h:221). As in faiss_tpu, the graph is built and
    searched over the decoded rows (centroid + decoded residual), so its
    distances are those of the reference's storage distance computer; the
    Index2Layer storage keeps the codes."""

    def __init__(self, quantizer, nlist: int, m_pq: int, M: int = 32):
        from .extra_indexes import Index2Layer

        super().__init__(Index2Layer(quantizer, nlist, m_pq), M)
        self.is_trained = self.storage.is_trained

    def add(self, x) -> None:
        x = self._check_input(x)
        self._check_trained()
        n0 = self.storage.ntotal
        self.storage.add(x)
        xr = np.ascontiguousarray(
            self.storage.reconstruct_n(n0, self.storage.ntotal - n0), np.float32)
        g = self._ensure_graph()
        added = watch_interrupt(
            self._lib.hnsw_set_interrupt,
            lambda: self._lib.hnsw_add(g, _fp(xr), len(xr)),
        )
        self.ntotal = n0 + added
        if added < len(xr):
            # graph node ids are storage rows: roll the storage back to the
            # graph's rows, or every later add would be misaligned
            self.storage._truncate(n0 + added)
            raise InterruptedException(
                f"HNSW2Level add interrupted after {added}/{len(xr)} nodes"
                " (storage rolled back to the graph prefix)")

    def flip_to_ivf(self):
        """An IndexIVFPQ over the same trained quantizer, PQ and codes
        (reference: IndexHNSW2Level::flip_to_ivf)."""
        from .ivf_pq import IndexIVFPQ

        st = self.storage
        ivf = IndexIVFPQ(st.q1_quantizer, st.d, st.nlist, st.pq.M, st.pq.nbits,
                         st.metric_type, device=st.device)
        ivf.pq.set_centroids(st.pq.centroids)
        ivf.is_trained = True
        if st.ntotal:
            ivf.add_encoded(st._codes.copy(), st._listnos.astype(np.int32),
                            np.arange(st.ntotal, dtype=np.int64))
        return ivf
