"""NSG and NN-descent indexes (counterpart of faiss_tpu/models/nsg.py;
reference: faiss/IndexNSG.{h,cpp}, impl/NSG.{h,cpp}, impl/NNDescent.{h,cpp}).

Graph construction (an NN-descent kNN bootstrap, the MRNG prune and a
spanning pass for connectivity) and the beam search run on the host in C++
(csrc/host/nsg.cpp, built by host_build.py), as in faiss_tpu and faiss. The
port's copy of the C++ makes the NN-descent deterministic: its graph is the
same for any number of OpenMP threads (faiss_tpu's local join races, see
ROADMAP queue 3). The PQ and SQ storages are the port's, trained and
encoded on the device; their graphs are built and searched over the decoded
rows, as faiss_tpu's are."""

from __future__ import annotations

import ctypes

import numpy as np

from ..base import Index, require_device
from ..callbacks import InterruptedException
from ..host_build import build_host_lib
from ..metric import MetricType
from .hnsw import _fp, _host_queries, _ip64, watch_interrupt

_LIB = None


def _load_lib():
    """The host NSG library with its C signatures (built at first use)."""
    global _LIB
    if _LIB is not None:
        return _LIB
    c = ctypes
    lib = build_host_lib("nsg")
    lib.nsg_new.restype = c.c_void_p
    lib.nsg_new.argtypes = [c.c_int, c.c_int]
    lib.nsg_free.argtypes = [c.c_void_p]
    lib.nsg_ntotal.restype = c.c_int64
    lib.nsg_ntotal.argtypes = [c.c_void_p]
    lib.nsg_enterpoint.restype = c.c_int64
    lib.nsg_enterpoint.argtypes = [c.c_void_p]
    lib.nsg_build.restype = c.c_int
    lib.nsg_build.argtypes = [
        c.c_void_p, c.POINTER(c.c_float), c.c_int64, c.c_int, c.c_int, c.c_int,
    ]
    lib.nsg_stats_get.argtypes = [c.POINTER(c.c_longlong)]
    lib.nsg_stats_reset.argtypes = []
    lib.nsg_set_interrupt.argtypes = [c.c_int]
    lib.nsg_search.argtypes = [
        c.c_void_p, c.POINTER(c.c_float), c.c_int64, c.c_int64, c.c_int,
        c.POINTER(c.c_float), c.POINTER(c.c_int64),
    ]
    lib.nsg_get_graph.argtypes = [c.c_void_p, c.POINTER(c.c_int64)]
    lib.nsg_get_vecs.argtypes = [c.c_void_p, c.POINTER(c.c_float)]
    lib.nsg_import.argtypes = [
        c.c_void_p, c.POINTER(c.c_float), c.c_int64, c.POINTER(c.c_int64),
        c.c_int64,
    ]
    _LIB = lib
    return lib


class NSGStats:
    """Distance evaluations of the builds' candidate searches (the
    hnsw_stats analogue of the host NSG component)."""

    def __init__(self):
        self.ndis = 0

    def sync(self) -> "NSGStats":
        if _LIB is not None:
            buf = (ctypes.c_longlong * 1)()
            _LIB.nsg_stats_get(buf)
            self.ndis = int(buf[0])
        return self

    def reset(self) -> None:
        if _LIB is not None:
            _LIB.nsg_stats_reset()
        self.ndis = 0


nsg_stats = NSGStats()


class IndexNSGFlat(Index):
    """NSG over raw vectors (reference: IndexNSG.h:23 IndexNSGFlat). As in
    the reference, the graph is built in one shot: ``add`` takes all the
    vectors in one call."""

    def __init__(self, d: int, R: int = 32, metric=MetricType.L2, *,
                 device="cuda"):
        if MetricType(metric) != MetricType.L2:
            raise ValueError("NSG supports L2 (like the reference default)")
        super().__init__(d, metric, device=require_device(device))
        self.R = int(R)
        self.GK = 64  # kNN-graph degree of the NN-descent (IndexNSG.h GK)
        self.nndescent_iter = 8
        self.build_L = 64
        self.search_L = 16  # reference: nsg.search_L
        self._g = None
        self._lib = None
        self._xb = None  # the rows the graph ranks by, on the host

    def __del__(self):
        if getattr(self, "_g", None) is not None and self._lib is not None:
            self._lib.nsg_free(self._g)
            self._g = None

    def _ensure(self):
        if self._g is None:
            self._lib = _load_lib()
            self._g = self._lib.nsg_new(self.d, self.R)
        return self._g

    def _build(self, xb: np.ndarray) -> int:
        """Build the graph over ``xb`` (0, or nonzero if interrupted)."""
        g = self._ensure()
        rc = watch_interrupt(
            self._lib.nsg_set_interrupt,
            lambda: self._lib.nsg_build(g, _fp(xb), len(xb), self.GK,
                                        self.nndescent_iter, self.build_L),
        )
        nsg_stats.sync()
        return rc

    def add(self, x) -> None:
        x = self._check_input(x)
        if self.ntotal:
            raise RuntimeError(
                "IndexNSG must be built in one add() call (reference "
                "IndexNSG.cpp has the same constraint)")
        if self._build(x) != 0:
            self.reset()
            raise InterruptedException("NSG build interrupted")
        self._xb = x.copy()
        self.ntotal = len(x)

    def search(self, x, k: int, *, params=None):
        """(D float32 [nq, k], I int64 [nq, k]) from the beam search over
        ``search_L`` candidates (``params.search_L`` overrides it)."""
        x = _host_queries(x, self.d)
        L = self.search_L
        if params is not None and getattr(params, "search_L", 0):
            L = params.search_L
        nq = len(x)
        D = np.full((nq, k), np.inf, np.float32)
        I = np.full((nq, k), -1, np.int64)
        if self.ntotal == 0:
            return D, I
        self._lib.nsg_search(self._g, _fp(x), nq, k, max(L, k), _fp(D), _ip64(I))
        return D, I

    def reconstruct(self, key: int) -> np.ndarray:
        return self._xb[key].copy()

    def reconstruct_n(self, n0, ni):
        return self._xb[n0 : n0 + ni].copy()

    def reset(self) -> None:
        if self._g is not None:
            self._lib.nsg_free(self._g)
            self._g = None
        self._xb = None
        self.ntotal = 0

    # -- the graph as arrays (index files, faiss_tpu nsg.py:183-206) ---------
    def graph_state(self):
        """The graph [ntotal * R] int64 (-1 padded), its enter point and
        the parameters; None without a graph."""
        if self._g is None:
            return None
        graph = np.empty(self.ntotal * self.R, np.int64)
        self._lib.nsg_get_graph(self._g, _ip64(graph))
        return {
            "graph": graph,
            "enterpoint": int(self._lib.nsg_enterpoint(self._g)),
            "R": self.R,
            "search_L": self.search_L,
        }

    def restore_graph(self, state, xb) -> None:
        """Load a graph of :meth:`graph_state`'s form over the rows ``xb``."""
        self.R = int(state["R"])
        self.search_L = int(state["search_L"])
        g = self._ensure()
        xb = np.ascontiguousarray(xb, np.float32)
        graph = np.ascontiguousarray(state["graph"], np.int64)
        self._lib.nsg_import(g, _fp(xb), len(xb), _ip64(graph),
                             int(state["enterpoint"]))
        self._xb = xb
        self.ntotal = len(xb)


class IndexNNDescentFlat(IndexNSGFlat):
    """The NN-descent kNN-graph index (reference: IndexNNDescent.h), served
    as faiss_tpu serves it: the NSG machinery with R = K and a kNN degree
    of at least 32."""

    def __init__(self, d: int, K: int = 32, metric=MetricType.L2, *,
                 device="cuda"):
        super().__init__(d, K, metric, device=device)
        self.GK = max(K, 32)


class IndexNSGPQ(IndexNSGFlat):
    """NSG graph over PQ-coded storage (reference: IndexNSG.h:89). The
    graph is built and searched over the decoded rows, so the distances
    are the ADC distances ||q - decode(code)||^2 of the reference's storage
    distance computer."""

    def __init__(self, d: int, pq_m: int, R: int = 32, pq_nbits: int = 8, *,
                 device="cuda"):
        from .pq import IndexPQ

        super().__init__(d, R, device=device)
        self.storage = IndexPQ(d, pq_m, pq_nbits, device=self.device)
        self.is_trained = False

    def train(self, x) -> None:
        self.storage.train(self._check_input(x))
        self.is_trained = True

    def add(self, x) -> None:
        """Encode into the storage, then build over the decoded rows; an
        interruption empties both (a retry must not encode the rows twice)."""
        x = self._check_input(x)
        self._check_trained()
        if self.ntotal:
            raise RuntimeError("IndexNSG must be built in one add() call")
        self.storage.add(x)
        xr = np.ascontiguousarray(
            self.storage.reconstruct_n(0, self.storage.ntotal), np.float32)
        if self._build(xr) != 0:
            self.reset()
            self.storage.reset()
            raise InterruptedException("NSG build interrupted")
        self._xb = xr
        self.ntotal = len(xr)

    def reconstruct(self, key: int) -> np.ndarray:
        return self.storage.reconstruct(key)


class IndexNSGSQ(IndexNSGPQ):
    """NSG graph over SQ-coded storage (reference: IndexNSG.h:98)."""

    def __init__(self, d: int, qtype, R: int = 32, metric=MetricType.L2, *,
                 device="cuda"):
        from .sq import IndexScalarQuantizer

        IndexNSGFlat.__init__(self, d, R, metric, device=device)
        self.storage = IndexScalarQuantizer(d, qtype, metric, device=self.device)
        self.is_trained = self.storage.is_trained
