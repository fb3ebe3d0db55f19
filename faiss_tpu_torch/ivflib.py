"""IVF surgery utilities (counterpart of faiss_tpu/ivflib.py; the
reference's IVFlib.{h,cpp} and contrib/ivf_tools.py).

They edit an IndexIVF's host entry store (codes / listnos / ids per slot).
Every edit ends in the index's ``_drop_caches``, which drops every device
layout built from the lists (faiss_tpu clears only some of them; ROADMAP
queue 3)."""

from __future__ import annotations

import copy

import numpy as np

from .models.ivf import IndexIVF
from .models.meta import IndexIDMap, IndexPreTransform


def extract_index_ivf(index) -> IndexIVF:
    """Unwrap PreTransform / IDMap down to the IndexIVF (IVFlib.h:31)."""
    while True:
        if isinstance(index, (IndexPreTransform, IndexIDMap)):
            index = index.index
        elif isinstance(index, IndexIVF):
            return index
        else:
            raise TypeError(f"no IndexIVF inside {type(index).__name__}")


def try_extract_index_ivf(index):
    try:
        return extract_index_ivf(index)
    except TypeError:
        return None


def merge_into(index0, index1, shift_ids: bool = False) -> None:
    """Move index1's entries into index0 (IVFlib.h merge_into), their ids
    shifted by index0's ntotal with ``shift_ids``; index1 is left empty."""
    ivf0 = extract_index_ivf(index0)
    ivf1 = extract_index_ivf(index1)
    ivf0.merge_from(ivf1, add_id=ivf0.ntotal if shift_ids else 0)
    index0.ntotal = ivf0.ntotal


def add_preassigned(index_ivf: IndexIVF, x, a, ids=None) -> None:
    """Add with a precomputed assignment (contrib/ivf_tools.py:15)."""
    index_ivf.add_core(np.ascontiguousarray(x, np.float32), ids, a)


def search_preassigned(index_ivf: IndexIVF, xq, k, list_nos, coarse_dis=None):
    """contrib/ivf_tools.py:26: coarse distances of 0 where none are
    given."""
    if coarse_dis is None:
        coarse_dis = np.zeros(np.asarray(list_nos).shape, np.float32)
    return index_ivf.search_preassigned(xq, k, list_nos, coarse_dis)


def replace_ivf_quantizer(index_ivf: IndexIVF, new_quantizer):
    """Swap the coarse quantizer (contrib/ivf_tools.py:53); an empty new
    quantizer is trained on (if untrained) and filled with the old
    centroids. Drops the layouts and tables built from the old centroids.
    Returns the old quantizer."""
    old = index_ivf.quantizer
    if new_quantizer.ntotal == 0:
        centroids = index_ivf._centroids_host()
        if not new_quantizer.is_trained:
            new_quantizer.train(centroids)
        new_quantizer.add(centroids)
    if new_quantizer.ntotal != index_ivf.nlist:
        raise ValueError("quantizer size != nlist")
    index_ivf.quantizer = new_quantizer
    index_ivf._cent_dev = None
    if hasattr(index_ivf, "_term2"):  # IVF-PQ's tables hold the centroids
        index_ivf._term2 = None
    index_ivf._drop_caches()
    return old


def get_invlist_range(index_ivf: IndexIVF, l0: int, l1: int):
    """(codes, listnos, ids) of the entries of lists [l0, l1), in slot
    order (IVFlib.h get_invlist_range)."""
    mask = (index_ivf._listnos_host >= l0) & (index_ivf._listnos_host < l1)
    return (
        index_ivf._codes_host[mask],
        index_ivf._listnos_host[mask],
        index_ivf._ids_host[mask],
    )


def shard_ivf_index_centroids(index_ivf: IndexIVF, n_shards: int):
    """Split an IVF index into ``n_shards`` by centroid ranges
    (IVFlib.h:171): shard s holds the entries of lists
    [s * per, (s + 1) * per), per = ceil(nlist / n_shards), with their ids,
    and shares the coarse quantizer and the codec."""
    shards = []
    per = -(-index_ivf.nlist // n_shards)
    for s in range(n_shards):
        l0, l1 = s * per, min((s + 1) * per, index_ivf.nlist)
        shard = copy.copy(index_ivf)
        codes, listnos, ids = get_invlist_range(index_ivf, l0, l1)
        shard._codes_host = codes.copy()
        shard._listnos_host = listnos.copy()
        shard._ids_host = ids.copy()
        shard.ntotal = len(ids)
        shard._drop_caches()
        shards.append(shard)
    return shards


def clone_index(index):
    """A deep copy on the same device, through a serialization round trip
    (clone_index.h)."""
    from .io import deserialize_index, serialize_index

    return deserialize_index(serialize_index(index), device=index.device)


class SlidingIndexWindow:
    """Sliding window over an IVF index (IVFlib.h:86): each ``step`` drops
    the oldest slice of entries and/or appends a sub-index's entries. The
    slices are kept as (ids, listnos, codes) blocks and concatenated into
    the index's entry store on each step; its device layouts are rebuilt at
    the next search."""

    def __init__(self, index):
        self.index = index
        self.ivf = extract_index_ivf(index)
        self.nlist = self.ivf.nlist
        self._slices = []
        if self.ivf.ntotal:
            self._slices.append(self._entries(self.ivf))
        self.n_slice = len(self._slices)

    @staticmethod
    def _entries(ivf):
        return (ivf._ids_host.copy(), ivf._listnos_host.copy(),
                None if ivf._codes_host is None else ivf._codes_host.copy())

    def step(self, sub_index, remove_oldest: bool) -> None:
        """Append ``sub_index``'s entries (it may be None) and/or drop the
        oldest slice (IVFlib.cpp SlidingIndexWindow::step)."""
        if remove_oldest and self._slices:
            self._slices.pop(0)
        if sub_index is not None:
            ivf = extract_index_ivf(sub_index)
            if ivf.nlist != self.nlist:
                raise ValueError("sub-index nlist mismatch")
            if ivf.ntotal:
                self._slices.append(self._entries(ivf))
        self.n_slice = len(self._slices)
        if self._slices:
            self.ivf._ids_host = np.concatenate([s[0] for s in self._slices])
            self.ivf._listnos_host = np.concatenate([s[1] for s in self._slices])
            if self._slices[0][2] is not None:
                self.ivf._codes_host = np.concatenate([s[2] for s in self._slices])
        else:
            self.ivf._ids_host = np.empty(0, np.int64)
            self.ivf._listnos_host = np.empty(0, np.int32)
            if self.ivf._codes_host is not None:
                self.ivf._codes_host = self.ivf._codes_host[:0]
        self.ivf.ntotal = len(self.ivf._ids_host)
        self.ivf._drop_caches()
        self.index.ntotal = self.ivf.ntotal
