"""InvertedLists and their combinator views (counterpart of
faiss_tpu/invlists.py; the reference's invlists/InvertedLists.{h,cpp},
OnDiskInvertedLists.h and InvertedListsIOHook.h).

An IndexIVF of this package keeps its lists as a host entry store
(codes / listnos / ids per slot: ArrayInvertedLists and DirectMap in one),
from which its device layouts are built. This module is the per-list layer
on top of it, host numpy as in faiss_tpu:

  - ``InvertedLists``: the per-list read API (list_size / get_codes /
    get_ids);
  - ``ArrayInvertedLists``: in-RAM lists, or a snapshot of an IndexIVF's
    store (``from_index``);
  - ``SliceInvertedLists`` (InvertedLists.h:399): a list-range view;
  - ``HStackInvertedLists`` (InvertedLists.h:375): per-list concatenation
    of several sources;
  - ``VStackInvertedLists`` (InvertedLists.h:420): list-wise stacking;
  - ``OnDiskInvertedLists`` (OnDiskInvertedLists.h:60): growable lists in
    one memory-mapped file;
  - ``InvertedListsIOHook``: the registry of custom InvertedLists classes.

Views are read-only; ``replace_invlists`` copies any InvertedLists into an
IndexIVF's entry store and drops the index's device layouts."""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Sequence

import numpy as np


class InvertedLists:
    """Abstract per-list storage (reference: InvertedLists.h:58)."""

    def __init__(self, nlist: int, code_size: int):
        self.nlist = int(nlist)
        self.code_size = int(code_size)

    def list_size(self, list_no: int) -> int:
        raise NotImplementedError

    def get_codes(self, list_no: int) -> np.ndarray:
        raise NotImplementedError

    def get_ids(self, list_no: int) -> np.ndarray:
        raise NotImplementedError

    def add_entries(self, list_no, ids, codes) -> int:
        raise RuntimeError("read-only InvertedLists")

    @property
    def compute_ntotal(self) -> int:
        return sum(self.list_size(i) for i in range(self.nlist))

    def print_stats(self) -> str:
        sizes = [self.list_size(i) for i in range(self.nlist)]
        return (
            f"InvertedLists: nlist={self.nlist} ntotal={sum(sizes)} "
            f"max={max(sizes) if sizes else 0}"
        )


class ArrayInvertedLists(InvertedLists):
    """In-RAM lists (reference: InvertedLists.h:264)."""

    def __init__(self, nlist: int, code_size: int):
        super().__init__(nlist, code_size)
        self._ids: List[np.ndarray] = [
            np.empty(0, np.int64) for _ in range(nlist)
        ]
        self._codes: List[np.ndarray] = [
            np.empty((0, code_size), np.uint8) for _ in range(nlist)
        ]

    @classmethod
    def from_index(cls, index) -> "ArrayInvertedLists":
        """Snapshot an IndexIVF's flat entry store into per-list arrays."""
        codes = index._codes_host
        if codes is None:
            codes = np.empty((index.ntotal, 0), np.uint8)
        code_size = (
            codes.shape[1] * codes.dtype.itemsize if codes.ndim == 2 else 0
        )
        il = cls(index.nlist, code_size)
        order = np.argsort(index._listnos_host, kind="stable")
        ln = index._listnos_host[order]
        bounds = np.searchsorted(ln, np.arange(index.nlist + 1))
        for l in range(index.nlist):
            sl = order[bounds[l] : bounds[l + 1]]
            il._ids[l] = index._ids_host[sl].copy()
            il._codes[l] = (
                codes[sl].view(np.uint8).reshape(len(sl), -1).copy()
            )
        return il

    def list_size(self, list_no):
        return len(self._ids[list_no])

    def get_codes(self, list_no):
        return self._codes[list_no]

    def get_ids(self, list_no):
        return self._ids[list_no]

    def add_entries(self, list_no, ids, codes) -> int:
        ids = np.asarray(ids, np.int64).ravel()
        codes = np.asarray(codes, np.uint8).reshape(len(ids), -1)
        self._ids[list_no] = np.concatenate([self._ids[list_no], ids])
        self._codes[list_no] = np.concatenate([self._codes[list_no], codes])
        return len(self._ids[list_no])

    def resize(self, list_no: int, new_size: int) -> None:
        self._ids[list_no] = self._ids[list_no][:new_size]
        self._codes[list_no] = self._codes[list_no][:new_size]


class SliceInvertedLists(InvertedLists):
    """View of lists [i0, i1) (reference: InvertedLists.h:399)."""

    def __init__(self, il: InvertedLists, i0: int, i1: int):
        super().__init__(i1 - i0, il.code_size)
        self.il = il
        self.i0, self.i1 = int(i0), int(i1)

    def list_size(self, list_no):
        return self.il.list_size(self.i0 + list_no)

    def get_codes(self, list_no):
        return self.il.get_codes(self.i0 + list_no)

    def get_ids(self, list_no):
        return self.il.get_ids(self.i0 + list_no)


class HStackInvertedLists(InvertedLists):
    """Per-list concatenation of several sources (InvertedLists.h:375)."""

    def __init__(self, ils: Sequence[InvertedLists]):
        if not ils:
            raise ValueError("need at least one source")
        super().__init__(ils[0].nlist, ils[0].code_size)
        for il in ils:
            if il.nlist != self.nlist or il.code_size != self.code_size:
                raise ValueError("incompatible InvertedLists for hstack")
        self.ils = list(ils)

    def list_size(self, list_no):
        return sum(il.list_size(list_no) for il in self.ils)

    def get_codes(self, list_no):
        return np.concatenate([il.get_codes(list_no) for il in self.ils])

    def get_ids(self, list_no):
        return np.concatenate([il.get_ids(list_no) for il in self.ils])


class VStackInvertedLists(InvertedLists):
    """List-wise stacking: output list l belongs to the source whose list
    range contains it (reference: InvertedLists.h:420)."""

    def __init__(self, ils: Sequence[InvertedLists]):
        if not ils:
            raise ValueError("need at least one source")
        super().__init__(sum(il.nlist for il in ils), ils[0].code_size)
        self.ils = list(ils)
        self.cumsz = np.cumsum([0] + [il.nlist for il in ils])

    def _locate(self, list_no):
        s = int(np.searchsorted(self.cumsz, list_no, side="right") - 1)
        return self.ils[s], list_no - int(self.cumsz[s])

    def list_size(self, list_no):
        il, l = self._locate(list_no)
        return il.list_size(l)

    def get_codes(self, list_no):
        il, l = self._locate(list_no)
        return il.get_codes(l)

    def get_ids(self, list_no):
        il, l = self._locate(list_no)
        return il.get_ids(l)


def replace_invlists(index, il: InvertedLists) -> None:
    """Copy an InvertedLists into an IndexIVF's entry store, list by list
    (faiss_tpu invlists.py:183; the reference swaps the pointer). Code
    bytes are viewed back as the store's dtype (float32 rows of IVF-Flat,
    uint16 PQ codes); the device layouts are rebuilt at the next search."""
    if il.nlist != index.nlist:
        raise ValueError("nlist mismatch")
    ids, listnos, codes = [], [], []
    for l in range(il.nlist):
        n = il.list_size(l)
        if n == 0:
            continue
        ids.append(il.get_ids(l))
        listnos.append(np.full(n, l, np.int32))
        codes.append(il.get_codes(l))
    index._ids_host = (
        np.concatenate(ids) if ids else np.empty(0, np.int64)
    )
    index._listnos_host = (
        np.concatenate(listnos) if listnos else np.empty(0, np.int32)
    )
    raw = (
        np.concatenate(codes)
        if codes
        else np.empty((0, il.code_size), np.uint8)
    )
    if index._codes_host is not None and index._codes_host.dtype != np.uint8:
        # flat store keeps codec-native dtype (e.g. f32 rows for IVFFlat)
        raw = raw.view(index._codes_host.dtype).reshape(len(raw), -1)
    index._codes_host = raw
    index.ntotal = len(index._ids_host)
    index._drop_caches()


class OnDiskInvertedLists(InvertedLists):
    """Growable on-disk lists over one mmapped file
    (reference: invlists/OnDiskInvertedLists.h:60).

    Layout mirrors the reference: each list owns a byte range holding
    ``capacity * code_size`` code bytes followed by ``capacity`` int64 ids;
    the first ``size`` entries are valid. Growth works the same way too —
    capacities round up to powers of two, freed ranges go to a slot
    free-list (best-fit allocation, OnDiskInvertedLists.h:71 Slot), and the
    file is truncated larger when no slot fits. ``prefetch_lists`` warms
    the page cache for an upcoming scan from a thread pool
    (OnDiskInvertedLists.h:115 / OngoingPrefetch): the scan runs on the
    device, so prefetch hides the disk latency of the host-side copy into
    the index's entry store, not of a CPU scan; ``close`` stops the pool.

    Incremental add is slow by design (as the reference documents): bulk
    construction should go through ``merge_from_multiple``.
    """

    def __init__(self, nlist: int, code_size: int, filename: str,
                 read_only: bool = False):
        super().__init__(nlist, code_size)
        self.filename = filename
        self.read_only = bool(read_only)
        # per-list (size, capacity, offset-in-bytes); capacity in entries
        self.sizes = np.zeros(nlist, np.int64)
        self.caps = np.zeros(nlist, np.int64)
        self.offs = np.zeros(nlist, np.int64)
        self.slots: List[tuple] = []  # free (offset, capacity_bytes)
        self.totsize = 0
        self._map = None
        self._pf = None
        if not os.path.exists(filename):
            with open(filename, "wb"):
                pass

    # -- mmap management ---------------------------------------------------
    def _entry_bytes(self, cap: int) -> int:
        return cap * self.code_size + cap * 8

    def _do_mmap(self):
        if self.totsize == 0:
            self._map = None
            return
        mode = "r" if self.read_only else "r+"
        self._map = np.memmap(
            self.filename, dtype=np.uint8, mode=mode, shape=(self.totsize,)
        )

    def _update_totsize(self, new_totsize: int) -> None:
        if new_totsize > self.totsize:
            # grow the file; the gap becomes one free slot
            with open(self.filename, "r+b") as f:
                f.truncate(new_totsize)
            self._free_slot(self.totsize, new_totsize - self.totsize)
            self.totsize = new_totsize
            self._do_mmap()

    # -- slot allocator (OnDiskInvertedLists.h:133 allocate_slot) ----------
    def _allocate_slot(self, capacity: int) -> int:
        """Return a byte offset for ``capacity`` bytes: best-fit from the
        free list, else grow the file."""
        best = -1
        for i, (o, c) in enumerate(self.slots):
            if c >= capacity and (best < 0 or c < self.slots[best][1]):
                best = i
        if best < 0:
            grow = max(capacity, self.totsize, 1 << 16)
            self._update_totsize(self.totsize + grow)
            return self._allocate_slot(capacity)
        o, c = self.slots.pop(best)
        if c > capacity:
            self.slots.append((o + capacity, c - capacity))
        return o

    def _free_slot(self, offset: int, capacity: int) -> None:
        if capacity == 0:
            return
        # coalesce with adjacent free slots
        merged = True
        while merged:
            merged = False
            for i, (o, c) in enumerate(self.slots):
                if o + c == offset:
                    offset, capacity = o, c + capacity
                    self.slots.pop(i)
                    merged = True
                    break
                if offset + capacity == o:
                    capacity += c
                    self.slots.pop(i)
                    merged = True
                    break
        self.slots.append((offset, capacity))

    # -- per-list accessors ------------------------------------------------
    def list_size(self, list_no):
        return int(self.sizes[list_no])

    def _code_view(self, list_no):
        o, cap = int(self.offs[list_no]), int(self.caps[list_no])
        if cap == 0 or self._map is None:
            return np.empty(0, np.uint8)
        return self._map[o : o + cap * self.code_size]

    def _id_view(self, list_no):
        o, cap = int(self.offs[list_no]), int(self.caps[list_no])
        if cap == 0 or self._map is None:
            return np.empty(0, np.int64)
        o += cap * self.code_size
        return self._map[o : o + cap * 8].view(np.int64)

    def get_codes(self, list_no):
        n = int(self.sizes[list_no])
        return self._code_view(list_no)[: n * self.code_size].reshape(
            n, self.code_size
        )

    def get_ids(self, list_no):
        return self._id_view(list_no)[: int(self.sizes[list_no])]

    # -- mutation ----------------------------------------------------------
    def _resize_locked(self, list_no: int, new_size: int) -> None:
        size, cap = int(self.sizes[list_no]), int(self.caps[list_no])
        if new_size <= cap and (new_size > cap // 2 or new_size == 0):
            if new_size == 0 and cap:
                self._free_slot(int(self.offs[list_no]), self._entry_bytes(cap))
                self.caps[list_no] = 0
                self.offs[list_no] = 0
            self.sizes[list_no] = new_size
            return
        new_cap = 1
        while new_cap < new_size:
            new_cap *= 2
        keep_codes = self.get_codes(list_no)[: min(size, new_size)].copy()
        keep_ids = self.get_ids(list_no)[: min(size, new_size)].copy()
        if cap:
            self._free_slot(int(self.offs[list_no]), self._entry_bytes(cap))
        off = self._allocate_slot(self._entry_bytes(new_cap))
        self.offs[list_no] = off
        self.caps[list_no] = new_cap
        self.sizes[list_no] = new_size
        if len(keep_ids):
            self._code_view(list_no)[: keep_codes.size] = keep_codes.ravel()
            self._id_view(list_no)[: len(keep_ids)] = keep_ids

    def resize(self, list_no: int, new_size: int) -> None:
        if self.read_only:
            raise RuntimeError("read-only OnDiskInvertedLists")
        self._resize_locked(list_no, int(new_size))

    def add_entries(self, list_no, ids, codes) -> int:
        if self.read_only:
            raise RuntimeError("read-only OnDiskInvertedLists")
        ids = np.asarray(ids, np.int64).ravel()
        codes = np.asarray(codes, np.uint8).reshape(len(ids), -1)
        o = int(self.sizes[list_no])
        self._resize_locked(list_no, o + len(ids))
        self._code_view(list_no)[
            o * self.code_size : (o + len(ids)) * self.code_size
        ] = codes.ravel()
        self._id_view(list_no)[o : o + len(ids)] = ids
        return int(self.sizes[list_no])

    def update_entries(self, list_no, offset, ids, codes) -> None:
        if self.read_only:
            raise RuntimeError("read-only OnDiskInvertedLists")
        ids = np.asarray(ids, np.int64).ravel()
        codes = np.asarray(codes, np.uint8).reshape(len(ids), -1)
        o = int(offset)
        assert o + len(ids) <= int(self.sizes[list_no])
        self._code_view(list_no)[
            o * self.code_size : (o + len(ids)) * self.code_size
        ] = codes.ravel()
        self._id_view(list_no)[o : o + len(ids)] = ids

    @property
    def is_compact(self) -> bool:
        """size == capacity everywhere and no free slots
        (OnDiskInvertedLists.h:50)."""
        return not self.slots and bool(np.all(self.sizes == self.caps))

    # -- bulk construction (OnDiskInvertedLists.h:103) ---------------------
    def merge_from_multiple(self, ils: Sequence[InvertedLists],
                            shift_ids: bool = False) -> int:
        """Copy every source list into this object in COMPACT form (exact
        capacities, no slots). Returns the total entries merged."""
        sizes = np.zeros(self.nlist, np.int64)
        for il in ils:
            if il.nlist != self.nlist or il.code_size != self.code_size:
                raise ValueError("incompatible InvertedLists for merge")
            for l in range(self.nlist):
                sizes[l] += il.list_size(l)
        self.set_all_lists_sizes(sizes)
        fill = np.zeros(self.nlist, np.int64)
        id_shift = 0
        for il in ils:
            for l in range(self.nlist):
                n = il.list_size(l)
                if n == 0:
                    continue
                o = int(fill[l])
                self._code_view(l)[
                    o * self.code_size : (o + n) * self.code_size
                ] = np.asarray(il.get_codes(l), np.uint8).ravel()
                new_ids = np.asarray(il.get_ids(l), np.int64)
                self._id_view(l)[o : o + n] = (
                    new_ids + id_shift if shift_ids else new_ids
                )
                fill[l] += n
            if shift_ids:
                id_shift += il.compute_ntotal
        self.sizes[:] = sizes
        return int(sizes.sum())

    def merge_from_1(self, il: InvertedLists) -> int:
        return self.merge_from_multiple([il])

    def set_all_lists_sizes(self, sizes) -> None:
        """Lay out a packed storage with the given sizes
        (OnDiskInvertedLists.h:137)."""
        sizes = np.asarray(sizes, np.int64)
        offs = np.zeros(self.nlist, np.int64)
        o = 0
        for l in range(self.nlist):
            offs[l] = o
            o += self._entry_bytes(int(sizes[l]))
        self.slots = []
        self.totsize = 0
        with open(self.filename, "r+b") as f:
            f.truncate(o)
        self.totsize = o
        self._do_mmap()
        self.sizes[:] = sizes
        self.caps[:] = sizes
        self.offs[:] = offs

    def crop_invlists(self, l0: int, l1: int) -> None:
        """Restrict to lists [l0, l1) without touching the file
        (OnDiskInvertedLists.h:113)."""
        self.sizes = self.sizes[l0:l1]
        self.caps = self.caps[l0:l1]
        self.offs = self.offs[l0:l1]
        self.nlist = int(l1 - l0)

    # -- prefetch (OnDiskInvertedLists.h:115 OngoingPrefetch) --------------
    def prefetch_lists(self, list_nos, nthread: int = 4) -> None:
        """Warm the page cache for the given lists from a thread pool; a
        subsequent staging gather then reads RAM, not disk."""
        if self._map is None:
            return
        lns = [int(l) for l in np.asarray(list_nos).ravel() if l >= 0]

        def touch(l):
            # force a read of the backing pages (sum is cheap and cannot
            # be optimized away by numpy)
            c = self._code_view(l)
            i = self._id_view(l)
            return int(c[:: 4096].sum()) + int(i[:: 512].sum())

        if self._pf is None:
            self._pf = ThreadPoolExecutor(max_workers=nthread)
        list(self._pf.map(touch, lns))

    def close(self) -> None:
        """Stop the prefetch threads and drop the mapping (the file
        stays)."""
        if self._pf is not None:
            self._pf.shutdown()
            self._pf = None
        self._map = None


# ---------------------------------------------------------------------------
# custom invlists IO registry (InvertedListsIOHook.h)
# ---------------------------------------------------------------------------

_io_hooks: Dict[str, "InvertedListsIOHook"] = {}


class InvertedListsIOHook:
    """Serialization hook for custom InvertedLists classes.

    Subclass, set ``classname``, implement write/read, then
    ``InvertedListsIOHook.add_callback(hook)`` — write_index/read_index
    route invlists whose class matches (reference: InvertedListsIOHook.h).
    """

    classname: str = ""

    def write(self, il, arrays: dict, path: str) -> dict:
        raise NotImplementedError

    def read(self, meta: dict, arrays: dict, path: str):
        raise NotImplementedError

    @staticmethod
    def add_callback(hook: "InvertedListsIOHook") -> None:
        _io_hooks[hook.classname] = hook

    @staticmethod
    def lookup(classname: str) -> "InvertedListsIOHook":
        if classname not in _io_hooks:
            raise KeyError(f"no InvertedListsIOHook for {classname}")
        return _io_hooks[classname]

    @staticmethod
    def lookup_or_none(classname: str):
        return _io_hooks.get(classname)
