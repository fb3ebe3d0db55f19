"""The reference library's own index format (.faissindex; counterpart of
faiss_tpu/io_ref.py).

The fourcc container of faiss's impl/index_write.cpp:100 and
impl/index_read.cpp:283 (io_macros.h WRITE1 / WRITEVECTOR), parsed and
written in numpy, so that indexes written by the reference library load into
the port (:func:`read_ref_index`) and indexes of the port export to it
(:func:`write_ref_index`). The families are faiss_tpu's: Flat
(IxF2/IxFI/IxFl), PQ (IxPq), PQFastScan (IPfs), ScalarQuantizer (IxSQ),
IVFFlat (IwFl), IVFScalarQuantizer (IwSq), IVFPQ (IwPQ), IVFPQFastScan (IwPf,
its BlockInvertedLists), PreTransform (IxPT) over LinearTransform, random
rotation, PCA, RemapDimensions, Normalization and Centering records, Refine
(IxRF) and IDMap (IxMp/IxM2). An unknown fourcc raises with its code.

The writer gives faiss_tpu's bytes for the same index. The reader turns the
records into the tree of the npz container (io.py) and builds the index
through the port's own loader on ``device``: an IVF index gets its host
lists through the path every file takes, so its device layouts are staged at
its first search, and codes above 8 bits stay uint16 on the host. A Refine
record's flat store is written as float32 (the values of an fp16 store) and
read back as a float32 store, as faiss_tpu does. Under a Refine the IVF's
entries are put back in the order of their ids (the file holds them list
by list), because the fused re-rank gathers the refinement's store by entry;
faiss_tpu's reader leaves them list by list.

Layout notes (all little-endian, no alignment padding):
  WRITE1(x)       raw bytes of x (int=4, size_t/idx_t=8, bool/char=1,
                  float=4, enums=4)
  WRITEVECTOR(v)  u64 count then count raw elements
  WRITEXBVECTOR   u64 count-of-f32 then raw f32s (IndexFlat codes,
                  io_macros.h:112)
  fourcc          4 ASCII bytes
"""

from __future__ import annotations

import struct
from typing import BinaryIO, Dict, List, Optional, Union

import numpy as np
import torch

from .metric import MetricType

__all__ = ["read_ref_index", "write_ref_index", "REF_FOURCCS"]


# the fourccs this module reads at the top of a file (io.read_index sniffs
# the container format by them)
REF_FOURCCS = {
    b"IxF2", b"IxFI", b"IxFl", b"IxPq", b"IPfs", b"IxSQ",
    b"IwFl", b"IwSq", b"IwPQ", b"IwPf",
    b"IxPT", b"IxRF", b"IxMp", b"IxM2", b"null",
}


# ---------------------------------------------------------------------------
# low-level reader / writer over a byte stream
# ---------------------------------------------------------------------------


class _R:
    def __init__(self, buf: bytes):
        self.b = buf
        self.o = 0

    def raw(self, n: int) -> bytes:
        if self.o + n > len(self.b):
            raise EOFError("truncated reference index file")
        out = self.b[self.o : self.o + n]
        self.o += n
        return out

    def u32(self) -> int:
        return struct.unpack("<I", self.raw(4))[0]

    def i32(self) -> int:
        return struct.unpack("<i", self.raw(4))[0]

    def u64(self) -> int:
        return struct.unpack("<Q", self.raw(8))[0]

    def i64(self) -> int:
        return struct.unpack("<q", self.raw(8))[0]

    def f32(self) -> float:
        return struct.unpack("<f", self.raw(4))[0]

    def boolean(self) -> bool:
        return self.raw(1) != b"\x00"

    def fourcc(self) -> bytes:
        return self.raw(4)

    def vector(self, dtype) -> np.ndarray:
        n = self.u64()
        dt = np.dtype(dtype)
        return np.frombuffer(self.raw(n * dt.itemsize), dt).copy()

    def xbvector(self) -> np.ndarray:
        # READXBVECTOR (io_macros.h:120): count is the number of f32s
        n = self.u64()
        return np.frombuffer(self.raw(n * 4), np.float32).copy()


class _W:
    def __init__(self):
        self.parts: List[bytes] = []

    def raw(self, b: bytes):
        self.parts.append(b)

    def u32(self, x):
        self.raw(struct.pack("<I", x))

    def i32(self, x):
        self.raw(struct.pack("<i", x))

    def u64(self, x):
        self.raw(struct.pack("<Q", x))

    def i64(self, x):
        self.raw(struct.pack("<q", x))

    def f32(self, x):
        self.raw(struct.pack("<f", x))

    def boolean(self, x):
        self.raw(b"\x01" if x else b"\x00")

    def fourcc(self, c: bytes):
        assert len(c) == 4
        self.raw(c)

    def vector(self, arr: np.ndarray, dtype):
        arr = np.ascontiguousarray(arr, dtype)
        self.u64(arr.size)
        self.raw(arr.tobytes())

    def xbvector(self, arr: np.ndarray):
        arr = np.ascontiguousarray(arr, np.float32)
        self.u64(arr.size)
        self.raw(arr.tobytes())

    def getvalue(self) -> bytes:
        return b"".join(self.parts)


# ---------------------------------------------------------------------------
# pq4 fast-scan block packing (impl/fast_scan/fast_scan.cpp:48
# pq4_pack_codes) — vectorized numpy pack/unpack of the interleaved
# nibble layout: blocks of bbs vectors x M2 nibbles; sub-quantizers
# paired two-per-byte-plane, 32-vector groups permuted by perm0
# ---------------------------------------------------------------------------

_PERM0 = np.array(
    [0, 8, 1, 9, 2, 10, 3, 11, 4, 12, 5, 13, 6, 14, 7, 15], np.int64
)


def _pq4_pack(codes_int: np.ndarray, bbs: int, M2: int) -> np.ndarray:
    """codes_int [n, M] (values < 16) -> packed uint8 of
    ceil(n/bbs) * bbs * M2 / 2 bytes in the reference block layout."""
    n, M = codes_int.shape
    nb = -(-max(n, 1) // bbs) * bbs
    c = np.zeros((nb, M2), np.uint8)
    c[:n, :M] = codes_int
    # byte stream per (block, sq-pair, 32-group): 32 bytes
    # j in 0..15: out[j]   = lo[perm0[j]] | lo[perm0[j]+16] << 4
    #             out[j+16]= hi[perm0[j]] | hi[perm0[j]+16] << 4
    # where lo/hi are the nibbles of the BYTE holding sq-pair (2 codes)
    byte = (c[:, 0::2] | (c[:, 1::2] << 4)).astype(np.uint8)  # [nb, M2/2]
    lo = byte & 15
    hi = byte >> 4
    g = nb // 32
    lo = lo.reshape(g, 32, M2 // 2)
    hi = hi.reshape(g, 32, M2 // 2)
    out = np.empty((g, M2 // 2, 32), np.uint8)
    out[:, :, :16] = np.transpose(
        lo[:, _PERM0] | (lo[:, _PERM0 + 16] << 4), (0, 2, 1)
    )
    out[:, :, 16:] = np.transpose(
        hi[:, _PERM0] | (hi[:, _PERM0 + 16] << 4), (0, 2, 1)
    )
    # group blocks of bbs vectors: [nb/bbs, M2/2, bbs/32 groups of 32]
    nblk = nb // bbs
    out = out.reshape(nblk, bbs // 32, M2 // 2, 32)
    out = np.transpose(out, (0, 2, 1, 3))
    return np.ascontiguousarray(out).reshape(-1)


def _pq4_unpack(blocks: np.ndarray, n: int, M: int, bbs: int,
                M2: int) -> np.ndarray:
    """Inverse of _pq4_pack: packed bytes -> codes_int [n, M] uint8."""
    nb = -(-max(n, 1) // bbs) * bbs
    out = blocks[: nb * M2 // 2].reshape(nb // bbs, M2 // 2, bbs // 32, 32)
    out = np.transpose(out, (0, 2, 1, 3)).reshape(-1, M2 // 2, 32)
    lo16 = out[:, :, :16]
    hi16 = out[:, :, 16:]
    g = out.shape[0]
    lo = np.empty((g, 32, M2 // 2), np.uint8)
    hi = np.empty((g, 32, M2 // 2), np.uint8)
    lo[:, _PERM0] = np.transpose(lo16 & 15, (0, 2, 1))
    lo[:, _PERM0 + 16] = np.transpose(lo16 >> 4, (0, 2, 1))
    hi[:, _PERM0] = np.transpose(hi16 & 15, (0, 2, 1))
    hi[:, _PERM0 + 16] = np.transpose(hi16 >> 4, (0, 2, 1))
    byte = (lo | (hi << 4)).reshape(nb, M2 // 2)
    codes = np.empty((nb, M2), np.uint8)
    codes[:, 0::2] = byte & 15
    codes[:, 1::2] = byte >> 4
    return codes[:n, :M].copy()


# ---------------------------------------------------------------------------
# generic nbits bitstring packing (impl/ProductQuantizer encoders /
# BitstringWriter: LSB-first within the byte stream)
# ---------------------------------------------------------------------------


def _bits_unpack(buf: np.ndarray, n: int, M: int, nbits: int) -> np.ndarray:
    """[n, code_size] packed bytes -> [n, M] int codes (LSB-first)."""
    if nbits == 8:
        return buf.reshape(n, M).copy()
    if nbits == 16:
        return buf.reshape(n, -1).view("<u2").reshape(n, M).copy()
    bits = np.unpackbits(buf.reshape(n, -1), axis=1, bitorder="little")
    bits = bits[:, : M * nbits].reshape(n, M, nbits)
    return (bits.astype(np.uint32) << np.arange(nbits, dtype=np.uint32)).sum(
        -1
    )


def _bits_pack(codes: np.ndarray, nbits: int) -> np.ndarray:
    """[n, M] int codes -> [n, code_size] packed bytes (LSB-first)."""
    n, M = codes.shape
    if nbits == 8:
        return codes.astype(np.uint8)
    if nbits == 16:
        return codes.astype("<u2").view(np.uint8).reshape(n, -1)
    c = codes.astype(np.uint32)
    bits = (
        (c[..., None] >> np.arange(nbits, dtype=np.uint32)) & 1
    ).astype(np.uint8).reshape(n, M * nbits)
    return np.packbits(bits, axis=1, bitorder="little")


# ---------------------------------------------------------------------------
# shared records
# ---------------------------------------------------------------------------


def _np(a) -> np.ndarray:
    """A host array of a port attribute (numpy, or a tensor anywhere)."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _read_header(r: _R):
    d = r.i32()
    ntotal = r.i64()
    r.i64()  # dummy (index_write.cpp:103)
    r.i64()
    is_trained = r.boolean()
    mt = r.i32()
    metric_arg = r.f32() if mt > 1 else 0.0
    return d, ntotal, is_trained, MetricType(mt), metric_arg


def _write_header(w: _W, index):
    w.i32(index.d)
    w.i64(index.ntotal)
    w.i64(1 << 20)
    w.i64(1 << 20)
    w.boolean(index.is_trained)
    mt = int(index.metric_type)
    w.i32(mt)
    if mt > 1:
        w.f32(getattr(index, "metric_arg", 0.0))


def _read_pq(r: _R, arrays, key):
    """write_ProductQuantizer (index_write.cpp:183): d, M, nbits size_t and
    the centroids [M, ksub, dsub] float32, stored under ``key``."""
    d, M, nbits = r.u64(), r.u64(), r.u64()
    cent = r.vector(np.float32)
    arrays[key] = cent.reshape(M, 1 << nbits, d // M)
    return {"d": d, "M": M, "nbits": nbits}


def _write_pq(w: _W, pq):
    w.u64(pq.d)
    w.u64(pq.M)
    w.u64(pq.nbits)
    w.vector(_np(pq.centroids).reshape(-1), np.float32)


def _read_sq(r: _R, arrays, key):
    """write_ScalarQuantizer (index_write.cpp:262): (qtype, code_size), the
    trained range stored under ``key``."""
    from .codecs.sq import QuantizerType

    qtype = QuantizerType(r.i32())
    r.i32()  # rangestat
    r.f32()  # rangestat_arg
    d = r.u64()
    code_size = r.u64()
    trained = r.vector(np.float32)
    if trained.size == 2:
        arrays[key] = trained.reshape(2, 1)
    elif trained.size == 2 * d:
        arrays[key] = trained.reshape(2, d)
    elif trained.size:
        raise ValueError(
            f"unsupported ScalarQuantizer trained layout ({trained.size} "
            f"floats for d={d}): TurboQuant tables are not in this format")
    return qtype, code_size


def _write_sq(w: _W, sq, d: int):
    w.i32(int(sq.qtype))
    w.i32(0)  # RS_minmax
    w.f32(0.0)
    w.u64(d)
    w.u64(sq.code_size)
    tr = sq.trained
    w.vector(np.zeros(0, np.float32) if tr is None else _np(tr).reshape(-1),
             np.float32)


def _read_direct_map(r: _R):
    """write_direct_map (index_write.cpp:451)."""
    dm_type = r.raw(1)[0]
    arr = r.vector(np.int64)
    if dm_type == 2:  # hashtable: vector<pair<idx_t, idx_t>>
        r.raw(r.u64() * 16)
    return arr


def _read_invlists_arrays(r: _R):
    """ArrayInvertedLists 'ilar' (index_write.cpp:271): (nlist, code_size,
    [(listno, codes bytes [n, code_size], ids [n])])."""
    h = r.fourcc()
    if h == b"il00":
        return 0, 0, []
    if h != b"ilar":
        raise ValueError(f"unsupported InvertedLists fourcc {h!r}")
    nlist = r.u64()
    code_size = r.u64()
    lt = r.fourcc()
    if lt == b"full":
        entries = [(i, int(sz)) for i, sz in enumerate(r.vector(np.uint64)) if sz]
    elif lt == b"sprs":
        entries = [(int(i), int(nn)) for i, nn in r.vector(np.uint64).reshape(-1, 2)]
    else:
        raise ValueError(f"unknown invlists list_type {lt!r}")
    lists = []
    for listno, nn in entries:
        codes = np.frombuffer(r.raw(nn * code_size), np.uint8).reshape(nn, code_size)
        ids = np.frombuffer(r.raw(nn * 8), np.int64).copy()
        lists.append((listno, codes, ids))
    return nlist, code_size, lists


def _write_invlists_arrays(w: _W, nlist: int, code_size: int, lists):
    """``lists``: (codes bytes [n, code_size], ids [n]) per list, empty
    lists included."""
    w.fourcc(b"ilar")
    w.u64(nlist)
    w.u64(code_size)
    n_non0 = sum(1 for c, _ in lists if len(c))
    if n_non0 > nlist // 2:
        w.fourcc(b"full")
        w.vector(np.array([len(c) for c, _ in lists], np.uint64), np.uint64)
    else:
        w.fourcc(b"sprs")
        pairs = []
        for i, (c, _) in enumerate(lists):
            if len(c):
                pairs.extend((i, len(c)))
        w.vector(np.array(pairs, np.uint64), np.uint64)
    for codes, ids in lists:
        if len(codes):
            w.raw(np.ascontiguousarray(codes, np.uint8).tobytes())
            w.raw(np.ascontiguousarray(ids, np.int64).tobytes())


def _gather_lists(index, to_bytes):
    """An IVF index's add-order host arrays grouped into per-list (codes
    bytes, ids), ``to_bytes(codes_rows) -> uint8 [n, cs]``."""
    listnos = index._listnos_host
    if index._codes_host is None:  # no entry yet
        return [(np.zeros((0, 0), np.uint8), np.zeros(0, np.int64))] * index.nlist
    order = np.argsort(listnos, kind="stable")
    bounds = np.searchsorted(listnos[order], np.arange(index.nlist + 1))
    lists = []
    for li in range(index.nlist):
        sel = order[bounds[li] : bounds[li + 1]]
        lists.append((to_bytes(index._codes_host[sel]), index._ids_host[sel]))
    return lists


# ---------------------------------------------------------------------------
# VectorTransform records (index_write.cpp:113)
# ---------------------------------------------------------------------------


def _read_vt(r: _R, arrays, path):
    """One transform record as the container's transform entry (io.py
    ``_dump_transform``), its arrays under ``path``."""
    h = r.fourcc()
    if h in (b"rrot", b"LTra", b"Pcam", b"Viqm"):
        vmeta = {"class": {b"rrot": "RandomRotationMatrix", b"Pcam": "PCAMatrix"}
                 .get(h, "LinearTransform")}
        if h == b"Pcam":
            vmeta["eigen_power"] = r.f32()
            r.f32()  # epsilon
            vmeta["random_rotation"] = r.boolean()
            r.boolean()  # balanced_bins
            mean = r.vector(np.float32)
            r.vector(np.float32)  # eigenvalues
            r.vector(np.float32)  # PCAMat (full rank; A below is the crop)
            if mean.size:
                arrays[f"{path}/mean"] = mean
        elif h == b"Viqm":
            r.i32()  # max_iter
            r.i32()  # seed
        vmeta["have_bias"] = r.boolean()
        A = r.vector(np.float32)
        b = r.vector(np.float32)
        vmeta["d_in"], vmeta["d_out"] = r.i32(), r.i32()
        r.boolean()  # is_trained
        if A.size:
            arrays[f"{path}/A"] = A.reshape(vmeta["d_out"], vmeta["d_in"])
        if b.size:
            arrays[f"{path}/b"] = b
        return vmeta
    if h == b"RmDT":
        arrays[f"{path}/map"] = r.vector(np.int32)
        d_in, d_out = r.i32(), r.i32()
        r.boolean()
        return {"class": "RemapDimensionsTransform", "d_in": d_in, "d_out": d_out}
    if h == b"VNrm":
        norm = r.f32()
        d_in, d_out = r.i32(), r.i32()
        r.boolean()
        return {"class": "NormalizationTransform", "d_in": d_in, "d_out": d_out,
                "norm": norm}
    if h == b"VCnt":
        arrays[f"{path}/mean"] = r.vector(np.float32)
        d_in, d_out = r.i32(), r.i32()
        r.boolean()
        return {"class": "CenteringTransform", "d_in": d_in, "d_out": d_out}
    raise ValueError(f"unsupported VectorTransform fourcc {h!r}")


def _write_vt(w: _W, vt):
    from . import transforms as T

    if isinstance(vt, T.RemapDimensionsTransform):
        w.fourcc(b"RmDT")
        w.vector(_np(vt.map), np.int32)
    elif isinstance(vt, T.NormalizationTransform):
        w.fourcc(b"VNrm")
        w.f32(vt.norm)
    elif isinstance(vt, T.CenteringTransform):
        w.fourcc(b"VCnt")
        w.vector(_np(vt.mean), np.float32)
    elif isinstance(vt, T.LinearTransform):
        # OPQ and the others export as the generic linear record, as the
        # reference does (index_write.cpp:141 "includes OPQ")
        w.fourcc(b"rrot" if isinstance(vt, T.RandomRotationMatrix) else b"LTra")
        bias = vt.have_bias and vt.b is not None
        w.boolean(bias)
        w.vector(np.zeros(0, np.float32) if vt.A is None else _np(vt.A).reshape(-1),
                 np.float32)
        w.vector(_np(vt.b) if bias else np.zeros(0, np.float32), np.float32)
    else:
        raise ValueError(f"cannot export VectorTransform {type(vt).__name__} to "
                         "the reference format")
    w.i32(vt.d_in)
    w.i32(vt.d_out)
    w.boolean(vt.is_trained)


# ---------------------------------------------------------------------------
# index records, read: the container's tree (io.py _dump's) and its arrays
# ---------------------------------------------------------------------------

_FLAT_CLASSES = ("IndexFlat", "IndexScalarQuantizer")  # faiss_tpu's IndexFlat tree


def _read_any(r: _R, arrays: Dict[str, np.ndarray], path: str):
    h = r.fourcc()
    if h == b"null":
        return None

    if h in (b"IxF2", b"IxFI", b"IxFl"):
        d, ntotal, _, mt, marg = _read_header(r)
        mt = {b"IxF2": MetricType.L2, b"IxFI": MetricType.INNER_PRODUCT}.get(h, mt)
        arrays[f"{path}/xb"] = r.xbvector().reshape(ntotal, d)
        return {"class": "IndexFlat", "d": d, "metric": int(mt), "metric_arg": marg,
                "storage_dtype": "float32"}

    if h == b"IxSQ":
        d, ntotal, is_trained, mt, _ = _read_header(r)
        qtype, code_size = _read_sq(r, arrays, f"{path}/sq_trained")
        codes = r.vector(np.uint8)
        if ntotal:
            arrays[f"{path}/codes"] = codes.reshape(ntotal, code_size)
        return {"class": "IndexScalarQuantizer", "d": d, "metric": int(mt),
                "qtype": int(qtype), "is_trained": is_trained}

    if h == b"IxPq":
        d, ntotal, is_trained, mt, _ = _read_header(r)
        pq = _read_pq(r, arrays, f"{path}/pq_centroids")
        codes = r.vector(np.uint8)
        r.i32()  # search_type
        r.boolean()  # encode_signs
        r.i32()  # polysemous_ht
        if ntotal:
            arrays[f"{path}/codes"] = _bits_unpack(
                codes.reshape(ntotal, -1), ntotal, pq["M"], pq["nbits"]
            ).astype(np.uint8 if pq["nbits"] <= 8 else np.uint16)
        return {"class": "IndexPQ", "d": d, "metric": int(mt),
                "is_trained": is_trained, "pq": pq}

    if h == b"IPfs":
        d, ntotal, is_trained, mt, _ = _read_header(r)
        pq = _read_pq(r, arrays, f"{path}/pq_centroids")
        r.i32()  # implem
        bbs = r.i32()
        r.i32()  # qbs
        r.u64()  # ntotal2
        M2 = r.u64()
        codes = r.vector(np.uint8)
        if ntotal:
            arrays[f"{path}/codes"] = _pq4_unpack(codes, ntotal, pq["M"], bbs, M2)
        return {"class": "IndexPQFastScan", "d": d, "metric": int(mt),
                "is_trained": is_trained, "pq": pq, "bbs": bbs}

    if h in (b"IwFl", b"IwSq", b"IwPQ", b"IwPf"):
        return _read_ivf(r, h, arrays, path)

    if h == b"IxPT":
        d, _, _, mt, _ = _read_header(r)
        chain = [_read_vt(r, arrays, f"{path}/vt{ci}") for ci in range(r.i32())]
        return {"class": "IndexPreTransform", "d": d, "metric": int(mt),
                "chain": chain, "sub": _read_any(r, arrays, f"{path}/sub")}

    if h == b"IxRF":
        _read_header(r)
        base = _read_any(r, arrays, f"{path}/base")
        if "nlist" in base:
            _add_order(arrays, f"{path}/base")
        refine = _read_any(r, arrays, f"{path}/refine")
        cls = "IndexRefineFlat" if refine["class"] in _FLAT_CLASSES else "IndexRefine"
        return {"class": cls, "k_factor": r.f32(), "base": base, "refine": refine}

    if h in (b"IxMp", b"IxM2"):
        _read_header(r)
        sub = _read_any(r, arrays, f"{path}/sub")
        arrays[f"{path}/id_map"] = r.vector(np.int64)
        return {"class": "IndexIDMap2" if h == b"IxM2" else "IndexIDMap", "sub": sub}

    raise ValueError(
        f"unsupported reference index fourcc {h!r}; supported: "
        f"{sorted(c.decode() for c in REF_FOURCCS)}")


def _add_order(arrays, path):
    """A refinement's IVF entries, read list by list, back in the order of
    their ids: the refinement's store holds row i for id i, and the port's
    fused re-rank gathers it by entry (slot), as after ``add``. Ids that are
    not 0..n-1 cannot be matched to the store's rows, and raise."""
    ids = arrays[f"{path}/ids"]
    order = np.argsort(ids, kind="stable")
    if not np.array_equal(ids[order], np.arange(len(ids))):
        raise ValueError(
            "IxRF over an IVF whose ids are not 0..ntotal-1: the refine "
            "store's rows cannot be matched to its entries")
    for name in ("ids", "listnos", "codes"):
        if f"{path}/{name}" in arrays:
            arrays[f"{path}/{name}"] = arrays[f"{path}/{name}"][order]


def _read_ivf(r: _R, h: bytes, arrays, path):
    """The IVF records: the header, the coarse quantizer, the direct map,
    the codec and the lists, as the container's host lists in list order."""
    d, ntotal, is_trained, mt, _ = _read_header(r)
    meta = {"d": d, "metric": int(mt), "nlist": r.u64(), "is_trained": is_trained}
    meta["nprobe"] = max(1, r.u64())
    meta["quantizer"] = _read_any(r, arrays, f"{path}/quantizer")
    _read_direct_map(r)
    meta["by_residual"] = False
    if h == b"IwFl":
        meta["class"] = "IndexIVFFlat"
        _, _, lists = _read_invlists_arrays(r)

        def conv(c):
            return np.ascontiguousarray(c).view(np.float32).reshape(len(c), d)
    elif h == b"IwSq":
        meta["class"] = "IndexIVFScalarQuantizer"
        qtype, _ = _read_sq(r, arrays, f"{path}/sq_trained")
        r.u64()  # code_size
        meta.update(qtype=int(qtype), by_residual=r.boolean())
        meta["sq_by_residual"] = meta["by_residual"]
        _, _, lists = _read_invlists_arrays(r)

        def conv(c):  # the packed SQ bytes, the port's layout
            return c
    elif h == b"IwPQ":
        meta["class"] = "IndexIVFPQ"
        meta["by_residual"] = r.boolean()
        r.u64()  # code_size
        pq = meta["pq"] = _read_pq(r, arrays, f"{path}/pq_centroids")
        _, _, lists = _read_invlists_arrays(r)

        def conv(c):
            return _bits_unpack(c, len(c), pq["M"], pq["nbits"]).astype(
                np.uint8 if pq["nbits"] <= 8 else np.uint16)
    else:  # IwPf
        meta["class"] = "IndexIVFPQFastScan"
        meta["by_residual"] = r.boolean()
        r.u64()  # code_size
        bbs = meta["bbs"] = r.i32()
        M2 = r.u64()
        r.i32()  # implem
        r.u64()  # qbs2
        pq = meta["pq"] = _read_pq(r, arrays, f"{path}/pq_centroids")
        ilh = r.fourcc()
        if ilh != b"ilbl":
            raise ValueError(f"IwPf expects BlockInvertedLists, got {ilh!r}")
        r.u64()  # nlist
        r.u64()  # code_size
        r.u64()  # n_per_block
        r.u64()  # block_size
        lists = []
        for li in range(meta["nlist"]):
            ids = r.vector(np.int64)
            blocks = r.vector(np.uint8)
            if len(ids):
                lists.append((li, _pq4_unpack(blocks, len(ids), pq["M"], bbs, M2), ids))

        def conv(c):  # unpacked above
            return c
    arrays[f"{path}/listnos"] = (
        np.concatenate([np.full(len(ids), li, np.int32) for li, _, ids in lists])
        if lists else np.zeros(0, np.int32))
    arrays[f"{path}/ids"] = (np.concatenate([ids for _, _, ids in lists])
                             if lists else np.zeros(0, np.int64))
    if lists:
        arrays[f"{path}/codes"] = np.concatenate([conv(c) for _, c, _ in lists])
    if len(arrays[f"{path}/ids"]) != ntotal:
        raise ValueError(f"the lists hold {len(arrays[f'{path}/ids'])} entries, "
                         f"the header says {ntotal}")
    return meta


# ---------------------------------------------------------------------------
# index records, write (faiss_tpu io_ref.py:715)
# ---------------------------------------------------------------------------


def _write_any(w: _W, index):
    from .models.flat import IndexFlat
    from .models.ivf_flat import IndexIVFFlat
    from .models.ivf_pq import IndexIVFPQ, IndexIVFPQFastScan
    from .models.meta import IndexIDMap, IndexIDMap2, IndexPreTransform, IndexRefine
    from .models.pq import IndexPQ, IndexPQFastScan
    from .models.sq import IndexIVFScalarQuantizer, IndexScalarQuantizer

    if index is None:
        w.fourcc(b"null")
        return

    if isinstance(index, IndexPreTransform):
        w.fourcc(b"IxPT")
        _write_header(w, index)
        w.i32(len(index.chain))
        for vt in index.chain:
            _write_vt(w, vt)
        _write_any(w, index.index)
        return

    if isinstance(index, IndexIDMap):
        w.fourcc(b"IxM2" if isinstance(index, IndexIDMap2) else b"IxMp")
        _write_header(w, index)
        _write_any(w, index.index)
        w.vector(_np(index.id_map), np.int64)
        return

    if isinstance(index, IndexRefine):
        w.fourcc(b"IxRF")
        _write_header(w, index)
        _write_any(w, index.base_index)
        _write_any(w, index.refine_index)
        w.f32(float(index.k_factor))
        return

    if isinstance(index, IndexIVFPQFastScan):
        w.fourcc(b"IwPf")
        _write_ivf_header(w, index)
        M2 = -(-index.pq.M // 2) * 2
        w.boolean(index.by_residual)
        w.u64(index.pq.M * index.pq.nbits // 8 or 1)
        w.i32(index.bbs)
        w.u64(M2)
        w.i32(0)  # implem: auto
        w.u64(0)  # qbs2
        _write_pq(w, index.pq)
        # BlockInvertedLists (invlists/BlockInvertedLists.cpp:152)
        w.fourcc(b"ilbl")
        w.u64(index.nlist)
        w.u64(M2 // 2)
        w.u64(index.bbs)
        w.u64(index.bbs * M2 // 2)
        for codes, ids in _gather_lists(index, lambda c: c):
            w.vector(np.asarray(ids, np.int64), np.int64)
            w.vector(_pq4_pack(codes, index.bbs, M2), np.uint8)
        return

    if isinstance(index, IndexIVFPQ):
        w.fourcc(b"IwPQ")
        _write_ivf_header(w, index)
        w.boolean(index.by_residual)
        w.u64(index.pq.code_size)
        _write_pq(w, index.pq)
        lists = _gather_lists(index, lambda c: _bits_pack(c, index.pq.nbits))
        _write_invlists_arrays(w, index.nlist, index.pq.code_size, lists)
        return

    if isinstance(index, IndexIVFScalarQuantizer):
        w.fourcc(b"IwSq")
        _write_ivf_header(w, index)
        _write_sq(w, index.sq, index.d)
        w.u64(index.sq.code_size)
        w.boolean(index.by_residual)
        lists = _gather_lists(index, lambda c: c)
        _write_invlists_arrays(w, index.nlist, index.sq.code_size, lists)
        return

    if isinstance(index, IndexIVFFlat):
        w.fourcc(b"IwFl")
        _write_ivf_header(w, index)
        lists = _gather_lists(index, lambda c: np.ascontiguousarray(c, np.float32)
                              .view(np.uint8).reshape(len(c), index.d * 4))
        _write_invlists_arrays(w, index.nlist, index.d * 4, lists)
        return

    if isinstance(index, IndexPQFastScan):
        w.fourcc(b"IPfs")
        _write_header(w, index)
        _write_pq(w, index.pq)
        M2 = -(-index.pq.M // 2) * 2
        w.i32(0)  # implem
        w.i32(index.bbs)
        w.i32(0)  # qbs
        w.u64(-(-max(index.ntotal, 1) // index.bbs) * index.bbs)  # ntotal2
        w.u64(M2)
        w.vector(_pq4_pack(index.codes_host, index.bbs, M2), np.uint8)
        return

    if isinstance(index, IndexPQ):
        w.fourcc(b"IxPq")
        _write_header(w, index)
        _write_pq(w, index.pq)
        codes = (_bits_pack(index.codes_host, index.pq.nbits) if index.ntotal
                 else np.zeros((0, 1), np.uint8))
        w.vector(codes.reshape(-1), np.uint8)
        w.i32(0)  # search_type ST_PQ
        w.boolean(False)  # encode_signs
        w.i32(0)  # polysemous_ht
        return

    if isinstance(index, IndexScalarQuantizer):
        w.fourcc(b"IxSQ")
        _write_header(w, index)
        _write_sq(w, index.sq, index.d)
        codes = index._codes if index._codes is not None else np.zeros((0, 1), np.uint8)
        w.vector(np.asarray(codes, np.uint8).reshape(-1), np.uint8)
        return

    if isinstance(index, IndexFlat):
        mt = index.metric_type
        w.fourcc(b"IxF2" if mt == MetricType.L2
                 else b"IxFI" if mt == MetricType.INNER_PRODUCT else b"IxFl")
        _write_header(w, index)
        w.xbvector(index.vectors())  # an fp16 store's values, as float32
        return

    raise ValueError(
        f"cannot export {type(index).__name__} to the reference binary format "
        "(supported: Flat/PQ/SQ/IVFFlat/IVFSQ/IVFPQ/IVFPQFastScan/PQFastScan/"
        "PreTransform/Refine/IDMap)")


def _write_ivf_header(w: _W, index):
    _write_header(w, index)
    w.u64(index.nlist)
    w.u64(index.nprobe)
    _write_any(w, index.quantizer)
    # direct map: none (write_direct_map, index_write.cpp:451)
    w.raw(b"\x00")
    w.u64(0)


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------


def _read_bytes(src: Union[str, bytes, BinaryIO]) -> bytes:
    if isinstance(src, (bytes, bytearray)):
        return bytes(src)
    if hasattr(src, "read"):
        return src.read()
    with open(src, "rb") as f:
        return f.read()


def read_ref_index(src: Union[str, bytes, BinaryIO], *, device="cuda"):
    """Load an index written by the reference library (impl/index_read.cpp
    read_index) onto ``device``; a file that is not one raises."""
    from .base import require_device
    from .io import _load

    device = require_device(device)
    arrays: Dict[str, np.ndarray] = {}
    meta = _read_any(_R(_read_bytes(src)), arrays, "root")
    return None if meta is None else _load(meta, arrays, "root", device)


def write_ref_index(index, dst: Union[str, BinaryIO, None] = None) -> Optional[bytes]:
    """Serialize ``index`` in the reference binary format
    (impl/index_write.cpp write_index). Returns the bytes when ``dst`` is
    None."""
    w = _W()
    _write_any(w, index)
    buf = w.getvalue()
    if dst is None:
        return buf
    if hasattr(dst, "write"):
        dst.write(buf)
    else:
        with open(dst, "wb") as f:
            f.write(buf)
    return None
