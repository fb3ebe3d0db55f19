"""reverse_index_factory — a factory string from an index (counterpart of
faiss_tpu/factory_tools.py; reference: faiss/factory_tools.h:19).

Where faiss_tpu's string rebuilds the index (``index_factory(d, s)`` gives
the same classes and sizes), the port returns the same string. Where
faiss_tpu's does not, the port returns one that does, or raises TypeError
when the factory's grammar has no string for the index: HNSW over SQ, PQ or
Panorama storage (faiss_tpu: ``HNSWm`` alone), an IVF coarse quantizer
other than flat (``IVFn_HNSWm``, ``IMI2xb``, ``IVFn(...)``; faiss_tpu:
``IVFn``), IndexFlat1D and ITQ without PCA (faiss_tpu: ``Flat``,
``ITQd``), FastScan blocks of other than 32
(faiss_tpu drops ``_bbs``), IndexIVFPQR (faiss_tpu: its IVF-PQ alone),
IndexRefine and the SQ8 refine store (faiss_tpu raises, or writes
``RFlat``), the ``Pad`` transform, every scalar-quantizer type (faiss_tpu
writes ``SQ8`` for the types beyond five). IVF-PQ not by residual and
IndexFlatSQ8 outside a refinement have no string (faiss_tpu writes the
IVF-PQ's, and ``Flat``)."""

from __future__ import annotations

import numpy as np


def _sq_name(qtype) -> str:
    from .factory import _SQ_TYPES

    for name, qt in _SQ_TYPES.items():
        if qt == qtype:
            return name
    raise TypeError(f"no factory token for {qtype!r}")


def _fs(M: int, bbs: int) -> str:
    return f"PQ{M}x4fs" + ("" if bbs == 32 else f"_{bbs}")


def _transform(vt) -> str:
    from . import transforms as T

    if isinstance(vt, T.OPQMatrix):
        return f"OPQ{vt.M}_{vt.d_out}"
    if isinstance(vt, T.PCAMatrix):
        opt = ("W" if vt.eigen_power != 0 else "") + ("R" if vt.random_rotation else "")
        return f"PCA{opt}{vt.d_out}"
    if isinstance(vt, T.RandomRotationMatrix):
        return f"RR{vt.d_out}"
    if isinstance(vt, T.NormalizationTransform):
        return "L2norm"
    if isinstance(vt, T.ITQTransform):
        return f"ITQ{vt.d_out}" if vt.do_pca else "ITQ"
    if isinstance(vt, T.RemapDimensionsTransform):
        pad = np.concatenate([np.arange(vt.d_in), np.full(vt.d_out - vt.d_in, -1)])
        if vt.d_out >= vt.d_in and np.array_equal(np.asarray(vt.map), pad):
            return f"Pad{vt.d_out}"
    raise TypeError(f"no factory token for {type(vt).__name__}")


def _plain_flat(index) -> bool:
    from .models.flat import IndexFlat, IndexFlatIP, IndexFlatL2

    return type(index) in (IndexFlat, IndexFlatL2, IndexFlatIP)


def _ivf_prefix(index) -> str:
    """The coarse spec: ``IVFn``, ``IVFn_HNSWm``, ``IMI2xb`` or ``IVFn(...)``
    around the quantizer's own string."""
    from .models.hnsw import IndexHNSWFlat
    from .models.imi import MultiIndexQuantizer

    q = index.quantizer
    if _plain_flat(q):
        return f"IVF{index.nlist}"
    if type(q) is IndexHNSWFlat and _plain_flat(q.storage):
        return f"IVF{index.nlist}_HNSW{q.hnsw.M}"
    if type(q) is MultiIndexQuantizer and q.pq.M == 2:
        return f"IMI2x{q.pq.nbits}"
    return f"IVF{index.nlist}({reverse_index_factory(q)})"


def _hnsw(index) -> str:
    from .models.hnsw import (
        IndexHNSWFlat,
        IndexHNSWFlatPanorama,
        IndexHNSWPQ,
        IndexHNSWSQ,
    )
    from .models.pq import IndexPQ
    from .models.sq import IndexScalarQuantizer

    M, st = index.hnsw.M, index.storage
    if type(index) is IndexHNSWFlatPanorama:
        return f"HNSW{M},FlatPanorama{index.num_panorama_levels}"
    if type(index) is IndexHNSWFlat and _plain_flat(st):
        return f"HNSW{M}"
    if type(index) is IndexHNSWSQ and isinstance(st, IndexScalarQuantizer):
        return f"HNSW{M},{_sq_name(st.sq.qtype)}"
    if type(index) is IndexHNSWPQ and type(st) is IndexPQ:
        return f"HNSW{M},PQ{st.pq.M}x{st.pq.nbits}"
    raise TypeError(f"no factory token for {type(index).__name__} over "
                    f"{type(st).__name__}")


def reverse_index_factory(index) -> str:
    from .models.flat import IndexFlat1D
    from .models.hnsw import IndexHNSW
    from .models.ivf_flat import IndexIVFFlat
    from .models.ivf_pq import IndexIVFPQ, IndexIVFPQFastScan, IndexIVFPQR
    from .models.lsh import IndexLSH
    from .models.meta import (
        IndexIDMap,
        IndexIDMap2,
        IndexPreTransform,
        IndexRefine,
        IndexRefineFlat,
    )
    from .models.pq import IndexPQ, IndexPQFastScan
    from .models.sq import IndexIVFScalarQuantizer, IndexScalarQuantizer

    if isinstance(index, IndexPreTransform):
        return ",".join([_transform(vt) for vt in index.chain]
                        + [reverse_index_factory(index.index)])
    if isinstance(index, IndexIDMap2):
        return "IDMap2," + reverse_index_factory(index.index)
    if isinstance(index, IndexIDMap):
        return "IDMap," + reverse_index_factory(index.index)
    if isinstance(index, IndexRefineFlat):
        suffix = ",Refine(SQ8)" if index.store == "sq8" else ",RFlat"
        return reverse_index_factory(index.base_index) + suffix
    if isinstance(index, IndexRefine):
        return (reverse_index_factory(index.base_index)
                + f",Refine({reverse_index_factory(index.refine_index)})")
    if type(index) in (IndexIVFPQ, IndexIVFPQFastScan, IndexIVFPQR) \
            and not index.by_residual:
        raise TypeError("no factory token for IVF-PQ not by residual")
    if type(index) is IndexIVFPQR:
        if index.pq.nbits != 8 or index.refine_pq.nbits != 8:
            raise TypeError("no factory token for IndexIVFPQR beyond 8 bits")
        return f"{_ivf_prefix(index)},PQ{index.pq.M}+{index.refine_pq.M}"
    if type(index) is IndexIVFPQFastScan:
        return f"{_ivf_prefix(index)},{_fs(index.pq.M, index.bbs)}"
    if type(index) is IndexIVFPQ:
        return f"{_ivf_prefix(index)},PQ{index.pq.M}x{index.pq.nbits}"
    if type(index) is IndexIVFScalarQuantizer:
        return f"{_ivf_prefix(index)},{_sq_name(index.sq.qtype)}"
    if type(index) is IndexIVFFlat:
        return f"{_ivf_prefix(index)},Flat"
    if isinstance(index, IndexHNSW):
        return _hnsw(index)
    if type(index) is IndexPQFastScan:
        return _fs(index.pq.M, index.bbs)
    if type(index) is IndexPQ:
        return f"PQ{index.pq.M}x{index.pq.nbits}"
    if type(index) is IndexScalarQuantizer:
        return _sq_name(index.sq.qtype)
    if type(index) is IndexLSH:
        return ("LSH" + ("r" if index.rotate_data else "")
                + ("t" if index.train_thresholds else ""))
    if _plain_flat(index):
        return "Flat"
    if type(index) is IndexFlat1D:
        return "Flat1D"
    raise TypeError(f"cannot reverse {type(index).__name__}")
