"""Index files (counterpart of faiss_tpu/io.py:59-1096; reference:
faiss/index_io.h).

The container is faiss_tpu's: one uncompressed ``.npz`` holding a
``__meta__`` JSON tree of class tags and scalar fields, and the arrays under
hierarchical ``root/...`` keys. The port reads what faiss_tpu writes and
faiss_tpu reads what the port writes, for the classes the port has:
IndexFlat (L2 / IP, with ``storage_dtype``), IndexFlatSQ8, IndexFlat1D,
IndexScalarQuantizer, IndexIVFScalarQuantizer, IndexPQ, IndexPQFastScan
(with ``bbs``), IndexLSH, IndexBinaryFlat, IndexBinaryIVF, IndexIVFFlat,
IndexIVFPQ, IndexIVFPQFastScan (with ``bbs``), IndexIVFPQR, IndexIDMap /
IndexIDMap2,
IndexRefine / IndexRefineFlat (its ``store`` recovered from the refine
index), IndexPreTransform over every transform of
faiss_tpu_torch.transforms, the HNSW indexes (IndexHNSW, IndexHNSWFlat,
IndexHNSWFlatPanorama, IndexHNSWPQ, IndexHNSWSQ: the graph's rows, levels,
neighbours, entry point and parameters beside the storage), the NSG indexes
(IndexNSGFlat, IndexNNDescentFlat, IndexNSGPQ, IndexNSGSQ: the graph and its
enter point) and MultiIndexQuantizer / MultiIndexQuantizer2 (the codebooks
and the sub-indexes), also as the coarse quantizer of an IVF index, the
additive-quantizer indexes, flat and IVF, FastScan and product forms (the
codebooks, the norm codec's state, the codes and, flat, their norms), and
the RaBitQ indexes, flat and IVF, 1-bit and multi-bit, FastScan (the
rotation and center of a flat one, ``nb_bits``, ``qb``, ``bbs``), IndexEDEN
(center, unpacked codes, factors) and IndexIVFEDEN (its lists' packed
bytes), IndexFlatPanorama and IndexIVFFlatPanorama (their levels and prune
factor), and IndexLattice (the trained norm range and the [n, nsq, 2]
fields). IndexFlat keeps its ``metric_arg``. IndexHNSW2Level and
IndexBinaryHNSW are refused with TypeError, as faiss_tpu refuses them
(neither has a file form there); so are the classes faiss_tpu does not write
(IndexRowwiseMinMax, IndexIVFIndependentQuantizer, the neural codecs), and
IndexIVFFlatDedup and IndexIVFSpectralHash are written as faiss_tpu writes
them but not read back (TypeError, as there).

``read_index`` builds the index on ``device`` (the card unless the caller
passes another); it also reads the reference library's own format, which
it tells by the file's first four bytes (io_ref). An IVF index gets its host lists (codes, list numbers,
ids) and stages its device layouts at its first search. ``IO_FLAG_MMAP``
maps the payloads in place instead of reading them."""

from __future__ import annotations

import io as _io
import json
import os
from typing import Dict

import numpy as np

from .base import Index, require_device
from .convert import transform_from_arrays
from .metric import MetricType
from .models.flat import IndexFlat, IndexFlat1D, IndexFlatIP, IndexFlatL2, IndexFlatSQ8
from .models.ivf import IndexIVF
from .models.ivf_flat import IndexIVFFlat
from .models.ivf_pq import IndexIVFPQ, IndexIVFPQFastScan, IndexIVFPQR
from .models.binary import IndexBinaryFlat, IndexBinaryIVF
from .models.hnsw import (
    IndexHNSW,
    IndexHNSW2Level,
    IndexHNSWFlat,
    IndexHNSWFlatPanorama,
    IndexHNSWPQ,
    IndexHNSWSQ,
)
from .models.imi import MultiIndexQuantizer, MultiIndexQuantizer2
from .models.nsg import IndexNNDescentFlat, IndexNSGFlat, IndexNSGPQ, IndexNSGSQ
from .models.lsh import IndexLSH
from .models.pq import IndexPQ, IndexPQFastScan
from .models.sq import IndexIVFScalarQuantizer, IndexScalarQuantizer
from .models.aq import (
    AQ_FLAT_CLASSES,
    AQ_IVF_CLASSES,
    IndexAdditiveQuantizer,
    IndexIVFAdditiveQuantizer,
    aq_index,
    set_aq_state,
)
from .models.rabitq import (
    IndexIVFRaBitQ,
    IndexIVFRaBitQFastScan,
    IndexRaBitQ,
    IndexRaBitQFastScan,
)
from .codecs.sq import QuantizerType
from .models.eden import IndexEDEN, IndexIVFEDEN
from .models.lattice import IndexLattice
from .models.panorama import IndexFlatPanorama, IndexIVFFlatPanorama
from .codecs.eden import EDENScaleType
from .models.meta import (
    IndexIDMap,
    IndexIDMap2,
    IndexPreTransform,
    IndexRefine,
    IndexRefineFlat,
)
from . import transforms as T

# io flags (reference: faiss/index_io.h:40-71)
IO_FLAG_MMAP = 0x646F0000  # map the array payloads in place
IO_FLAG_READ_ONLY = 2

_RABITQ_CLASSES = {"IndexRaBitQ": IndexRaBitQ,
                   "IndexRaBitQFastScan": IndexRaBitQFastScan,
                   "IndexIVFRaBitQ": IndexIVFRaBitQ,
                   "IndexIVFRaBitQFastScan": IndexIVFRaBitQFastScan}


def _pq_meta(pq):
    return {"d": pq.d, "M": pq.M, "nbits": pq.nbits}


def _dump_aq_norm(aq, meta, arrays, path):
    """An AQ codec's norm state (faiss_tpu io.py:36): search_type, the qint
    range, the cqint / 2x4 tables."""
    meta["search_type"] = int(aq.search_type)
    if aq.norm_min == aq.norm_min:  # not NaN
        meta["norm_min"], meta["norm_max"] = aq.norm_min, aq.norm_max
    if aq.qnorm is not None:
        arrays[f"{path}/aq_qnorm"] = aq.qnorm
    if aq.norm_tabs is not None:
        arrays[f"{path}/aq_norm_tabs"] = aq.norm_tabs


def _load_aq_norm(aq, meta, arrays, path, codebooks_key):
    """The codec state written by :func:`_dump_aq_norm` and its codebooks
    (faiss_tpu io.py:47 and :652-680)."""
    set_aq_state(aq, arrays.get(f"{path}/{codebooks_key}"), meta.get("search_type"),
                 meta.get("norm_min"), meta.get("norm_max"),
                 arrays.get(f"{path}/aq_qnorm"), arrays.get(f"{path}/aq_norm_tabs"))


def _dump_transform(vt, arrays, path):
    """One transform of a chain as faiss_tpu writes it (io.py:87-111)."""
    vmeta = {"class": type(vt).__name__, "d_in": vt.d_in, "d_out": vt.d_out}
    if isinstance(vt, T.LinearTransform):
        vmeta["have_bias"] = vt.have_bias
        if vt.A is not None:
            arrays[f"{path}/A"] = vt.A
        if vt.b is not None:
            arrays[f"{path}/b"] = vt.b
        if isinstance(vt, T.PCAMatrix):
            vmeta["eigen_power"] = vt.eigen_power
            vmeta["random_rotation"] = vt.random_rotation
            if vt.mean is not None:
                arrays[f"{path}/mean"] = np.asarray(vt.mean, np.float32)
        if isinstance(vt, T.OPQMatrix):
            vmeta["M"] = vt.M
    elif isinstance(vt, T.NormalizationTransform):
        vmeta["norm"] = vt.norm
    elif isinstance(vt, T.CenteringTransform):
        arrays[f"{path}/mean"] = vt.mean
    elif isinstance(vt, T.RemapDimensionsTransform):
        arrays[f"{path}/map"] = vt.map
    elif isinstance(vt, T.ITQTransform):
        arrays[f"{path}/mean"] = vt.mean
        arrays[f"{path}/A"] = vt.pca_then_itq.A
    return vmeta


def _dump(index, arrays: Dict[str, np.ndarray], path: str):
    """(meta tree, arrays) of ``index``, recursively (faiss_tpu io.py:59)."""
    meta = {"class": type(index).__name__}
    if isinstance(index, IndexPreTransform):
        meta.update(d=index.d, metric=int(index.metric_type))
        meta["chain"] = [_dump_transform(vt, arrays, f"{path}/vt{ci}")
                         for ci, vt in enumerate(index.chain)]
        meta["sub"] = _dump(index.index, arrays, f"{path}/sub")
        return meta
    if isinstance(index, IndexIDMap):
        arrays[f"{path}/id_map"] = index.id_map
        meta["sub"] = _dump(index.index, arrays, f"{path}/sub")
        return meta
    if isinstance(index, IndexRefine):
        meta["k_factor"] = index.k_factor
        meta["base"] = _dump(index.base_index, arrays, f"{path}/base")
        meta["refine"] = _dump(index.refine_index, arrays, f"{path}/refine")
        return meta
    if isinstance(index, IndexHNSW):  # faiss_tpu io.py:125
        meta["d"] = index.d
        meta["M"] = index.hnsw.M
        state = index.graph_state()
        meta["has_graph"] = state is not None
        if isinstance(index, IndexHNSWFlatPanorama):
            # also at the top: a graphless Panorama index keeps its levels
            meta["pano_levels"] = int(index.num_panorama_levels)
        if state is not None:
            for key in ("vecs", "levels", "neighbors"):
                arrays[f"{path}/hnsw/{key}"] = state[key]
            meta["hnsw"] = {k: state[k] for k in (
                "entry_point", "max_level", "M", "efConstruction", "efSearch")}
            if "pano_levels" in state:
                meta["hnsw"]["pano_levels"] = state["pano_levels"]
        meta["storage"] = _dump(index.storage, arrays, f"{path}/storage")
        return meta
    if isinstance(index, MultiIndexQuantizer):  # faiss_tpu io.py:293
        if isinstance(index, MultiIndexQuantizer2):
            meta["assign"] = [_dump(sub, arrays, f"{path}/assign{m}")
                              for m, sub in enumerate(index.assign_indexes)]
        meta["pq"] = _pq_meta(index.pq)
        meta["is_trained"] = index.is_trained
        if index.pq.centroids is not None:
            arrays[f"{path}/pq_centroids"] = index.pq.centroids
        return meta
    if isinstance(index, IndexNSGFlat):  # faiss_tpu io.py:390
        meta.update(d=index.d, R=index.R, GK=index.GK)
        state = index.graph_state()
        meta["has_graph"] = state is not None
        if state is not None:
            arrays[f"{path}/graph"] = state["graph"]
            meta["nsg"] = {k: state[k] for k in ("enterpoint", "R", "search_L")}
        storage = getattr(index, "storage", None)
        if storage is not None:  # IndexNSGPQ / IndexNSGSQ: codes + graph
            meta["storage"] = _dump(storage, arrays, f"{path}/storage")
        elif state is not None:  # flat: the graph's rows are the storage
            arrays[f"{path}/xb"] = index._xb
        return meta
    if isinstance(index, IndexIVF):
        meta.update(
            d=index.d, metric=int(index.metric_type), nlist=index.nlist,
            nprobe=index.nprobe, by_residual=getattr(index, "by_residual", False),
            is_trained=index.is_trained,
        )
        meta["quantizer"] = _dump(index.quantizer, arrays, f"{path}/quantizer")
        if index._codes_host is not None:
            arrays[f"{path}/codes"] = index._codes_host
        arrays[f"{path}/listnos"] = index._listnos_host
        arrays[f"{path}/ids"] = index._ids_host
        if isinstance(index, IndexIVFPQ):
            meta["pq"] = _pq_meta(index.pq)
            if index.pq.centroids is not None:
                arrays[f"{path}/pq_centroids"] = index.pq.centroids
        if isinstance(index, IndexIVFPQR):
            meta["refine_pq"] = _pq_meta(index.refine_pq)
            meta["k_factor"] = index.k_factor
            if index.refine_pq.centroids is not None:
                arrays[f"{path}/refine_pq_centroids"] = index.refine_pq.centroids
            if index._refine_codes is not None:
                arrays[f"{path}/refine_codes"] = index._refine_codes
        if isinstance(index, IndexIVFPQFastScan):
            meta["bbs"] = index.bbs
        if isinstance(index, IndexIVFScalarQuantizer):
            meta["qtype"] = int(index.sq.qtype)
            meta["sq_by_residual"] = bool(index.by_residual)
            meta["tq_seed"] = int(index.sq.tq_seed)
            if index.sq.trained is not None:
                arrays[f"{path}/sq_trained"] = index.sq.trained
        if isinstance(index, IndexIVFRaBitQ):  # faiss_tpu io.py:197-207
            meta["nb_bits"] = index.nb_bits
            meta["qb"] = index.qb
            if isinstance(index, IndexIVFRaBitQFastScan):
                meta["bbs"] = index.bbs
        if isinstance(index, IndexIVFEDEN):  # faiss_tpu io.py:196-201
            meta["nb_bits"] = index.eden.nb_bits
            meta["scale_type"] = int(index.eden.scale_type)
        if isinstance(index, IndexIVFFlatPanorama):  # faiss_tpu io.py:209-212
            meta["n_levels"] = index.n_levels
            meta["prune_factor"] = index.prune_factor
        if isinstance(index, IndexIVFAdditiveQuantizer):  # io.py:213-230
            meta["aq"] = {"class": type(index.aq).__name__, "M": index.aq.M,
                          "nbits": index.aq.nbits}
            if hasattr(index.aq, "nsplits"):
                meta["aq"]["nsplits"] = index.aq.nsplits
            if index.aq.codebooks is not None:
                arrays[f"{path}/aq_codebooks"] = index.aq.codebooks
            _dump_aq_norm(index.aq, meta["aq"], arrays, path)
            if hasattr(index, "bbs"):
                meta["bbs"] = index.bbs
        return meta
    if isinstance(index, IndexLSH):  # faiss_tpu io.py:146
        meta.update(d=index.d, nbits=index.nbits, rotate_data=index.rotate_data,
                    train_thresholds=index.train_thresholds,
                    is_trained=index.is_trained)
        arrays[f"{path}/codes"] = index.codes_host
        if index.rrot is not None:
            arrays[f"{path}/rrot_A"] = index.rrot.A
        if index.thresholds is not None:
            arrays[f"{path}/thresholds"] = index.thresholds
        return meta
    if isinstance(index, IndexPQ):  # faiss_tpu io.py:247
        meta.update(d=index.d, metric=int(index.metric_type),
                    is_trained=index.is_trained, pq=_pq_meta(index.pq))
        if isinstance(index, IndexPQFastScan):
            meta["bbs"] = index.bbs
        if index.pq.centroids is not None:
            arrays[f"{path}/pq_centroids"] = index.pq.centroids
        if index._codes is not None:
            arrays[f"{path}/codes"] = index.codes_host
        return meta
    if isinstance(index, IndexBinaryFlat):  # faiss_tpu io.py:307
        meta.update(d=index.d)
        arrays[f"{path}/xb"] = index.xb
        return meta
    if isinstance(index, IndexBinaryIVF):
        meta.update(d=index.d, nlist=index.nlist, nprobe=index.nprobe,
                    is_trained=index.is_trained)
        meta["quantizer"] = _dump(index.quantizer, arrays, f"{path}/quantizer")
        arrays[f"{path}/codes"] = index._codes
        arrays[f"{path}/listnos"] = index._listnos
        arrays[f"{path}/ids"] = index._ids
        return meta
    if isinstance(index, IndexAdditiveQuantizer):  # faiss_tpu io.py:340
        meta.update(d=index.d, metric=int(index.metric_type), M=index.aq.M,
                    nbits=index.aq.nbits, aq_class=type(index.aq).__name__,
                    is_trained=index.is_trained)
        if hasattr(index.aq, "nsplits"):
            meta["nsplits"] = index.aq.nsplits
        if hasattr(index, "bbs"):
            meta["bbs"] = index.bbs
        if index.aq.codebooks is not None:
            arrays[f"{path}/codebooks"] = index.aq.codebooks
        _dump_aq_norm(index.aq, meta, arrays, path)
        if index._codes is not None:
            arrays[f"{path}/codes"] = index._codes_int
            arrays[f"{path}/norms"] = index._norms
        return meta
    if isinstance(index, IndexEDEN):  # faiss_tpu io.py:325
        meta.update(d=index.d, metric=int(index.metric_type),
                    nb_bits=index.eden.nb_bits,
                    scale_type=int(index.eden.scale_type),
                    is_trained=index.is_trained)
        arrays[f"{path}/center"] = index.center
        if index._codes is not None:
            arrays[f"{path}/codes"] = index.codes_host
            arrays[f"{path}/factors"] = index.factors_host
        return meta
    if isinstance(index, IndexLattice):  # faiss_tpu io.py:378
        meta.update(d=index.d, nsq=index.nsq, scale_nbit=index.scale_nbit,
                    r2=index.zn_sphere_codec.r2, metric=int(index.metric_type),
                    is_trained=index.is_trained)
        if index.trained is not None:
            arrays[f"{path}/trained"] = index.trained
        if index._codes is not None:
            arrays[f"{path}/codes"] = index._codes
        return meta
    if isinstance(index, IndexRaBitQ):  # faiss_tpu io.py:359
        meta.update(d=index.d, is_trained=index.is_trained, nb_bits=index.nb_bits,
                    qb=index.qb)
        if isinstance(index, IndexRaBitQFastScan):
            meta["bbs"] = index.bbs
        arrays[f"{path}/P"] = index.rabitq.P
        if index.rabitq.center is not None:
            arrays[f"{path}/center"] = index.rabitq.center
        if index._bits is not None:
            arrays[f"{path}/bits"] = index._bits
            arrays[f"{path}/factors"] = index._factors
        return meta
    if isinstance(index, IndexScalarQuantizer):
        meta.update(d=index.d, metric=int(index.metric_type),
                    qtype=int(index.sq.qtype), is_trained=index.is_trained,
                    tq_seed=int(index.sq.tq_seed))
        if index.sq.trained is not None:
            arrays[f"{path}/sq_trained"] = index.sq.trained
        if index._codes is not None:
            arrays[f"{path}/codes"] = index._codes
        return meta
    if isinstance(index, IndexFlatSQ8):
        meta.update(d=index.d, metric=int(index.metric_type),
                    trained=index.is_trained)
        if index.is_trained:
            arrays[f"{path}/sq_trained"] = np.asarray(index.sq.trained, np.float32)
        codes = index._consolidate()
        if codes is not None:
            arrays[f"{path}/codes"] = codes.cpu().numpy()
        return meta
    if isinstance(index, IndexFlat):
        meta.update(d=index.d, metric=int(index.metric_type),
                    metric_arg=index.metric_arg,
                    storage_dtype=np.dtype(index.storage_dtype).name)
        if isinstance(index, IndexFlat1D):
            meta["continuous_update"] = index.continuous_update
        if isinstance(index, IndexFlatPanorama):  # faiss_tpu io.py:285-289
            meta["num_levels"] = index.num_levels
            meta["prune_factor"] = index.prune_factor
        arrays[f"{path}/xb"] = index.vectors()
        return meta
    raise TypeError(f"don't know how to serialize {type(index).__name__}")


def _load_transform(vmeta, arrays, path, device):
    def arr(name):
        return arrays.get(f"{path}/{name}")

    fields = {k: vmeta[k] for k in ("norm", "eigen_power", "random_rotation",
                                    "M", "have_bias") if k in vmeta}
    return transform_from_arrays(
        vmeta["class"], vmeta["d_in"], vmeta["d_out"], arr("A"), arr("b"),
        arr("mean"), device=device, dim_map=arr("map"), **fields)


def _load(meta, arrays, path: str, device):
    cls = meta["class"]
    if cls == "IndexPreTransform":
        sub = _load(meta["sub"], arrays, f"{path}/sub", device)
        index = IndexPreTransform(sub)
        for ci, vmeta in reversed(list(enumerate(meta["chain"]))):
            index.prepend_transform(
                _load_transform(vmeta, arrays, f"{path}/vt{ci}", device))
        index.is_trained = True
        index.ntotal = sub.ntotal
        return index
    if cls in ("IndexIDMap", "IndexIDMap2"):
        sub = _load(meta["sub"], arrays, f"{path}/sub", device)
        index = (IndexIDMap2 if cls == "IndexIDMap2" else IndexIDMap)(sub)
        index.id_map = arrays[f"{path}/id_map"]
        index.ntotal = sub.ntotal
        return index
    if cls in ("IndexRefine", "IndexRefineFlat"):
        base = _load(meta["base"], arrays, f"{path}/base", device)
        refine = _load(meta["refine"], arrays, f"{path}/refine", device)
        index = IndexRefine(base, refine)
        if cls == "IndexRefineFlat":  # its store, from the refine index
            index.__class__ = IndexRefineFlat
            index.store_float16 = (
                np.dtype(getattr(refine, "storage_dtype", np.float32))
                == np.float16)
            index.store = ("sq8" if isinstance(refine, IndexFlatSQ8)
                           else "f16" if index.store_float16 else "f32")
        index.k_factor = meta["k_factor"]
        index.ntotal = base.ntotal
        return index
    if cls in ("IndexIVFFlat", "IndexIVFPQ", "IndexIVFPQFastScan",
               "IndexIVFPQR", "IndexIVFScalarQuantizer", "IndexIVFRaBitQ",
               "IndexIVFRaBitQFastScan", "IndexIVFEDEN",
               "IndexIVFFlatPanorama") or cls in AQ_IVF_CLASSES:
        return _load_ivf(meta, arrays, path, device)
    if cls in AQ_FLAT_CLASSES:  # faiss_tpu io.py:813
        index = aq_index(cls, meta["d"], meta["M"], meta["nbits"], meta["metric"],
                         nsplits=meta.get("nsplits", 0), bbs=meta.get("bbs", 32),
                         aq_class=meta.get("aq_class"), device=device)
        _load_aq_norm(index.aq, meta, arrays, path, "codebooks")
        index.is_trained = meta["is_trained"]
        if f"{path}/codes" in arrays:
            index.add_codes_int(arrays[f"{path}/codes"], arrays[f"{path}/norms"])
        return index
    if cls in ("IndexRaBitQ", "IndexRaBitQFastScan"):  # faiss_tpu io.py:898
        if cls == "IndexRaBitQFastScan":
            index = IndexRaBitQFastScan(meta["d"], bbs=meta.get("bbs", 32),
                                        nb_bits=meta.get("nb_bits", 1), device=device)
        else:
            index = IndexRaBitQ(meta["d"], nb_bits=meta.get("nb_bits", 1),
                                device=device)
        index.qb = meta.get("qb", index.qb)
        index.rabitq.P = np.ascontiguousarray(arrays[f"{path}/P"])
        if f"{path}/center" in arrays:
            index.rabitq.center = np.ascontiguousarray(arrays[f"{path}/center"])
        index.is_trained = meta["is_trained"]
        if f"{path}/bits" in arrays:
            index.add_codes(arrays[f"{path}/bits"], arrays[f"{path}/factors"])
        return index
    if cls in _HNSW_CLASSES:  # faiss_tpu io.py:507
        storage = _load(meta["storage"], arrays, f"{path}/storage", device)
        index = IndexHNSW(storage, meta["M"])
        index.__class__ = _HNSW_CLASSES[cls]
        if cls == "IndexHNSWFlatPanorama":
            index.num_panorama_levels = int(meta.get(
                "pano_levels", meta.get("hnsw", {}).get("pano_levels", 8)))
        if meta["has_graph"]:
            state = dict(meta["hnsw"])
            state["levels"] = arrays[f"{path}/hnsw/levels"]
            state["neighbors"] = arrays[f"{path}/hnsw/neighbors"]
            index.restore_graph(state, arrays[f"{path}/hnsw/vecs"])
        index.ntotal = storage.ntotal
        index.is_trained = True
        return index
    if cls in ("MultiIndexQuantizer", "MultiIndexQuantizer2"):  # io.py:779
        pq = meta["pq"]
        if cls == "MultiIndexQuantizer2":
            subs = [_load(m, arrays, f"{path}/assign{i}", device)
                    for i, m in enumerate(meta["assign"])]
            index = MultiIndexQuantizer2(pq["d"], pq["nbits"], *subs,
                                         device=device)
        else:
            index = MultiIndexQuantizer(pq["d"], pq["M"], pq["nbits"],
                                        device=device)
        if f"{path}/pq_centroids" in arrays:
            index.pq.set_centroids(arrays[f"{path}/pq_centroids"])
        index.is_trained = meta["is_trained"]
        if index.is_trained:
            index.ntotal = index.pq.ksub ** index.pq.M
        return index
    if cls in ("IndexNSGFlat", "IndexNNDescentFlat", "IndexNSGPQ",
               "IndexNSGSQ"):  # faiss_tpu io.py:935
        return _load_nsg(meta, arrays, path, device)
    if cls == "IndexLSH":  # faiss_tpu io.py:537
        index = IndexLSH(meta["d"], meta["nbits"], meta["rotate_data"],
                         meta["train_thresholds"], device=device)
        if f"{path}/rrot_A" in arrays and index.rrot is not None:
            index.rrot.A = np.ascontiguousarray(arrays[f"{path}/rrot_A"])
        if f"{path}/thresholds" in arrays:
            index.thresholds = np.ascontiguousarray(arrays[f"{path}/thresholds"])
        index.add_codes(np.asarray(arrays[f"{path}/codes"]))
        index.is_trained = meta["is_trained"]
        return index
    if cls in ("IndexPQ", "IndexPQFastScan"):  # faiss_tpu io.py:724
        pq, metric = meta["pq"], MetricType(meta["metric"])
        if cls == "IndexPQFastScan":
            index = IndexPQFastScan(meta["d"], pq["M"], pq["nbits"], metric,
                                    meta["bbs"], device=device)
        else:
            index = IndexPQ(meta["d"], pq["M"], pq["nbits"], metric, device=device)
        if f"{path}/pq_centroids" in arrays:
            index.pq.set_centroids(arrays[f"{path}/pq_centroids"])
        index.is_trained = meta["is_trained"]
        if f"{path}/codes" in arrays:
            index.add_codes_int(arrays[f"{path}/codes"])
        return index
    if cls == "IndexBinaryFlat":  # faiss_tpu io.py:797
        index = IndexBinaryFlat(meta["d"], device=device)
        index.add(arrays[f"{path}/xb"])
        return index
    if cls == "IndexBinaryIVF":
        quantizer = _load(meta["quantizer"], arrays, f"{path}/quantizer", device)
        index = IndexBinaryIVF(quantizer, meta["d"], meta["nlist"], device=device)
        index.nprobe = meta["nprobe"]
        index.add_encoded(arrays[f"{path}/codes"], arrays[f"{path}/listnos"],
                          arrays[f"{path}/ids"])
        index.is_trained = meta["is_trained"]
        return index
    if cls == "IndexScalarQuantizer":
        index = IndexScalarQuantizer(meta["d"], QuantizerType(meta["qtype"]),
                                     MetricType(meta["metric"]), device=device)
        index.sq.tq_seed = int(meta.get("tq_seed", 123))
        if f"{path}/sq_trained" in arrays:
            index.sq.trained = arrays[f"{path}/sq_trained"]
        index.is_trained = meta["is_trained"]
        if f"{path}/codes" in arrays:
            index.add_codes(arrays[f"{path}/codes"])
        return index
    if cls == "IndexFlatSQ8":
        index = IndexFlatSQ8(meta["d"], MetricType(meta["metric"]), device=device)
        if meta.get("trained"):
            index.sq.trained = arrays[f"{path}/sq_trained"]
            index.is_trained = True
        if f"{path}/codes" in arrays:
            index.add_codes(arrays[f"{path}/codes"])
        return index
    if cls == "IndexEDEN":  # faiss_tpu io.py:882
        index = IndexEDEN(meta["d"], MetricType(meta["metric"]), meta["nb_bits"],
                          EDENScaleType(meta["scale_type"]), device=device)
        index.center = np.ascontiguousarray(arrays[f"{path}/center"], np.float32)
        index.is_trained = meta["is_trained"]
        if f"{path}/codes" in arrays:
            index.add_codes(arrays[f"{path}/codes"], arrays[f"{path}/factors"])
        return index
    if cls == "IndexLattice":  # faiss_tpu io.py:918
        index = IndexLattice(meta["d"], meta["nsq"], meta["scale_nbit"], meta["r2"],
                             MetricType(meta["metric"]), device=device)
        if f"{path}/trained" in arrays:
            index.trained = np.asarray(arrays[f"{path}/trained"])
        index.is_trained = meta["is_trained"]
        if f"{path}/codes" in arrays:
            index.add_fields(arrays[f"{path}/codes"])
        return index
    if cls in ("IndexFlat", "IndexFlatL2", "IndexFlatIP", "IndexFlat1D",
               "IndexFlatPanorama"):
        if cls == "IndexFlatL2":
            index = IndexFlatL2(meta["d"], device=device)
        elif cls == "IndexFlatIP":
            index = IndexFlatIP(meta["d"], device=device)
        elif cls == "IndexFlat1D":
            index = IndexFlat1D(meta.get("continuous_update", True), device=device)
        elif cls == "IndexFlatPanorama":
            index = IndexFlatPanorama(meta["d"], meta["num_levels"], device=device)
            index.prune_factor = meta["prune_factor"]
        else:
            index = IndexFlat(meta["d"], MetricType(meta["metric"]),
                              meta.get("metric_arg", 0.0), device=device)
        index.storage_dtype = np.dtype(meta.get("storage_dtype", "float32")).type
        xb = arrays[f"{path}/xb"]
        if len(xb):
            index.add(xb)
        return index
    raise TypeError(f"unknown serialized class {cls}")


_HNSW_CLASSES = {
    "IndexHNSW": IndexHNSW,
    "IndexHNSWFlat": IndexHNSWFlat,
    "IndexHNSWPQ": IndexHNSWPQ,
    "IndexHNSWSQ": IndexHNSWSQ,
    "IndexHNSW2Level": IndexHNSW2Level,
    "IndexHNSWFlatPanorama": IndexHNSWFlatPanorama,
}


def _load_nsg(meta, arrays, path, device):
    """An NSG index with its graph restored over its rows: the decoded
    storage for the PQ and SQ forms, the stored rows for the flat ones."""
    cls = meta["class"]
    state = None
    if meta["has_graph"]:
        state = dict(meta["nsg"])
        state["graph"] = arrays[f"{path}/graph"]
    if cls in ("IndexNSGPQ", "IndexNSGSQ"):
        storage = _load(meta["storage"], arrays, f"{path}/storage", device)
        kls = IndexNSGPQ if cls == "IndexNSGPQ" else IndexNSGSQ
        index = kls.__new__(kls)
        IndexNSGFlat.__init__(index, meta["d"], meta["R"],
                              MetricType(storage.metric_type), device=device)
        index.storage = storage
        index.is_trained = storage.is_trained
        index.GK = meta["GK"]
        if state is not None:
            index.restore_graph(state, storage.reconstruct_n(0, storage.ntotal))
        return index
    kls = IndexNNDescentFlat if cls == "IndexNNDescentFlat" else IndexNSGFlat
    index = kls(meta["d"], meta["R"], device=device)
    index.GK = meta["GK"]
    if state is not None:
        index.restore_graph(state, arrays[f"{path}/xb"])
    return index


def _load_ivf(meta, arrays, path, device):
    """An IVF index with its host lists set; the device layouts are staged
    at its first search (faiss_tpu io.py:724-731)."""
    cls = meta["class"]
    quantizer = _load(meta["quantizer"], arrays, f"{path}/quantizer", device)
    d, nlist, metric = meta["d"], meta["nlist"], MetricType(meta["metric"])
    if cls == "IndexIVFFlat":
        index = IndexIVFFlat(quantizer, d, nlist, metric, device=device)
    elif cls == "IndexIVFFlatPanorama":  # faiss_tpu io.py:575
        index = IndexIVFFlatPanorama(quantizer, d, nlist, meta["n_levels"], metric,
                                     device=device)
        index.prune_factor = meta["prune_factor"]
    elif cls == "IndexIVFEDEN":  # faiss_tpu io.py:596
        index = IndexIVFEDEN(quantizer, d, nlist, metric, meta["nb_bits"],
                             EDENScaleType(meta["scale_type"]), device=device)
    elif cls == "IndexIVFScalarQuantizer":
        index = IndexIVFScalarQuantizer(
            quantizer, d, nlist, QuantizerType(meta["qtype"]), metric,
            by_residual=bool(meta.get("sq_by_residual", False)), device=device)
        index.sq.tq_seed = int(meta.get("tq_seed", 123))
        if f"{path}/sq_trained" in arrays:
            index.sq.trained = arrays[f"{path}/sq_trained"]
        index.by_residual = meta["by_residual"]
    elif cls in _RABITQ_CLASSES:  # faiss_tpu io.py:582-595
        fs = (meta.get("bbs", 32),) if cls == "IndexIVFRaBitQFastScan" else ()
        index = _RABITQ_CLASSES[cls](quantizer, d, nlist, metric, *fs,
                                     nb_bits=meta.get("nb_bits", 1), device=device)
        index.qb = meta.get("qb", index.qb)
        index.rabitq.center = np.zeros(d, np.float32)
    elif cls in AQ_IVF_CLASSES:  # faiss_tpu io.py:612-680
        aqm = meta["aq"]
        index = aq_index(cls, d, aqm["M"], aqm["nbits"], metric,
                         nsplits=aqm.get("nsplits", 0), bbs=meta.get("bbs", 32),
                         aq_class=aqm["class"], quantizer=quantizer, nlist=nlist,
                         device=device)
        _load_aq_norm(index.aq, aqm, arrays, path, "aq_codebooks")
        index.by_residual = meta["by_residual"]
    else:
        pq = meta["pq"]
        if cls == "IndexIVFPQFastScan":
            index = IndexIVFPQFastScan(quantizer, d, nlist, pq["M"], pq["nbits"],
                                       metric, meta.get("bbs", 32), device=device)
        elif cls == "IndexIVFPQR":
            rpq = meta["refine_pq"]
            index = IndexIVFPQR(quantizer, d, nlist, pq["M"], pq["nbits"],
                                rpq["M"], rpq["nbits"], metric, device=device)
            index.k_factor = meta["k_factor"]
            if f"{path}/refine_pq_centroids" in arrays:
                index.refine_pq.set_centroids(arrays[f"{path}/refine_pq_centroids"])
            index._refine_codes = arrays.get(f"{path}/refine_codes")
        else:
            index = IndexIVFPQ(quantizer, d, nlist, pq["M"], pq["nbits"],
                               metric, device=device)
        if f"{path}/pq_centroids" in arrays:
            index.pq.set_centroids(arrays[f"{path}/pq_centroids"])
        index.by_residual = meta["by_residual"]
    index.nprobe = meta["nprobe"]
    index.is_trained = meta["is_trained"]
    index._codes_host = arrays.get(f"{path}/codes")
    index._listnos_host = arrays[f"{path}/listnos"]
    index._ids_host = arrays[f"{path}/ids"]
    index.ntotal = len(index._ids_host)
    index._drop_caches()
    return index


def write_index(index: Index, fname_or_file) -> None:
    """Write ``index`` to a path (the exact name given) or a file object."""
    arrays: Dict[str, np.ndarray] = {}
    meta = _dump(index, arrays, "root")
    arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode("utf-8"),
                                       dtype=np.uint8)
    if isinstance(fname_or_file, (str, bytes, os.PathLike)):
        with open(fname_or_file, "wb") as f:
            np.savez(f, **arrays)
    else:
        np.savez(fname_or_file, **arrays)


def _mmap_npz(fname) -> Dict[str, np.ndarray]:
    """Every array payload of an uncompressed .npz as a read-only np.memmap
    at its byte offset (faiss_tpu io.py:956): only the headers are read."""
    import struct
    import zipfile

    from numpy.lib import format as npformat

    out: Dict[str, np.ndarray] = {}
    with zipfile.ZipFile(fname) as zf, open(fname, "rb") as f:
        for info in zf.infolist():
            if info.compress_type != zipfile.ZIP_STORED:
                raise ValueError("IO_FLAG_MMAP needs uncompressed payloads")
            # the local header: 30 fixed bytes, then the name and extra
            # fields, whose lengths may differ from the central directory's
            f.seek(info.header_offset)
            name_len, extra_len = struct.unpack("<HH", f.read(30)[26:30])
            f.seek(info.header_offset + 30 + name_len + extra_len)
            version = npformat.read_magic(f)
            read_header = {(1, 0): npformat.read_array_header_1_0,
                           (2, 0): npformat.read_array_header_2_0}.get(version)
            if read_header is None:
                raise ValueError(f"npy format {version} cannot be mapped")
            shape, fortran, dtype = read_header(f)
            if dtype.hasobject:
                raise ValueError("object arrays cannot be mapped")
            out[info.filename[:-4]] = np.memmap(
                fname, dtype=dtype, mode="r", offset=f.tell(),
                shape=tuple(shape), order="F" if fortran else "C",
            )
    return out


def _sniff_ref_format(fname_or_file) -> bool:
    """True where the payload is a file of the reference library's own
    format (.faissindex, io_ref): it opens with one of its fourccs, where the
    npz container opens with the zip magic "PK\\x03\\x04" (faiss_tpu
    io.py:1043)."""
    from .io_ref import REF_FOURCCS

    if isinstance(fname_or_file, (str, bytes, os.PathLike)) and not (
        isinstance(fname_or_file, bytes) and len(fname_or_file) > 4096
    ):
        try:
            with open(fname_or_file, "rb") as f:
                head = f.read(4)
        except (OSError, ValueError):
            return False
    elif hasattr(fname_or_file, "read") and hasattr(fname_or_file, "seek"):
        pos = fname_or_file.tell()
        head = fname_or_file.read(4)
        fname_or_file.seek(pos)
    else:
        return False
    return head in REF_FOURCCS


def read_index(fname_or_file, io_flags: int = 0, *, device="cuda") -> Index:
    """Read an index written by :func:`write_index` or by faiss_tpu's, or a
    file of the reference library's own format (sniffed by its first four
    bytes; io_ref), onto ``device``."""
    device = require_device(device)
    if _sniff_ref_format(fname_or_file):
        from .io_ref import read_ref_index

        if isinstance(fname_or_file, bytes):  # a path, as the sniff read it
            fname_or_file = os.fsdecode(fname_or_file)
        return read_ref_index(fname_or_file, device=device)
    if io_flags & IO_FLAG_MMAP:
        if not isinstance(fname_or_file, (str, bytes, os.PathLike)):
            raise ValueError("IO_FLAG_MMAP requires a file path")
        arrays = _mmap_npz(fname_or_file)
    else:
        with np.load(fname_or_file, allow_pickle=False) as z:
            arrays = {k: z[k] for k in z.files}
    meta = json.loads(bytes(arrays.pop("__meta__")).decode("utf-8"))
    return _load(meta, arrays, "root", device)


def serialize_index(index: Index) -> np.ndarray:
    buf = _io.BytesIO()
    write_index(index, buf)
    return np.frombuffer(buf.getvalue(), dtype=np.uint8)


def deserialize_index(data, *, device="cuda") -> Index:
    return read_index(_io.BytesIO(bytes(np.asarray(data, np.uint8))),
                      device=device)


# the binary-index entry points (index_io.h write_index_binary; faiss_tpu
# io.py:1094)
write_index_binary = write_index
read_index_binary = read_index
