"""Build port indexes from the state of faiss_tpu indexes.

The state is handed over as numpy arrays, so this module needs neither JAX
nor faiss_tpu. With both packages serving the same trained state, search
parity does not depend on k-means RNG. For a faiss_tpu flat index ``flat``
the state is ``flat.vectors()`` and its metric; for a faiss_tpu
``IndexRefineFlat(IndexIVFPQFastScan(...))`` named ``ref`` the arrays are::

    base = ref.base_index
    refine_flat_from_arrays(
        base.quantizer.vectors(), base.pq.centroids, base._codes_host,
        base._listnos_host, base._ids_host, ref.refine_index.vectors(),
        device=..., store_float16=True)

for a faiss_tpu ``IndexIVFFlat`` named ``ivf``::

    ivfflat_from_arrays(ivf.quantizer.vectors(), ivf._codes_host,
                        ivf._listnos_host, ivf._ids_host, device=...)

and for a faiss_tpu ``IndexIVFPQR`` named ``pqr``::

    ivfpqr_from_arrays(pqr.quantizer.vectors(), pqr.pq.centroids,
                       pqr._codes_host, pqr._listnos_host, pqr._ids_host,
                       pqr.refine_pq.centroids, pqr._refine_codes,
                       device=...)

IVF-Flat and IVF-PQ take ``metric=`` (faiss_tpu's ``index.metric_type``).
An ``IndexFlatSQ8`` named ``sq8`` is ``flat_sq8_from_arrays(sq8.sq.trained,
sq8._xb, sq8.metric_type, device=...)``; a Refine(SQ8) ``IndexRefine(base,
sq8)`` over IVF-PQ is ``refine_sq8_from_arrays`` with the base's arrays and
those two; an ``IndexScalarQuantizer`` named ``sq`` is
``sq_from_arrays(sq.d, sq.sq.qtype, sq.sq.trained, sq._codes,
sq.metric_type, device=...)`` and an ``IndexIVFScalarQuantizer`` named
``ivfsq`` is ``ivfsq_from_arrays(ivfsq.quantizer.vectors(), ivfsq.sq.qtype,
ivfsq.sq.trained, ivfsq._codes_host, ivfsq._listnos_host, ivfsq._ids_host,
by_residual=ivfsq.by_residual, metric=ivfsq.metric_type, device=...)``
(both take ``tq_seed=`` where it is not 123); an ``IndexPQ`` named ``pq``
is ``pq_from_arrays(pq.d, pq.pq.M, pq.pq.nbits, pq.pq.centroids,
pq._codes_host, pq.metric_type, fastscan=..., device=...)``; an
``IndexLSH`` named ``lsh`` is ``lsh_from_arrays(lsh.d, lsh.nbits,
lsh.rrot.A, lsh.thresholds, lsh._codes, rotate_data=...,
train_thresholds=..., device=...)``; an ``IndexBinaryFlat`` named ``bf`` is
``binary_flat_from_arrays(bf.xb, device=...)`` and an ``IndexBinaryIVF``
named ``bi`` is ``binary_ivf_from_arrays(bi.quantizer.xb, bi._codes,
bi._listnos, bi._ids, bi.nprobe, device=...)``; an ``IndexIDMap`` or
``IndexIDMap2`` named ``m`` wraps the port of ``m.index`` as
``idmap_from_arrays(port_inner, m.id_map, two=...)``.

A transform ``vt`` of a faiss_tpu ``IndexPreTransform`` named ``pre`` is
``transform_from_arrays(type(vt).__name__, vt.d_in, vt.d_out, vt.A, vt.b,
device=...)`` for the linear transforms (with ``mean=vt.mean`` for
PCAMatrix), ``mean=vt.mean`` for CenteringTransform, ``vt.pca_then_itq.A``
and ``mean=vt.mean`` for ITQTransform, ``dim_map=vt.map`` for
RemapDimensionsTransform and ``norm=vt.norm`` for NormalizationTransform;
``pretransform_from([...], port_inner)`` then wraps the port of
``pre.index`` in that chain.

A faiss_tpu ``IndexHNSW`` named ``h`` (Flat, FlatPanorama, PQ or SQ) is
``hnsw_from_state(port_storage, h.graph_state())``, its storage ported as
above (``flat_from_arrays(h.storage.vectors())``, ``pq_from_arrays``,
``sq_from_arrays``); a faiss_tpu ``IndexNSGFlat`` or ``IndexNNDescentFlat``
named ``g`` is ``nsg_from_state(g.graph_state(), g._xb, GK=g.GK,
nndescent=..., device=...)`` and an ``IndexNSGPQ``/``IndexNSGSQ`` passes
its ported ``storage=`` instead of the rows; a faiss_tpu
``MultiIndexQuantizer`` named ``imi`` is ``imi_from_arrays(imi.d,
imi.pq.centroids, nbits=imi.pq.nbits, device=...)``.

An additive-quantizer index ``a`` (flat) is ``aq_from_arrays(type(a).__name__,
a.d, a.aq.M, a.aq.nbits, a.aq.codebooks, a._codes_int, a._norms,
a.metric_type, nsplits=..., bbs=..., norm_state=aq_norm_state(a.aq),
device=...)`` and an IVF one ``iv`` is ``ivf_aq_from_arrays(type(iv).__name__,
iv.quantizer.vectors(), iv.aq.M, iv.aq.nbits, iv.aq.codebooks,
iv._codes_host, iv._listnos_host, iv._ids_host, ...)`` with the same
keywords; a RaBitQ index ``r`` is ``rabitq_from_arrays(r.d, r.nb_bits,
r.rabitq.P, r.rabitq.center, r._bits, r._factors, fastscan=..., qb=r.qb,
device=...)`` and an IVF one ``ir`` is ``ivf_rabitq_from_arrays(
ir.quantizer.vectors(), ir.nb_bits, ir._codes_host, ir._listnos_host,
ir._ids_host, fastscan=..., qb=ir.qb, device=...)``.

An ``IndexEDEN`` named ``e`` is ``eden_from_arrays(e.d, e.eden.nb_bits,
e.eden.scale_type, e.center, e._codes, e._factors, e.metric_type,
device=...)`` and an ``IndexIVFEDEN`` named ``ie`` is
``ivf_eden_from_arrays(ie.quantizer.vectors(), ie.eden.nb_bits,
ie.eden.scale_type, ie._codes_host, ie._listnos_host, ie._ids_host, ...)``;
an ``IndexLattice`` named ``l`` is ``lattice_from_arrays(l.d, l.nsq,
l.scale_nbit, l.zn_sphere_codec.r2, l.trained, l._codes, device=...)``; an
``IndexFlatPanorama`` named ``p`` is ``panorama_from_arrays(p.vectors(),
p.num_levels, device=...)`` and an ``IndexIVFFlatPanorama`` named ``ip``
``ivf_panorama_from_arrays(ip.quantizer.vectors(), ip._codes_host,
ip._listnos_host, ip._ids_host, ip.n_levels, device=...)``; a faiss_tpu
``QINCo`` state dict (``utils.neuralnet._qinco_init``'s, or numpy arrays of
a trained one) is ``qinco_from_state(state, d, K, L, M, h, device=...)``.

The sharded indexes take a port mesh (``parallel.sharded.make_mesh``) in
place of a device; their unsharded index lives on ``mesh.devices[0]``. A
faiss_tpu ``ShardedFlat`` over rows ``xb`` is ``sharded_flat_from_arrays(
xb, mesh, metric)``; a ``ShardedIVF`` over an IVF-Flat ``ivf`` is
``sharded_ivf_from_arrays(ivf.quantizer.vectors(), ivf._codes_host,
ivf._listnos_host, ivf._ids_host, mesh, metric=...)``; a ``ShardedIVFPQ``
over an IVF-PQ ``ivfpq`` is ``sharded_ivfpq_from_arrays`` with
:func:`ivfpq_from_arrays`' arrays and the mesh, and a
``ShardedRefinedIVFPQ`` adds its ``xb_t`` rows
(``sharded_refined_ivfpq_from_arrays``); a trained
``ShardedIVFPQBuilder`` named ``b`` is ``ivfpq_builder_from_arrays(
b.centroids, b.pq.centroids, mesh, metric=b.metric_type,
by_residual=b.by_residual)``.
"""

from __future__ import annotations

import numpy as np

from . import transforms as T
from .base import Index
from .metric import MetricType
from .models.flat import IndexFlat, IndexFlatSQ8
from .models.ivf_flat import IndexIVFFlat
from .models.ivf_pq import IndexIVFPQ, IndexIVFPQFastScan, IndexIVFPQR
from .models.sq import IndexIVFScalarQuantizer, IndexScalarQuantizer
from .models.binary import IndexBinaryFlat, IndexBinaryIVF
from .models.hnsw import (
    IndexHNSW,
    IndexHNSWFlat,
    IndexHNSWFlatPanorama,
    IndexHNSWPQ,
    IndexHNSWSQ,
)
from .models.imi import MultiIndexQuantizer
from .models.nsg import IndexNNDescentFlat, IndexNSGFlat, IndexNSGPQ, IndexNSGSQ
from .models.lsh import IndexLSH
from .models.pq import IndexPQ, IndexPQFastScan
from .models.aq import aq_index, set_aq_state
from .models.rabitq import (
    IndexIVFRaBitQ,
    IndexIVFRaBitQFastScan,
    IndexRaBitQ,
    IndexRaBitQFastScan,
)
from .models.eden import IndexEDEN, IndexIVFEDEN
from .models.lattice import IndexLattice
from .models.panorama import IndexFlatPanorama, IndexIVFFlatPanorama
from .utils.neuralnet import QINCo
from .parallel.sharded import (
    ShardedFlat,
    ShardedIVF,
    ShardedIVFPQ,
    ShardedIVFPQBuilder,
    ShardedRefinedIVFPQ,
)
from .models.meta import (
    IndexIDMap,
    IndexIDMap2,
    IndexPreTransform,
    IndexRefine,
    IndexRefineFlat,
)


def flat_from_arrays(xb, metric=MetricType.L2, *, device) -> IndexFlat:
    """IndexFlat (METRIC_L2 or METRIC_INNER_PRODUCT) holding the rows
    ``xb`` [n, d] in order, as a faiss_tpu flat index's ``vectors()`` gives
    them."""
    xb = np.ascontiguousarray(xb, np.float32)
    if xb.ndim != 2:
        raise ValueError(f"xb must be [n, d], got shape {xb.shape}")
    index = IndexFlat(xb.shape[1], MetricType(metric), device=device)
    index.add(xb)
    return index


def _ivf_arrays(centroids, listnos, ids, n):
    """The coarse state of an IVF index as the port holds it; raises where
    the arrays disagree."""
    centroids = np.ascontiguousarray(centroids, np.float32)
    listnos = np.ascontiguousarray(listnos, np.int32).ravel()
    ids = np.ascontiguousarray(ids, np.int64).ravel()
    if len(listnos) != n or len(ids) != n:
        raise ValueError("codes, listnos and ids disagree in length")
    if n and not (0 <= listnos.min() and listnos.max() < len(centroids)):
        raise ValueError("list numbers out of range")
    return centroids, listnos, ids


def _quantizer(centroids, metric, device) -> IndexFlat:
    quantizer = IndexFlat(centroids.shape[1], MetricType(metric), device=device)
    quantizer.add(centroids)
    return quantizer


def ivfflat_from_arrays(centroids, xb, listnos, ids, *, device,
                        metric=MetricType.L2) -> IndexIVFFlat:
    """IndexIVFFlat from coarse centroids [nlist, d] and the lists' entries
    in add order: vectors ``xb`` [n, d], list numbers [n] and ids [n]."""
    xb = np.ascontiguousarray(xb, np.float32)
    centroids, listnos, ids = _ivf_arrays(centroids, listnos, ids, len(xb))
    nlist, d = centroids.shape
    if xb.ndim != 2 or xb.shape[1] != d:
        raise ValueError(f"xb must be [n, {d}], got shape {xb.shape}")
    index = IndexIVFFlat(_quantizer(centroids, metric, device), d, nlist,
                         MetricType(metric), device=device)
    index.add_encoded(xb, listnos, ids)
    return index


def _pq_state(pq_centroids, codes):
    """(codebooks float32 [M, ksub, dsub], codes [n, M] uint8 up to 8 bits
    and uint16 above, nbits)."""
    pq_centroids = np.ascontiguousarray(pq_centroids, np.float32)
    M, ksub, _ = pq_centroids.shape
    nbits = ksub.bit_length() - 1
    codes = np.ascontiguousarray(codes, np.uint8 if nbits <= 8 else np.uint16)
    if codes.ndim != 2 or codes.shape[1] != M:
        raise ValueError(f"codes must be [n, M={M}], got shape {codes.shape}")
    return pq_centroids, codes, nbits


def _ivfpq(cls, centroids, pq_centroids, codes, listnos, ids, device, *extra,
           metric=MetricType.L2):
    """A trained ``cls`` holding the coarse and PQ state; returns
    (index, codes, listnos, ids) for the caller to add."""
    pq_centroids, codes, nbits = _pq_state(pq_centroids, codes)
    centroids, listnos, ids = _ivf_arrays(centroids, listnos, ids, len(codes))
    nlist, d = centroids.shape
    index = cls(_quantizer(centroids, metric, device), d, nlist,
                pq_centroids.shape[0], nbits, *extra, metric=MetricType(metric),
                device=device)
    index.pq.set_centroids(pq_centroids)
    index.is_trained = True
    return index, codes, listnos, ids


def ivfpq_from_arrays(centroids, pq_centroids, codes, listnos, ids, *, device,
                      by_residual=True, metric=MetricType.L2) -> IndexIVFPQ:
    """IndexIVFPQ (IndexIVFPQFastScan when nbits = 4) from coarse centroids
    [nlist, d], PQ codebooks [M, ksub, dsub] (ksub = 2^nbits, nbits 1 to
    16, as given: polysemous-permuted codebooks too), unpacked codes [n, M]
    (uint8, uint16 above 8 bits), coarse list numbers [n] and ids [n];
    ``by_residual`` as the index was trained (faiss_tpu's
    ``index.by_residual``)."""
    ksub = np.shape(pq_centroids)[1]
    cls = IndexIVFPQFastScan if ksub == 16 else IndexIVFPQ
    index, codes, listnos, ids = _ivfpq(cls, centroids, pq_centroids, codes,
                                        listnos, ids, device, metric=metric)
    index.by_residual = bool(by_residual)
    index.add_encoded(codes, listnos, ids)
    return index


def ivfpqr_from_arrays(centroids, pq_centroids, codes, listnos, ids,
                       refine_pq_centroids, refine_codes, *, device
                       ) -> IndexIVFPQR:
    """IndexIVFPQR from the arrays of :func:`ivfpq_from_arrays` (by
    residual) and the refine PQ's codebooks [M_refine, ksub_r, dsub_r] and
    its codes [n, M_refine] uint8."""
    rcb, rcodes, rbits = _pq_state(refine_pq_centroids, refine_codes)
    index, codes, listnos, ids = _ivfpq(
        IndexIVFPQR, centroids, pq_centroids, codes, listnos, ids, device,
        rcb.shape[0], rbits,
    )
    index.refine_pq.set_centroids(rcb)
    index.add_encoded(codes, listnos, ids, refine_codes=rcodes)
    return index


def refine_flat_from_arrays(centroids, pq_centroids, codes, listnos, ids,
                            refine_rows, *, device, store_float16=True
                            ) -> IndexRefineFlat:
    """IndexRefineFlat over :func:`ivfpq_from_arrays`; ``refine_rows``
    [n, d] are the refine store's rows in add order."""
    base = ivfpq_from_arrays(
        centroids, pq_centroids, codes, listnos, ids, device=device
    )
    return IndexRefineFlat(base, refine_rows, store_float16=store_float16)


def flat_sq8_from_arrays(trained, codes, metric=MetricType.L2, *, device
                         ) -> IndexFlatSQ8:
    """IndexFlatSQ8 from its quantizer's ``trained`` [2, d] float32 (vmin,
    vdiff) and its codes [n, d] uint8 in add order."""
    trained = np.ascontiguousarray(trained, np.float32)
    if trained.ndim != 2 or trained.shape[0] != 2:
        raise ValueError(f"trained must be [2, d], got shape {trained.shape}")
    index = IndexFlatSQ8(trained.shape[1], MetricType(metric), device=device)
    index.sq.trained = trained.copy()
    index.is_trained = True
    index.add_codes(codes)
    return index


def refine_sq8_from_arrays(centroids, pq_centroids, codes, listnos, ids,
                           sq_trained, sq_codes, *, device) -> IndexRefine:
    """Refine(SQ8) over IVF-PQ: IndexRefine over :func:`ivfpq_from_arrays`
    with the IndexFlatSQ8 store of :func:`flat_sq8_from_arrays`."""
    base = ivfpq_from_arrays(
        centroids, pq_centroids, codes, listnos, ids, device=device
    )
    return IndexRefine(
        base, flat_sq8_from_arrays(sq_trained, sq_codes, base.metric_type,
                                   device=device)
    )


def _sq_trained(sq, trained, tq_seed):
    """Set a ScalarQuantizer's state: ``trained`` [2, d] or [2, 1] float32
    (vmin, vdiff) as faiss_tpu holds it, None for an untrained one."""
    if trained is not None:
        trained = np.ascontiguousarray(trained, np.float32)
        if trained.ndim != 2 or trained.shape[0] != 2:
            raise ValueError(f"trained must be [2, w], got shape {trained.shape}")
        sq.trained = trained.copy()
    sq.tq_seed = int(tq_seed)


def sq_from_arrays(d, qtype, trained, codes, metric=MetricType.L2, *,
                   device, tq_seed=123) -> IndexScalarQuantizer:
    """IndexScalarQuantizer(d, qtype) from its quantizer's ``trained``
    array and its codes [n, code_size] uint8 in add order."""
    index = IndexScalarQuantizer(d, qtype, metric, device=device)
    _sq_trained(index.sq, trained, tq_seed)
    index.is_trained = index.sq.is_trained
    index.add_codes(codes)
    return index


def ivfsq_from_arrays(centroids, qtype, trained, codes, listnos, ids, *,
                      device, by_residual=False, metric=MetricType.L2,
                      tq_seed=123) -> IndexIVFScalarQuantizer:
    """IndexIVFScalarQuantizer from coarse centroids [nlist, d], the
    quantizer type and its ``trained`` array, and the lists' entries in add
    order: codes [n, code_size] uint8, list numbers [n] and ids [n];
    ``by_residual`` as the index was trained."""
    codes = np.ascontiguousarray(codes, np.uint8)
    centroids, listnos, ids = _ivf_arrays(centroids, listnos, ids, len(codes))
    nlist, d = centroids.shape
    index = IndexIVFScalarQuantizer(
        _quantizer(centroids, metric, device), d, nlist, qtype,
        MetricType(metric), by_residual=bool(by_residual), device=device)
    _sq_trained(index.sq, trained, tq_seed)
    index.is_trained = True
    index.add_encoded(codes.reshape(len(codes), index.code_size), listnos, ids)
    return index


def pq_from_arrays(d, M, nbits, pq_centroids, codes, metric=MetricType.L2, *,
                   fastscan=False, bbs=32, device) -> IndexPQ:
    """IndexPQ (IndexPQFastScan with ``fastscan``) from its codebooks
    [M, 2^nbits, d / M] and unpacked codes [n, M] in add order."""
    index = (IndexPQFastScan(d, M, nbits, metric, bbs, device=device) if fastscan
             else IndexPQ(d, M, nbits, metric, device=device))
    cb, codes, _ = _pq_state(pq_centroids, codes)
    index.pq.set_centroids(cb)
    index.is_trained = True
    index.add_codes_int(codes)
    return index


def lsh_from_arrays(d, nbits, A, thresholds, codes, *, rotate_data=True,
                    train_thresholds=False, device) -> IndexLSH:
    """IndexLSH from its rotation ``A`` [nbits, d] (None without one), its
    per-bit ``thresholds`` [nbits] (None if untrained) and its codes
    [n, (nbits + 7) / 8] uint8."""
    index = IndexLSH(d, nbits, rotate_data, train_thresholds, device=device)
    if A is not None and index.rrot is not None:
        index.rrot.A = np.ascontiguousarray(A, np.float32)
    if thresholds is not None:
        index.thresholds = np.ascontiguousarray(thresholds, np.float32)
    index.is_trained = True
    index.add_codes(codes)
    return index


def binary_flat_from_arrays(codes, *, device) -> IndexBinaryFlat:
    """IndexBinaryFlat over the codes [n, d / 8] uint8."""
    codes = np.ascontiguousarray(codes, np.uint8)
    index = IndexBinaryFlat(codes.shape[1] * 8, device=device)
    index.add(codes)
    return index


def binary_ivf_from_arrays(quantizer_codes, codes, listnos, ids, nprobe=1, *,
                           device) -> IndexBinaryIVF:
    """IndexBinaryIVF from its coarse centroids' codes [nlist, d / 8] and
    the lists' entries in add order: codes [n, d / 8], list numbers [n] and
    ids [n]."""
    q = binary_flat_from_arrays(quantizer_codes, device=device)
    index = IndexBinaryIVF(q, q.d, q.ntotal, device=device)
    index.nprobe = int(nprobe)
    index.add_encoded(codes, listnos, ids)
    return index


def idmap_from_arrays(index: Index, id_map, *, two: bool = False
                      ) -> IndexIDMap:
    """IndexIDMap (IndexIDMap2 with ``two``) over the port index ``index``,
    whose row i has the id ``id_map[i]``."""
    id_map = np.ascontiguousarray(id_map, np.int64).ravel()
    if len(id_map) != index.ntotal:
        raise ValueError("id_map and the index differ in length")
    out = (IndexIDMap2 if two else IndexIDMap)(index)
    out.id_map = id_map.copy()
    out.ntotal = index.ntotal
    return out


def transform_from_arrays(cls_name, d_in, d_out, A=None, b=None, mean=None, *,
                          device, dim_map=None, norm=2.0, eigen_power=0.0,
                          random_rotation=False, M=None, have_bias=False):
    """A trained transform of class ``cls_name`` (a name of
    faiss_tpu_torch.transforms) from its arrays: ``A`` [d_out, d_in] and
    ``b`` [d_out] of a linear transform (``b`` sets ``have_bias``), ``mean``
    of PCAMatrix, CenteringTransform and ITQTransform (whose ``A`` is its
    PCA-then-ITQ matrix), ``dim_map`` of RemapDimensionsTransform, ``norm``
    of NormalizationTransform, PCAMatrix's ``eigen_power`` and
    ``random_rotation`` and OPQMatrix's ``M``. The arrays are kept as given
    (float32 from faiss_tpu: bitwise the same)."""
    if cls_name == "NormalizationTransform":
        return T.NormalizationTransform(d_in, norm, device=device)
    if cls_name == "CenteringTransform":
        vt = T.CenteringTransform(d_in, device=device)
        vt.mean = mean
        vt.is_trained = True
        return vt
    if cls_name == "RemapDimensionsTransform":
        return T.RemapDimensionsTransform(d_in, d_out, np.asarray(dim_map),
                                          device=device)
    if cls_name == "ITQTransform":
        vt = T.ITQTransform(d_in, d_out, device=device)
        vt.mean = mean
        lt = T.LinearTransform(d_in, d_out, False, device=device)
        lt.A = A
        vt.pca_then_itq = lt
        vt.is_trained = True
        return vt
    if cls_name == "PCAMatrix":
        vt = T.PCAMatrix(d_in, d_out, eigen_power, random_rotation,
                         device=device)
        vt.mean = mean
    elif cls_name == "OPQMatrix":
        vt = T.OPQMatrix(d_in, M, d_out, device=device)
    elif cls_name == "RandomRotationMatrix":
        vt = T.RandomRotationMatrix(d_in, d_out, device=device)
    elif cls_name == "HadamardRotation":
        vt = T.HadamardRotation(d_in, device=device)
    elif cls_name == "ITQMatrix":
        vt = T.ITQMatrix(d_in, device=device)
    else:  # any other linear transform, as faiss_tpu reads one
        vt = T.LinearTransform(d_in, d_out, have_bias, device=device)
    if A is not None:
        vt.A = A
    if b is not None:
        vt.b = b
        vt.have_bias = True
    vt.is_trained = True
    vt.set_is_orthonormal()
    return vt


def pretransform_from(chain, index: Index) -> IndexPreTransform:
    """IndexPreTransform of the port transforms ``chain`` (applied first to
    last) over the port index ``index``."""
    out = IndexPreTransform(index)
    for vt in reversed(list(chain)):
        out.prepend_transform(vt)
    out.is_trained = index.is_trained and all(vt.is_trained for vt in chain)
    return out


def hnsw_from_state(storage: Index, state) -> IndexHNSW:
    """The HNSW index over the port index ``storage`` (holding the rows in
    graph order) whose graph is ``state``, a faiss_tpu ``graph_state()``:
    the graph's rows ``vecs``, ``levels``, the concatenated ``neighbors``,
    ``entry_point``, ``max_level``, ``M``, ``efConstruction``,
    ``efSearch`` and, for Panorama, ``pano_levels``. The class follows the
    storage: IndexHNSWSQ, IndexHNSWPQ, IndexHNSWFlat(Panorama)."""
    if isinstance(storage, IndexScalarQuantizer):
        cls = IndexHNSWSQ
    elif isinstance(storage, IndexPQ):
        cls = IndexHNSWPQ
    elif isinstance(storage, IndexFlat):
        cls = IndexHNSWFlatPanorama if "pano_levels" in state else IndexHNSWFlat
    else:
        raise TypeError(f"no HNSW class over {type(storage).__name__}")
    vecs = np.ascontiguousarray(state["vecs"], np.float32)
    if len(vecs) != storage.ntotal:
        raise ValueError("the graph's rows and the storage differ in length")
    index = IndexHNSW(storage, int(state["M"]))
    index.__class__ = cls
    if cls is IndexHNSWFlatPanorama:
        index.num_panorama_levels = int(state["pano_levels"])
    index.restore_graph(state, vecs)
    index.is_trained = True
    return index


def nsg_from_state(state, xb=None, *, storage: Index = None, GK: int = 64,
                   nndescent: bool = False, device) -> IndexNSGFlat:
    """The NSG index whose graph is ``state``, a faiss_tpu
    ``graph_state()`` (``graph`` [ntotal * R], ``enterpoint``, ``R``,
    ``search_L``): IndexNSGFlat (IndexNNDescentFlat with ``nndescent``) over
    the rows ``xb``, or, given the port index ``storage`` (PQ or SQ),
    IndexNSGPQ / IndexNSGSQ over its decoded rows."""
    R = int(state["R"])
    if storage is None:
        xb = np.ascontiguousarray(xb, np.float32)
        index = (IndexNNDescentFlat if nndescent else IndexNSGFlat)(
            xb.shape[1], R, device=device)
    else:
        kls = IndexNSGSQ if isinstance(storage, IndexScalarQuantizer) else IndexNSGPQ
        index = kls.__new__(kls)
        IndexNSGFlat.__init__(index, storage.d, R, storage.metric_type,
                              device=device)
        index.storage = storage
        index.is_trained = storage.is_trained
        xb = storage.reconstruct_n(0, storage.ntotal)
    index.GK = int(GK)
    index.restore_graph(state, xb)
    return index


def imi_from_arrays(d: int, pq_centroids, *, nbits: int,
                    device) -> MultiIndexQuantizer:
    """A trained MultiIndexQuantizer from its sub-codebooks
    ``pq_centroids`` [M, 2^nbits, d / M]."""
    cb = np.ascontiguousarray(pq_centroids, np.float32)
    index = MultiIndexQuantizer(d, cb.shape[0], nbits, device=device)
    index.pq.set_centroids(cb)
    index.is_trained = True
    index.ntotal = index.pq.ksub ** index.pq.M
    return index


def aq_norm_state(aq) -> dict:
    """The norm codec's state of an AQ codec (either package's), as
    keywords of :func:`aq_from_arrays`."""
    state = {"search_type": aq.search_type, "qnorm": aq.qnorm,
             "norm_tabs": aq.norm_tabs}
    if aq.norm_min == aq.norm_min:  # not NaN
        state.update(norm_min=aq.norm_min, norm_max=aq.norm_max)
    return state


def aq_from_arrays(cls_name, d, M, nbits, codebooks, codes, norms,
                   metric=MetricType.L2, *, nsplits=0, bbs=32, norm_state=None,
                   aq_class="ResidualQuantizer", device):
    """A flat additive-quantizer index of faiss_tpu's class ``cls_name``
    from its codebooks [M, 2^nbits, d] (a product codec's embedded full-d
    ones), unpacked codes [n, M] and the norms it ranks them with [n], in
    add order; ``norm_state`` as :func:`aq_norm_state` gives it."""
    index = aq_index(cls_name, d, M, nbits, metric, nsplits=nsplits, bbs=bbs,
                     aq_class=aq_class, device=device)
    set_aq_state(index.aq, codebooks, **(norm_state or {}))
    index.is_trained = True
    index.add_codes_int(codes, norms)
    return index


def ivf_aq_from_arrays(cls_name, centroids, M, nbits, codebooks, codes,
                       listnos, ids, metric=MetricType.L2, *, nsplits=0, bbs=32,
                       norm_state=None, aq_class="ResidualQuantizer",
                       device):
    """An IVF additive-quantizer index of faiss_tpu's class ``cls_name``
    from coarse centroids [nlist, d], the codec's codebooks, and the lists'
    entries in add order: the residuals' unpacked codes [n, M], list
    numbers [n] and ids [n]."""
    codes = np.ascontiguousarray(codes)
    centroids, listnos, ids = _ivf_arrays(centroids, listnos, ids, len(codes))
    nlist, d = centroids.shape
    index = aq_index(cls_name, d, M, nbits, metric, nsplits=nsplits, bbs=bbs,
                     aq_class=aq_class, quantizer=_quantizer(centroids, metric, device),
                     nlist=nlist, device=device)
    set_aq_state(index.aq, codebooks, **(norm_state or {}))
    index.is_trained = True
    index.add_encoded(codes, listnos, ids)
    return index


def rabitq_from_arrays(d, nb_bits, P, center, bits, factors, *, fastscan=False,
                       bbs=32, qb=None, device):
    """IndexRaBitQ (IndexRaBitQFastScan with ``fastscan``) from its rotation
    P [d, d], center [d] and, in add order, its codes (1-bit packed signs
    [n, d/8], multi-bit codes [n, d]) and factors [n, 2]."""
    index = (IndexRaBitQFastScan(d, bbs=bbs, nb_bits=nb_bits, device=device)
             if fastscan else IndexRaBitQ(d, nb_bits=nb_bits, device=device))
    if qb is not None:
        index.qb = int(qb)
    index.rabitq.P = np.ascontiguousarray(P, np.float32)
    index.rabitq.center = np.ascontiguousarray(center, np.float32)
    index.is_trained = True
    index.add_codes(bits, factors)
    return index


def ivf_rabitq_from_arrays(centroids, nb_bits, codes, listnos, ids, *,
                           fastscan=False, bbs=32, qb=None, device):
    """IndexIVFRaBitQ (IndexIVFRaBitQFastScan with ``fastscan``) from coarse
    centroids [nlist, d] and the lists' entries in add order: codes [n,
    code_size] uint8 (1-bit: bits, factors and <P c, o_bar>; multi-bit: the
    packed bytes), list numbers [n] and ids [n]. The rotation is the seed's,
    as faiss_tpu's files rebuild it."""
    codes = np.ascontiguousarray(codes, np.uint8)
    centroids, listnos, ids = _ivf_arrays(centroids, listnos, ids, len(codes))
    nlist, d = centroids.shape
    quantizer = _quantizer(centroids, MetricType.L2, device)
    index = (IndexIVFRaBitQFastScan(quantizer, d, nlist, bbs=bbs, nb_bits=nb_bits,
                                    device=device)
             if fastscan else IndexIVFRaBitQ(quantizer, d, nlist, nb_bits=nb_bits,
                                             device=device))
    if qb is not None:
        index.qb = int(qb)
    index.rabitq.center = np.zeros(d, np.float32)
    index.is_trained = True
    index.add_encoded(codes, listnos, ids)
    return index


def eden_from_arrays(d, nb_bits, scale_type, center, codes, factors,
                     metric=MetricType.L2, *, device) -> IndexEDEN:
    """IndexEDEN from its center [d] and, in add order, its unpacked codes
    [n, d] uint8 and factors [n, 2] float32."""
    index = IndexEDEN(d, metric, nb_bits, scale_type, device=device)
    index.center = np.ascontiguousarray(center, np.float32)
    index.is_trained = True
    index.add_codes(np.ascontiguousarray(codes, np.uint8),
                    np.ascontiguousarray(factors, np.float32))
    return index


def ivf_eden_from_arrays(centroids, nb_bits, scale_type, codes, listnos, ids,
                         metric=MetricType.L2, *, device) -> IndexIVFEDEN:
    """IndexIVFEDEN from coarse centroids [nlist, d] and the lists' entries in
    add order: packed codes [n, code_size] uint8, list numbers and ids."""
    codes = np.ascontiguousarray(codes, np.uint8)
    centroids, listnos, ids = _ivf_arrays(centroids, listnos, ids, len(codes))
    nlist, d = centroids.shape
    index = IndexIVFEDEN(_quantizer(centroids, metric, device), d, nlist, metric,
                         nb_bits, scale_type, device=device)
    index.add_encoded(codes, listnos, ids)
    return index


def lattice_from_arrays(d, nsq, scale_nbit, r2, trained, fields,
                        metric=MetricType.L2, *, device) -> IndexLattice:
    """IndexLattice from its trained norm range [2, nsq] and, in add order,
    its fields [n, nsq, 2] int64 (norm code, lattice id)."""
    index = IndexLattice(d, nsq, scale_nbit, r2, metric, device=device)
    index.trained = np.asarray(trained, np.float32)
    index.is_trained = True
    index.add_fields(fields)
    return index


def panorama_from_arrays(xb, num_levels=4, *, device) -> IndexFlatPanorama:
    """IndexFlatPanorama holding the rows ``xb`` [n, d] in order."""
    xb = np.ascontiguousarray(xb, np.float32)
    index = IndexFlatPanorama(xb.shape[1], num_levels, device=device)
    index.add(xb)
    return index


def ivf_panorama_from_arrays(centroids, xb, listnos, ids, n_levels=4, *,
                             device) -> IndexIVFFlatPanorama:
    """IndexIVFFlatPanorama from coarse centroids and the lists' vectors,
    list numbers and ids in add order."""
    xb = np.ascontiguousarray(xb, np.float32)
    centroids, listnos, ids = _ivf_arrays(centroids, listnos, ids, len(xb))
    nlist, d = centroids.shape
    index = IndexIVFFlatPanorama(_quantizer(centroids, MetricType.L2, device), d,
                                 nlist, n_levels, device=device)
    index.add_encoded(xb, listnos, ids)
    return index


def qinco_from_state(state, d, K, L, M, h, *, device) -> QINCo:
    """A QINCo module on ``device`` loaded from a numpy state dict of
    faiss_tpu's names."""
    model = QINCo(d, K, L, M, h).to(device)
    model.load_state(state)
    return model


def sharded_flat_from_arrays(xb, mesh, metric=MetricType.L2) -> ShardedFlat:
    """ShardedFlat over ``mesh`` holding the rows ``xb`` [n, d] in order."""
    xb = np.ascontiguousarray(xb, np.float32)
    index = ShardedFlat(xb.shape[1], mesh, metric)
    index.add(xb)
    return index


def sharded_ivf_from_arrays(centroids, xb, listnos, ids, mesh, *,
                            metric=MetricType.L2) -> ShardedIVF:
    """ShardedIVF over ``mesh`` of the :func:`ivfflat_from_arrays` index
    (built on ``mesh.devices[0]``)."""
    return ShardedIVF(ivfflat_from_arrays(centroids, xb, listnos, ids,
                                          device=mesh.devices[0], metric=metric),
                      mesh)


def sharded_ivfpq_from_arrays(centroids, pq_centroids, codes, listnos, ids,
                              mesh, *, by_residual=True,
                              metric=MetricType.L2) -> ShardedIVFPQ:
    """ShardedIVFPQ over ``mesh`` of the :func:`ivfpq_from_arrays` index
    (built on ``mesh.devices[0]``)."""
    return ShardedIVFPQ(ivfpq_from_arrays(
        centroids, pq_centroids, codes, listnos, ids, device=mesh.devices[0],
        by_residual=by_residual, metric=metric), mesh)


def sharded_refined_ivfpq_from_arrays(centroids, pq_centroids, codes, listnos,
                                      ids, xb_t, mesh, *, store_float16=True,
                                      k_factor=4, by_residual=True,
                                      metric=MetricType.L2
                                      ) -> ShardedRefinedIVFPQ:
    """ShardedRefinedIVFPQ over ``mesh`` of the :func:`ivfpq_from_arrays`
    index, its refine store the rows ``xb_t`` [n, d] in add order."""
    index = ivfpq_from_arrays(centroids, pq_centroids, codes, listnos, ids,
                              device=mesh.devices[0], by_residual=by_residual,
                              metric=metric)
    return ShardedRefinedIVFPQ(index, mesh, xb_t, store_float16=store_float16,
                               k_factor=k_factor)


def ivfpq_builder_from_arrays(centroids, pq_centroids, mesh, *,
                              metric=MetricType.L2, by_residual=True
                              ) -> ShardedIVFPQBuilder:
    """A trained ShardedIVFPQBuilder over ``mesh`` from coarse centroids
    [nlist, d] and PQ codebooks [M, ksub, dsub], ready to ``add``."""
    centroids = np.ascontiguousarray(centroids, np.float32)
    M, ksub, _ = np.shape(pq_centroids)
    builder = ShardedIVFPQBuilder(centroids.shape[1], len(centroids), M,
                                  ksub.bit_length() - 1, mesh, metric=metric,
                                  by_residual=by_residual)
    builder.centroids = centroids
    builder.pq.set_centroids(pq_centroids)
    builder.is_trained = True
    return builder
