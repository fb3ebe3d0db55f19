"""index_factory: an index from a factory string (counterpart of
faiss_tpu/factory.py:74-518; reference: faiss/index_factory.cpp).

The grammar is faiss_tpu's: the string splits on top-level commas into
[pretransforms] [IDMap | IDMap2] coarse + encoding | flat encoding
[RFlat | Refine(...)]. Transforms wrap the refinement and IDMap wraps
everything. The port builds:

  - pretransforms ``PCA[W][R]n``, ``OPQm[_d]``, ``RR[n]``, ``ITQ[n]``,
    ``Padn`` and ``L2norm``;
  - the coarse quantizers ``IVFn`` (flat), ``IVFn_HNSWm`` (an
    IndexHNSWFlat over the centroids), ``IVFn(<any string>)`` (the index
    that string builds) and ``IMI2xb`` (a MultiIndexQuantizer of 2^2b cells
    that trains itself), with the encodings ``Flat``, ``PQmx4fs[_bbs]``,
    ``PQmxn``, ``PQm+n`` (IndexIVFPQR), ``PQm`` and the scalar quantizers
    ``SQ*`` (IndexIVFScalarQuantizer);
  - the graphs ``HNSWn`` and ``NSGn``, alone or with a storage token
    ``Flat``, ``FlatPanoramaN`` (HNSW), ``PQm[xb]``, ``SQ*``, ``k+PQm`` and
    ``2xb+PQm`` (IndexHNSW2Level over a flat or an IMI quantizer), and
    ``NNDescentn``;
  - the flat encodings ``Flat``, ``Flat1D``, ``SQ*``
    (IndexScalarQuantizer), ``PQm``, ``PQmxn`` (IndexPQ), ``PQmx4fs[_bbs]``
    (IndexPQFastScan) and ``LSH[r][t]`` (IndexLSH with d bits, rotated
    with ``r``, trained thresholds with ``t``);
  - the additive quantizers ``RQmxn``, ``LSQmxn``, ``RQmx4fs[_bbs]``,
    ``LSQmx4fs[_bbs]``, ``PRQsxmxn`` and ``PLSQsxmxn`` (flat and in IVF;
    ``PRQ``/``PLSQ`` ``x4fs[_bbs]`` in IVF only, as faiss_tpu's grammar), each
    with an optional norm suffix ``_Nfloat``, ``_Nnone``, ``_Nqint8``,
    ``_Nqint4``, ``_Ncqint8``, ``_Ncqint4``, ``_Nlsq2x4`` or ``_Nrq2x4`` on
    the non-FastScan tokens, and RaBitQ, ``RaBitQ[n]`` and
    ``RaBitQfs[n][_bbs]`` (n bits a dimension, flat and in IVF);
  - ``EDEN[n][BIASED|BIAS]`` (IndexEDEN, IndexIVFEDEN),
    ``FlatPanorama[n]`` (IndexFlatPanorama, and IndexIVFFlatPanorama with
    an optional ``_m`` suffix in IVF) and ``ZnLatticeNxS_R`` (IndexLattice,
    flat only);
  - ``RFlat`` and ``Refine(Flat)`` (IndexRefineFlat), ``Refine(SQ8)``
    (IndexRefineFlat with an SQ8 store) and ``Refine(<any string>)``
    (IndexRefine over the index that string builds).

A string that faiss_tpu's grammar does not parse raises ValueError, as
faiss_tpu does. ``metric_arg`` (p of METRIC_Lp) goes to every index of the
tree that takes one (faiss_tpu's factory has no such argument; its indexes
keep 0)."""

from __future__ import annotations

import re
from typing import Optional

from .base import Index, require_device
from .metric import MetricType
from .models.flat import IndexFlat, IndexFlat1D
from .models.hnsw import (
    IndexHNSW2Level,
    IndexHNSWFlat,
    IndexHNSWFlatPanorama,
    IndexHNSWPQ,
    IndexHNSWSQ,
)
from .models.imi import MultiIndexQuantizer
from .models.nsg import IndexNNDescentFlat, IndexNSGFlat, IndexNSGPQ, IndexNSGSQ
from .models.ivf_flat import IndexIVFFlat
from .models.ivf_pq import IndexIVFPQ, IndexIVFPQFastScan, IndexIVFPQR
from .models.lsh import IndexLSH
from .models.aq import aq_index
from .models.rabitq import (
    IndexIVFRaBitQ,
    IndexIVFRaBitQFastScan,
    IndexRaBitQ,
    IndexRaBitQFastScan,
)
from .models.pq import IndexPQ, IndexPQFastScan
from .models.sq import IndexIVFScalarQuantizer, IndexScalarQuantizer
from .models.meta import (
    IndexIDMap,
    IndexIDMap2,
    IndexPreTransform,
    IndexRefine,
    IndexRefineFlat,
)
from .models.eden import IndexEDEN, IndexIVFEDEN
from .models.lattice import IndexLattice
from .models.panorama import IndexFlatPanorama, IndexIVFFlatPanorama
from .codecs.aq import AdditiveQuantizer
from .codecs.eden import EDENScaleType
from .codecs.sq import QuantizerType
from . import transforms as T

# the scalar-quantizer tokens (faiss_tpu/factory.py:31-48;
# index_factory.cpp:160-179 sq_types)
_SQ_TYPES = {
    "SQ8": QuantizerType.QT_8bit,
    "SQ4": QuantizerType.QT_4bit,
    "SQ6": QuantizerType.QT_6bit,
    "SQfp16": QuantizerType.QT_fp16,
    "SQbf16": QuantizerType.QT_bf16,
    "SQ8_direct_signed": QuantizerType.QT_8bit_direct_signed,
    "SQ8_direct": QuantizerType.QT_8bit_direct,
    "SQ0": QuantizerType.QT_0bit,
    "SQtqmse1": QuantizerType.QT_1bit_tqmse,
    "SQtqmse2": QuantizerType.QT_2bit_tqmse,
    "SQtqmse3": QuantizerType.QT_3bit_tqmse,
    "SQtqmse4": QuantizerType.QT_4bit_tqmse,
    "SQtqmse8": QuantizerType.QT_8bit_tqmse,
    "SQtq2": QuantizerType.QT_2bit_tq,
    "SQtq3": QuantizerType.QT_3bit_tq,
    "SQtq4": QuantizerType.QT_4bit_tq,
    "SQtq5": QuantizerType.QT_5bit_tq,
}

# the AQ norm-storage suffixes (faiss_tpu factory.py:52-71;
# index_factory.cpp:193 aq_norm_pattern) and the tokens that take them
_AQ_NORMS = {
    "_Nfloat": AdditiveQuantizer.ST_norm_float,
    "_Nnone": AdditiveQuantizer.ST_LUT_nonorm,
    "_Nqint8": AdditiveQuantizer.ST_norm_qint8,
    "_Nqint4": AdditiveQuantizer.ST_norm_qint4,
    "_Ncqint8": AdditiveQuantizer.ST_norm_cqint8,
    "_Ncqint4": AdditiveQuantizer.ST_norm_cqint4,
    "_Nlsq2x4": AdditiveQuantizer.ST_norm_lsq2x4,
    "_Nrq2x4": AdditiveQuantizer.ST_norm_rq2x4,
}
_AQ_NORM_BASE = r"(RQ|LSQ)\d+x\d+|(PRQ|PLSQ)\d+x\d+x\d+"


def _strip_aq_norm_suffix(tok: str):
    """(token without its AQ norm suffix, search_type or None)."""
    for s, st in _AQ_NORMS.items():
        if tok.endswith(s):
            return tok[: -len(s)], st
    return tok, None


# the AQ tokens' codecs; the class is Index[IVF]<codec>[FastScan]
_AQ_CODECS = {"RQ": "ResidualQuantizer", "LSQ": "LocalSearchQuantizer",
              "PRQ": "ProductResidualQuantizer",
              "PLSQ": "ProductLocalSearchQuantizer"}


def _aq_encoding(tok: str, d: int, metric, device, ivf):
    """The additive-quantizer index of ``tok`` (faiss_tpu factory.py:128-230
    IVF, :245-306 flat): ``RQmxn``, ``LSQmxn``, ``RQmx4fs[_bbs]``,
    ``LSQmx4fs[_bbs]``, ``PRQsxmxn``, ``PLSQsxmxn`` and, in IVF only,
    ``PRQsxmx4fs[_bbs]`` / ``PLSQsxmx4fs[_bbs]``; ``ivf`` the (quantizer,
    nlist) of an IVF encoding, None for a flat one; or None."""
    m = (re.fullmatch(r"(RQ|LSQ)()(\d+)x(\d+)", tok)
         or re.fullmatch(r"(RQ|LSQ)()(\d+)x(4)(fs)(?:_(\d+))?", tok)
         or re.fullmatch(r"(PRQ|PLSQ)(\d+)x(\d+)x(\d+)", tok)
         or (ivf and re.fullmatch(r"(PRQ|PLSQ)(\d+)x(\d+)x(4)(fs)(?:_(\d+))?", tok)))
    if not m:
        return None
    kind, nsplits, msub, nbits, fs, bbs = m.groups() + (None,) * (6 - len(m.groups()))
    nsplits = int(nsplits or 0)
    quantizer, nlist = ivf or (None, 0)
    cls = f"Index{'IVF' if ivf else ''}{_AQ_CODECS[kind]}{'FastScan' if fs else ''}"
    return aq_index(cls, d, int(msub) * max(1, nsplits), int(nbits), metric,
                    nsplits=nsplits, bbs=int(bbs or 32), quantizer=quantizer,
                    nlist=nlist, device=device)


def _rabitq_encoding(tok: str, d: int, metric, device, ivf):
    """``RaBitQfs[n][_bbs]`` / ``RaBitQ[n]`` (index_factory.cpp:535), flat
    or with ``ivf`` = (quantizer, nlist); or None."""
    head = (ivf[0], d, ivf[1]) if ivf else (d,)
    if m := re.fullmatch(r"RaBitQfs([1-9])?(?:_(\d+))?", tok):
        cls = IndexIVFRaBitQFastScan if ivf else IndexRaBitQFastScan
        return cls(*head, metric, int(m.group(2) or 32), int(m.group(1) or 1),
                   device=device)
    if m := re.fullmatch(r"RaBitQ([1-9])?", tok):
        cls = IndexIVFRaBitQ if ivf else IndexRaBitQ
        return cls(*head, metric, int(m.group(1) or 1), device=device)
    return None


def _coded_encoding(tok: str, d: int, metric, device, ivf=None):
    """An AQ token with or without its norm suffix, or a RaBitQ token;
    None otherwise."""
    base, st = _strip_aq_norm_suffix(tok)
    if st is not None and re.fullmatch(_AQ_NORM_BASE, base):
        index = _aq_encoding(base, d, metric, device, ivf)
        index.aq.set_search_type(st)
        return index
    return (_aq_encoding(tok, d, metric, device, ivf)
            or _rabitq_encoding(tok, d, metric, device, ivf))


def _eden_encoding(tok: str, d: int, metric, device, ivf=None):
    """``EDEN[n][BIASED|BIAS]`` (faiss_tpu factory.py:231, :312), flat or
    with ``ivf`` = (quantizer, nlist); or None."""
    if m := re.fullmatch(r"EDEN([1-8])?(BIASED|BIAS)?", tok):
        st = EDENScaleType.BIASED if m.group(2) else EDENScaleType.UNBIASED
        head = (ivf[0], d, ivf[1]) if ivf else (d,)
        cls = IndexIVFEDEN if ivf else IndexEDEN
        return cls(*head, metric, int(m.group(1) or 1), st, device=device)
    return None


def _parse_transform(tok: str, d: int, device):
    """Pretransform tokens (index_factory.cpp:226 parse_VectorTransform)."""
    if m := re.fullmatch(r"PCA(R|W|WR)?(\d+)", tok):
        opt, d_out = m.group(1) or "", int(m.group(2))
        return T.PCAMatrix(d, d_out, eigen_power=-0.5 if "W" in opt else 0.0,
                           random_rotation="R" in opt, device=device)
    if m := re.fullmatch(r"OPQ(\d+)(?:_(\d+))?", tok):
        M, d_out = int(m.group(1)), m.group(2)
        return T.OPQMatrix(d, M, int(d_out) if d_out else -1, device=device)
    if m := re.fullmatch(r"RR(\d+)?", tok):
        rr = T.RandomRotationMatrix(d, int(m.group(1)) if m.group(1) else d,
                                    device=device)
        rr.init()
        return rr
    if m := re.fullmatch(r"ITQ(\d+)?", tok):
        d_out = int(m.group(1)) if m.group(1) else d
        return T.ITQTransform(d, d_out, do_pca=m.group(1) is not None,
                              device=device)
    if m := re.fullmatch(r"Pad(\d+)", tok):
        return T.RemapDimensionsTransform(d, max(d, int(m.group(1))), False,
                                          device=device)
    if tok == "L2norm":
        return T.NormalizationTransform(d, 2.0, device=device)
    return None


def _parse_coarse(tok: str, d: int, metric, device):
    """(quantizer or None for flat, nlist) of a coarse spec
    (index_factory.cpp:278 parse_coarse_quantizer; faiss_tpu
    factory.py:103), or None where the token is no coarse spec."""
    if m := re.fullmatch(r"IVF(\d+)", tok):
        return None, int(m.group(1))
    if m := re.fullmatch(r"IVF(\d+)\((.+)\)", tok):
        return (index_factory(d, m.group(2), metric, device=device),
                int(m.group(1)))
    if m := re.fullmatch(r"IVF(\d+)_HNSW(\d+)?", tok):
        hm = int(m.group(2)) if m.group(2) else 32
        return IndexHNSWFlat(d, hm, metric, device=device), int(m.group(1))
    if m := re.fullmatch(r"IMI2x(\d+)", tok):
        nbits = int(m.group(1))
        return MultiIndexQuantizer(d, 2, nbits, device=device), 1 << (2 * nbits)
    return None


def _parse_ivf_encoding(tok: str, quantizer, d: int, nlist: int, metric,
                        device, metric_arg=0.0):
    """Encoding inside IVF (index_factory.cpp:367 parse_IndexIVF)."""
    if tok == "Flat":
        return IndexIVFFlat(quantizer, d, nlist, metric, device=device,
                            metric_arg=metric_arg)
    if m := re.fullmatch(r"FlatPanorama(\d+)?(?:_\d+)?", tok):
        return IndexIVFFlatPanorama(quantizer, d, nlist, int(m.group(1) or 4),
                                    metric, device=device)
    if m := re.fullmatch(r"PQ(\d+)x4fs(?:_(\d+))?", tok):
        bbs = int(m.group(2)) if m.group(2) else 32
        return IndexIVFPQFastScan(quantizer, d, nlist, int(m.group(1)), 4,
                                  metric, bbs, device=device)
    if m := re.fullmatch(r"PQ(\d+)x(\d+)", tok):
        return IndexIVFPQ(quantizer, d, nlist, int(m.group(1)),
                          int(m.group(2)), metric, device=device)
    if m := re.fullmatch(r"PQ(\d+)\+(\d+)", tok):
        return IndexIVFPQR(quantizer, d, nlist, int(m.group(1)), 8,
                           int(m.group(2)), 8, metric, device=device)
    if m := re.fullmatch(r"PQ(\d+)", tok):
        return IndexIVFPQ(quantizer, d, nlist, int(m.group(1)), 8, metric,
                          device=device)
    if tok in _SQ_TYPES:
        return IndexIVFScalarQuantizer(quantizer, d, nlist, _SQ_TYPES[tok],
                                       metric, device=device)
    return (_coded_encoding(tok, d, metric, device, (quantizer, nlist))
            or _eden_encoding(tok, d, metric, device, (quantizer, nlist)))


def _parse_flat_encoding(tok: str, d: int, metric, device, metric_arg=0.0):
    """Standalone encodings (index_factory.cpp parse_other_indexes)."""
    if tok == "Flat":
        return IndexFlat(d, metric, metric_arg, device=device)
    if m := re.fullmatch(r"FlatPanorama(\d+)?", tok):
        return IndexFlatPanorama(d, int(m.group(1) or 4), metric, device=device)
    if m := re.fullmatch(r"ZnLattice(\d+)x(\d+)_(\d+)", tok):
        return IndexLattice(d, int(m.group(1)), int(m.group(2)), int(m.group(3)),
                            metric, device=device)
    if tok == "Flat1D":
        return IndexFlat1D(device=device)
    if tok in _SQ_TYPES:
        return IndexScalarQuantizer(d, _SQ_TYPES[tok], metric, device=device)
    if m := re.fullmatch(r"PQ(\d+)x4fs(?:_(\d+))?", tok):
        return IndexPQFastScan(d, int(m.group(1)), 4, metric,
                               int(m.group(2) or 32), device=device)
    if m := re.fullmatch(r"PQ(\d+)x(\d+)", tok):
        return IndexPQ(d, int(m.group(1)), int(m.group(2)), metric, device=device)
    if m := re.fullmatch(r"PQ(\d+)", tok):
        return IndexPQ(d, int(m.group(1)), 8, metric, device=device)
    if m := re.fullmatch(r"LSH(r?)(t?)", tok):
        return IndexLSH(d, d, rotate_data=bool(m.group(1)),
                        train_thresholds=bool(m.group(2)), device=device)
    if m := re.fullmatch(r"HNSW(\d+)?", tok):
        return IndexHNSWFlat(d, int(m.group(1) or 32), metric, device=device)
    if m := re.fullmatch(r"NSG(\d+)?", tok):
        return IndexNSGFlat(d, int(m.group(1) or 32), metric, device=device)
    if m := re.fullmatch(r"NNDescent(\d+)?", tok):
        return IndexNNDescentFlat(d, int(m.group(1) or 32), metric,
                                  device=device)
    return (_coded_encoding(tok, d, metric, device)
            or _eden_encoding(tok, d, metric, device))


def _parse_graph_index(kind: str, gM: int, suffix, d: int, metric, device):
    """A graph index and whether it took the next token as its storage
    (index_factory.cpp parse_IndexHNSW / parse_IndexNSG; faiss_tpu
    factory.py:450): no suffix, a refine token or an unknown token leaves
    the graph flat and the token to the main loop."""
    hnsw = kind == "HNSW"
    flat_cls = IndexHNSWFlat if hnsw else IndexNSGFlat
    if suffix is None or suffix == "RFlat" or suffix.startswith("Refine"):
        return flat_cls(d, gM, metric, device=device), False
    if suffix == "Flat":
        return flat_cls(d, gM, metric, device=device), True
    if hnsw and (m := re.fullmatch(r"FlatPanorama(\d+)?", suffix)):
        nlevels = int(m.group(1)) if m.group(1) else 8
        return IndexHNSWFlatPanorama(d, gM, nlevels, metric,
                                     device=device), True
    if m := re.fullmatch(r"PQ(\d+)(?:x(\d+))?(?:np)?", suffix):
        pm, nbit = int(m.group(1)), int(m.group(2) or 8)
        if hnsw:
            return IndexHNSWPQ(d, gM, pm, nbit, device=device), True
        return IndexNSGPQ(d, pm, gM, nbit, device=device), True
    if suffix in _SQ_TYPES:
        if hnsw:
            return IndexHNSWSQ(d, _SQ_TYPES[suffix], gM, metric,
                               device=device), True
        return IndexNSGSQ(d, _SQ_TYPES[suffix], gM, metric, device=device), True
    if hnsw and (m := re.fullmatch(r"(\d+)\+PQ(\d+)", suffix)):
        return IndexHNSW2Level(IndexFlat(d, metric, device=device),
                               int(m.group(1)), int(m.group(2)), gM), True
    if hnsw and (m := re.fullmatch(r"2x(\d+)\+PQ(\d+)", suffix)):
        nbit = int(m.group(1))
        quant = MultiIndexQuantizer(d, 2, nbit, device=device)
        return IndexHNSW2Level(quant, 1 << (2 * nbit), int(m.group(2)),
                               gM), True
    return flat_cls(d, gM, metric, device=device), False


def _split_toplevel(description: str):
    """Split on commas not inside parentheses."""
    toks, depth, cur = [], 0, []
    for c in description:
        if c == "(":
            depth += 1
        elif c == ")":
            depth -= 1
        if c == "," and depth == 0:
            toks.append("".join(cur))
            cur = []
        else:
            cur.append(c)
    if cur:
        toks.append("".join(cur))
    return [t.strip() for t in toks if t.strip()]


def index_factory(d: int, description: str, metric=MetricType.L2, *,
                  device="cuda", metric_arg: float = 0.0) -> Index:
    """Build an index from a factory string (index_factory.h:17) on
    ``device`` (the card unless the caller passes another)."""
    metric = MetricType(metric)
    device = require_device(device)
    toks = _split_toplevel(description)
    transforms = []
    idmap: Optional[str] = None
    core: Optional[Index] = None
    refine: Optional[str] = None
    cur_d = d
    i = 0
    while i < len(toks):
        tok = toks[i]
        vt = _parse_transform(tok, cur_d, device)
        if vt is not None and core is None:
            transforms.append(vt)
            cur_d = vt.d_out
            i += 1
            continue
        if tok in ("IDMap", "IDMap2") and core is None:
            idmap = tok
            i += 1
            continue
        coarse = _parse_coarse(tok, cur_d, metric, device)
        if coarse is not None:
            quantizer, nlist = coarse
            if i + 1 >= len(toks):
                raise ValueError(f"IVF spec {tok!r} needs an encoding token")
            i += 1
            enc = _parse_ivf_encoding(toks[i], quantizer, cur_d, nlist, metric,
                                      device, metric_arg)
            if enc is None:
                raise ValueError(f"cannot parse IVF encoding {toks[i]!r}")
            if isinstance(quantizer, MultiIndexQuantizer):
                enc.quantizer_trains_alone = 1  # the IMI trains on the data
            core = enc
            i += 1
            continue
        if tok == "RFlat":
            refine = "Flat"
            i += 1
            continue
        if m := re.fullmatch(r"Refine\((.+)\)", tok):
            refine = m.group(1)
            i += 1
            continue
        if (m := re.fullmatch(r"(HNSW|NSG)(\d+)?", tok)) and core is None:
            nxt = toks[i + 1] if i + 1 < len(toks) else None
            core, used_suffix = _parse_graph_index(
                m.group(1), int(m.group(2) or 32), nxt, cur_d, metric, device)
            i += 2 if used_suffix else 1
            continue
        enc = _parse_flat_encoding(tok, cur_d, metric, device, metric_arg)
        if enc is not None:
            if core is not None:
                raise ValueError(f"unexpected token {tok!r} after index spec")
            core = enc
            i += 1
            continue
        raise ValueError(f"could not parse token {tok!r} in {description!r}")
    if core is None:
        raise ValueError(f"no index component in {description!r}")

    index = core
    if refine == "Flat":
        index = IndexRefineFlat(index)
    elif refine == "SQ8":
        index = IndexRefineFlat(index, store="sq8")
    elif refine is not None:
        index = IndexRefine(index, index_factory(cur_d, refine, metric,
                                                 device=device))
    for vt in reversed(transforms):
        index = IndexPreTransform(vt, index)
    if idmap == "IDMap":
        index = IndexIDMap(index)
    elif idmap == "IDMap2":
        index = IndexIDMap2(index)
    return index
