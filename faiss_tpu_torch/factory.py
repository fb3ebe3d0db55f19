"""index_factory: an index from a factory string (counterpart of
faiss_tpu/factory.py:74-518; reference: faiss/index_factory.cpp).

The grammar is faiss_tpu's: the string splits on top-level commas into
[pretransforms] [IDMap | IDMap2] coarse + encoding | flat encoding
[RFlat | Refine(...)]. Transforms wrap the refinement and IDMap wraps
everything. The port builds:

  - pretransforms ``PCA[W][R]n``, ``OPQm[_d]``, ``RR[n]``, ``ITQ[n]``,
    ``Padn`` and ``L2norm``;
  - ``IVFn`` over a flat coarse quantizer with the encodings ``Flat``,
    ``PQmx4fs[_bbs]``, ``PQmxn``, ``PQm+n`` (IndexIVFPQR), ``PQm`` and the
    scalar quantizers ``SQ*`` (IndexIVFScalarQuantizer);
  - the flat encodings ``Flat``, ``Flat1D``, ``SQ*``
    (IndexScalarQuantizer), ``PQm``, ``PQmxn`` (IndexPQ), ``PQmx4fs[_bbs]``
    (IndexPQFastScan) and ``LSH[r][t]`` (IndexLSH with d bits, rotated
    with ``r``, trained thresholds with ``t``);
  - ``RFlat`` and ``Refine(Flat)`` (IndexRefineFlat), ``Refine(SQ8)``
    (IndexRefineFlat with an SQ8 store) and ``Refine(<any string>)``
    (IndexRefine over the index that string builds).

A token whose class the port does not have yet raises NotImplementedError
naming its ROADMAP queue-1 item; a string that faiss_tpu's grammar does not
parse raises ValueError, as faiss_tpu does."""

from __future__ import annotations

import re
from typing import Optional

from .base import Index, require_device
from .metric import MetricType
from .models.flat import IndexFlat, IndexFlat1D
from .models.ivf_flat import IndexIVFFlat
from .models.ivf_pq import IndexIVFPQ, IndexIVFPQFastScan, IndexIVFPQR
from .models.lsh import IndexLSH
from .models.pq import IndexPQ, IndexPQFastScan
from .models.sq import IndexIVFScalarQuantizer, IndexScalarQuantizer
from .models.meta import (
    IndexIDMap,
    IndexIDMap2,
    IndexPreTransform,
    IndexRefine,
    IndexRefineFlat,
)
from .codecs.sq import QuantizerType
from . import transforms as T

_ITEM10 = "ROADMAP queue 1 item 10"

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

# faiss_tpu's tokens for the other codecs, the graphs (with their SQ
# variants, HNSWn,SQx and NSGn,SQx) and the quantizers the port does not
# have yet (ROADMAP queue 1 item 10): they parse, then raise
_UNPORTED_CODECS = (
    r"(RQ|LSQ)\d+x(4fs|\d+)(_\w+)?", r"(PRQ|PLSQ)\d+x\d+x(4fs|\d+)(_\w+)?",
    r"RaBitQ(fs)?\d?(_\d+)?", r"EDEN[1-8]?(BIASED|BIAS)?", r"FlatPanorama(\d+)?(_\d+)?",
    r"ZnLattice\d+x\d+_\d+",
    r"(HNSW|NSG|NNDescent)(\d+)?",
)


def _unported(tok: str, what: str):
    raise NotImplementedError(
        f"index_factory: {what} {tok!r} is not ported yet ({_ITEM10})"
    )


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


def _parse_coarse(tok: str):
    """nlist of an ``IVFn`` token (index_factory.cpp:278), or None where the
    token is no coarse spec; the coarse quantizers other than flat raise."""
    if m := re.fullmatch(r"IVF(\d+)", tok):
        return int(m.group(1))
    if re.fullmatch(r"IVF\d+\(.+\)|IVF\d+_HNSW\d*", tok):
        _unported(tok, "the coarse quantizer of")
    if re.fullmatch(r"IMI2x\d+", tok):
        _unported(tok, "the coarse quantizer")
    return None


def _parse_ivf_encoding(tok: str, d: int, nlist: int, metric, device):
    """Encoding inside IVF (index_factory.cpp:367 parse_IndexIVF)."""
    if tok == "Flat":
        return IndexIVFFlat(None, d, nlist, metric, device=device)
    if m := re.fullmatch(r"PQ(\d+)x4fs(?:_(\d+))?", tok):
        bbs = int(m.group(2)) if m.group(2) else 32
        return IndexIVFPQFastScan(None, d, nlist, int(m.group(1)), 4, metric,
                                  bbs, device=device)
    if m := re.fullmatch(r"PQ(\d+)x(\d+)", tok):
        return IndexIVFPQ(None, d, nlist, int(m.group(1)), int(m.group(2)),
                          metric, device=device)
    if m := re.fullmatch(r"PQ(\d+)\+(\d+)", tok):
        return IndexIVFPQR(None, d, nlist, int(m.group(1)), 8,
                           int(m.group(2)), 8, metric, device=device)
    if m := re.fullmatch(r"PQ(\d+)", tok):
        return IndexIVFPQ(None, d, nlist, int(m.group(1)), 8, metric,
                          device=device)
    if tok in _SQ_TYPES:
        return IndexIVFScalarQuantizer(None, d, nlist, _SQ_TYPES[tok], metric,
                                       device=device)
    if any(re.fullmatch(p, tok) for p in _UNPORTED_CODECS):
        _unported(tok, "the IVF encoding")
    return None


def _parse_flat_encoding(tok: str, d: int, metric, device):
    """Standalone encodings (index_factory.cpp parse_other_indexes)."""
    if tok == "Flat":
        return IndexFlat(d, metric, device=device)
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
    if any(re.fullmatch(p, tok) for p in _UNPORTED_CODECS):
        _unported(tok, "the encoding")
    return None


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
                  device="cuda") -> Index:
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
        nlist = _parse_coarse(tok)
        if nlist is not None:
            if i + 1 >= len(toks):
                raise ValueError(f"IVF spec {tok!r} needs an encoding token")
            i += 1
            enc = _parse_ivf_encoding(toks[i], cur_d, nlist, metric, device)
            if enc is None:
                raise ValueError(f"cannot parse IVF encoding {toks[i]!r}")
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
        enc = _parse_flat_encoding(tok, cur_d, metric, device)
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
