"""Port parity for the additive quantizers (faiss_tpu_torch/codecs/aq.py and
models/aq.py against faiss_tpu's): the same seeded numpy inputs go through
both packages, with the port on the CPU.

With faiss_tpu's trained codebooks carried across, RQ's beam search gives
faiss_tpu's codes (a row may differ only where its two best beams tie within
float32 rounding) and LSQ's ICM and iterated local search give them on the
same perturbations; packed codes and every norm storage encode and decode as
faiss_tpu's. Training is compared by its objective. The flat, FastScan,
product and IVF indexes search as faiss_tpu's from its trained state
(convert.aq_from_arrays / ivf_aq_from_arrays): distances within
1e-5 * (|q|^2 + max |y|^2), ids tie-aware. ID selectors, which faiss_tpu's
AQ searches ignore, are checked on the port's side against float64 over the
selected rows. Files go both ways."""

import functools

import numpy as np
import pytest
import torch

import faiss_tpu as ftj
from faiss_tpu.codecs import aq as aqj
from faiss_tpu.models import aq as ref_aq
import faiss_tpu_torch as ftt
from faiss_tpu_torch import convert
from faiss_tpu_torch.codecs import aq as aqt
from faiss_tpu_torch.utils.evaluation import ids_agree_tie_aware
from torch_threads import one_torch_thread  # noqa: F401

D, NB, NQ, K, NLIST = 16, 1500, 32, 10, 8


def mixture(seed, n, d=D, ncent=24):
    rs = np.random.RandomState(seed)
    cent = np.random.RandomState(98).randn(ncent, d).astype(np.float32)
    return (cent[rs.randint(ncent, size=n)] + 0.4 * rs.randn(n, d)).astype(np.float32)


@pytest.fixture(scope="module")
def data():
    return mixture(1, NB), mixture(2, NQ)


@pytest.fixture(autouse=True)
def small_reference_chunks(monkeypatch):
    """faiss_tpu's flat AQ scan pads the codes to its 65,536-code chunk; a
    2048-code chunk gives the same results in a fraction of the CPU time."""
    monkeypatch.setattr(ref_aq, "_aq_knn", functools.partial(ref_aq._aq_knn, db_chunk=2048))


def row_err(aq, codes, x):
    r = aq.decode_int(codes).astype(np.float64) - x
    return (r**2).sum(1)


def check_codes(a, b, ca, cb, x):
    """Codes equal but on rows where the two packages' choices reconstruct
    equally well (a float32 tie between beams or ICM candidates)."""
    same = (ca == cb).all(1)
    assert same.mean() >= 0.99
    ea, eb = row_err(a, ca, x), row_err(a, cb, x)
    tie = 1e-5 * (x.astype(np.float64) ** 2).sum(1)
    assert (np.abs(ea - eb)[~same] <= tie[~same]).all()


@pytest.mark.parametrize("M,nbits,beam", [(4, 6, 5), (3, 4, 1), (2, 8, 3)])
def test_rq_beam_search_codes(data, M, nbits, beam):
    xb, _ = data
    a = aqj.ResidualQuantizer(D, M, nbits)
    a.max_beam_size = beam
    a.train(xb)
    b = aqt.ResidualQuantizer(D, M, nbits, device="cpu")
    b.max_beam_size = beam
    b.codebooks = a.codebooks
    ca, cb = a.compute_codes_int(xb), b.compute_codes_int(xb)
    assert cb.dtype == ca.dtype == np.uint8 and cb.shape == (NB, M)
    check_codes(a, b, ca, cb, xb)
    # packed codes and their stored float norm, decoded
    pa, pb = a.compute_codes(xb), b.compute_codes(xb)
    same = (ca == cb).all(1)
    assert pb.shape == pa.shape == (NB, b.code_size)
    assert np.array_equal(pa[same, : pa.shape[1] - 4], pb[same, : pb.shape[1] - 4])
    np.testing.assert_allclose(b.decode_norms(pb), a.decode_norms(pa), rtol=1e-5)
    assert np.array_equal(b.decode(pb), b.decode_int(cb))


def test_beam_search_tiles_give_the_same_codes(data, monkeypatch):
    """Rows go in tiles of BEAM_TILE elements: a tile of a few rows gives
    the codes of one untiled pass, for RQ and for LSQ."""
    xb, _ = data
    rq = aqt.ResidualQuantizer(D, 3, 5, device="cpu")
    rq.train(xb)
    lsq = aqt.LocalSearchQuantizer(D, 3, 5, device="cpu")
    lsq.codebooks = rq.codebooks
    whole = rq.compute_codes_int(xb), lsq.compute_codes_int(xb)
    monkeypatch.setattr(aqt, "BEAM_TILE", 5 * 32 * 37)  # 37 rows a tile
    tiled = rq.compute_codes_int(xb), lsq.compute_codes_int(xb)
    assert all(np.array_equal(u, v) for u, v in zip(whole, tiled))


@pytest.mark.parametrize("M,nbits,ils,nperts", [(4, 6, 4, 4), (3, 5, 3, 2), (3, 5, 1, 3)])
def test_lsq_icm_and_ils_codes(data, M, nbits, ils, nperts):
    """ICM sweeps and the iterated local search on faiss_tpu's codebooks:
    the same perturbations from RandomState(0x15C), the same codes."""
    xb, _ = data
    a = aqj.LocalSearchQuantizer(D, M, nbits)
    a.train(xb)
    b = aqt.LocalSearchQuantizer(D, M, nbits, device="cpu")
    for q in (a, b):
        q.encode_ils_iters, q.nperts = ils, nperts
    b.codebooks = a.codebooks
    ca, cb = a.compute_codes_int(xb), b.compute_codes_int(xb)
    check_codes(a, b, ca, cb, xb)
    # the local search never loses against its RQ init
    b._rq.codebooks = b.codebooks
    init = b._rq.compute_codes_int(xb)
    assert row_err(b, cb, xb).mean() <= row_err(b, init, xb).mean() * (1 + 1e-6)


CODECS = [
    ("ResidualQuantizer", (4, 6)), ("LocalSearchQuantizer", (4, 5)),
    ("ProductResidualQuantizer", (2, 2, 6)), ("ProductLocalSearchQuantizer", (2, 2, 4)),
]


@pytest.mark.parametrize("name,shape", CODECS, ids=[c[0] for c in CODECS])
def test_training_objective(data, name, shape):
    """Each package trains its own codebooks on the same rows: the mean
    reconstruction error agrees within 2% (the k-means arithmetic differs
    in its float32 order)."""
    xb, _ = data
    a = getattr(aqj, name)(D, *shape)
    b = getattr(aqt, name)(D, *shape, device="cpu")
    a.train(xb)
    b.train(xb)
    assert b.codebooks.shape == a.codebooks.shape and b.codebooks.dtype == np.float32
    ea = row_err(a, a.compute_codes_int(xb), xb).mean()
    eb = row_err(b, b.compute_codes_int(xb), xb).mean()
    assert abs(eb - ea) <= 0.02 * ea
    if name.startswith("Product"):  # the sub-codebooks embed block-diagonally
        Msub, dsub = b.M // b.nsplits, b.dsub
        assert (b.codebooks[:Msub, :, dsub:] == 0).all()
        assert np.array_equal(b.codebooks[:Msub, :, :dsub], b.subs[0].codebooks)


ST = aqj.AdditiveQuantizer
NORM_MODES = [ST.ST_norm_float, ST.ST_norm_qint8, ST.ST_norm_qint4, ST.ST_norm_cqint8,
              ST.ST_norm_cqint4, ST.ST_norm_lsq2x4, ST.ST_norm_rq2x4, ST.ST_LUT_nonorm]


@pytest.mark.parametrize("st", NORM_MODES)
def test_norm_storage_round_trip(data, st):
    """Every norm storage: the norm codec trained as faiss_tpu's (the
    host-numpy modes bit for bit; the 2x4 modes train their small codec on
    the device and are compared with faiss_tpu's tables carried across),
    the payload bytes and decoded norms equal, and a norm decodes to its
    table entry or quantization cell."""
    xb, _ = data
    a = aqj.ResidualQuantizer(D, 3, 5)
    a.set_search_type(st)
    a.train(xb)
    b = aqt.ResidualQuantizer(D, 3, 5, device="cpu")
    b.set_search_type(st)
    assert b.code_size == a.code_size
    norms = (a.decode_int(a.compute_codes_int(xb)) ** 2).sum(1).astype(np.float32)
    b.train_norm(norms[:1024])
    a2 = aqj.ResidualQuantizer(D, 3, 5)
    a2.set_search_type(st)
    a2.train_norm(norms[:1024])
    if st not in (ST.ST_norm_lsq2x4, ST.ST_norm_rq2x4):
        for f in ("norm_min", "norm_max"):
            assert getattr(b, f) == getattr(a2, f)
        assert (b.qnorm is None) == (a2.qnorm is None)
        if b.qnorm is not None:
            assert np.array_equal(b.qnorm, a2.qnorm)
    else:
        assert b.norm_tabs.shape == (2, 16) and b.qnorm.shape == (256,)
        np.testing.assert_allclose(np.sort(b.qnorm), np.sort(a2.qnorm),
                                   rtol=0.05, atol=0.05 * norms.max())
        b.qnorm, b.norm_tabs = a2.qnorm, a2.norm_tabs
        b.norm_min, b.norm_max = a2.norm_min, a2.norm_max
    ea, eb = a2.encode_norms(norms), b.encode_norms(norms)
    assert eb.dtype == np.uint8 and np.array_equal(ea, eb)
    if eb.shape[1]:
        da, db = a2.decode_norms(ea), b.decode_norms(eb)
        assert np.array_equal(da, db)
        if st != ST.ST_norm_float:
            err = np.abs(db - norms).max()
            assert err <= (norms.max() - norms.min()) / 4 + 1e-6
    else:
        assert b.decode_norms(eb) is None


def aq_tol(xq, norms):
    return 1e-5 * ((xq.astype(np.float64) ** 2).sum(1) + np.abs(norms).max())


def assert_search_agree(ref, port, xq, norms, k=K, largest=False, params=None):
    Dr, Ir = ref.search(xq, k)
    Dp, Ip = port.search(xq, k, params=params)
    tol = aq_tol(xq, norms)
    assert Dp.dtype == np.float32 and Ip.dtype == np.int64
    assert (np.abs(Dp - Dr) <= tol[:, None]).all()
    s = -1.0 if largest else 1.0
    assert ids_agree_tie_aware(s * Dr, Ir, s * Dp, Ip, tol).all()


FLAT = [
    ("IndexResidualQuantizer", (4, 6), "l2"), ("IndexResidualQuantizer", (3, 5), "ip"),
    ("IndexLocalSearchQuantizer", (3, 5), "l2"),
    ("IndexProductResidualQuantizer", (2, 2, 6), "l2"),
    ("IndexProductLocalSearchQuantizer", (2, 2, 4), "l2"),
    ("IndexResidualQuantizerFastScan", (4, 4), "l2"),
    ("IndexLocalSearchQuantizerFastScan", (4, 4), "ip"),
    ("IndexProductResidualQuantizerFastScan", (2, 3, 4), "l2"),
    ("IndexProductLocalSearchQuantizerFastScan", (2, 2, 4), "l2"),
]


def _metric(m):
    return (ftj.METRIC_L2, 1) if m == "l2" else (ftj.METRIC_INNER_PRODUCT, 0)


@pytest.mark.parametrize("cls,shape,metric", FLAT,
                         ids=[f"{c}-{m}" for c, _, m in FLAT])
def test_flat_search_matches_reference(data, cls, shape, metric):
    """A trained faiss_tpu index's codebooks, codes and norms
    (convert.aq_from_arrays) search as faiss_tpu's, the float32 tables
    summed by gathers, the select exact; sa_*, reconstruct_n; the port's
    own encode of the same rows gives faiss_tpu's codes but for ties."""
    xb, xq = data
    mj, is_l2 = _metric(metric)
    ref = getattr(ftj, cls)(D, *shape, mj)
    ref.train(xb)
    ref.add(xb)
    nsplits = shape[0] if "Product" in cls else 0
    port = convert.aq_from_arrays(
        cls, D, ref.aq.M, ref.aq.nbits, ref.aq.codebooks, ref._codes_int, ref._norms,
        int(mj), nsplits=nsplits, norm_state=convert.aq_norm_state(ref.aq),
        bbs=getattr(ref, "bbs", 32), device="cpu")
    assert type(port).__name__ == cls and port.ntotal == NB
    assert_search_agree(ref, port, xq, ref._norms, largest=not is_l2)
    assert np.array_equal(port.reconstruct_n(0, NB), ref.reconstruct_n(0, NB))
    codes = ref.sa_encode(xq)
    assert port.sa_code_size() == ref.sa_code_size()
    assert np.array_equal(port.sa_decode(codes), ref.sa_decode(codes))
    own = port.aq.compute_codes_int(xb)
    check_codes(ref.aq, port.aq, ref._codes_int, own, xb)


@pytest.mark.parametrize("desc", ["RQ3x5_Nqint8", "RQ3x5_Ncqint4", "LSQ3x5_Nrq2x4"])
def test_quantized_norm_search(data, desc):
    """A one-byte norm code ranks with the norm it decodes to, as faiss_tpu
    stores it; the port's own add over faiss_tpu's codec state stores the
    same norms."""
    xb, xq = data
    ref = ftj.index_factory(D, desc)
    ref.train(xb)
    ref.add(xb)
    port = convert.aq_from_arrays(
        type(ref).__name__, D, ref.aq.M, ref.aq.nbits, ref.aq.codebooks, ref._codes_int,
        ref._norms, norm_state=convert.aq_norm_state(ref.aq), device="cpu")
    assert port.aq.search_type == ref.aq.search_type
    assert_search_agree(ref, port, xq, ref._norms)
    port.reset()
    port.add(xb)
    same = (port._codes_int == ref._codes_int).all(1)
    assert same.mean() >= 0.99
    assert np.array_equal(port._norms[same], ref._norms[same])


def test_own_flat_index_trains_and_searches(data):
    """The port's IndexResidualQuantizer trained and filled by itself
    ranks by the decoded rows' exact distances plus float32 rounding."""
    xb, xq = data
    index = ftt.IndexResidualQuantizer(D, 4, 5, device="cpu")
    assert not index.is_trained
    index.train(xb)
    index.add(xb[:1000])
    index.add(xb[1000:])
    assert index.ntotal == NB and index._codes.dtype == torch.uint8
    rows = index.reconstruct_n(0, NB).astype(np.float64)
    d64 = ((xq.astype(np.float64)[:, None] - rows[None]) ** 2).sum(-1)
    Dp, Ip = index.search(xq, K)
    o = np.argsort(d64, 1, kind="stable")[:, :K]
    tol = aq_tol(xq, (rows**2).sum(1))
    assert (np.abs(Dp - np.take_along_axis(d64, o, 1)) <= tol[:, None]).all()
    assert ids_agree_tie_aware(np.take_along_axis(d64, o, 1), o, Dp, Ip, tol).all()
    D0, I0 = index.search(xq, NB + 5)  # more than ntotal: padded
    assert (I0[:, NB:] == -1).all() and np.isinf(D0[:, NB:]).all()
    index.reset()
    assert index.ntotal == 0 and (index.search(xq, 3)[1] == -1).all()


def test_flat_selector_before_select(data):
    """An ID selector keeps its codes before the select (faiss_tpu ignores
    ``params``): every id selected, each row against float64 of the same
    tables plus norms over the selected rows, a query of no selected row
    empty."""
    xb, xq = data
    index = ftt.IndexLocalSearchQuantizer(D, 3, 5, device="cpu")
    index.train(xb)
    index.add(xb)
    keep = (np.arange(NB) % 7 == 3)
    params = ftt.SearchParameters(sel=ftt.IDSelectorArray(np.nonzero(keep)[0]))
    Dp, Ip = index.search(xq, K, params=params)
    assert np.isin(Ip, np.nonzero(keep)[0]).all()
    luts = np.einsum("qd,mkd->qmk", xq.astype(np.float64), index.aq.codebooks.astype(np.float64))
    codes = index._codes_int.astype(np.int64)
    ip = sum(luts[:, m, codes[:, m]] for m in range(codes.shape[1]))
    d64 = (xq.astype(np.float64) ** 2).sum(1)[:, None] + index._norms[None] - 2 * ip
    d64 = np.where(keep[None], d64, np.inf)
    o = np.argsort(d64, 1, kind="stable")[:, :K]
    ref = np.take_along_axis(d64, o, 1)
    tol = aq_tol(xq, index._norms)
    assert (np.abs(Dp - ref) <= tol[:, None]).all()
    assert ids_agree_tie_aware(ref, o, Dp, Ip, tol).all()
    none = ftt.SearchParameters(sel=ftt.IDSelectorRange(NB, NB + 5))
    Dn, In = index.search(xq, K, params=none)
    assert (In == -1).all() and np.isinf(Dn).all()


def ivf_ref(cls, shape, mj=ftj.METRIC_L2, xb=None):
    ref = getattr(ftj, cls)(None, D, NLIST, *shape, mj)
    ref.cp.niter = 4
    ref.cp.min_points_per_centroid = 1
    ref.train(xb)
    ref.add(xb)
    ref.nprobe = 3
    return ref


def ivf_port(ref, cls, nsplits=0):
    port = convert.ivf_aq_from_arrays(
        cls, ref.quantizer.vectors(), ref.aq.M, ref.aq.nbits, ref.aq.codebooks,
        ref._codes_host, ref._listnos_host, ref._ids_host, int(ref.metric_type),
        nsplits=nsplits, norm_state=convert.aq_norm_state(ref.aq),
        bbs=getattr(ref, "bbs", 32), device="cpu")
    port.nprobe = ref.nprobe
    return port


IVF = [
    ("IndexIVFResidualQuantizer", (4, 6), "l2"), ("IndexIVFResidualQuantizer", (3, 5), "ip"),
    ("IndexIVFLocalSearchQuantizer", (3, 5), "l2"),
    ("IndexIVFResidualQuantizerFastScan", (4, 4), "l2"),
    ("IndexIVFLocalSearchQuantizerFastScan", (3, 4), "l2"),
    ("IndexIVFProductResidualQuantizer", (2, 2, 6), "l2"),
    ("IndexIVFProductLocalSearchQuantizer", (2, 2, 4), "ip"),
    ("IndexIVFProductResidualQuantizerFastScan", (2, 2, 4), "l2"),
    ("IndexIVFProductLocalSearchQuantizerFastScan", (2, 2, 4), "l2"),
]


@pytest.mark.parametrize("cls,shape,metric", IVF,
                         ids=[f"{c}-{m}" for c, _, m in IVF])
def test_ivf_search_matches_reference(data, cls, shape, metric):
    """The IVF forms from faiss_tpu's trained state search as faiss_tpu's
    (by probe over decoded rows, L2 or inner product); the decoded rows are
    faiss_tpu's bit for bit, and the port encodes faiss_tpu's residuals to
    its codes but for ties."""
    xb, xq = data
    mj, is_l2 = _metric(metric)
    ref = ivf_ref(cls, shape, mj, xb)
    port = ivf_port(ref, cls, shape[0] if "Product" in cls else 0)
    rows = ref.decode_vectors(ref._codes_host, ref._listnos_host)
    assert np.array_equal(port.reconstruct_n(0, NB)[np.argsort(ref._ids_host)],
                          rows[np.argsort(ref._ids_host)])
    assert_search_agree(ref, port, xq, (rows.astype(np.float64) ** 2).sum(1),
                        largest=not is_l2)
    res = xb - ref.quantizer.vectors()[ref._listnos_host]
    check_codes(ref.aq, port.aq, ref._codes_host, port.aq.compute_codes_int(res), res)


def test_ivf_selector_and_preassigned(data):
    """IVF-RQ by probe with an ID selector against float64 over the
    selected rows of the probed lists; search_preassigned with faiss_tpu's
    coarse assignment equals its search."""
    xb, xq = data
    ref = ivf_ref("IndexIVFResidualQuantizer", (3, 5), xb=xb)
    port = ivf_port(ref, "IndexIVFResidualQuantizer")
    lo, hi = 300, 1500
    params = ftt.SearchParametersIVF(sel=ftt.IDSelectorRange(lo, hi))
    Dp, Ip = port.search(xq, K, params=params)
    assert ((Ip == -1) | ((Ip >= lo) & (Ip < hi))).all()
    rows = port.reconstruct_n(0, NB).astype(np.float64)
    cd, probes = port.quantizer.search(xq, port.nprobe)
    listno = port._listnos_host[np.argsort(port._ids_host)]
    ids = np.arange(NB)
    for r in range(NQ):
        m = np.isin(listno, probes[r]) & (ids >= lo) & (ids < hi)
        d = ((xq[r].astype(np.float64) - rows[m]) ** 2).sum(1)
        o = np.argsort(d, kind="stable")[:K]
        tol = 1e-5 * ((xq[r].astype(np.float64) ** 2).sum() + (rows**2).sum(1).max())
        assert (np.abs(Dp[r, : len(o)] - d[o]) <= tol).all()
        assert ids_agree_tie_aware(d[o][None], ids[m][o][None], Dp[r : r + 1, : len(o)],
                                   Ip[r : r + 1, : len(o)], np.array([tol])).all()
    Dr, Ir = port.search(xq, K)
    Da, Ia = port.search_preassigned(xq, K, probes, cd)
    assert np.array_equal(Da, Dr) and np.array_equal(Ia, Ir)


FILES = [("RQ3x5", False), ("PLSQ2x2x4_Nqint8", False), ("LSQ4x4fs", False),
         ("IVF8,RQ3x5_Ncqint8", True), ("IVF8,PRQ2x2x4fs", True)]


@pytest.mark.parametrize("desc,ivf", FILES, ids=[f[0] for f in FILES])
def test_files_both_ways(data, desc, ivf, tmp_path):
    """faiss_tpu writes, the port reads; the port writes, faiss_tpu reads:
    the codec state, codes and norms survive and the searches agree."""
    xb, xq = data
    ref = ftj.index_factory(D, desc)
    if ivf:
        ref.cp.niter, ref.cp.min_points_per_centroid = 4, 1
    ref.train(xb)
    ref.add(xb)
    if ivf:
        ref.nprobe = 3
    path = tmp_path / "j.npz"
    ftj.write_index(ref, str(path))
    port = ftt.read_index(str(path), device="cpu")
    assert type(port).__name__ == type(ref).__name__
    assert port.aq.search_type == ref.aq.search_type
    assert np.array_equal(port.aq.codebooks, ref.aq.codebooks)
    if hasattr(ref.aq, "subs"):
        for s, t in zip(ref.aq.subs, port.aq.subs):
            assert np.array_equal(s.codebooks, t.codebooks)
    rows = ref.reconstruct_n(0, NB)
    assert_search_agree(ref, port, xq, (rows.astype(np.float64) ** 2).sum(1))
    ftt.write_index(port, str(tmp_path / "t.npz"))
    back = ftj.read_index(str(tmp_path / "t.npz"))
    assert type(back) is type(ref) and back.ntotal == NB
    assert_search_agree(back, port, xq, (rows.astype(np.float64) ** 2).sum(1))
    again = ftt.deserialize_index(ftt.serialize_index(port), device="cpu")
    assert np.array_equal(again.search(xq, K)[0], port.search(xq, K)[0])


def test_factory_norm_suffix_and_refusals():
    """The norm suffix sets the search type and code size; FastScan needs
    nbits = 4; PRQ x4fs is an IVF encoding only, as in faiss_tpu."""
    index = ftt.index_factory(32, "PLSQ2x4x6_Ncqint8", device="cpu")
    assert isinstance(index, ftt.IndexProductLocalSearchQuantizer)
    assert index.aq.search_type == ST.ST_norm_cqint8 and index.aq.code_size == 7
    with pytest.raises(ValueError, match="FastScan"):
        ftt.IndexResidualQuantizerFastScan(32, 4, 6, device="cpu")
    with pytest.raises(ValueError):
        ftt.index_factory(32, "PRQ2x4x4fs", device="cpu")
    with pytest.raises(ValueError):
        ftj.index_factory(32, "PRQ2x4x4fs")
