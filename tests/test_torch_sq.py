"""Port parity for the scalar-quantizer family (faiss_tpu_torch/codecs/sq.py
and models/sq.py against faiss_tpu's): every QuantizerType x RangeStat
encodes bit for bit and decodes equal; IndexScalarQuantizer (the plain
k-NN, and the hi/lo screen of K2's plain version) and
IndexIVFScalarQuantizer (L2 and inner product, by residual or not, QT_0bit)
search as faiss_tpu's from its trained state (ids tie-aware, distances
within rtol 1e-5); sa_*, reconstruct_n and remove_ids against float64;
the SQ factory strings; and npz files written by each package and read by
the other, with the port on the CPU."""

import numpy as np
import pytest
import torch

import faiss_tpu as ftj
from faiss_tpu.codecs import sq as sqj
import faiss_tpu_torch as ftt
from faiss_tpu_torch import convert
from faiss_tpu_torch.codecs import sq as sqt
from faiss_tpu_torch.models import flat as flat_t
from faiss_tpu_torch.utils.evaluation import ids_agree_tie_aware
from test_torch_io import assert_same_file
from torch_threads import one_torch_thread  # noqa: F401

D, NB, NQ, K, NLIST = 16, 3000, 48, 10, 16
QT = sqj.QuantizerType


def mixture(seed, n, d=D, ncent=24):
    rs = np.random.RandomState(seed)
    cent = np.random.RandomState(98).randn(ncent, d).astype(np.float32)
    return (cent[rs.randint(ncent, size=n)]
            + 0.4 * rs.randn(n, d)).astype(np.float32)


@pytest.fixture(scope="module")
def data():
    return mixture(1, NB), mixture(2, NQ)


@pytest.mark.parametrize("rangestat", list(sqj.RangeStat), ids=lambda r: r.name)
@pytest.mark.parametrize("qtype", list(QT), ids=lambda q: q.name)
def test_codec_bit_identical(qtype, rangestat):
    """Training, codes and decodes of every type and range statistic, at an
    odd d (4-bit padding, 6-bit packing, bit planes); arg 0 and a set
    rangestat_arg."""
    rs = np.random.RandomState(int(qtype) * 7 + int(rangestat))
    x = (rs.randn(400, 13) * 2).astype(np.float32)
    x[:5] *= 40  # outliers: clipped codes
    for arg in (0.0, 0.05 if rangestat == sqj.RangeStat.RS_quantiles else 1.5):
        a, b = sqj.ScalarQuantizer(13, qtype), sqt.ScalarQuantizer(13, int(qtype))
        a.rangestat = b.rangestat = rangestat
        a.rangestat_arg = b.rangestat_arg = arg
        assert a.is_trained == b.is_trained and a.code_size == b.code_size
        assert a.bits == b.bits
        a.train(x)
        b.train(x)
        assert a.trained.dtype == b.trained.dtype and np.array_equal(a.trained, b.trained)
        ca, cb = a.compute_codes(x), b.compute_codes(x)
        assert ca.dtype == cb.dtype == np.uint8 and ca.shape == cb.shape
        assert cb.shape == (400, b.code_size) and np.array_equal(ca, cb)
        da, db = a.decode(ca), b.decode(cb)
        assert db.dtype == np.float32 and np.array_equal(da, db)


def test_lloyd_max_and_bit_planes_equal():
    for nbits in (1, 2, 3, 4, 8):
        for u, v in zip(sqj.lloyd_max_gaussian(nbits), sqt.lloyd_max_gaussian(nbits)):
            assert u.dtype == v.dtype and np.array_equal(u, v)
    q = np.random.RandomState(3).randint(0, 8, size=(9, 21)).astype(np.uint8)
    packed = sqt._pack_bit_planes(q, 3)
    assert np.array_equal(packed, sqj._pack_bit_planes(q, 3))
    assert np.array_equal(sqt._unpack_bit_planes(packed, 3, 21), q)
    assert np.array_equal(sqt._tq_rotation(12, 5), sqj._tq_rotation(12, 5))


def exact_tol(xq, rows):
    return 1e-5 * ((xq.astype(np.float64) ** 2).sum(1)
                   + (rows.astype(np.float64) ** 2).sum(1).max())


def check_against_float64(xq, rows, ids_of_rows, D, I, k, largest=False):
    """Each row's results against float64 over ``rows`` (their ids
    ``ids_of_rows``): distances per rank within 1e-5 (|q|^2 + max |y|^2),
    ids tie-aware."""
    q, y = xq.astype(np.float64), rows.astype(np.float64)
    d = q @ y.T if largest else ((q[:, None] - y[None]) ** 2).sum(-1)
    order = np.argsort(-d if largest else d, axis=1, kind="stable")[:, :k]
    Dr = np.take_along_axis(d, order, 1)
    Ir = ids_of_rows[order]
    tol = exact_tol(xq, rows)
    assert (np.abs(D - Dr) <= tol[:, None]).all()
    s = -1.0 if largest else 1.0
    assert ids_agree_tie_aware(s * Dr, Ir, s * D, I, tol).all()


FLAT_CASES = [
    (QT.QT_8bit, "l2"), (QT.QT_4bit, "l2"), (QT.QT_6bit, "ip"), (QT.QT_fp16, "l2"),
    (QT.QT_bf16, "ip"), (QT.QT_8bit_uniform, "l2"), (QT.QT_3bit_tqmse, "l2"),
    (QT.QT_4bit_tq, "ip"),
]


@pytest.mark.parametrize("qtype,metric", FLAT_CASES,
                         ids=[f"{q.name}-{m}" for q, m in FLAT_CASES])
def test_index_sq_search_matches_reference(data, qtype, metric):
    """IndexScalarQuantizer built from faiss_tpu's trained state
    (convert.sq_from_arrays) searches as faiss_tpu does, on the plain k-NN
    and, with the store above PALLAS_MIN_NB, on the hi/lo screen (K2's plain
    version, a certified exact re-rank) at k = 10; the port trains and
    encodes bit for bit; reconstruct_n, sa_* and remove_ids hold."""
    xb, xq = data
    mj = ftj.METRIC_L2 if metric == "l2" else ftj.METRIC_INNER_PRODUCT
    ref = ftj.IndexScalarQuantizer(D, qtype, mj)
    ref.train(xb)
    ref.add(xb)
    port = convert.sq_from_arrays(D, ref.sq.qtype, ref.sq.trained, ref._codes,
                                  int(mj), device="cpu")
    own = ftt.IndexScalarQuantizer(D, int(qtype), int(mj), device="cpu")
    own.train(xb)
    own.add(xb)
    assert np.array_equal(own._codes, ref._codes)
    largest = metric == "ip"
    Dj, Ij = ref.search(xq, K)
    rows = ref.sq.decode(ref._codes)
    for min_nb in (flat_t.IndexFlat.PALLAS_MIN_NB, 1024):
        port.PALLAS_MIN_NB = min_nb
        nq0 = flat_t.screen_stats["nq"]
        Dt, It = port.search(xq, K)
        assert (flat_t.screen_stats["nq"] > nq0) == (min_nb == 1024)
        tol = exact_tol(xq, rows)
        assert (np.abs(Dt - Dj) <= tol[:, None]).all()
        s = -1.0 if largest else 1.0
        assert ids_agree_tie_aware(s * Dj, Ij, s * Dt, It, tol).all()
        check_against_float64(xq, rows, np.arange(NB), Dt, It, K, largest)
    assert np.array_equal(port.reconstruct_n(10, 20), rows[10:30])
    codes = port.sa_encode(xq)
    assert port.sa_code_size() == ref.sa_code_size() == codes.shape[1]
    assert np.array_equal(codes, ref.sa_encode(xq))
    assert np.array_equal(port.sa_decode(codes), ref.sa_decode(codes))
    sel = ftt.IDSelectorRange(100, 2000)
    assert port.remove_ids(sel) == 1900 and port.ntotal == NB - 1900
    keep = np.r_[0:100, 2000:NB]
    assert np.array_equal(port._codes, ref._codes[keep])
    Dr, Ir = port.search(xq, K)
    check_against_float64(xq, rows[keep], np.arange(len(keep)), Dr, Ir, K, largest)


def test_index_sq_merge_and_refusals(data):
    xb, xq = data
    a = ftt.IndexScalarQuantizer(D, ftt.QuantizerType.QT_8bit, device="cpu")
    a.train(xb)
    b = ftt.IndexScalarQuantizer(D, ftt.QuantizerType.QT_8bit, device="cpu")
    b.sq.trained = a.sq.trained.copy()
    b.is_trained = True
    a.add(xb[:1000])
    b.add(xb[1000:])
    a.merge_from(b)
    assert a.ntotal == NB and b.ntotal == 0
    whole = ftt.IndexScalarQuantizer(D, ftt.QuantizerType.QT_8bit, device="cpu")
    whole.sq.trained = a.sq.trained.copy()
    whole.is_trained = True
    whole.add(xb)
    assert np.array_equal(a._codes, whole._codes)
    with pytest.raises(ValueError, match="IndexIVFScalarQuantizer"):
        ftt.IndexScalarQuantizer(D, ftt.QuantizerType.QT_0bit, device="cpu")
    with pytest.raises(ValueError, match="IndexIVFScalarQuantizer"):
        ftj.IndexScalarQuantizer(D, QT.QT_0bit)
    with pytest.raises(RuntimeError, match="not trained"):
        ftt.IndexScalarQuantizer(D, device="cpu").add(xb)


def build_ivfsq(xb, qtype, metric, by_residual):
    ref = ftj.IndexIVFScalarQuantizer(None, D, NLIST, qtype, metric,
                                      by_residual=by_residual)
    ref.cp.niter = 6
    ref.train(xb)
    ref.add(xb)
    port = convert.ivfsq_from_arrays(
        ref.quantizer.vectors(), ref.sq.qtype, ref.sq.trained, ref._codes_host,
        ref._listnos_host, ref._ids_host, by_residual=ref.by_residual,
        metric=int(metric), device="cpu")
    return ref, port


IVF_CASES = [(q, m, r) for q in (QT.QT_8bit, QT.QT_4bit, QT.QT_fp16)
             for m in ("l2", "ip") for r in (False, True)] + [
    (QT.QT_0bit, "l2", False), (QT.QT_0bit, "ip", False),
    (QT.QT_8bit_direct_signed, "l2", True), (QT.QT_2bit_tq, "l2", False)]


@pytest.mark.parametrize("qtype,metric,by_residual", IVF_CASES,
                         ids=[f"{q.name}-{m}-{'res' if r else 'raw'}"
                              for q, m, r in IVF_CASES])
def test_ivfsq_search_matches_reference(data, qtype, metric, by_residual):
    """IndexIVFScalarQuantizer from faiss_tpu's trained state searches by
    probe as faiss_tpu does (ids tie-aware, distances within 1e-5 (|q|^2 +
    max |y|^2)), and equals float64 over the probed lists' decoded rows;
    QT_0bit codes residuals whatever was asked; the port's own encoder,
    trained on the same assignment, encodes bit for bit."""
    xb, xq = data
    mj = ftj.METRIC_L2 if metric == "l2" else ftj.METRIC_INNER_PRODUCT
    ref, port = build_ivfsq(xb, qtype, mj, by_residual)
    assert port.by_residual == ref.by_residual == (by_residual or qtype == QT.QT_0bit)
    largest = metric == "ip"
    for nprobe in (1, 4):
        ref.nprobe = port.nprobe = nprobe
        Dj, Ij = ref.search(xq, K)
        Dt, It = port.search(xq, K)
        rows = ref.decode_vectors(ref._codes_host, ref._listnos_host)
        tol = exact_tol(xq, rows)
        np.testing.assert_array_equal(Ij == -1, It == -1)
        fin = Ij >= 0
        assert (np.abs(np.where(fin, Dt - Dj, 0)) <= tol[:, None]).all()
        s = -1.0 if largest else 1.0
        assert ids_agree_tie_aware(s * Dj, Ij, s * Dt, It, tol).all()
    # 8 rows against float64 over the probed lists (nprobe 4)
    _, probes = port.quantizer.search(xq[:8], 4)
    for r in range(8):
        mask = np.isin(port._listnos_host, probes[r])
        n = int(mask.sum())
        check_against_float64(xq[r : r + 1], rows[mask], port._ids_host[mask],
                              Dt[r : r + 1, : min(K, n)], It[r : r + 1, : min(K, n)],
                              min(K, n), largest)
    # the port's encoder on the reference's assignment
    xd = torch.from_numpy(xb)
    ln = torch.from_numpy(ref._listnos_host.astype(np.int64))
    other = ftt.IndexIVFScalarQuantizer(port.quantizer, D, NLIST, int(qtype), int(mj),
                                        by_residual=by_residual, device="cpu")
    other.train_encoder(xd, ln)
    assert (other.sq.trained is None) == (ref.sq.trained is None)
    if ref.sq.trained is not None:
        assert np.array_equal(other.sq.trained, ref.sq.trained)
    assert np.array_equal(other.encode_vectors(xd, ln), ref._codes_host)


def test_ivfsq_trains_adds_and_searches_on_its_own(data):
    """The port's own train and add: every entry in its nearest list, the
    search exact over the probed lists against float64."""
    xb, xq = data
    index = ftt.index_factory(D, "IVF16,SQ8", device="cpu")
    index.cp.niter = 6
    index.train(xb)
    index.add(xb)
    index.nprobe = 3
    assert index.ntotal == NB and index.is_trained
    cen = index.quantizer.vectors().astype(np.float64)
    d2 = ((xb[:, None].astype(np.float64) - cen[None]) ** 2).sum(-1)
    near = d2[np.arange(NB), index._listnos_host]
    assert (near <= d2.min(1) + 1e-5 * (1 + d2.min(1))).all()
    Dt, It = index.search(xq, K)
    rows = index.reconstruct_n(0, NB)
    _, probes = index.quantizer.search(xq, 3)
    for r in range(8):
        mask = np.isin(index._listnos_host, probes[r])
        check_against_float64(xq[r : r + 1], rows[mask], index._ids_host[mask],
                              Dt[r : r + 1], It[r : r + 1], K)


@pytest.mark.parametrize("by_residual", [False, True])
def test_ivfsq_sa_reconstruct_and_remove(data, by_residual):
    """sa_encode = the list number in coarse_code_size bytes + the code;
    sa_decode and reconstruct_n equal the float64 decode (plus the list
    centroid by residual); remove_ids drops entries and restages; the
    searches after it equal float64 without them; merge_from restores."""
    xb, xq = data
    ref, port = build_ivfsq(xb, QT.QT_8bit, ftj.METRIC_L2, by_residual)
    port.nprobe = 4
    codes = port.sa_encode(xq)
    assert port.coarse_code_size() == 1
    assert codes.shape == (NQ, port.sa_code_size()) == (NQ, 1 + D)
    ln = codes[:, 0].astype(np.int64)
    _, nearest = port.quantizer.search(xq, 1)
    assert np.array_equal(ln, nearest[:, 0])
    cen = port.quantizer.vectors().astype(np.float64)
    t = ref.sq.trained.astype(np.float64)
    dec = (codes[:, 1:] + 0.5) / 256 * t[1] + t[0] + (cen[ln] if by_residual else 0)
    np.testing.assert_allclose(port.sa_decode(codes), dec, rtol=1e-6, atol=1e-5)
    rec = port.reconstruct_n(0, NB)
    ln_all = ref._listnos_host
    dec_all = ((ref._codes_host + 0.5) / 256 * t[1] + t[0]
               + (cen[ln_all] if by_residual else 0))
    np.testing.assert_allclose(rec, dec_all, rtol=1e-6, atol=1e-5)
    Dt, It = port.search(xq, K)
    removed = port.remove_ids(ftt.IDSelectorRange(0, 1500))
    assert removed == 1500 and port.ntotal == NB - 1500
    Dr, Ir = port.search(xq, K)
    assert not np.isin(Ir, np.arange(1500)).any()
    _, probes = port.quantizer.search(xq, 4)
    rows = port.decode_vectors(port._codes_host, port._listnos_host)
    for r in range(8):
        mask = np.isin(port._listnos_host, probes[r])
        n = int(mask.sum())
        check_against_float64(xq[r : r + 1], rows[mask], port._ids_host[mask],
                              Dr[r : r + 1, : min(K, n)], Ir[r : r + 1, : min(K, n)],
                              min(K, n))
    rest = convert.ivfsq_from_arrays(
        port.quantizer.vectors(), ref.sq.qtype, ref.sq.trained,
        ref._codes_host[:1500], ref._listnos_host[:1500], ref._ids_host[:1500],
        by_residual=ref.by_residual, device="cpu")
    port.merge_from(rest)
    assert rest.ntotal == 0 and port.ntotal == NB
    Dm, Im = port.search(xq, K)
    assert ids_agree_tie_aware(Dt, It, Dm, Im, exact_tol(xq, dec_all)).all()
    np.testing.assert_allclose(Dm, Dt, rtol=1e-5, atol=1e-5)


FACTORY = ["SQ8", "SQ4", "SQ6", "SQfp16", "SQbf16", "SQ8_direct", "SQ8_direct_signed",
           "SQtqmse2", "SQtq3", "IVF16,SQ8", "IVF16,SQfp16", "IVF16,SQ0", "IVF16,SQtqmse4",
           "IDMap2,IVF16,SQ4", "PCA8,IVF16,SQ8", "IVF16,Flat,Refine(SQ4)",
           "IVF16,PQ4,Refine(SQfp16)"]


def sq_tree(index):
    out = {"class": type(index).__name__, "d": index.d,
           "metric": int(index.metric_type)}
    if hasattr(index, "sq"):
        out.update(qtype=int(index.sq.qtype), code_size=index.sq.code_size,
                   by_residual=getattr(index, "by_residual", None))
    for name in ("index", "base_index", "refine_index"):
        if hasattr(index, name) and getattr(index, name) is not None:
            out[name] = sq_tree(getattr(index, name))
    if hasattr(index, "nlist"):
        out["nlist"] = index.nlist
    return out


@pytest.mark.parametrize("desc", FACTORY)
def test_factory_sq_strings(desc):
    """The SQ tokens build faiss_tpu's tree (classes, quantizer types, code
    sizes, residual coding); the graph SQ variants keep raising."""
    for metric in (ftj.METRIC_L2, ftj.METRIC_INNER_PRODUCT):
        ref = ftj.index_factory(32, desc, metric)
        port = ftt.index_factory(32, desc, int(metric), device="cpu")
        assert sq_tree(port) == sq_tree(ref)


@pytest.mark.parametrize("desc", ["HNSW32,SQ8", "NSG32,SQ4", "HNSW16,SQfp16"])
def test_factory_graph_sq_raises_item_10(desc):
    """The graph SQ variants, refused until the graph wrappers were ported
    (ROADMAP queue 1 item 10), now build faiss_tpu's tree: the graph class
    over an IndexScalarQuantizer storage of the same type and code size."""
    ref = ftj.index_factory(32, desc)
    port = ftt.index_factory(32, desc, device="cpu")
    assert type(port).__name__ == type(ref).__name__
    assert sq_tree(port.storage) == sq_tree(ref.storage)


IO_CASES = [("flat", QT.QT_8bit, False), ("flat", QT.QT_4bit_tq, False),
            ("flat", QT.QT_fp16, False), ("ivf", QT.QT_8bit, True),
            ("ivf", QT.QT_6bit, False), ("ivf", QT.QT_0bit, False),
            ("ivf", QT.QT_3bit_tqmse, True)]


@pytest.mark.parametrize("kind,qtype,by_residual", IO_CASES,
                         ids=[f"{k}-{q.name}-{r}" for k, q, r in IO_CASES])
def test_files_both_ways(data, kind, qtype, by_residual):
    """faiss_tpu writes and the port reads, the port writes faiss_tpu's file
    bit for bit and faiss_tpu reads it; the indexes search alike."""
    xb, xq = data
    if kind == "flat":
        ref = ftj.IndexScalarQuantizer(D, qtype)
    else:
        ref = ftj.IndexIVFScalarQuantizer(None, D, NLIST, qtype,
                                          by_residual=by_residual)
        ref.cp.niter = 4
        ref.nprobe = 3
    ref.sq.tq_seed = 77
    ref.train(xb)
    ref.add(xb)
    blob = ftj.serialize_index(ref)
    port = ftt.deserialize_index(blob, device="cpu")
    assert type(port).__name__ == type(ref).__name__ and port.ntotal == NB
    assert port.sq.tq_seed == 77 and port.sq.qtype == ref.sq.qtype
    Dj, Ij = ref.search(xq, K)
    Dt, It = port.search(xq, K)
    rows = ref.reconstruct_n(0, NB)
    tol = exact_tol(xq, rows)
    assert (np.abs(Dt - Dj) <= tol[:, None]).all()
    assert ids_agree_tie_aware(Dj, Ij, Dt, It, tol).all()
    port_blob = ftt.serialize_index(port)
    assert_same_file(blob, port_blob)
    back = ftj.deserialize_index(port_blob)
    Db, Ib = back.search(xq, K)
    np.testing.assert_array_equal(Ib, Ij)
    np.testing.assert_array_equal(Db, Dj)


def test_sq_entry_points_need_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        ftt.IndexScalarQuantizer(D)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        ftt.IndexIVFScalarQuantizer(None, D, NLIST)
