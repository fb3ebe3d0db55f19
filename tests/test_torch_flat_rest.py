"""Port parity for the rest of the flat family: IndexFlat's range_search,
remove_ids, merge_from, reconstruct* and sa_* (bytes equal), the kernel
paths after a mutation, IndexFlatSQ8 (its trained arrays and codes bitwise,
its norms and search), IndexFlat1D, and Refine(SQ8): IndexRefine over
IVF-PQ with an IndexFlatSQ8 store, on the fused path (the plain K1 against
faiss_tpu's Pallas kernel in interpret mode, ``fused_interpret``, as
tests/test_torch_ivfpq.py runs it) and on the eager path with a selector.

Tolerances: distances within 1e-5 * (|q|^2 + max |y|^2), the size of
float32's error on the norm expansion, ids up to ties at it. Range results
are compared as per-query sets: an entry that one side holds and the other
does not must lie within that tolerance of the radius."""

import jax.numpy as jnp
import numpy as np
import pytest

import faiss_tpu as ftj
import faiss_tpu_torch as ftt
from faiss_tpu.models.flat import _sq8_norms as ref_sq8_norms
from faiss_tpu.models.ivf_pq import (
    _fused_search_rerank_recon_dyn as jax_recon_dyn,
    _unpack_results,
)
from faiss_tpu_torch.convert import (
    flat_from_arrays,
    flat_sq8_from_arrays,
    refine_sq8_from_arrays,
)
from faiss_tpu_torch.utils.evaluation import ids_agree_tie_aware
from torch_threads import one_torch_thread  # noqa: F401

D, NB, NQ, K = 16, 3000, 128, 10


def mixture(rs, n, ncent=64, d=D):
    """Small Gaussian mixture in the shape of bench.py's generator."""
    cent = np.random.RandomState(99).rand(ncent, d).astype(np.float32)
    scales = (1.0 / (np.arange(d) + 1.0)).astype(np.float32) * 0.4
    a = rs.randint(ncent, size=n)
    return (cent[a] + rs.randn(n, d).astype(np.float32) * scales).astype(np.float32)


@pytest.fixture(scope="module")
def data():
    rs = np.random.RandomState(51)
    return mixture(rs, NB), mixture(rs, NQ)


def tol_of(xq, xb):
    return 1e-5 * ((xq.astype(np.float64) ** 2).sum(1)
                   + (xb.astype(np.float64) ** 2).sum(1).max())


def agree(Dj, Ij, Dt, It, tol, largest=False):
    assert Dt.dtype == np.float32 and It.dtype == np.int64
    np.testing.assert_array_equal(Ij == -1, It == -1)
    fin = np.isfinite(Dj)
    assert (np.abs(np.where(fin, Dt - Dj, 0)) <= tol[:, None]).all()
    s = -1.0 if largest else 1.0
    ok = ids_agree_tie_aware(np.where(fin, s * Dj, 1e30), Ij,
                             np.where(fin, s * Dt, 1e30), It, tol)
    assert ok.all(), np.where(~ok)


def range_agree(rj, rt, radius, tol):
    """Per query, the two result sets are equal apart from entries within
    ``tol`` of the radius; a shared entry's distances agree within tol."""
    assert rt.lims.dtype == np.uint64 and len(rt.lims) == len(rj.lims)
    assert rt.labels.dtype == np.int64 and rt.distances.dtype == np.float32
    n_shared = 0
    for q in range(len(rj.lims) - 1):
        sj = slice(int(rj.lims[q]), int(rj.lims[q + 1]))
        st = slice(int(rt.lims[q]), int(rt.lims[q + 1]))
        dj = dict(zip(rj.labels[sj].tolist(), rj.distances[sj].tolist()))
        dt = dict(zip(rt.labels[st].tolist(), rt.distances[st].tolist()))
        assert len(dt) == st.stop - st.start  # no id twice
        for a, b in ((dj, dt), (dt, dj)):
            for i in set(a) - set(b):
                assert abs(a[i] - radius) <= tol[q], (q, i, a[i], radius)
        for i in set(dj) & set(dt):
            assert abs(dj[i] - dt[i]) <= tol[q]
            n_shared += 1
    return n_shared


def keep_selected(res, mask):
    """``res`` with only the labels ``mask`` keeps."""
    q = np.repeat(np.arange(len(res.lims) - 1), np.diff(res.lims.astype(np.int64)))
    ok = mask[res.labels]
    lims = np.zeros_like(res.lims)
    lims[1:] = np.cumsum(np.bincount(q[ok], minlength=len(lims) - 1))
    return ftj.RangeSearchResult(lims, res.distances[ok], res.labels[ok])


@pytest.mark.parametrize("metric", ["L2", "IP"])
@pytest.mark.parametrize("sel", [None, "range"])
def test_flat_range_search_matches_reference(data, metric, sel):
    """Radius at the median 10th-neighbour distance; hits below it (L2) or
    above it (inner product), optionally within an IDSelectorRange.
    faiss_tpu's flat range_search raises with a selector
    (``np.arange(self.ntotal, np.int64)`` at faiss_tpu/models/flat.py:410
    passes the dtype as the stop), so there the port is held to faiss_tpu's
    result without the selector, filtered by the selector's mask."""
    xb, xq = data
    m_j = getattr(ftj, f"METRIC_{'L2' if metric == 'L2' else 'INNER_PRODUCT'}")
    m_t = getattr(ftt, f"METRIC_{'L2' if metric == 'L2' else 'INNER_PRODUCT'}")
    ref = ftj.IndexFlat(D, m_j)
    ref.add(xb)
    port = flat_from_arrays(xb, m_t, device="cpu")
    port.RANGE_TILE_ROWS = 1000  # several tiles, the last one partial
    pt = None
    Dk, _ = ref.search(xq, K)
    radius = float(np.median(Dk[:, K - 1]))
    rj = ref.range_search(xq, radius)
    if sel:
        pt = ftt.SearchParameters(sel=ftt.IDSelectorRange(500, 2600))
        rj = keep_selected(rj, ftj.IDSelectorRange(500, 2600).mask_for_ids(
            np.arange(NB, dtype=np.int64)))
    rt = port.range_search(xq, radius, params=pt)
    n = range_agree(rj, rt, radius, tol_of(xq, xb))
    assert n > 5 * NQ
    for q in range(NQ):  # ascending ids within a query
        lab = rt.labels[int(rt.lims[q]) : int(rt.lims[q + 1])]
        assert (np.diff(lab) > 0).all()
        if sel:
            assert ((lab >= 500) & (lab < 2600)).all()
    empty = port.range_search(xq[:3], -1.0 if metric == "L2" else 1e9)
    assert (empty.lims == 0).all() and len(empty.labels) == 0


def test_flat_remove_merge_reconstruct_and_codec_match_reference(data):
    """remove_ids, merge_from, reconstruct* and sa_* against faiss_tpu,
    bytes equal."""
    xb, xq = data
    gone = np.random.RandomState(2).choice(NB, 300, replace=False)
    ref, port = ftj.IndexFlatL2(D), ftt.IndexFlatL2(D, device="cpu")
    for index, lib in ((ref, ftj), (port, ftt)):
        index.add(xb)
        assert index.remove_ids(lib.IDSelectorBatch(gone)) == 300
        assert index.remove_ids(lib.IDSelectorRange(NB * 2, NB * 3)) == 0
    assert port.ntotal == ref.ntotal == NB - 300
    np.testing.assert_array_equal(port.vectors(), ref.vectors())
    other_j, other_t = ftj.IndexFlatL2(D), ftt.IndexFlatL2(D, device="cpu")
    other_j.add(xq)
    other_t.add(xq)
    ref.merge_from(other_j)
    port.merge_from(other_t)
    assert other_t.ntotal == 0 and port.ntotal == ref.ntotal
    np.testing.assert_array_equal(port.vectors(), ref.vectors())
    with pytest.raises(ValueError):
        port.merge_from(ftt.IndexFlatIP(D, device="cpu"))
    np.testing.assert_array_equal(port.reconstruct_n(10, 50),
                                  ref.reconstruct_n(10, 50))
    keys = np.array([0, 7, port.ntotal - 1, 3])
    np.testing.assert_array_equal(port.reconstruct_batch(keys),
                                  ref.reconstruct_batch(keys))
    np.testing.assert_array_equal(port.reconstruct(17), ref.reconstruct(17))
    with pytest.raises(IndexError):
        port.reconstruct_n(port.ntotal - 1, 2)
    assert port.sa_code_size() == ref.sa_code_size() == D * 4
    codes = port.sa_encode(xq)
    np.testing.assert_array_equal(codes, ref.sa_encode(xq))
    assert codes.dtype == np.uint8 and codes.shape == (NQ, D * 4)
    np.testing.assert_array_equal(port.sa_decode(codes), xq)
    agree(*ref.search(xq, K), *port.search(xq, K), tol_of(xq, xb))


@pytest.mark.parametrize("k", [10, 200])
@pytest.mark.parametrize("storage", ["f32", "f16"])
def test_kernel_paths_after_mutation(data, k, storage, monkeypatch):
    """With the kernel paths engaged (PALLAS_MIN_NB lowered: the screen at
    k = 10, K3 at k = 200), a search stages its copies; remove_ids and
    merge_from drop them, and the next search equals that of a fresh index
    of the same rows, bitwise, and faiss_tpu's exact search of those rows
    tie-aware."""
    xb, xq = data
    monkeypatch.setattr(ftt.IndexFlat, "PALLAS_MIN_NB", 1024)
    port = ftt.IndexFlatL2(D, device="cpu")
    if storage == "f16":
        port.storage_dtype = np.float16
    port.add(xb)
    port.search(xq, k)
    assert port._screen is not None or port._xbT is not None
    keep = np.ones(NB, bool)
    keep[np.random.RandomState(4).choice(NB, 400, replace=False)] = False
    port.remove_ids(ftt.IDSelectorBatch(np.nonzero(~keep)[0]))
    assert port._screen is None and port._xbT is None and port._norms is None
    more = ftt.IndexFlatL2(D, device="cpu")
    more.add(xq)
    port.merge_from(more)
    rows = np.concatenate([xb[keep], xq])
    if storage == "f16":
        rows = rows.astype(np.float16).astype(np.float32)
    fresh = ftt.IndexFlatL2(D, device="cpu")
    fresh.add(rows)
    Dt, It = port.search(xq, k)
    Df, If = fresh.search(xq, k)
    np.testing.assert_array_equal(It, If)
    np.testing.assert_array_equal(Dt, Df)
    ref = ftj.IndexFlatL2(D)
    ref.add(rows)
    agree(*ref.search(xq, k), Dt, It, tol_of(xq, rows))


@pytest.fixture(scope="module")
def sq8(data):
    xb, _ = data
    ref = ftj.IndexFlatSQ8(D)
    ref.train(xb[:1000])
    ref.add(xb)
    port = ftt.IndexFlatSQ8(D, device="cpu")
    port.train(xb[:1000])
    port.add(xb)
    return ref, port


def test_sq8_trained_codes_and_norms_match_reference(data, sq8):
    xb, _ = data
    ref, port = sq8
    np.testing.assert_array_equal(port.sq.trained, ref.sq.trained)
    assert port.sq.trained.dtype == np.float32 and port.sq.trained.shape == (2, D)
    codes = port._consolidate().numpy()
    np.testing.assert_array_equal(codes, np.asarray(ref._consolidate()))
    assert codes.dtype == np.uint8 and codes.shape == (NB, D)
    np.testing.assert_array_equal(port.sq.compute_codes(xb[:50]),
                                  ref.sq.compute_codes(xb[:50]))
    np.testing.assert_array_equal(port.vectors(), ref.vectors())
    np.testing.assert_array_equal(port.reconstruct_n(5, 20), ref.reconstruct_n(5, 20))
    np.testing.assert_array_equal(port.reconstruct(9), ref.reconstruct(9))
    scale, off = port._sq_params()
    sj, oj = ref._sq_params()
    np.testing.assert_array_equal(scale.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(off.numpy(), np.asarray(oj))
    nj = np.asarray(ref_sq8_norms(jnp.asarray(codes), sj, oj))
    np.testing.assert_allclose(port._norms.numpy(), nj, rtol=1e-6)
    # untrained: add trains on the first batch, as faiss_tpu's does
    a, b = ftj.IndexFlatSQ8(D), ftt.IndexFlatSQ8(D, device="cpu")
    a.add(xb[:700])
    b.add(xb[:700])
    np.testing.assert_array_equal(b.sq.trained, a.sq.trained)
    # the other quantizer types and range statistics, bit for bit
    q4j = ftj.ScalarQuantizer(D, ftj.QuantizerType.QT_4bit)
    q4t = ftt.ScalarQuantizer(D, ftt.QuantizerType.QT_4bit)
    qj, qt = ftj.ScalarQuantizer(D), ftt.ScalarQuantizer(D)
    qj.rangestat, qt.rangestat = ftj.RangeStat.RS_quantiles, ftt.RangeStat.RS_quantiles
    for a, b in ((q4j, q4t), (qj, qt)):
        a.train(xb)
        b.train(xb)
        assert np.array_equal(b.trained, a.trained)
        assert np.array_equal(b.compute_codes(xb), a.compute_codes(xb))


@pytest.mark.parametrize("metric", ["L2", "IP"])
def test_sq8_search_matches_reference(data, metric, monkeypatch):
    """Search by decoded row blocks (two blocks and a partial one here)
    against faiss_tpu's; a selector raises, as in faiss_tpu."""
    xb, xq = data
    mj = ftj.METRIC_L2 if metric == "L2" else ftj.METRIC_INNER_PRODUCT
    mt = ftt.METRIC_L2 if metric == "L2" else ftt.METRIC_INNER_PRODUCT
    ref = ftj.IndexFlatSQ8(D, mj)
    ref.add(xb)
    port = flat_sq8_from_arrays(ref.sq.trained, np.asarray(ref._consolidate()), mt,
                                device="cpu")
    monkeypatch.setattr(port, "DECODE_ROWS", 1100)
    dec = port.vectors()
    agree(*ref.search(xq, K), *port.search(xq, K), tol_of(xq, dec),
          largest=metric == "IP")
    # the submit API and range search read decoded rows too
    Ds, Is = port.search_collect(port.search_submit(xq, K))
    np.testing.assert_array_equal(Is, port.search(xq, K)[1])
    radius = float(np.median(port.search(xq, K)[0][:, -1]))
    truth = ftj.IndexFlat(D, mj)
    truth.add(dec)
    range_agree(truth.range_search(xq, radius), port.range_search(xq, radius),
                radius, tol_of(xq, dec))
    with pytest.raises(NotImplementedError, match="selectors"):
        port.search(xq, K, params=ftt.SearchParameters(sel=ftt.IDSelectorAll()))
    # remove_ids keeps the other rows' codes
    codes = port._consolidate().numpy()
    port.remove_ids(ftt.IDSelectorRange(0, 100))
    ref.remove_ids(ftj.IDSelectorRange(0, 100))
    np.testing.assert_array_equal(port._consolidate().numpy(), codes[100:])
    np.testing.assert_array_equal(port.vectors(), ref.vectors())


def test_flat1d_matches_reference():
    rs = np.random.RandomState(8)
    x = rs.randn(2000, 1).astype(np.float32)
    q = rs.randn(64, 1).astype(np.float32)
    ref, port = ftj.IndexFlat1D(), ftt.IndexFlat1D(device="cpu")
    for index in (ref, port):
        index.add(x[:1500])
        index.add(x[1500:])
    np.testing.assert_array_equal(port.perm, ref.perm)
    np.testing.assert_array_equal(port.vectors()[port.perm, 0],
                                  np.sort(x[:, 0], kind="stable"))
    agree(*ref.search(q, 5), *port.search(q, 5), tol_of(q, x))
    lazy = ftt.IndexFlat1D(continuous_update=False, device="cpu")
    lazy.add(x)
    assert len(lazy.perm) == 0
    lazy.update_permutation()
    np.testing.assert_array_equal(lazy.perm, ref.perm)


# -- Refine(SQ8) over IVF-PQ --------------------------------------------------
NLIST, M, CT, KF, MSTEPS, NQR = 256, 4, 256, 4, 4, 256


@pytest.fixture(scope="module")
def refine_sq8(data):
    xb, _ = data
    xq = mixture(np.random.RandomState(52), NQR)
    base = ftj.IndexIVFPQFastScan(None, D, NLIST, M, 4)
    base.cp.niter = 4
    base.cp.min_points_per_centroid = 1
    base.FUSED_CT = CT
    base.fused_interpret = True
    base.query_h2d_dtype = None
    base.pack_d2h = None
    base.strict_probe = False
    base.dyn_msteps = MSTEPS
    ref = ftj.IndexRefineFlat(base, store="sq8")
    ref.k_factor = KF
    ref.train(xb)
    ref.add(xb)
    sq = ref.refine_index
    port = refine_sq8_from_arrays(
        base.quantizer.vectors(), base.pq.centroids, base._codes_host,
        base._listnos_host, base._ids_host, sq.sq.trained,
        np.asarray(sq._consolidate()), device="cpu",
    )
    port.base_index.FUSED_CT = CT
    port.base_index.strict_probe = False
    port.base_index.dyn_msteps = MSTEPS
    port.k_factor = KF
    return ref, port, xq


def test_refine_sq8_fused_path_matches_reference(data, refine_sq8, monkeypatch):
    """The fused path (K1 soft over the worklists, then the re-rank on the
    SQ8 codes dequantized after the gather) against faiss_tpu's in
    interpret mode, on the rows its approximate select did not flag; the
    port's distances are exact to the SQ8 reconstruction of their ids."""
    ref, port, xq = refine_sq8
    from faiss_tpu_torch.models import ivf_pq as port_pq

    calls = []
    real = port_pq._fused_search_rerank_recon_dyn
    monkeypatch.setattr(port_pq, "_fused_search_rerank_recon_dyn",
                        lambda *a, **kw: calls.append(kw.get("sq")) or real(*a, **kw))
    ref.base_index.nprobe = port.base_index.nprobe = 1
    Dj, Ij = ref.search(xq, K)
    Dt, It = port.search(xq, K)
    assert calls and calls[0] is not None
    base, br = ref.base_index, ref.base_index._build_brute()
    sq = ref.refine_index
    packed = jax_recon_dyn(
        jnp.asarray(xq), br["centroids_g"], br["cn2g"], br["yT"], br["n2s"],
        br["lid"], br["slot_map_dev"], sq._consolidate(), br["chunk_first"],
        br["chunk_last"], br["cgroup"], K, K * KF, 256, CT, 1, MSTEPS,
        br["max_span"], qdepth=base.refined_qdepth, strict_probe=False,
        xb_n2=sq._norms, rr_prec="high", sq_scale=sq._sq_params()[0],
        sq_off=sq._sq_params()[1], interpret=True,
    )
    lossy = np.asarray(_unpack_results(packed, K)[2])[:NQR]
    e = ~lossy
    assert e.mean() > 0.5, e.mean()
    dec = port.refine_index.vectors()
    tol = tol_of(xq, dec)
    agree(Dj[e], Ij[e], Dt[e], It[e], tol[e])
    assert (It >= 0).all()
    d64 = ((xq[:, None, :].astype(np.float64) - dec[It]) ** 2).sum(-1)
    assert (np.abs(Dt - d64) <= tol[:, None]).all()
    assert port.refine_index._consolidate().dtype.itemsize == 1


def test_refine_sq8_eager_path_with_selector(data, refine_sq8):
    """A selector takes the eager path: the base searches by probe with it,
    then the candidates are re-ranked on the SQ8 codes; against faiss_tpu's
    eager path with the same selector."""
    ref, port, xq = refine_sq8
    ref.base_index.nprobe = port.base_index.nprobe = 4
    pj = ftj.SearchParametersIVF(sel=ftj.IDSelectorRange(0, NB // 2))
    pt = ftt.SearchParametersIVF(sel=ftt.IDSelectorRange(0, NB // 2))
    Dj, Ij = ref.search(xq, K, params=pj)
    Dt, It = port.search(xq, K, params=pt)
    assert ((It >= 0) & (It < NB // 2)).all()
    agree(Dj, Ij, Dt, It, tol_of(xq, port.refine_index.vectors()))
    np.testing.assert_array_equal(port.reconstruct(3), ref.reconstruct(3))
