"""Port parity for the meta layer (faiss_tpu_torch/models/meta.py against
faiss_tpu/models/meta.py): IndexPreTransform over IndexRefineFlat over
IndexIVFPQFastScan carried from a trained faiss_tpu index (the fused path
through search_submit / search_collect, the plain K2 against faiss_tpu's
Pallas kernel in interpret mode, ``fused_interpret``; and the eager path),
paged adds equal to one-shot adds, reconstruction through the reverse
chain, IndexRefine over an IVF-Flat base and over a store that is not flat,
IndexSplitVectors and IndexRandom.

Tolerances: the port rotates in a float32 torch.mm where faiss_tpu uses a
float32 numpy matmul, so the rotated vectors differ in their last bits.
Re-ranked distances agree within 1e-5 * (|q|^2 + max |y|^2) and ids up to
ties at it; ADC distances (a by-probe IVF-PQ base) within 1e-4 of that
scale. faiss_tpu's kernels select approximately and flag the rows whose
eviction floor says a candidate may be lost: those rows are left out, as
tests/test_torch_ivfpq.py does."""

import numpy as np
import pytest

import faiss_tpu as ftj
import faiss_tpu_torch as ftt
from faiss_tpu.models import ivf_pq as ref_mod
from faiss_tpu.models.meta import IndexRandom as RefRandom
from faiss_tpu_torch import base as ftt_base
from faiss_tpu_torch.convert import (
    flat_from_arrays,
    ivfflat_from_arrays,
    ivfpq_from_arrays,
    pretransform_from,
    refine_flat_from_arrays,
    transform_from_arrays,
)
from faiss_tpu_torch.utils.evaluation import ids_agree_tie_aware
from torch_threads import one_torch_thread  # noqa: F401

D, NB, NQ, NLIST, M, K = 16, 1500, 128, 32, 4, 10


def mixture(rs, n, ncent=64, d=D):
    """Small Gaussian mixture in the shape of bench.py's generator."""
    cent = np.random.RandomState(99).rand(ncent, d).astype(np.float32)
    scales = (1.0 / (np.arange(d) + 1.0)).astype(np.float32) * 0.4
    a = rs.randint(ncent, size=n)
    return (cent[a] + rs.randn(n, d).astype(np.float32) * scales).astype(np.float32)


@pytest.fixture(scope="module")
def data():
    rs = np.random.RandomState(61)
    return mixture(rs, NB), mixture(rs, NQ)


def scale_tol(xq, xb, rel=1e-5):
    return rel * ((xq.astype(np.float64) ** 2).sum(1)
                  + (xb.astype(np.float64) ** 2).sum(1).max())


def agree(Dj, Ij, Dt, It, tol, rows=None, largest=False):
    """Port (Dt, It) against faiss_tpu (Dj, Ij) on ``rows``: -1 at the same
    places, distances within tol, ids tie-aware at it."""
    assert Dt.dtype == np.float32 and It.dtype == np.int64
    assert Dt.shape == Dj.shape
    if rows is not None:
        Dj, Ij, Dt, It, tol = Dj[rows], Ij[rows], Dt[rows], It[rows], tol[rows]
    np.testing.assert_array_equal(Ij == -1, It == -1)
    fin = np.isfinite(Dj)
    assert (np.abs(np.where(fin, Dt - Dj, 0)) <= tol[:, None]).all()
    s = -1.0 if largest else 1.0
    ok = ids_agree_tie_aware(np.where(fin, s * Dj, 1e30), Ij,
                             np.where(fin, s * Dt, 1e30), It, tol)
    assert ok.all(), np.where(~ok)


@pytest.fixture(scope="module")
def opq_built(data):
    """faiss_tpu's IndexPreTransform(OPQMatrix, IndexRefineFlat(
    IndexIVFPQFastScan)) trained and added, and the port's holding the same
    rotation, lists and refine store."""
    xb, _ = data
    base = ftj.IndexIVFPQFastScan(None, D, NLIST, M, 4)
    base.FUSED_CT = 256
    base.fused_interpret = True
    base.big_batch_threshold = 64
    base.query_h2d_dtype = None
    base.pack_d2h = None
    base.cp.niter = 4
    base.cp.min_points_per_centroid = 1
    refine = ftj.IndexRefineFlat(base)
    refine.k_factor = 4
    opq = ftj.OPQMatrix(D, M)
    opq.niter = 4
    ref = ftj.IndexPreTransform(opq, refine)
    ref.train(xb)
    ref.add(xb)
    port_refine = refine_flat_from_arrays(
        base.quantizer.vectors(), base.pq.centroids, base._codes_host,
        base._listnos_host, base._ids_host, refine.refine_index.vectors(),
        device="cpu", store_float16=False,
    )
    pb = port_refine.base_index
    pb.FUSED_CT, pb.big_batch_threshold = 256, 64
    port_refine.k_factor = 4
    vt = transform_from_arrays("OPQMatrix", D, D, opq.A, M=M, device="cpu")
    port = pretransform_from([vt], port_refine)
    return ref, port


def test_pretransform_fused_submit_collect_matches_reference(data, opq_built,
                                                             monkeypatch):
    """The fused path through the wrapper (every list probed: K2's plain
    version against faiss_tpu's Pallas K2 in interpret mode): the handle is
    the inner index's, and the results agree with faiss_tpu's on the rows
    its kernel did not flag as lossy."""
    _, xq = data
    ref, port = opq_built
    flags = []
    unpack_results = ref_mod._unpack_results

    def unpack(packed, k):
        out = unpack_results(packed, k)
        flags.append(out[2])
        return out

    monkeypatch.setattr(ref_mod, "_unpack_results", unpack)
    for base in (ref.index.base_index, port.index.base_index):
        monkeypatch.setattr(base, "nprobe", NLIST)
    hj, ht = ref.search_submit(xq, K), port.search_submit(xq, K)
    assert hj[0] == ht[0] == "fused"
    Dj, Ij = ref.search_collect(hj)
    Dt, It = port.search_collect(ht)
    lossy = np.concatenate(flags)[:NQ]
    assert (~lossy).mean() > 0.5
    agree(Dj, Ij, Dt, It, scale_tol(xq, data[0]), rows=~lossy)
    # search() is search_submit + search_collect on the port
    Ds, Is = port.search(xq, K)
    np.testing.assert_array_equal(Is, It)
    np.testing.assert_array_equal(Ds, Dt)


def probed(index, xr, nprobe):
    """Each row's nprobe nearest coarse lists (sorted), from its rotated
    query ``xr``."""
    cent = index.index.base_index.quantizer.vectors().astype(np.float64)
    d = ((xr.astype(np.float64)[:, None] - cent[None]) ** 2).sum(-1)
    return np.sort(np.argsort(d, 1)[:, :nprobe], 1)


@pytest.mark.parametrize("case", ["small_batch", "too_many_candidates"])
def test_pretransform_eager_matches_reference(data, opq_built, monkeypatch, case):
    """The eager path through the wrapper: the base's own search for
    k * k_factor candidates, then the exact re-rank. Rows are compared where
    the rotated queries probe the same list in both packages and that list
    holds at most k * k_factor entries: every entry is then a candidate,
    and the result is the exact top k of the list, held to float64 of the
    rotated store. A batch under big_batch_threshold searches the base by
    probe in both packages and is held to faiss_tpu's too; a big batch with
    k * k_factor > 128 takes the base's XLA ADC scan, whose select is
    approximate in faiss_tpu (recall target 0.97, at most 32 a chunk:
    faiss_tpu/ops/pq_ops.py:323) and exact in the port, so there the port is
    held to float64 alone."""
    xb, xq = data
    ref, port = opq_built
    nprobe, kf = 1, 13
    for index in (ref, port):
        monkeypatch.setattr(index.index.base_index, "nprobe", nprobe)
        monkeypatch.setattr(index.index, "k_factor", kf)
    xs = xq[:40] if case == "small_batch" else xq
    hj, ht = ref.search_submit(xs, K), port.search_submit(xs, K)
    assert hj[0] == ht[0] == "eager"
    Dt, It = port.search_collect(ht)
    xr = port.apply_chain(xs)
    lists = probed(port, xr, nprobe)
    listnos = port.index.base_index._listnos_host
    sizes = np.bincount(listnos, minlength=NLIST)
    rows = ((lists == probed(ref, ref.apply_chain(xs), nprobe)).all(1)
            & (sizes[lists].sum(1) <= K * kf))
    assert rows.mean() > 0.8
    store = port.index.refine_index.vectors().astype(np.float64)
    D64 = np.full((len(xs), K), np.inf, np.float32)
    I64 = np.full((len(xs), K), -1, np.int64)
    for r in np.nonzero(rows)[0]:
        ent = np.nonzero(np.isin(listnos, lists[r]))[0]
        d = ((store[ent] - xr[r].astype(np.float64)) ** 2).sum(1)
        o = np.argsort(d, kind="stable")[:K]
        D64[r, : len(o)], I64[r, : len(o)] = d[o], ent[o]
    tol = scale_tol(xs, xb)
    agree(D64, I64, Dt, It, tol, rows=rows)
    if case == "small_batch":
        agree(*ref.search_collect(hj), Dt, It, tol, rows=rows)


def test_paged_add_matches_one_shot(data, monkeypatch):
    """Bulk adds are paged (add_page_rows): a tiny page gives the same index
    and results as one add through IndexPreTransform, IndexRefineFlat and
    IVF-PQ (tests/test_components.py:1030 for faiss_tpu), and ids survive
    paging with add_with_ids through the wrapper over IVF-Flat."""
    rs = np.random.RandomState(11)
    xb = rs.randn(3000, 32).astype(np.float32)
    xq = rs.randn(64, 32).astype(np.float32)
    one_shot = ftt_base.ADD_PAGE_BYTES

    def build(paged):
        monkeypatch.setattr(ftt_base, "ADD_PAGE_BYTES",
                            700 * 32 * 4 if paged else one_shot)
        ivf = ftt.IndexIVFPQ(None, 32, 16, 4, 8, device="cpu")
        ivf.cp.niter = 4
        ivf.cp.min_points_per_centroid = 1
        ivf.nprobe = 16
        refine = ftt.IndexRefineFlat(ivf)
        refine.k_factor = 4
        index = ftt.IndexPreTransform(ftt.PCAMatrix(32, 32, device="cpu"), refine)
        index.train(xb)
        index.add(xb)
        return index

    a, b = build(False), build(True)
    assert a.ntotal == b.ntotal == 3000
    for name in ("_codes_host", "_listnos_host", "_ids_host"):
        assert np.array_equal(getattr(a.index.base_index, name),
                              getattr(b.index.base_index, name))
    Da, Ia = a.search(xq, 5)
    Db, Ib = b.search(xq, 5)
    np.testing.assert_array_equal(Ia, Ib)
    np.testing.assert_allclose(Da, Db, rtol=1e-5)

    ivf2 = ftt.IndexIVFFlat(None, 32, 8, device="cpu")
    ivf2.cp.niter = 4
    ivf2.cp.min_points_per_centroid = 1
    pre = ftt.IndexPreTransform(ftt.CenteringTransform(32, device="cpu"), ivf2)
    pre.train(xb)
    monkeypatch.setattr(ftt_base, "ADD_PAGE_BYTES", 700 * 32 * 4)
    pre.add_with_ids(xb, np.arange(3000)[::-1].copy())
    assert pre.ntotal == 3000
    _, I2 = pre.search(xb[:8], 1)
    np.testing.assert_array_equal(I2.ravel(), 2999 - np.arange(8))


def test_reconstruct_through_reverse_chain(data):
    """reconstruct / reconstruct_n / reconstruct_batch / sa_decode run the
    inner index's reconstruction back through the chain: equal to faiss_tpu's
    over the same transforms and lists, and (orthonormal and centring
    transforms over exact storage) to the vectors that were added."""
    xb, xq = data
    rr = ftj.RandomRotationMatrix(D, D)
    rr.init(3)
    center = ftj.CenteringTransform(D)
    center.train(xb)
    ivf = ftj.IndexIVFFlat(None, D, 8)
    ivf.cp.niter = 4
    ref = ftj.IndexPreTransform(rr, ivf)
    ref.prepend_transform(center)
    ref.train(xb)
    ref.add(xb)
    chain = [transform_from_arrays("CenteringTransform", D, D, mean=center.mean,
                                   device="cpu"),
             transform_from_arrays("RandomRotationMatrix", D, D, rr.A, device="cpu")]
    port_ivf = ivfflat_from_arrays(ivf.quantizer.vectors(), ivf._codes_host,
                                   ivf._listnos_host, ivf._ids_host, device="cpu")
    port = pretransform_from(chain, port_ivf)
    assert port.d == D and port.ntotal == NB and port.is_trained
    tol = 1e-5 * (xb[:20].astype(np.float64) ** 2).sum(1)[:, None]
    rj, rt = ref.reconstruct_n(0, 20), port.reconstruct_n(0, 20)
    assert (np.abs(rt - rj) <= tol).all()
    assert (np.abs(rt - xb[:20]) <= tol).all()
    assert (np.abs(port.reconstruct(7) - xb[7]) <= tol[7]).all()
    keys = np.array([5, 1000, 3])
    assert (np.abs(port.reconstruct_batch(keys) - xb[keys]) <= 1e-5).all()
    codes = port.sa_encode(xq[:6])
    assert codes.dtype == np.uint8 and len(codes) == 6
    np.testing.assert_allclose(port.sa_decode(codes), xq[:6], atol=1e-5)
    np.testing.assert_array_equal(codes, ref.sa_encode(xq[:6]))


def test_pretransform_wrapper_api(data):
    """Reads forward to the inner index and writes do not (faiss_tpu's
    behaviour: set knobs on the inner index); range_search and remove_ids
    through the chain; prepend_transform checks the dimensions."""
    xb, xq = data
    flat = ftt.IndexFlatL2(D, device="cpu")
    pre = ftt.IndexPreTransform(ftt.HadamardRotation(D, device="cpu"), flat)
    pre.add(xb)
    assert pre.ntotal == NB and pre.PALLAS_MIN_NB == flat.PALLAS_MIN_NB
    pre.flat_screen = False
    assert flat.flat_screen is True and pre.__dict__["flat_screen"] is False
    with pytest.raises(AttributeError):
        pre._no_such_attribute
    with pytest.raises(ValueError, match="d_out"):
        pre.prepend_transform(ftt.PCAMatrix(D, 8, device="cpu"))
    raw = flat_from_arrays(xb, device="cpu")
    D0, I0 = raw.search(xq, 5)
    D1, I1 = pre.search(xq, 5)  # Hadamard is orthonormal: the same neighbours
    assert ids_agree_tie_aware(D0, I0, D1, I1, scale_tol(xq, xb)).all()
    radius = float(np.median(D0[:, 4]))
    r0, r1 = raw.range_search(xq[:8], radius), pre.range_search(xq[:8], radius)
    assert r1.lims[-1] > 0 and abs(int(r1.lims[-1]) - int(r0.lims[-1])) <= 2
    assert pre.remove_ids(ftt.IDSelectorRange(0, 100)) == 100
    assert pre.ntotal == flat.ntotal == NB - 100


def test_refine_over_ivfflat_base_matches_reference(data):
    """IndexRefine(IndexIVFFlat, IndexFlat): the base's own search for
    k * k_factor candidates, then the exact re-rank against the flat store
    (no fused path for this base), against faiss_tpu's."""
    xb, xq = data
    ivf = ftj.IndexIVFFlat(None, D, NLIST)
    ivf.cp.niter = 4
    ivf.train(xb)
    ivf.add(xb)
    ivf.nprobe = 3
    store = ftj.IndexFlatL2(D)
    store.add(xb)
    ref = ftj.IndexRefine(ivf, store)
    ref.k_factor = 3
    base = ivfflat_from_arrays(ivf.quantizer.vectors(), ivf._codes_host,
                               ivf._listnos_host, ivf._ids_host, device="cpu")
    base.nprobe = 3
    port = ftt.IndexRefine(base, flat_from_arrays(xb, device="cpu"))
    port.k_factor = 3
    xs = xq[:64]
    assert port.search_submit(xs, K)[0] == "eager"
    agree(*ref.search(xs, K), *port.search(xs, K), scale_tol(xs, xb))


def test_refine_over_a_store_that_is_not_flat(data):
    """IndexRefine with an IVF-PQ (8-bit) refine store: the candidates are
    re-ranked against the store's reconstructions (one reconstruct_batch
    on the device; faiss_tpu reconstructs row by row), and rows with fewer
    candidates than k keep -1 / +inf."""
    xb, xq = data
    ivf = ftj.IndexIVFFlat(None, D, NLIST)
    ivf.cp.niter = 4
    ivf.train(xb)
    ivf.add(xb)
    ivf.nprobe = 2
    pq = ftj.IndexIVFPQ(None, D, 8, 8, 8)
    pq.cp.niter = 4
    pq.cp.min_points_per_centroid = 1
    pq.train(xb)
    pq.add(xb)
    ref = ftj.IndexRefine(ivf, pq)
    ref.k_factor = 2
    base = ivfflat_from_arrays(ivf.quantizer.vectors(), ivf._codes_host,
                               ivf._listnos_host, ivf._ids_host, device="cpu")
    base.nprobe = 2
    store = ivfpq_from_arrays(pq.quantizer.vectors(), pq.pq.centroids,
                              pq._codes_host, pq._listnos_host, pq._ids_host,
                              device="cpu")
    port = ftt.IndexRefine(base, store)
    port.k_factor = 2
    xs = xq[:24]
    Dj, Ij = ref.search(xs, K)
    Dt, It = port.search(xs, K)
    agree(Dj, Ij, Dt, It, scale_tol(xs, xb))
    # every distance is the float64 distance to the store's reconstruction
    got = It >= 0
    y = store.reconstruct_batch(It[got]).astype(np.float64)
    q = np.repeat(xs, got.sum(1), axis=0).astype(np.float64)
    np.testing.assert_allclose(Dt[got], ((y - q) ** 2).sum(1), rtol=1e-5, atol=1e-5)
    # a base with one list probed returns fewer than k * k_factor candidates
    # on small lists: the missing ranks stay -1 / +inf
    base.nprobe = 1
    Dt1, It1 = port.search(xs, 200)
    assert ((It1 == -1) == np.isinf(Dt1)).all() and (It1 == -1).any()


def test_split_vectors_and_random_match_reference(data):
    xb, xq = data
    ref = ftj.IndexSplitVectors(D)
    port = ftt.IndexSplitVectors(D, device="cpu")
    for lo, hi in ((0, 6), (6, D)):
        sub = ftj.IndexFlatIP(hi - lo)
        sub.add(np.ascontiguousarray(xb[:, lo:hi]))
        ref.add_sub_index(sub)
        port.add_sub_index(flat_from_arrays(xb[:, lo:hi], ftt.METRIC_INNER_PRODUCT,
                                            device="cpu"))
    assert port.ntotal == NB and port.sum_d == D
    Dj, Ij = ref.search(xq[:32], K)
    Dt, It = port.search(xq[:32], K)
    agree(Dj, Ij, Dt, It, scale_tol(xq[:32], xb), largest=True)
    # the sums are the full inner products
    np.testing.assert_allclose(
        Dt, np.take_along_axis(xq[:32] @ xb.T, It, 1), rtol=1e-5, atol=1e-5)
    bad = ftt.IndexSplitVectors(D + 1, device="cpu")
    bad.add_sub_index(port.sub_indexes[0])
    with pytest.raises(RuntimeError, match="sum to d"):
        bad.search(xq[:2], K)

    rj, rt = RefRandom(D, 500, seed=9), ftt.IndexRandom(D, 500, seed=9, device="cpu")
    rj.add(xb[:10])
    rt.add(xb[:10])
    assert rt.ntotal == rj.ntotal == 510
    for a, b in zip(rj.search(xq[:5], 7), rt.search(xq[:5], 7)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert np.array_equal(rj.reconstruct(42), rt.reconstruct(42))


def test_refine_flat_stores(data):
    """IndexRefineFlat's store argument, as faiss_tpu's: f32, f16
    (store_float16), sq8 (an IndexFlatSQ8 of one byte a dimension)."""
    xb, _ = data
    base = ftt.IndexFlatL2(D, device="cpu")
    for kw, store, cls in ((dict(), "f32", ftt.IndexFlat),
                           (dict(store_float16=True), "f16", ftt.IndexFlat),
                           (dict(store="f16"), "f16", ftt.IndexFlat),
                           (dict(store="sq8"), "sq8", ftt.IndexFlatSQ8)):
        r = ftt.IndexRefineFlat(base, **kw)
        j = ftj.IndexRefineFlat(ftj.IndexFlatL2(D), **kw)
        assert r.store == j.store == store and r.store_float16 == j.store_float16
        assert type(r.refine_index) is cls
        assert np.dtype(getattr(r.refine_index, "storage_dtype", np.float32)) == (
            np.float16 if store == "f16" else np.float32)
    with pytest.raises(ValueError, match="unknown refine store"):
        ftt.IndexRefineFlat(base, store="pq")
