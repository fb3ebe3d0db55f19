"""Port parity for the whole serving slice: IndexRefineFlat over
IndexIVFPQFastScan, soft-probed dynamic-chunk scan, exact fp16 re-rank,
through ``search`` and ``search_submit``/``search_collect``. Both packages
serve the state of one trained faiss_tpu index (faiss_tpu_torch.convert);
faiss_tpu runs its Pallas kernel in interpret mode with f32 queries and f32
results (query_h2d_dtype=None, pack_d2h=None)."""

import jax.numpy as jnp
import numpy as np
import pytest

import faiss_tpu as ftj
import faiss_tpu_torch as ftt
from faiss_tpu.models.ivf_pq import (
    _fused_search_rerank_recon_dyn as jax_recon_dyn,
    _unpack_results,
)
from faiss_tpu_torch.convert import (
    ivfflat_from_arrays,
    ivfpq_from_arrays,
    refine_flat_from_arrays,
)
from faiss_tpu_torch.utils.evaluation import ids_agree_tie_aware
from torch_threads import one_torch_thread  # noqa: F401

D, NLIST, NB, NQ, M, CT, K, KF, MSTEPS = 16, 256, 3000, 512, 4, 256, 10, 4, 4


def mixture(rs, n, ncent=64, d=D):
    """Small Gaussian mixture in the shape of bench.py's generator."""
    cent = np.random.RandomState(99).rand(ncent, d).astype(np.float32)
    scales = (1.0 / (np.arange(d) + 1.0)).astype(np.float32) * 0.4
    a = rs.randint(ncent, size=n)
    return (cent[a] + rs.randn(n, d).astype(np.float32) * scales).astype(np.float32)


def set_serving(base, index):
    base.FUSED_CT = CT
    base.strict_probe = False
    base.dyn_msteps = MSTEPS  # the adaptive 64-bucket exceeds nchunks here
    index.k_factor = KF


@pytest.fixture(scope="module")
def built():
    rs = np.random.RandomState(11)
    xb, xq = mixture(rs, NB), mixture(rs, NQ)
    base = ftj.IndexIVFPQFastScan(None, D, NLIST, M, 4)
    base.cp.niter = 4
    base.cp.min_points_per_centroid = 1
    base.fused_interpret = True
    base.query_h2d_dtype = None
    base.pack_d2h = None
    ref = ftj.IndexRefineFlat(base, store_float16=True)
    set_serving(base, ref)
    ref.train(xb)
    ref.add(xb)
    arrays = (
        base.quantizer.vectors(), base.pq.centroids, base._codes_host,
        base._listnos_host, base._ids_host, ref.refine_index.vectors(),
    )
    gt = np.argsort(((xq[:, None, :] - xb[None]) ** 2).sum(-1), 1)[:, :K]
    return ref, arrays, xq, gt


def make_port(arrays):
    port = refine_flat_from_arrays(*arrays, device="cpu", store_float16=True)
    set_serving(port.base_index, port)
    return port


def jax_lossy(ref, xq, nprobe):
    """faiss_tpu's lossy-row flags for the same single sub-batch its search
    ran (its search reads and drops them)."""
    base, br = ref.base_index, ref.base_index._build_brute()
    xb = ref.refine_index._consolidate()
    packed = jax_recon_dyn(
        jnp.asarray(xq), br["centroids_g"], br["cn2g"], br["yT"], br["n2s"],
        br["lid"], br["slot_map_dev"], xb, br["chunk_first"],
        br["chunk_last"], br["cgroup"], K, K * KF, 256, CT, nprobe, MSTEPS,
        br["max_span"], qdepth=base.refined_qdepth, strict_probe=False,
        xb_n2=ref.refine_index._norms, rr_prec="high", interpret=True,
    )
    return _unpack_results(packed, K)[2]


def recall(I, gt):
    return np.array([len(set(I[i]) & set(gt[i])) / K for i in range(len(I))])


@pytest.mark.parametrize("api", ["search", "submit_collect"])
@pytest.mark.parametrize("nprobe", [1, 4])
def test_slice_matches_reference(built, nprobe, api):
    ref, arrays, xq, gt = built
    port = make_port(arrays)
    ref.base_index.nprobe = port.base_index.nprobe = nprobe
    if api == "search":
        Dj, Ij = ref.search(xq, K)
        Dt, It = port.search(xq, K)
    else:
        Dj, Ij = ref.search_collect(ref.search_submit(xq, K))
        Dt, It = port.search_collect(port.search_submit(xq, K))
    assert Dt.dtype == np.float32 and It.dtype == np.int64
    assert Dt.shape == It.shape == (NQ, K)
    lossy = jax_lossy(ref, xq, nprobe)[:NQ]
    e = ~lossy
    assert e.mean() > 0.5, e.mean()
    agree = ids_agree_tie_aware(Dj[e], Ij[e], Dt[e], It[e], 1e-4 * Dj[e, -1])
    assert agree.all(), np.where(~agree)
    same = Ij[e] == It[e]
    np.testing.assert_allclose(Dt[e][same], Dj[e][same], rtol=1e-4, atol=1e-4)
    if lossy.any():
        assert recall(It[lossy], gt[lossy]).mean() >= recall(
            Ij[lossy], gt[lossy]
        ).mean()


def parity(Dj, Ij, Dt, It, xq, rows, largest=False):
    """Port (Dt, It) against faiss_tpu (Dj, Ij): distances within
    1e-5 * (|q|^2 + max |y|^2), ids up to ties at it."""
    tol = 1e-5 * ((xq.astype(np.float64) ** 2).sum(1)
                  + (rows.astype(np.float64) ** 2).sum(1).max())
    assert Dt.dtype == np.float32 and It.dtype == np.int64
    np.testing.assert_array_equal(Ij == -1, It == -1)
    fin = np.isfinite(Dj)
    assert (np.abs(np.where(fin, Dt - Dj, 0)) <= tol[:, None]).all()
    s = -1.0 if largest else 1.0
    assert ids_agree_tie_aware(np.where(fin, s * Dj, 1e30), Ij,
                               np.where(fin, s * Dt, 1e30), It, tol).all()


def ivfflat_case(case, ref, arrays, xq):
    """IVF-Flat over the slice's lists and vectors, in the port and in
    faiss_tpu, through ``case``: a selector in search, remove_ids (then
    search by probe), the inner-product metric. Returns both results."""
    cent, _, _, listnos, ids, rows = arrays
    metric = "ip" if case == "ivfflat_ip_metric" else "l2"
    port = ivfflat_from_arrays(
        cent, rows, listnos, ids, device="cpu",
        metric=ftt.METRIC_INNER_PRODUCT if metric == "ip" else ftt.METRIC_L2)
    quantizer = ref.base_index.quantizer
    if metric == "ip":
        quantizer = ftj.IndexFlatIP(D)
        quantizer.add(cent)
    jflat = ftj.IndexIVFFlat(
        quantizer, D, NLIST,
        ftj.METRIC_INNER_PRODUCT if metric == "ip" else ftj.METRIC_L2)
    keep = np.ones(len(ids), bool)
    xq = xq[:100]  # by probe on both sides
    pj = pt = None
    if case == "ivfflat_selector":
        pj = ftj.SearchParametersIVF(sel=ftj.IDSelectorRange(0, NB // 2))
        pt = ftt.SearchParametersIVF(sel=ftt.IDSelectorRange(0, NB // 2))
    elif case == "ivfflat_remove_ids":
        gone = np.arange(0, NB, 3)
        assert port.remove_ids(ftt.IDSelectorArray(gone)) == len(gone)
        keep = ~np.isin(ids, gone)
    jflat.add_core(rows[keep], ids[keep], listnos[keep])
    jflat.nprobe = port.nprobe = 4
    return jflat.search(xq, K, params=pj), port.search(xq, K, params=pt), xq, metric


@pytest.mark.parametrize(
    "case", ["small_batch", "too_many_candidates", "pq8_unrefined",
             "pq_preassigned", "ivfflat_selector", "ivfflat_remove_ids",
             "ivfflat_ip_metric"]
)
def test_unported_branches_raise(built, case):
    """What was unported on each branch now runs, and equals faiss_tpu's on
    the same state: the polysemous filter on the per-probe scan of small
    batches (under the refine); IVF-PQ training with the polysemous
    permutation (the port's codebooks permuted as faiss_tpu's
    PolysemousTraining permutes them); ID selectors (on the refined search
    with k * k_factor > 128, which searches the base by probe and re-ranks,
    and on IVF-PQ's search_preassigned), IVF-Flat's remove_ids and its
    inner-product metric."""
    ref, arrays, xq, _ = built
    index = make_port(arrays)
    index.base_index.nprobe = 1
    if case == "small_batch":  # the per-probe scan's polysemous filter
        xq = xq[: index.base_index.big_batch_threshold - 1]
        index.base_index.polysemous_ht = ref.base_index.polysemous_ht = 6
        ref.base_index.nprobe = 1
        try:
            Dj, Ij = ref.search(xq, K)
        finally:
            ref.base_index.polysemous_ht = 0
        Dt, It = index.search(xq, K)
        parity(Dj, Ij, Dt, It, xq, arrays[5])
        return
    if case == "pq8_unrefined":  # IVF-PQ training with the permutation
        from faiss_tpu.codecs.polysemous import PolysemousTraining as PolyJ
        from faiss_tpu.codecs.pq import ProductQuantizer as PQJ

        cent, pq_cent, codes, listnos, ids, _ = arrays
        rs = np.random.RandomState(0)
        trained = []
        for poly in (False, True):
            index = ivfpq_from_arrays(
                cent, rs.rand(M, 256, D // M), rs.randint(256, size=codes.shape),
                listnos, ids, device="cpu",
            )
            index.do_polysemous_training = poly
            index.polysemous_training = ftt.PolysemousTraining()
            index.polysemous_training.n_iter = 300
            index.train(xq)
            trained.append(index.pq.centroids)
        pj = PQJ(D, M, 8)
        pj.centroids = trained[0].copy()
        pt = PolyJ()
        pt.n_iter = 300
        pt.optimize_pq_for_hamming(pj)
        np.testing.assert_array_equal(trained[1], pj.centroids)
        return
    ref.base_index.nprobe = 1  # other tests of the module set it
    sj = ftj.SearchParametersIVF(sel=ftj.IDSelectorRange(NB // 4, NB))
    st = ftt.SearchParametersIVF(sel=ftt.IDSelectorRange(NB // 4, NB))
    rows = arrays[5]
    if case == "too_many_candidates":  # the base's own search + re-rank
        index.k_factor = ref.k_factor = 13
        try:
            Dj, Ij = ref.search(xq, K, params=sj)
        finally:
            ref.k_factor = KF
        Dt, It = index.search(xq, K, params=st)
        assert ((It >= NB // 4) | (It == -1)).all()
        parity(Dj, Ij, Dt, It, xq, rows)
    elif case == "pq_preassigned":  # IVF-PQ's per-probe ADC scan
        assign = np.random.RandomState(1).randint(NLIST, size=(len(xq), 3))
        cdis = np.random.RandomState(2).rand(len(xq), 3).astype(np.float32)
        Dj, Ij = ref.base_index.search_preassigned(xq, K, assign, cdis, params=sj)
        Dt, It = index.base_index.search_preassigned(xq, K, assign, cdis,
                                                     params=st)
        assert ((It >= NB // 4) | (It == -1)).all()
        parity(Dj, Ij, Dt, It, xq, rows)
    else:
        (Dj, Ij), (Dt, It), xq, metric = ivfflat_case(case, ref, arrays, xq)
        parity(Dj, Ij, Dt, It, xq, rows, largest=metric == "ip")


def test_port_alone_adaptive_worklist_and_streaming():
    """The port's own train/add/search on CPU, without faiss_tpu: the
    adaptive worklist bucket engages (small chunks), a batch that drops
    probed chunks widens it, and search_submit/search_collect with several
    sub-batches and two handles in flight return what search returns."""
    rs = np.random.RandomState(5)
    # queries from 4 of the 64 mixture components: tiles probe few lists
    xb, xq = mixture(rs, NB), mixture(rs, 300, ncent=4)
    base = ftt.IndexIVFPQFastScan(None, D, 64, M, 4, device="cpu")
    base.cp.niter = 4
    base.cp.min_points_per_centroid = 1
    base.FUSED_CT = 32
    base.strict_probe = False
    base.pipeline_batch = 128
    index = ftt.IndexRefineFlat(base, store_float16=True)
    index.k_factor = KF
    index.train(xb)
    index.add(xb)
    assert index.ntotal == NB
    base.nprobe = 1
    D1, I1 = index.search(xq, K)
    nchunks = base._brute["nchunks"]
    bucket = base._dyn_bucket[1]
    assert bucket % 64 == 0 and bucket <= 0.7 * nchunks
    gt = np.argsort(((xq[:, None, :] - xb[None]) ** 2).sum(-1), 1)[:, :K]
    r1 = recall(I1, gt).mean()
    assert r1 > 0.5
    h1 = index.search_submit(xq, K)
    h2 = index.search_submit(xq[:200], K)
    D2b, I2b = index.search_collect(h2)
    D2, I2 = index.search_collect(h1)
    np.testing.assert_array_equal(I2, I1)
    np.testing.assert_array_equal(D2, D1)
    np.testing.assert_array_equal(I2b, I1[:200])
    # force dropped chunks: each of the 3 sub-batches widens the bucket by 64
    base._dyn_bucket[1] = 1
    index.search(xq, K)
    assert base._dyn_bucket[1] == min(nchunks, 1 + 3 * 64)
    # nprobe > 4 takes the top-k probe instead of the iterative argmin (the
    # worklists are cut at 0.7 * nchunks here, so recall drops)
    base.nprobe = 8
    base.dyn_msteps = int(0.7 * nchunks)
    _, I8 = index.search(xq, K)
    assert (I8 >= 0).all() and recall(I8, gt).mean() > 0.5
    # distances are exact squared L2 against the fp16-rounded store
    xb16 = xb.astype(np.float16).astype(np.float32)
    d_chk = ((xq[:, None, :] - xb16[I1[:, :3]]) ** 2).sum(-1)
    np.testing.assert_allclose(D1[:, :3], d_chk, rtol=1e-4, atol=1e-4)
