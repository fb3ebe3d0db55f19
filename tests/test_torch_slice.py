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


def ivfflat_unported(case, arrays, xq):
    """Call IVF-Flat's unported option ``case`` on a port index built from
    the slice's lists and vectors."""
    cent, _, _, listnos, ids, rows = arrays
    flat = ivfflat_from_arrays(cent, rows, listnos, ids, device="cpu")
    if case == "ivfflat_selector":
        flat.search(xq, K, params=ftt.SearchParametersIVF(sel=object()))
    elif case == "ivfflat_remove_ids":
        flat.remove_ids(object())
    else:
        ftt.IndexIVFFlat(None, D, NLIST, ftt.METRIC_INNER_PRODUCT, device="cpu")


@pytest.mark.parametrize(
    "case", ["small_batch", "too_many_candidates", "pq8_unrefined",
             "pq_preassigned", "ivfflat_selector", "ivfflat_remove_ids",
             "ivfflat_ip_metric"]
)
def test_unported_branches_raise(built, case):
    """What is still unported on each branch raises, naming its ROADMAP
    item. Small batches, k * k_factor > 128, 8-bit PQ and IVF-PQ's
    search_preassigned themselves now run (tests/test_torch_ivfpq_probe.py);
    on those branches the polysemous filter and ID selectors still raise."""
    _, arrays, xq, _ = built
    index = make_port(arrays)
    index.base_index.nprobe = 1
    sel = ftt.SearchParametersIVF(sel=object())
    if case == "small_batch":  # the per-probe scan's polysemous filter
        xq = xq[: index.base_index.big_batch_threshold - 1]
        index.base_index.polysemous_ht = 4
    elif case == "too_many_candidates":  # the base's own search + re-rank
        index.k_factor = 13
    elif case == "pq8_unrefined":  # faiss_tpu's unrefined XLA ADC path
        cent, pq_cent, codes, listnos, ids, _ = arrays
        rs = np.random.RandomState(0)
        index = ivfpq_from_arrays(
            cent, rs.rand(M, 256, D // M), rs.randint(256, size=codes.shape),
            listnos, ids, device="cpu",
        )
        index.do_polysemous_training = True
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        if case.startswith("ivfflat"):
            ivfflat_unported(case, arrays, xq)
        elif case == "pq_preassigned":  # IVF-PQ's per-probe ADC scan
            index.base_index.search_preassigned(
                xq, K, np.zeros((len(xq), 1), np.int64),
                np.zeros((len(xq), 1), np.float32), params=sel)
        elif case == "pq8_unrefined":
            index.train(xq)
        elif case == "too_many_candidates":
            index.search(xq, K, params=sel)
        else:
            index.search(xq, K)


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
