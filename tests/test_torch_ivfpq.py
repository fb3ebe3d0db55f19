"""Port parity for the rest of IVF-PQ FastScan search: the unrefined
``IndexIVFPQFastScan.search`` (K4) and, under IndexRefineFlat, the
code-streaming scans (K4, K5), the exhaustive and strictly masked recon scan
(K2) and the strict dynamic-chunk recon scan (K1 penalized), each against
faiss_tpu's function on the same sub-batch (Pallas kernels in interpret
mode, f32 queries and results); the branch each search takes against
faiss_tpu's gates; and two refined searches end to end. Both packages serve
the state of one trained faiss_tpu index (faiss_tpu_torch.convert).

Tolerances. faiss_tpu's kernels select approximately and flag the rows where
their eviction floor says a candidate may be lost: those rows are left out.
On the others, ids agree up to ties within 1e-4 of the row's last distance,
and distances of equal ids within rtol 1e-4 (the re-ranked distances are
exact float32 on both sides). The unrefined search returns ADC distances,
whose coarse term faiss_tpu adds through bf16 hi + lo parts (~2^-16 of
|2 q.c|): they agree within 1e-4 * (|q|^2 + max n2)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import faiss_tpu as ftj
from faiss_tpu.models import ivf_pq as ref_mod
from faiss_tpu.ops import pq_ops as ref_pq
from faiss_tpu.ops.pallas_knn import ivfpq_fused_pallas
from faiss_tpu_torch.convert import refine_flat_from_arrays
from faiss_tpu_torch.models import ivf_pq as port_mod
from faiss_tpu_torch.ops import pq_ops as port_pq
from faiss_tpu_torch.utils.evaluation import ids_agree_tie_aware
from torch_threads import one_torch_thread  # noqa: F401

D, NLIST, NB, NQ, M, CT, K, KF = 16, 256, 3000, 128, 4, 256, 10, 4
KC, QT = K * KF, 128
FUSED = ("_fused_search_rerank", "_fused_search_rerank_dyn",
         "_fused_search_rerank_recon", "_fused_search_rerank_recon_dyn")


def mixture(rs, n, ncent=64, d=D):
    """Small Gaussian mixture in the shape of bench.py's generator."""
    cent = np.random.RandomState(99).rand(ncent, d).astype(np.float32)
    scales = (1.0 / (np.arange(d) + 1.0)).astype(np.float32) * 0.4
    a = rs.randint(ncent, size=n)
    return (cent[a] + rs.randn(n, d).astype(np.float32) * scales).astype(np.float32)


@pytest.fixture(scope="module")
def built():
    rs = np.random.RandomState(21)
    xb, xq = mixture(rs, NB), mixture(rs, NQ)
    base = ftj.IndexIVFPQFastScan(None, D, NLIST, M, 4)
    base.cp.niter = 4
    base.cp.min_points_per_centroid = 1
    base.FUSED_CT = CT
    base.fused_interpret = True
    base.query_h2d_dtype = None
    base.pack_d2h = None
    ref = ftj.IndexRefineFlat(base, store_float16=True)
    ref.k_factor = KF
    ref.train(xb)
    ref.add(xb)
    port = refine_flat_from_arrays(
        base.quantizer.vectors(), base.pq.centroids, base._codes_host,
        base._listnos_host, base._ids_host, ref.refine_index.vectors(),
        device="cpu", store_float16=True,
    )
    port.base_index.FUSED_CT = CT
    port.k_factor = KF
    bj, bt = base._build_brute(), port.base_index._build_brute()
    assert bj["nchunks"] == bt["nchunks"] >= 8
    return ref, port, xq


def full_rows(port, xq, nprobe, chunks=None):
    """Rows whose nprobe nearest lists hold at least KC slots (within the
    packed ``chunks``, when given). On the other rows a kernel's top KC ends
    in masked slots, whose keys near 1e9 rank at float32's resolution there
    (64), arbitrarily on either side, before the exact re-rank."""
    if not nprobe:
        return np.ones(len(xq), bool)
    base = port.base_index
    sm = base._build_brute()["slot_map"]
    lists = np.where(sm >= 0, base._listnos_host[np.maximum(sm, 0)], -1)
    if chunks is not None:
        lists = np.where(np.isin(np.arange(len(sm)) // CT, chunks), lists, -1)
    cent = base.quantizer.vectors()
    near = np.argsort(((xq[:, None] - cent[None]) ** 2).sum(-1), 1)[:, :nprobe]
    return np.array([np.isin(lists, near[r]).sum() >= KC for r in range(len(xq))])


def agree(Dj, Ij, lossy, Dt, It, what, rows):
    """Port (Dt, It) against faiss_tpu (Dj, Ij) on ``rows`` that faiss_tpu's
    kernel did not flag as lossy."""
    e = ~np.asarray(lossy)[: len(Dj)] & rows
    assert e.mean() > 0.4, (what, e.mean(), rows.mean())
    ok = ids_agree_tie_aware(Dj[e], Ij[e], Dt[e], It[e], 1e-4 * np.abs(Dj[e, -1]))
    assert ok.all(), (what, np.where(~ok))
    same = Ij[e] == It[e]
    np.testing.assert_allclose(Dt[e][same], Dj[e][same], rtol=1e-4, atol=1e-4)


def ref_inputs(ref):
    base = ref.base_index
    br = base._build_brute()
    xb = ref.refine_index._consolidate()
    return br, xb


def port_inputs(port):
    br = port.base_index._build_brute()
    return br, port.refine_index._consolidate(), port.refine_index._norms


def ref_result(packed):
    Dj, Sj, lossy, nd = ref_mod._unpack_results(packed, K)
    return Dj, Sj, lossy, nd


def port_result(out):
    Dt, St, nd = out
    return Dt.numpy(), St.numpy(), int(nd)


def test_adc_tables_match_reference(built):
    """The block-diagonal codebook equals faiss_tpu's, and the ADC tables as
    one product with it equal pq_ip_tables (float32, 1e-5) and the bf16
    LUTs faiss_tpu hands to K4 (bf16 rounding of a float32 difference may
    flip: within one bf16 ulp)."""
    ref, port, xq = built
    cb = ref.base_index.pq.centroids
    cbt = port_pq.pq_blockdiag_codebook(torch.from_numpy(cb))
    np.testing.assert_array_equal(cbt.numpy(), ref_pq.pq_blockdiag_codebook(cb))
    x = torch.from_numpy(xq)
    ip = port_pq.pq_ip_tables(x, torch.from_numpy(cb))
    np.testing.assert_allclose(ip.numpy(), np.asarray(ref_pq.pq_ip_tables(
        jnp.asarray(xq), jnp.asarray(cb))), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose((x @ cbt).numpy(), ip.reshape(NQ, -1).numpy(),
                               rtol=1e-5, atol=1e-5)
    lt = port_mod._adc_luts(x, cbt).float().numpy()
    lj = np.asarray(jnp.asarray(
        -2.0 * (jnp.asarray(xq) @ jnp.asarray(cbt.numpy())), jnp.bfloat16
    ).astype(jnp.float32))
    assert (np.abs(lt - lj) <= np.abs(lj) * 2.0**-7).all()


def test_adc_scan_rerank_matches_reference(built):
    """_fused_search_rerank: K4 over every chunk, masked by nprobe (its
    exhaustive scan is held against faiss_tpu's by the unrefined search)."""
    ref, port, xq = built
    nprobe = 4
    br, xb = ref_inputs(ref)
    Dj, Sj, lossy, _ = ref_result(ref_mod._fused_search_rerank(
        jnp.asarray(xq), br["centroids_g"], br["cn2g"], br["cbt"],
        br["codesT"], br["n2s"], br["lid"], br["slot_map_dev"], xb,
        K, KC, QT, CT, nprobe, interpret=True,
    ))
    bt, xbt, _ = port_inputs(port)
    Dt, St, _ = port_result(port_mod._fused_search_rerank(
        torch.from_numpy(xq), bt, xbt, K, KC, QT, CT, nprobe
    ))
    agree(Dj, Sj, lossy, Dt, St, f"K4 nprobe={nprobe}",
          full_rows(port, xq, nprobe))


def test_adc_dyn_scan_rerank_matches_reference(built):
    """_fused_search_rerank_dyn: K5 over worklists short enough to drop
    probed chunks, which both count alike."""
    ref, port, xq = built
    br, xb = ref_inputs(ref)
    nprobe, msteps = 8, 6
    Dj, Sj, lossy, nd = ref_result(ref_mod._fused_search_rerank_dyn(
        jnp.asarray(xq), br["centroids_g"], br["cn2g"], br["cbt"],
        br["codesT"], br["n2s"], br["lid"], br["slot_map_dev"], xb,
        br["chunk_first"], br["chunk_last"], br["cgroup"], K, KC, QT, CT,
        nprobe, msteps, br["max_span"], interpret=True,
    ))
    bt, xbt, _ = port_inputs(port)
    Dt, St, ndt = port_result(port_mod._fused_search_rerank_dyn(
        torch.from_numpy(xq), bt, xbt, K, KC, QT, CT, nprobe, msteps
    ))
    assert ndt == nd > 0
    cmap = port_mod._dyn_inputs(torch.from_numpy(xq), bt, nprobe, QT, msteps)[3]
    agree(Dj, Sj, lossy, Dt, St, "K5", full_rows(port, xq, nprobe, cmap[0]))


@pytest.mark.parametrize("nprobe", [0, 4])
def test_recon_scan_rerank_matches_reference(built, nprobe):
    """_fused_search_rerank_recon: K2 over the decoded store, with the
    strict mask at nprobe > 0."""
    ref, port, xq = built
    br, xb = ref_inputs(ref)
    Dj, Sj, lossy, _ = ref_result(ref_mod._fused_search_rerank_recon(
        jnp.asarray(xq), br["centroids_g"], br["cn2g"], br["yT"], br["n2s"],
        br["lid"], br["slot_map_dev"], xb, K, KC, QT, CT, nprobe,
        xb_n2=ref.refine_index._norms, rr_prec="high", interpret=True,
    ))
    bt, xbt, n2t = port_inputs(port)
    Dt, St, _ = port_result(port_mod._fused_search_rerank_recon(
        torch.from_numpy(xq), bt, xbt, n2t, K, KC, QT, CT, nprobe
    ))
    agree(Dj, Sj, lossy, Dt, St, f"K2 nprobe={nprobe}",
          full_rows(port, xq, nprobe))


def test_strict_recon_dyn_matches_reference(built):
    """_fused_search_rerank_recon_dyn with strict probing: K1 penalized."""
    ref, port, xq = built
    br, xb = ref_inputs(ref)
    nprobe, msteps = 4, br["nchunks"]
    Dj, Sj, lossy, nd = ref_result(ref_mod._fused_search_rerank_recon_dyn(
        jnp.asarray(xq), br["centroids_g"], br["cn2g"], br["yT"], br["n2s"],
        br["lid"], br["slot_map_dev"], xb, br["chunk_first"],
        br["chunk_last"], br["cgroup"], K, KC, QT, CT, nprobe, msteps,
        br["max_span"], strict_probe=True, xb_n2=ref.refine_index._norms,
        rr_prec="high", interpret=True,
    ))
    bt, xbt, n2t = port_inputs(port)
    Dt, St, ndt = port_result(port_mod._fused_search_rerank_recon_dyn(
        torch.from_numpy(xq), bt, xbt, n2t, K, KC, QT, CT, nprobe, msteps, True
    ))
    assert ndt == nd == 0
    full = full_rows(port, xq, nprobe)
    agree(Dj, Sj, lossy, Dt, St, "K1 penalized", full)
    # strict: where the query's nearest lists hold kc slots, every result
    # lies in them (with fewer, the re-rank may keep a masked candidate)
    cent = port.base_index.quantizer.vectors()
    listnos = port.base_index._listnos_host
    near = np.argsort(((xq[:, None] - cent[None]) ** 2).sum(-1), 1)[:, :nprobe]
    assert all(np.isin(listnos[St[r]], near[r]).all() for r in np.where(full)[0])


@pytest.mark.parametrize("nprobe", [0, 1])
def test_unrefined_search_matches_reference_k4_path(built, nprobe):
    """IndexIVFPQFastScan.search against faiss_tpu's K4 path, assembled as
    _search_big_batch assembles it (on the CPU faiss_tpu's own search takes
    its XLA fallback, whose select is approximate)."""
    ref, port, xq = built
    base = ref.base_index
    br = base._build_brute()
    xj = jnp.asarray(xq)
    cm2 = ref_mod._masked_coarse_bias(xj, br["centroids_g"], br["cn2g"], nprobe)
    v, s, ev = map(np.asarray, ivfpq_fused_pallas(
        cm2, jnp.asarray(-2.0 * (xj @ br["cbt"]), jnp.bfloat16), br["codesT"],
        br["n2s"], br["lid"], qt=QT, ct=CT, interpret=True,
    ))
    qn2 = (xq**2).sum(1)
    d = v[:, :K] + qn2[:, None]
    slots = np.where(s[:, :K] >= 0, br["slot_map"][np.maximum(s[:, :K], 0)], -1)
    if nprobe:
        slots = np.where(d < 5e8, slots, -1)
        d = np.where(d < 5e8, d, np.inf)
    Dj = np.maximum(d, 0.0)
    Ij = np.where(slots >= 0, base._ids_host[np.maximum(slots, 0)], -1)
    port.base_index.nprobe = nprobe
    Dt, It = port.base_index.search(xq, K)
    assert Dt.dtype == np.float32 and It.dtype == np.int64
    e = ev.min(1) >= v[:, K - 1]
    assert e.mean() > 0.5, e.mean()
    n2max = np.asarray(br["n2s"])[np.isfinite(np.asarray(br["n2s"]))].max()
    tol = 1e-4 * (qn2 + n2max)
    np.testing.assert_array_equal(Ij[e] == -1, It[e] == -1)
    fin = np.isfinite(Dj[e])
    assert ids_agree_tie_aware(np.where(fin, Dj[e], 1e30), Ij[e],
                               np.where(fin, Dt[e], 1e30), It[e], tol[e]).all()
    np.testing.assert_allclose(Dt[e][fin], Dj[e][fin], rtol=0,
                               atol=tol[e].max())
    if nprobe:
        assert (It == -1).any()  # a probed list shorter than k


class Taken(Exception):
    pass


def spy(name):
    def f(*args, **kwargs):
        raise Taken(name)
    return f


BRANCH = {
    "strict_store": "_fused_search_rerank_recon",  # 4 > 0.08 * nchunks
    "strict_store_dyn": "_fused_search_rerank_recon_dyn",
    "soft_store_dyn": "_fused_search_rerank_recon_dyn",
    "soft_store_long": "_fused_search_rerank_recon",  # 12 > 0.7 * nchunks
    "exhaustive": "_fused_search_rerank_recon",
    "nprobe_nlist": "_fused_search_rerank_recon",
    "no_store_soft_dyn": "_fused_search_rerank_dyn",
    "no_store_strict": "_fused_search_rerank",
    "no_store_exhaustive": "_fused_search_rerank",
}


@pytest.mark.parametrize("case", sorted(BRANCH))
def test_refined_branch_matches_reference(built, case, monkeypatch):
    """_sbbr_submit takes faiss_tpu's branch at the same settings."""
    ref, port, xq = built
    nprobe = {"exhaustive": 0, "no_store_exhaustive": 0,
              "nprobe_nlist": NLIST}.get(case, 1)
    for index, mod in ((ref, ref_mod), (port, port_mod)):
        base = index.base_index
        for name in FUSED:
            monkeypatch.setattr(mod, name, spy(name))
        monkeypatch.setattr(base, "nprobe", nprobe)
        monkeypatch.setattr(base, "strict_probe", case.startswith(
            ("strict", "exhaustive", "nprobe", "no_store_strict")))
        monkeypatch.setattr(base, "dyn_msteps", 12 if "long" in case else 4)
        if case.endswith("_dyn") and "strict" in case:
            monkeypatch.setattr(base, "dyn_engage_frac", 0.7)
        if case.startswith("no_store"):
            monkeypatch.setattr(base, "recon_scan_max_bytes", 0)
            monkeypatch.setattr(base, "_brute", None)
    with pytest.raises(Taken) as tj:
        ref.search(xq, K)
    with pytest.raises(Taken) as tt:
        port.search(xq, K)
    assert str(tt.value) == str(tj.value) == BRANCH[case]
    has_store = port.base_index._brute["yT"] is not None
    assert has_store != case.startswith("no_store")


def test_unrefined_branch_matches_reference(built, monkeypatch):
    """search takes the big-batch scan from big_batch_threshold queries on,
    as faiss_tpu does; below it both scan per probe (exact: ids agree up to
    ties within 1e-5 of the row's last distance, distances within 1e-4)."""
    ref, port, xq = built
    for index in (ref.base_index, port.base_index):
        monkeypatch.setattr(index, "_search_big_batch", spy("big_batch"))
        with pytest.raises(Taken):
            index.search(xq, K)
    n = port.base_index.big_batch_threshold - 1
    for index in (ref.base_index, port.base_index):
        monkeypatch.setattr(index, "nprobe", 4)
    Dj, Ij = ref.base_index.search(xq[:n], K)  # both: the per-probe scan
    Dt, It = port.base_index.search(xq[:n], K)
    assert ids_agree_tie_aware(Dj, Ij, Dt, It, 1e-5 * np.abs(Dj[:, -1])).all()
    np.testing.assert_allclose(Dt, Dj, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("case", ["strict_masked_recon", "soft_no_store_dyn"])
def test_refined_search_matches_reference(built, case, monkeypatch):
    """The slice end to end through IndexRefineFlat.search: the default
    strict probing over the decoded store (K2 masked), and soft probing
    without a decoded store (K5). faiss_tpu's lossy flags are read where its
    collect unpacks them."""
    ref, port, xq = built
    flags = []
    unpack_results = ref_mod._unpack_results

    def unpack(packed, k):
        out = unpack_results(packed, k)
        flags.append(out[2])
        return out

    monkeypatch.setattr(ref_mod, "_unpack_results", unpack)
    nprobe, msteps = 8, int(0.7 * port.base_index._brute["nchunks"])
    for base in (ref.base_index, port.base_index):
        monkeypatch.setattr(base, "nprobe", nprobe)
        if case == "soft_no_store_dyn":
            monkeypatch.setattr(base, "strict_probe", False)
            monkeypatch.setattr(base, "dyn_msteps", msteps)
            monkeypatch.setattr(base, "recon_scan_max_bytes", 0)
            monkeypatch.setattr(base, "_brute", None)
    Dj, Ij = ref.search(xq, K)
    Dt, It = port.search(xq, K)
    assert Dt.dtype == np.float32 and It.dtype == np.int64
    chunks = None
    if case == "soft_no_store_dyn":
        chunks = port_mod._dyn_inputs(
            torch.from_numpy(xq), port.base_index._brute, nprobe, QT, msteps
        )[3][0]
    agree(Dj, Ij, np.concatenate(flags), Dt, It, case,
          full_rows(port, xq, nprobe, chunks))
