"""Port parity for IVF-Flat search: faiss_tpu_torch.IndexIVFFlat against
faiss_tpu.IndexIVFFlat, both serving the state of one trained faiss_tpu
index (faiss_tpu_torch.convert.ivfflat_from_arrays), faiss_tpu with its
Pallas kernels in interpret mode (``fused_interpret``). The shapes are
faiss_tpu's own IVF-Flat test's (tests/test_ivf_flat.py:235): d=16, 256
lists, 3000 vectors, 128 queries, chunks of 256 slots, qt=128, kc=42 at
k=10.

Held against faiss_tpu: the per-probe scan (with -1 probes and the
``max_codes`` cut) over an equal padded layout, the big-batch layout with
its store planes bitwise equal, the big-batch search functions with the lo
plane (K2 masked, K1 penalized and soft), the branch ``_sbbf_submit`` takes,
and whole searches on every branch. The port alone: search_submit/collect,
search_preassigned, reconstruction, and a strict big-batch search that is
exact within the probed lists.

Tolerances. Distances are exact float32 on both sides, summed in another
order: rtol 1e-5, and atol 2e-5, which is 1e-6 (|q|^2 + |y|^2) at the
data's largest norms (the norm expansion's float32 error scales with the
norms, not with the distance). Ids agree up to ties within the larger of
that atol and 1e-5 of the row's largest distance. faiss_tpu's kernels
select approximately and flag the rows where a candidate may have been
lost (its search replays them); those rows are left out of the big-batch
comparisons. With strict probing a row
whose probed lists hold fewer than kc slots also re-ranks masked
candidates, whose keys near 1e9 rank at float32's resolution there (64),
arbitrarily on either side: strict comparisons keep the rows whose probed
lists hold kc slots."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import faiss_tpu as ftj
import faiss_tpu_torch as ftt
from faiss_tpu.models import ivf_pq as ref_pq
from faiss_tpu.ops.ivf_ops import ivf_flat_scan as ref_scan
from faiss_tpu_torch.convert import ivfflat_from_arrays
from faiss_tpu_torch.models import ivf_flat as port_mod
from faiss_tpu_torch.models import ivf_pq as port_pq
from faiss_tpu_torch.ops.ivf_ops import ivf_flat_scan
from faiss_tpu_torch.utils.evaluation import ids_agree_tie_aware
from torch_threads import one_torch_thread  # noqa: F401

D, NLIST, NB, NQ, CT, K, QT = 16, 256, 3000, 128, 256, 10, 128
KC = max(2 * K, K + 32)
# 1e-6 * (|q|^2 + |y|^2) at the mixture's largest norms (~9 each): the float32
# norm expansion's error scales with the norms, not with the distance
ATOL = 2e-5
FUSED = ("_fused_search_rerank_recon", "_fused_search_rerank_recon_dyn")


def mixture(rs, n, ncent=64, d=D):
    """Small Gaussian mixture in the shape of bench.py's generator."""
    cent = np.random.RandomState(99).rand(ncent, d).astype(np.float32)
    scales = (1.0 / (np.arange(d) + 1.0)).astype(np.float32) * 0.4
    a = rs.randint(ncent, size=n)
    return (cent[a] + rs.randn(n, d).astype(np.float32) * scales).astype(np.float32)


@pytest.fixture(scope="module")
def built():
    rs = np.random.RandomState(23)
    xb, xq = mixture(rs, NB), mixture(rs, NQ)
    ref = ftj.IndexIVFFlat(None, D, NLIST)
    ref.FUSED_CT = CT
    ref.cp.niter = 4
    ref.cp.min_points_per_centroid = 1
    ref.fused_interpret = True
    ref.train(xb)
    ref.add(xb)
    port = ivfflat_from_arrays(ref.quantizer.vectors(), ref._codes_host,
                               ref._listnos_host, ref._ids_host, device="cpu")
    port.FUSED_CT = CT
    bj, bt = ref._build_brute(), port._build_brute()
    assert bj["nchunks"] == bt["nchunks"] >= 8
    return ref, port, xb, xq


def agree(Dj, Ij, Dt, It, rows, what, atol=ATOL):
    """Port (Dt, It) against faiss_tpu (Dj, Ij) on ``rows``."""
    assert rows.mean() > 0.5, (what, rows.mean())
    assert Dt.dtype == np.float32 and It.dtype == np.int64
    np.testing.assert_array_equal(Ij[rows] == -1, It[rows] == -1)
    fin = np.isfinite(Dj[rows])
    tol = np.maximum(1e-5 * np.where(fin, Dj[rows], 0).max(1), atol)
    ok = ids_agree_tie_aware(np.where(fin, Dj[rows], 1e30), Ij[rows],
                             np.where(fin, Dt[rows], 1e30), It[rows], tol)
    assert ok.all(), (what, np.where(rows)[0][~ok])
    same = Ij[rows] == It[rows]
    np.testing.assert_allclose(Dt[rows][same], Dj[rows][same], rtol=1e-5, atol=atol)


def nearest_lists(port, xq, nprobe):
    cent = port.quantizer.vectors()
    return np.argsort(((xq[:, None] - cent[None]) ** 2).sum(-1), 1)[:, :nprobe]


def full_rows(port, xq, nprobe):
    """Rows whose nprobe nearest lists hold at least KC slots."""
    sizes = np.bincount(port._listnos_host, minlength=NLIST)
    return sizes[nearest_lists(port, xq, nprobe)].sum(1) >= KC


def in_probed_lists(port, xq, I, nprobe):
    """Per row, True where every result lies in the nprobe nearest lists."""
    slot_of = np.argsort(port._ids_host)  # ids are 0..n-1 here
    lists = np.where(I >= 0, port._listnos_host[slot_of[np.maximum(I, 0)]], -1)
    near = nearest_lists(port, xq, nprobe)
    return np.array([np.isin(lists[r][lists[r] >= 0], near[r]).all()
                     for r in range(len(I))])


def test_per_probe_scan_matches_reference(built):
    """ivf_flat_scan over the padded layout (equal to faiss_tpu's) with -1
    probes, and the max_codes cut of search."""
    ref, port, _, xq = built
    dj, dt = ref._build_device(), port._build_device()
    for key in ("slot_ids", "lengths", "codes"):
        np.testing.assert_array_equal(np.asarray(dj[key]), dt[key].numpy(), key)
    np.testing.assert_allclose(np.asarray(dj["code_norms"]),
                               dt["code_norms"].numpy(), rtol=1e-6)
    probes = port._coarse_search(torch.from_numpy(xq), 6)[1].numpy()
    probes[::3, 2:] = -1  # unused probe slots
    probes[1::7, :] = -1  # rows that probe nothing
    Dj, Sj = map(np.asarray, ref_scan(
        jnp.asarray(xq), jnp.asarray(probes.astype(np.int32)), dj["codes"],
        dj["slot_ids"], dj["lengths"], K, code_norms=dj["code_norms"],
    ))
    Dt, St = ivf_flat_scan(torch.from_numpy(xq), torch.from_numpy(probes),
                           dt["codes"], dt["slot_ids"], dt["lengths"], K,
                           code_norms=dt["code_norms"])
    agree(Dj, Sj.astype(np.int64), Dt.numpy(), St.numpy().astype(np.int64),
          np.ones(NQ, bool), "ivf_flat_scan")
    assert (St.numpy()[1::7] == -1).all()
    # max_codes: probing stops once the lists probed so far hold 20 codes
    Dj, Ij = ref.search(xq, K, params=ftj.SearchParametersIVF(nprobe=8, max_codes=20))
    Dt, It = port.search(xq, K, params=ftt.SearchParametersIVF(nprobe=8, max_codes=20))
    agree(Dj, Ij, Dt, It, np.ones(NQ, bool), "max_codes")
    # all 8 lists (the big-batch path here: its re-rank sums in another
    # order, so the k-th distances compare within ATOL)
    Dp, _ = port.search(xq, K, params=ftt.SearchParametersIVF(nprobe=8))
    assert (Dp[:, -1] <= Dt[:, -1] + ATOL).all()
    assert (Dp[:, -1] < Dt[:, -1] - ATOL).any()


@pytest.mark.parametrize("hilo", [True, False])
def test_big_batch_layout_matches_reference(built, hilo, monkeypatch):
    """_build_brute: the layout's metadata equal, the store planes bitwise
    equal (hi/lo, and one plane with brute_hilo = False), the norms exact
    float32 to 1e-6, the re-rank store the vectors."""
    ref, port, _, _ = built
    for index in (ref, port):
        monkeypatch.setattr(index, "brute_hilo", hilo)
        monkeypatch.setattr(index, "_brute", None)
    bj, bt = ref._build_brute(), port._build_brute()
    for key in ("slot_map", "nchunks"):
        np.testing.assert_array_equal(bj[key], bt[key])
    for key in ("slot_map_dev", "centroids_g", "cn2g", "chunk_first",
                "chunk_last", "cgroup", "lid", "xb"):
        np.testing.assert_array_equal(np.asarray(bj[key]), bt[key].numpy(), key)
    n2j = np.asarray(bj["n2s"])
    np.testing.assert_array_equal(np.isinf(n2j), np.isinf(bt["n2s"].numpy()))
    np.testing.assert_allclose(n2j, bt["n2s"].numpy(), rtol=1e-6)

    def bits(a):
        return np.asarray(a.view(torch.int16) if torch.is_tensor(a)
                          else a.view(jnp.int16))

    np.testing.assert_array_equal(bits(bj["yT"]), bits(bt["yT"]))
    if hilo:
        np.testing.assert_array_equal(bits(bj["yT_lo"]), bits(bt["yT_lo"]))
        assert bt["yT_lo"].float().abs().max() > 0  # not folded away
        # hi + lo holds every vector to 2^-16 of its largest entry
        sm = bt["slot_map_dev"]
        y = (bt["yT"].float() + bt["yT_lo"].float())[:D, sm >= 0].T
        x = bt["xb"][sm[sm >= 0]]
        assert ((y - x).abs() <= x.abs().max(1, keepdim=True).values * 2.0**-16).all()
    else:
        assert bj["yT_lo"] is None and bt["yT_lo"] is None


def ref_unpacked(packed):
    Dj, Sj, lossy, nd = ref_pq._unpack_results(packed, K)
    return Dj, Sj.astype(np.int64), np.asarray(lossy), int(nd)


@pytest.mark.parametrize("case", ["k2_masked", "k1_strict", "k1_soft"])
def test_search_functions_match_reference(built, case):
    """_fused_search_rerank_recon (K2 masked) and _fused_search_rerank_recon_dyn
    (K1 penalized or soft) with the lo plane, on the same sub-batch."""
    ref, port, _, xq = built
    bj, bt = ref._build_brute(), port._build_brute()
    nprobe, msteps = 8, bt["nchunks"]
    common = (bj["centroids_g"], bj["cn2g"], bj["yT"], bj["n2s"], bj["lid"],
              bj["slot_map_dev"], bj["xb"])
    # the arguments faiss_tpu's _sbbf_submit passes (ivf.py:883-934), so that
    # test_search_matches_reference reuses these interpret-mode compiles
    kw = dict(qdepth=ref.refined_qdepth, carry=None, yT_lo=bj["yT_lo"],
              pack16=False, interpret=True)
    if case == "k2_masked":
        Dj, Sj, lossy, _ = ref_unpacked(ref_pq._fused_search_rerank_recon(
            jnp.asarray(xq), *common, K, KC, QT, CT, nprobe,
            lossy_rank=min(K, KC - 1), fmax=ref.fused_fmax,
            sort_rot=ref.fused_sort_rot, cheap_after=ref.fused_cheap_after, **kw,
        ))
        Dt, St, nd = port_pq._fused_search_rerank_recon(
            torch.from_numpy(xq), bt, bt["xb"], None, K, KC, QT, CT, nprobe)
    else:
        strict = case == "k1_strict"
        Dj, Sj, lossy, ndj = ref_unpacked(ref_pq._fused_search_rerank_recon_dyn(
            jnp.asarray(xq), *common, bj["chunk_first"], bj["chunk_last"],
            bj["cgroup"], K, KC, QT, CT, nprobe, msteps, bj["max_span"],
            strict_probe=strict, **kw,
        ))
        Dt, St, nd = port_pq._fused_search_rerank_recon_dyn(
            torch.from_numpy(xq), bt, bt["xb"], None, K, KC, QT, CT, nprobe,
            msteps, strict)
        assert int(nd) == ndj == 0
    rows = ~lossy
    if case != "k1_soft":
        rows &= full_rows(port, xq, nprobe)
        assert in_probed_lists(port, xq, St.numpy(), nprobe)[rows].all()
    agree(Dj, Sj, Dt.numpy(), St.numpy(), rows, case)


class Taken(Exception):
    pass


def spy(name, kc_at=0, nprobe_at=0):
    def f(*args, **kwargs):
        raise Taken((name, args[kc_at], args[nprobe_at]))
    return f


# positions of (kc, nprobe) among the search functions' arguments
SPY_AT = {
    "ref": {FUSED[0]: (9, 12), FUSED[1]: (12, 15)},
    "port": {FUSED[0]: (5, 8), FUSED[1]: (5, 8)},
}


@pytest.mark.parametrize("nprobe", [1, 8, NLIST])
@pytest.mark.parametrize("mode", ["strict", "soft", "strict_frac_0.7"])
def test_branch_matches_reference(built, nprobe, mode, monkeypatch):
    """_sbbf_submit takes faiss_tpu's branch, kc and nprobe (0 at nlist) at
    the same settings, with a worklist of 4 chunks: strict probing engages
    the dynamic-chunk scan up to 0.08 of the chunks (so not here), soft
    probing up to 0.7, and so does strict probing at dyn_engage_frac 0.7."""
    ref, port, _, xq = built
    for index, mod, at in ((ref, ref_pq, SPY_AT["ref"]),
                           (port, port_mod, SPY_AT["port"])):
        for name in FUSED:
            monkeypatch.setattr(mod, name, spy(name, *at[name]))
        monkeypatch.setattr(index, "nprobe", nprobe)
        monkeypatch.setattr(index, "dyn_msteps", 4)
        monkeypatch.setattr(index, "strict_probe", mode != "soft")
        if mode == "strict_frac_0.7":
            monkeypatch.setattr(index, "dyn_engage_frac", 0.7)
    with pytest.raises(Taken) as tj:
        ref.search(xq, K)
    with pytest.raises(Taken) as tt:
        port.search(xq, K)
    assert tt.value.args == tj.value.args
    dyn = nprobe < NLIST and mode != "strict"
    assert tt.value.args[0] == (FUSED[1] if dyn else FUSED[0], KC,
                                nprobe if nprobe < NLIST else 0)


@pytest.mark.parametrize("nprobe", [1, 8])
def test_adaptive_worklist_matches_reference(built, nprobe):
    """The per-tile probed-chunk unions that size the adaptive worklist
    equal faiss_tpu's (_dyn_probe_counts), and so does the bucket."""
    ref, port, _, xq = built
    bj, bt = ref._build_brute(), port._build_brute()
    cj = np.asarray(ref_pq._dyn_probe_counts(
        jnp.asarray(xq), bj["centroids_g"], bj["cn2g"], bj["chunk_first"],
        bj["chunk_last"], nprobe, 64, bj["max_span"], bj["nchunks"],
    ))
    ct_ = port_pq._dyn_probe_bitmap(
        torch.from_numpy(xq), bt["centroids_g"], bt["cn2g"], bt["chunk_first"],
        bt["chunk_last"], nprobe, 64, bt["nchunks"],
    )[3].sum(1).numpy()
    np.testing.assert_array_equal(cj, ct_)
    ref._dyn_bucket = port._dyn_bucket = None
    assert ref._dyn_bucket_for(jnp.asarray(xq), bj, nprobe, QT) == \
        port._dyn_bucket_for(torch.from_numpy(xq), bt, nprobe, QT)


@pytest.mark.parametrize("case", ["small_batch", "large_k"])
def test_per_probe_fallback_matches_reference(built, case, monkeypatch):
    """nq below big_batch_threshold and k > 64 scan by probe on both
    sides, with equal results (-1 where the probed lists hold < k)."""
    ref, port, _, xq = built
    for index in (ref, port):
        monkeypatch.setattr(index, "_sbbf_submit", spy("big_batch"))
        monkeypatch.setattr(index, "nprobe", 4)
    x, k = (xq[:100], K) if case == "small_batch" else (xq, 80)
    Dj, Ij = ref.search(x, k)
    Dt, It = port.search(x, k)
    agree(Dj, Ij, Dt, It, np.ones(len(x), bool), case)
    if case == "large_k":
        assert (It == -1).any()
        h = port.search_submit(x, k)
        assert h[0] == "eager"
        np.testing.assert_array_equal(port.search_collect(h)[1], It)


@pytest.mark.parametrize(
    "case", ["k2_masked", "k1_strict", "k1_soft", "nprobe_nlist", "k1_soft_tail"]
)
def test_search_matches_reference(built, case, monkeypatch):
    """Whole searches through IndexIVFFlat.search on each big-batch branch:
    the strict default at nprobe=8 (K2 masked), strict and soft with every
    worklist engaged (K1 penalized, K1 soft), nprobe = nlist (K2 unmasked,
    exact k-NN), and soft in sub-batches of 120 queries (two sub-batches,
    the second 8 queries padded to 128). faiss_tpu's lossy flags are read
    where its collect unpacks them."""
    ref, port, xb, xq = built
    batch = 120 if case == "k1_soft_tail" else port.pipeline_batch
    flags = []
    unpack_results = ref_pq._unpack_results

    def unpack(packed, k):
        out = unpack_results(packed, k)
        flags.append(out[2])
        return out

    monkeypatch.setattr(ref_pq, "_unpack_results", unpack)
    nprobe = NLIST if case == "nprobe_nlist" else 8
    taken = []
    for index, mod in ((ref, ref_pq), (port, port_mod)):
        monkeypatch.setattr(index, "nprobe", nprobe)
        monkeypatch.setattr(index, "pipeline_batch", batch)
        if case.startswith("k1"):
            monkeypatch.setattr(index, "strict_probe", case == "k1_strict")
            monkeypatch.setattr(index, "dyn_engage_frac", 1.0)
            monkeypatch.setattr(index, "soft_engage_frac", 1.0)
        for name in FUSED:
            fn = getattr(mod, name)
            monkeypatch.setattr(mod, name, lambda *a, _f=fn, _n=name, **kw: (
                taken.append(_n), _f(*a, **kw))[1])
    Dj, Ij = ref.search(xq, K)
    Dt, It = port.search(xq, K)
    dyn = case.startswith("k1")
    reals = [real for _, _, real in ftt.base.query_buckets(NQ, batch)]
    assert taken == [FUSED[dyn]] * len(reals) * 2
    rows = ~np.concatenate([f[:real] for f, real in zip(flags, reals)])
    if case in ("k2_masked", "k1_strict"):
        rows &= full_rows(port, xq, nprobe)
        assert in_probed_lists(port, xq, It, nprobe)[rows].all()
    agree(Dj, Ij, Dt, It, rows, case)
    if case == "nprobe_nlist":  # exact k-NN: the float64 brute force
        d64 = ((xq[:, None].astype(np.float64) - xb[None]) ** 2).sum(-1)
        want = np.sort(d64, 1)[:, :K]
        np.testing.assert_allclose(Dt, want, rtol=1e-5, atol=1e-5)


def test_submit_collect_preassigned_and_reconstruct(built, monkeypatch):
    """The port's other entry points: search_submit/search_collect with two
    handles in flight equal search; search_preassigned with the coarse
    assignment equals the per-probe search; reconstruct_n, reconstruct,
    sa_encode/sa_decode round-trip; the list sizes equal faiss_tpu's."""
    ref, port, xb, xq = built
    monkeypatch.setattr(port, "nprobe", 8)
    D0, I0 = port.search(xq, K)
    h1 = port.search_submit(xq, K)
    h2 = port.search_submit(xq[:64], K)  # below the threshold: eager
    assert (h1[0], h2[0]) == ("fused", "eager")
    D2, I2 = port.search_collect(h2)
    D1, I1 = port.search_collect(h1)
    np.testing.assert_array_equal(I1, I0)
    np.testing.assert_array_equal(D1, D0)
    dis, probes = port._coarse_search(torch.from_numpy(xq), 8)
    Dp, Ip = port.search_preassigned(xq, K, probes.numpy(), dis.numpy())
    Dq, Iq = port.search(xq[:100], K)
    np.testing.assert_array_equal(Ip[:100], Iq)
    np.testing.assert_array_equal(I2, Iq[:64])
    Dr, Ir = ref.search_preassigned(xq, K, probes.numpy(), dis.numpy())
    agree(Dr, Ir, Dp, Ip, np.ones(NQ, bool), "search_preassigned")
    # strict big batch = exact within the probed lists, on full rows
    full = full_rows(port, xq, 8)
    agree(Dp, Ip, D0, I0, full, "big batch vs by probe")
    np.testing.assert_array_equal(port.reconstruct_n(0, NB), xb)
    np.testing.assert_array_equal(port.reconstruct(17), xb[17])
    codes = port.sa_encode(xb[:5])
    assert codes.shape == (5, port.sa_code_size()) == (5, 4 * D)
    np.testing.assert_array_equal(port.sa_decode(codes), xb[:5])
    for lst in (0, 7, NLIST - 1):
        assert port.get_list_size(lst) == ref.get_list_size(lst)
        np.testing.assert_array_equal(port.invlists_ids(lst), ref.invlists_ids(lst))


def test_port_alone_train_add_and_invalidation():
    """The port's own train/add on the CPU, without faiss_tpu: add_with_ids
    keeps the ids, a second add drops both device layouts, the strict big
    batch agrees with the per-probe scan where the probed lists hold kc
    slots, and an index with nothing added returns -1."""
    rs = np.random.RandomState(5)
    xb, xq = mixture(rs, 2000), mixture(rs, 200)
    index = ftt.IndexIVFFlat(None, D, 32, device="cpu")
    index.FUSED_CT = 128
    index.cp.niter = 4
    index.cp.min_points_per_centroid = 1
    index.train(xb)
    D0, I0 = index.search(xq, K)
    assert (I0 == -1).all() and np.isinf(D0).all()
    index.add_with_ids(xb[:1500], np.arange(1500) + 10_000)
    index.nprobe = 2
    index.search(xq, K)
    assert index._brute is not None
    index.search(xq[:10], K)
    assert index._device is not None
    index.add_with_ids(xb[1500:], np.arange(1500, 2000) + 10_000)
    assert index._brute is None and index._device is None
    assert index.ntotal == 2000
    Db, Ib = index.search(xq, K)
    index.big_batch_threshold = 0
    Dp, Ip = index.search(xq, K)
    assert (Ib >= 10_000).all()
    agree(Dp, Ip, Db, Ib, full_rows(index, xq, 2), "port alone")
    np.testing.assert_array_equal(index.reconstruct(10_005), xb[5])
