"""Kernels K4 and K5 and the penalized mode of K1 and the masked mode of K2
(faiss_tpu_torch.ops.fused_knn): their plain PyTorch versions against
faiss_tpu's Pallas kernels (ivfpq_fused_pallas, ivfpq_fused_dyn_pallas,
ivf_recon_fused_dyn_pallas(penalized=True), ivf_recon_fused_pallas with a
mask; interpret mode) on the same numpy inputs, K4 against an exhaustive
float64 select, and the wrappers' input and device checks. The CUDA kernels
themselves are compared with the plain versions on the card by
chip_smoke.py.

The layout has 200 lists in G = 2 groups of 128 list columns and a trailing
all-+inf PAD chunk, so the static chunk -> group map clamps it to the last
group. Lists hold ~7 slots each: a query that probes one or two lists has
fewer than 128 probed slots, and the rest of its top-128 are masked slots;
other queries probe 40 lists (~300 slots).

Tolerances. faiss_tpu's kernels select approximately; on the rows whose
eviction floor does not flag a loss among the first KC keys, the keys below
5e8 (the unmasked ones) must agree within 1e-4 of the magnitude of their
terms: K4 and K5 add the coarse bias through bf16 hi + lo parts (~2^-16 of
|bias|), K1 and K2 take the query as bf16 hi + lo; the port adds both in
float32. Masked keys differ by design (faiss_tpu rounds the 1e9 mask to bf16
in K1 and K2, and to hi + lo in K4 and K5), so they are compared only as a
count: both must put the same number of unmasked keys first."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faiss_tpu.models.ivf_pq import pack_invlists_grouped
from faiss_tpu.ops.pallas_knn import (
    ivf_recon_fused_dyn_pallas,
    ivf_recon_fused_pallas,
    ivfpq_fused_dyn_pallas,
    ivfpq_fused_pallas,
)
from faiss_tpu_torch.ops.fused_knn import (
    ivf_recon_fused,
    ivf_recon_fused_dyn,
    ivfpq_fused,
    ivfpq_fused_dyn,
    ivfpq_fused_dyn_ref,
    ivfpq_fused_ref,
)
from faiss_tpu_torch.utils.evaluation import ids_agree_tie_aware
from torch_threads import one_torch_thread  # noqa: F401

NQ, QT, M, KSUB, NLIST, CT, NB, D, KC = 128, 64, 4, 16, 200, 256, 1500, 16, 40
MASK = 1e9


def bf16(a):
    """float32 values rounded to bf16: (numpy float32, torch bfloat16)."""
    t = torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(torch.bfloat16)
    return t.float().numpy(), t


@pytest.fixture(scope="module")
def layout():
    rs = np.random.RandomState(0)
    listnos = rs.randint(NLIST, size=NB).astype(np.int32)
    g = pack_invlists_grouped(listnos, NLIST, CT)
    G, S = g["ngroups"], g["S"]
    assert G == 2
    Sp = S + CT  # + the PAD chunk
    pos, order, lp = g["pos"], g["order"], g["list_perm"]
    col_of = np.zeros(NLIST, np.int64)  # grouped column of each list
    col_of[lp[lp >= 0]] = np.where(lp >= 0)[0]
    slot_list = np.full(Sp, -1)
    slot_list[pos] = listnos[order]
    lid = np.zeros((1, Sp), np.int32)
    lid[0, :S] = g["lid"]
    # probed lists per query: 1, 2 or 40
    nprobe = rs.choice([1, 2, 40], size=NQ)
    probed = np.zeros((NQ, G * 128), bool)
    for q in range(NQ):
        probed[q, col_of[rs.choice(NLIST, nprobe[q], replace=False)]] = True
    cgroup = np.concatenate(
        [np.repeat(np.arange(G), g["cpg"]), [G - 1]]
    ).astype(np.int32)
    L = dict(g=g, S=Sp, lid=lid, probed=probed, cgroup=cgroup,
             slot_list=slot_list, col_of=col_of)
    # per tile a worklist: the ascending chunks of its probed lists, PAD after
    nchunks = Sp // CT
    L["cmap"] = np.full((NQ // QT, nchunks), nchunks - 1, np.int32)
    for t in range(NQ // QT):
        hit = slot_probed(L, slice(t * QT, (t + 1) * QT)).any(0)
        chunks = np.unique(np.where(hit)[0] // CT)
        L["cmap"][t, : len(chunks)] = chunks
    return L


def slot_probed(L, rows=slice(None)):
    """[nq, S] True where a slot lies in a list its query probed."""
    sl = L["slot_list"]
    out = L["probed"][rows][:, L["col_of"][np.maximum(sl, 0)]]
    return out & (sl >= 0)[None, :]


def compare(v, s, ev, keys, slots, tol, L, masked=True):
    """Port (keys, slots) against a Pallas kernel's (v, s, ev) on its rows
    that are exact among the first KC keys; unmasked keys only."""
    keys, slots = keys.numpy(), slots.numpy()
    np.testing.assert_array_equal(slots == -1, np.isinf(keys))
    e = ev.min(1) >= v[:, KC - 1]
    assert e.mean() > 0.5, e.mean()
    for r in np.where(e)[0]:
        nv = int((v[r, :KC] < 5e8).sum())
        nk = int((keys[r, :KC] < 5e8).sum())
        assert nv == nk, (r, nv, nk)
        if masked:  # the port's exact select keeps every probed slot it can
            assert (keys[r] < 5e8).sum() == min(128, slot_probed(L, [r]).sum())
        np.testing.assert_allclose(keys[r, :nk], v[r, :nk], rtol=0, atol=tol[r])
        assert ids_agree_tie_aware(v[None, r, :nk], s[None, r, :nk],
                                   keys[None, r, :nk], slots[None, r, :nk],
                                   tol[r]).all(), r


@pytest.fixture(scope="module")
def adc(layout):
    L = layout
    rs = np.random.RandomState(1)
    S = L["S"]
    luts, luts_t = bf16(rs.randn(NQ, M * KSUB))
    codesT = rs.randint(KSUB, size=(M, S)).astype(np.uint8)
    n2 = (rs.rand(1, S) * 2).astype(np.float32)
    n2[0, L["slot_list"] < 0] = np.inf
    cm2 = rs.randn(NQ, 2 * 128).astype(np.float32)
    biasg = np.where(L["probed"], cm2, np.float32(MASK)).astype(np.float32)
    # magnitude of a key's terms, per row
    mag = np.abs(cm2).max(1) + 2.0 + np.abs(luts).reshape(NQ, M, KSUB).max(2).sum(1)
    return dict(luts=luts, luts_t=luts_t, codesT=codesT, n2=n2, cm2=cm2,
                biasg=biasg, tol=1e-4 * mag)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("masked", [False, True])
def test_k4_plain_version_matches_pallas_and_exact_select(layout, adc, masked):
    L, A = layout, adc
    biasg = A["biasg"] if masked else A["cm2"]
    v, s, ev = map(np.asarray, ivfpq_fused_pallas(
        jnp.asarray(biasg), jnp.asarray(A["luts"], jnp.bfloat16),
        jnp.asarray(A["codesT"]), jnp.asarray(A["n2"]), jnp.asarray(L["lid"]),
        qt=QT, ct=CT, interpret=True,
    ))
    args = (t(biasg), A["luts_t"], t(A["codesT"]), t(A["n2"]), t(L["lid"]))
    keys, slots, floor = ivfpq_fused(*args, qt=QT, ct=CT)
    assert np.isinf(floor.numpy()).all()
    compare(v, s, ev, keys, slots, A["tol"], L, masked)
    # exact: the 128 smallest float64 keys of every row, groups clamped
    S = L["S"]
    grp = np.minimum(np.arange(S) // CT // L["g"]["cpg"], 1)
    cols = grp * 128 + L["lid"][0]
    lut = A["luts"].astype(np.float64).reshape(NQ, M, KSUB)
    ip = sum(lut[:, m, A["codesT"][m].astype(np.int64)] for m in range(M))
    full = A["n2"].astype(np.float64) + biasg[:, cols] + ip
    want = np.sort(full, 1)[:, :128]
    np.testing.assert_allclose(keys.numpy(), want, rtol=1e-6, atol=1e-5)
    fin = np.isfinite(want)
    kk = keys.numpy()
    assert np.allclose(np.take_along_axis(full, np.maximum(slots.numpy(), 0), 1)[fin],
                       kk[fin], rtol=1e-6, atol=1e-5)
    if masked:
        # a query with fewer than 128 probed slots keeps all of them first
        few = slot_probed(L).sum(1) < 128
        assert few.any()
        for r in np.where(few)[0]:
            n = slot_probed(L, [r]).sum()
            assert set(slots.numpy()[r, :n]) == set(np.where(slot_probed(L, [r])[0])[0])
            assert (kk[r, n:] >= 5e8).all()


def test_k5_plain_version_matches_pallas(layout, adc):
    L, A = layout, adc
    v, s, ev = map(np.asarray, ivfpq_fused_dyn_pallas(
        jnp.asarray(A["biasg"]), jnp.asarray(A["luts"], jnp.bfloat16),
        jnp.asarray(A["codesT"]), jnp.asarray(A["n2"]), jnp.asarray(L["lid"]),
        jnp.asarray(L["cmap"]), jnp.asarray(L["cgroup"]), qt=QT, ct=CT,
        interpret=True,
    ))
    args = (t(A["biasg"]), A["luts_t"], t(A["codesT"]), t(A["n2"]), t(L["lid"]),
            t(L["cmap"]), t(L["cgroup"]))
    keys, slots, floor = ivfpq_fused_dyn(*args, qt=QT, ct=CT)
    assert np.isinf(floor.numpy()).all()
    compare(v, s, ev, keys, slots, A["tol"], L)
    # the worklists cover every probed list: K5 finds what K4 finds
    k4 = ivfpq_fused_ref(*args[:5], qt=QT, ct=CT)
    kk, k4k = keys.numpy(), k4[0].numpy()
    unmasked = k4k < 5e8
    np.testing.assert_array_equal(kk < 5e8, unmasked)
    np.testing.assert_allclose(kk[unmasked], k4k[unmasked], rtol=1e-6)


@pytest.fixture(scope="module")
def recon(layout):
    L = layout
    rs = np.random.RandomState(2)
    S = L["S"]
    y = np.zeros((128, S), np.float32)
    y[:D] = rs.randn(D, S)
    y[:, L["slot_list"] < 0] = 0
    y, yT = bf16(y)
    n2 = (y.astype(np.float64) ** 2).sum(0, keepdims=True).astype(np.float32)
    n2[0, L["slot_list"] < 0] = np.inf
    xq = np.zeros((NQ, 128), np.float32)
    xq[:, :D] = rs.randn(NQ, D)
    penalty = np.where(L["probed"], 0.0, MASK).astype(np.float32)
    tol = 1e-4 * ((xq**2).sum(1) + n2[np.isfinite(n2)].max())
    return dict(xq=xq, yT=yT, n2=n2, penalty=penalty, tol=tol)


def test_k1_penalized_plain_version_matches_pallas(layout, recon):
    L, R = layout, recon
    v, s, ev = map(np.asarray, ivf_recon_fused_dyn_pallas(
        jnp.asarray(R["penalty"]), jnp.asarray(R["xq"]),
        jnp.asarray(R["yT"].view(torch.int16).numpy()).view(jnp.bfloat16),
        jnp.asarray(R["n2"]), jnp.asarray(L["lid"]), jnp.asarray(L["cmap"]),
        jnp.asarray(L["cgroup"]), qt=QT, ct=CT, qdepth=2, penalized=True,
        interpret=True,
    ))
    keys, slots, floor = ivf_recon_fused_dyn(
        t(R["xq"]), R["yT"], t(R["n2"]), t(L["cmap"]), QT, CT,
        biasg=t(R["penalty"]), lid=t(L["lid"]), cgroup=t(L["cgroup"]),
    )
    assert np.isinf(floor.numpy()).all()
    compare(v, s, ev, keys, slots, R["tol"], L)


def test_k2_masked_plain_version_matches_pallas(layout, recon):
    L, R = layout, recon
    v, s, ev = map(np.asarray, ivf_recon_fused_pallas(
        jnp.asarray(R["xq"]),
        jnp.asarray(R["yT"].view(torch.int16).numpy()).view(jnp.bfloat16),
        jnp.asarray(R["n2"]), jnp.asarray(L["lid"]), jnp.asarray(R["penalty"]),
        qt=QT, ct=CT, interpret=True,
    ))
    keys, slots, floor = ivf_recon_fused(
        t(R["xq"]), R["yT"], t(R["n2"]), qt=QT, ct=CT,
        biasg=t(R["penalty"]), lid=t(L["lid"]),
    )
    assert np.isinf(floor.numpy()).all()
    compare(v, s, ev, keys, slots, R["tol"], L)
    # the unmasked keys are those of the unmasked scan on the probed slots
    plain = ivf_recon_fused(t(R["xq"]), R["yT"], t(R["n2"]), qt=QT, ct=CT)
    assert (plain[0].numpy()[:, 0] <= keys.numpy()[:, 0]).all()


def test_wrappers_check_inputs_and_device():
    nq, S, ct = 16, 512, 128
    biasg = torch.zeros(nq, 256)
    luts = torch.zeros(nq, 64, dtype=torch.bfloat16)
    codesT = torch.zeros(4, S, dtype=torch.uint8)
    n2 = torch.zeros(1, S)
    lid = torch.zeros(1, S, dtype=torch.int32)
    cmap = torch.zeros(1, 2, dtype=torch.int32)
    cgroup = torch.zeros(S // ct, dtype=torch.int32)
    before = (ivfpq_fused.launches, ivfpq_fused_dyn.launches,
              ivf_recon_fused.launches, ivf_recon_fused_dyn.launches)
    ivfpq_fused(biasg, luts, codesT, n2, lid, qt=16, ct=ct)  # CPU: plain
    ivfpq_fused_dyn(biasg, luts, codesT, n2, lid, cmap, cgroup, qt=16, ct=ct)
    ivfpq_fused_dyn_ref(biasg, luts, codesT, n2, lid, cmap, cgroup, qt=16, ct=ct)
    with pytest.raises(ValueError, match="bfloat16"):
        ivfpq_fused(biasg, luts.float(), codesT, n2, lid, qt=16, ct=ct)
    with pytest.raises(ValueError, match="M \\* ksub"):
        ivfpq_fused(biasg, luts[:, :63], codesT, n2, lid, qt=16, ct=ct)
    with pytest.raises(ValueError, match="groups"):  # 4 chunks, 5 groups
        ivfpq_fused(torch.zeros(nq, 640), luts, codesT, n2, lid, qt=16, ct=ct)
    with pytest.raises(ValueError, match="lid"):
        ivfpq_fused(biasg, luts, codesT, n2, lid.long(), qt=16, ct=ct)
    with pytest.raises(ValueError, match="cgroup"):
        ivfpq_fused_dyn(biasg, luts, codesT, n2, lid, cmap, cgroup.long(),
                        qt=16, ct=ct)
    odd = torch.zeros(4 * S + 1, dtype=torch.uint8)[1:].view(4, S)
    with pytest.raises(ValueError, match="boundary"):  # an odd first column
        ivfpq_fused(biasg, luts, odd, n2, lid, qt=16, ct=ct)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        ivfpq_fused(*(x.to("meta") for x in (biasg, luts, codesT, n2, lid)),
                    qt=16, ct=ct)
    # the modes of K1 and K2 take their tensors together, K2's on a whole
    # store only (one plane, or hi/lo as IVF-Flat stages it)
    xq = torch.zeros(nq, 8)
    yT = torch.zeros(8, S, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="together"):
        ivf_recon_fused_dyn(xq, yT, n2, cmap, 16, ct, biasg=biasg, lid=lid)
    with pytest.raises(ValueError, match="together"):
        ivf_recon_fused(xq, yT, n2, qt=16, ct=ct, biasg=biasg)
    with pytest.raises(ValueError, match="column slice"):
        ivf_recon_fused(xq, torch.zeros(8, 2 * S, dtype=torch.bfloat16)[:, :S],
                        n2, qt=16, ct=ct, biasg=biasg, lid=lid)
    ivf_recon_fused(xq, yT, n2, yT, qt=16, ct=ct, biasg=biasg, lid=lid)
    ivf_recon_fused(xq, yT, n2, qt=16, ct=ct, biasg=biasg, lid=lid)
    ivf_recon_fused_dyn(xq, yT, n2, cmap, 16, ct, biasg=biasg, lid=lid,
                        cgroup=cgroup)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        ivf_recon_fused_dyn(*(x.to("meta") for x in (xq, yT, n2, cmap)), 16, ct,
                            biasg=biasg.to("meta"), lid=lid.to("meta"),
                            cgroup=cgroup.to("meta"))
    assert (ivfpq_fused.launches, ivfpq_fused_dyn.launches,
            ivf_recon_fused.launches, ivf_recon_fused_dyn.launches) == before
