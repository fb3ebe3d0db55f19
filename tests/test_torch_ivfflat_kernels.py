"""The hi/lo modes of kernels K1 and K2 that IVF-Flat search runs
(faiss_tpu_torch.ops.fused_knn): K1 soft and penalized and K2 masked, each
over the two bf16 store planes hi = bf16(x) and lo = bf16(x - hi), as plain
PyTorch versions against faiss_tpu's Pallas kernels
(ivf_recon_fused_dyn_pallas and ivf_recon_fused_pallas with ``yT_lo``;
interpret mode) on the same numpy inputs, and the wrappers' checks of the
lo plane. The CUDA kernels themselves are compared with the plain versions
on the card by chip_smoke.py.

The layout is IVF-Flat's test shape (d=16 zero-padded to 128, 256 lists,
3000 vectors, chunks of 256 slots): 256 lists in G = 2 groups of 128 list
columns and a trailing all-+inf PAD chunk, 128 queries in two 64-query
tiles (so the worklists differ per tile). Lists hold ~12 slots each: a
query that probes one or two lists has fewer than 128 probed slots, and the
rest of its top-128 are masked slots; other queries probe 40 lists.

Tolerances. faiss_tpu's kernels select approximately; on the rows whose
eviction floor does not flag a loss among the first KC keys, the keys below
5e8 (the unmasked ones) must agree within 1e-5 * (|q|^2 + max n2): the TPU
kernel's three bf16 passes drop the ql . yl term (at most 2^-18 |q| |y|),
the port multiplies the float32 query by hi + lo in float32. Slots agree
tie-aware at that tolerance. Masked keys differ by design (faiss_tpu rounds
the 1e9 penalty to bf16), so they are compared only as a count: both must
put the same number of unmasked keys first."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faiss_tpu.models.ivf_pq import pack_invlists_grouped
from faiss_tpu.ops.pallas_knn import ivf_recon_fused_dyn_pallas, ivf_recon_fused_pallas
from faiss_tpu_torch.ops.fused_knn import (
    ivf_recon_fused,
    ivf_recon_fused_dyn,
    ivf_recon_fused_dyn_ref,
    ivf_recon_fused_ref,
)
from faiss_tpu_torch.utils.evaluation import ids_agree_tie_aware
from torch_threads import one_torch_thread  # noqa: F401

NQ, QT, NLIST, CT, NB, D, D_PAD, KC = 128, 64, 256, 256, 3000, 16, 128, 40
MASK = 1e9


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def jbf16(plane):
    """A torch bfloat16 tensor as a jax bfloat16 array, bit for bit."""
    return jnp.asarray(plane.view(torch.int16).numpy()).view(jnp.bfloat16)


@pytest.fixture(scope="module")
def case():
    rs = np.random.RandomState(3)
    listnos = rs.randint(NLIST, size=NB).astype(np.int32)
    g = pack_invlists_grouped(listnos, NLIST, CT)
    G, S = g["ngroups"], g["S"]
    assert G == 2
    Sp = S + CT  # + the PAD chunk
    nchunks = Sp // CT
    pos, order, lp = g["pos"], g["order"], g["list_perm"]
    col_of = np.zeros(NLIST, np.int64)  # grouped column of each list
    col_of[lp[lp >= 0]] = np.where(lp >= 0)[0]
    slot_list = np.full(Sp, -1)
    slot_list[pos] = listnos[order]
    lid = np.zeros((1, Sp), np.int32)
    lid[0, :S] = g["lid"]
    cgroup = np.concatenate([np.repeat(np.arange(G), g["cpg"]), [0]]).astype(np.int32)
    # the vectors of the slots as IVF-Flat stages them: hi/lo planes, exact
    # float32 norms, zeros and +inf on pads
    x = np.zeros((D_PAD, Sp), np.float32)
    x[:D] = rs.randn(D, Sp)
    x[:, slot_list < 0] = 0
    xt = torch.from_numpy(x)
    hi = xt.to(torch.bfloat16)
    lo = (xt - hi.float()).to(torch.bfloat16)
    n2 = (x.astype(np.float64) ** 2).sum(0, keepdims=True).astype(np.float32)
    n2[0, slot_list < 0] = np.inf
    xq = np.zeros((NQ, D_PAD), np.float32)
    xq[:, :D] = rs.randn(NQ, D)
    # probed lists per query: 1, 2 or 40
    probed = np.zeros((NQ, G * 128), bool)
    for q in range(NQ):
        probed[q, col_of[rs.choice(NLIST, rs.choice([1, 2, 40]), replace=False)]] = True
    penalty = np.where(probed, 0.0, MASK).astype(np.float32)
    slot_probed = probed[:, col_of[np.maximum(slot_list, 0)]] & (slot_list >= 0)
    # per tile a worklist: the ascending chunks of its probed lists, then
    # the PAD chunk (the last)
    cmap = np.full((NQ // QT, nchunks), nchunks - 1, np.int32)
    for tl in range(NQ // QT):
        tile = slot_probed[tl * QT : (tl + 1) * QT]
        chunks = np.unique(np.where(tile.any(0))[0] // CT)
        cmap[tl, : len(chunks)] = chunks
    assert (cmap == nchunks - 1).any(1).all()  # every tile visits the PAD chunk
    tol = 1e-5 * ((xq**2).sum(1) + n2[np.isfinite(n2)].max())
    return dict(xq=xq, hi=hi, lo=lo, n2=n2, lid=lid, cgroup=cgroup, cmap=cmap,
                penalty=penalty, slot_probed=slot_probed, tol=tol)


def compare(v, s, ev, keys, slots, C, masked):
    """Port (keys, slots) against a Pallas kernel's (v, s, ev) on its rows
    that are exact among the first KC keys; unmasked keys only."""
    keys, slots = keys.numpy(), slots.numpy()
    np.testing.assert_array_equal(slots == -1, np.isinf(keys))
    assert np.isfinite(keys).all()  # pads and the PAD chunk never enter
    e = ev.min(1) >= v[:, KC - 1]
    assert e.mean() > 0.5, e.mean()
    for r in np.where(e)[0]:
        nv = int((v[r, :KC] < 5e8).sum())
        nk = int((keys[r, :KC] < 5e8).sum())
        assert nv == nk, (r, nv, nk)
        if masked:  # the exact select keeps every probed slot it can
            assert (keys[r] < 5e8).sum() == min(128, C["slot_probed"][r].sum())
        np.testing.assert_allclose(keys[r, :nk], v[r, :nk], rtol=0, atol=C["tol"][r])
        assert ids_agree_tie_aware(v[None, r, :nk], s[None, r, :nk],
                                   keys[None, r, :nk], slots[None, r, :nk],
                                   C["tol"][r]).all(), r


@pytest.mark.parametrize("penalized", [False, True])
def test_k1_hilo_plain_version_matches_pallas(case, penalized):
    C = case
    v, s, ev = map(np.asarray, ivf_recon_fused_dyn_pallas(
        jnp.asarray(C["penalty"]) if penalized else None, jnp.asarray(C["xq"]),
        jbf16(C["hi"]), jnp.asarray(C["n2"]), jnp.asarray(C["lid"]),
        jnp.asarray(C["cmap"]), jnp.asarray(C["cgroup"]), yT_lo=jbf16(C["lo"]),
        qt=QT, ct=CT, qdepth=2, penalized=penalized, interpret=True,
    ))
    pen = dict(biasg=t(C["penalty"]), lid=t(C["lid"]), cgroup=t(C["cgroup"]))
    keys, slots, floor = ivf_recon_fused_dyn(
        t(C["xq"]), C["hi"], t(C["n2"]), t(C["cmap"]), QT, CT,
        yT_lo=C["lo"], **(pen if penalized else {}),
    )
    assert np.isinf(floor.numpy()).all()
    compare(v, s, ev, keys, slots, C, penalized)
    if penalized:
        # the worklists cover every probed list: K1 penalized finds what
        # K2 masked finds over the whole store
        k2 = ivf_recon_fused_ref(t(C["xq"]), C["hi"], t(C["n2"]), C["lo"], qt=QT,
                                 ct=CT, biasg=pen["biasg"], lid=pen["lid"])[0].numpy()
        kk = keys.numpy()
        np.testing.assert_array_equal(kk < 5e8, k2 < 5e8)
        np.testing.assert_allclose(kk[kk < 5e8], k2[k2 < 5e8], rtol=1e-6, atol=1e-5)
    else:
        # soft: the lo plane moves the keys of the one-plane scan by at most
        # 2 |q| |y| 2^-9
        one = ivf_recon_fused_dyn_ref(t(C["xq"]), C["hi"], t(C["n2"]),
                                      t(C["cmap"]), QT, CT)[0].numpy()
        bound = 2 * np.sqrt((C["xq"] ** 2).sum(1) * C["n2"][np.isfinite(C["n2"])].max())
        assert (np.abs(one - keys.numpy()).max(1) <= bound * 2.0**-8).all()


def test_k2_masked_hilo_plain_version_matches_pallas(case):
    C = case
    v, s, ev = map(np.asarray, ivf_recon_fused_pallas(
        jnp.asarray(C["xq"]), jbf16(C["hi"]), jnp.asarray(C["n2"]),
        jnp.asarray(C["lid"]), jnp.asarray(C["penalty"]), yT_lo=jbf16(C["lo"]),
        qt=QT, ct=CT, interpret=True,
    ))
    keys, slots, floor = ivf_recon_fused(
        t(C["xq"]), C["hi"], t(C["n2"]), C["lo"], qt=QT, ct=CT,
        biasg=t(C["penalty"]), lid=t(C["lid"]),
    )
    assert np.isinf(floor.numpy()).all()
    compare(v, s, ev, keys, slots, C, True)
    # a query with fewer than 128 probed slots keeps all of them first
    few = C["slot_probed"].sum(1) < 128
    assert few.any()
    for r in np.where(few)[0]:
        n = C["slot_probed"][r].sum()
        assert set(slots.numpy()[r, :n]) == set(np.where(C["slot_probed"][r])[0])
        assert (keys.numpy()[r, n:] >= 5e8).all()


def test_hilo_wrappers_check_the_lo_plane():
    nq, S, ct = 16, 512, 128
    xq = torch.zeros(nq, 8)
    yT = torch.zeros(8, S, dtype=torch.bfloat16)
    n2 = torch.zeros(1, S)
    cmap = torch.zeros(1, 2, dtype=torch.int32)
    biasg = torch.zeros(nq, 256)
    lid = torch.zeros(1, S, dtype=torch.int32)
    cgroup = torch.zeros(S // ct, dtype=torch.int32)
    counts = (ivf_recon_fused.launches, ivf_recon_fused.hilo_launches,
              ivf_recon_fused_dyn.launches, ivf_recon_fused_dyn.hilo_launches)
    # CPU tensors: the plain versions, every mode with both planes
    for pen in ({}, dict(biasg=biasg, lid=lid, cgroup=cgroup)):
        ivf_recon_fused_dyn(xq, yT, n2, cmap, 16, ct, yT_lo=yT.clone(), **pen)
    ivf_recon_fused(xq, yT, n2, yT.clone(), qt=16, ct=ct, biasg=biasg, lid=lid)
    with pytest.raises(ValueError, match="yT_lo must"):  # another shape
        ivf_recon_fused_dyn(xq, yT, n2, cmap, 16, ct, yT_lo=yT[:, : S // 2])
    with pytest.raises(ValueError, match="yT_lo must"):  # another stride
        ivf_recon_fused_dyn(xq, yT, n2, cmap, 16, ct, yT_lo=yT.T.contiguous().T)
    with pytest.raises(ValueError, match="yT_lo must"):  # another type
        ivf_recon_fused_dyn(xq, yT, n2, cmap, 16, ct, yT_lo=yT.float())
    with pytest.raises(ValueError, match="store planes"):
        ivf_recon_fused(xq, yT, n2, yT[:, : S // 2], qt=16, ct=ct)
    wide = torch.zeros(8, 2 * S, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="column slice"):  # a stripe, masked
        ivf_recon_fused(xq, wide[:, :S], n2, wide[:, S:], qt=16, ct=ct,
                        biasg=biasg, lid=lid)
    meta = [a.to("meta") for a in (xq, yT, n2, cmap)]
    with pytest.raises(ValueError, match="CUDA or CPU"):
        ivf_recon_fused_dyn(*meta, 16, ct, yT_lo=meta[1])
    assert (ivf_recon_fused.launches, ivf_recon_fused.hilo_launches,
            ivf_recon_fused_dyn.launches, ivf_recon_fused_dyn.hilo_launches) == counts
