"""K5 on the tensor cores (faiss_tpu_torch.ops.fused_knn.ivfpq_fused_dyn,
csrc/ivfpq_adc.cu on adc_mma.cuh, its blocks as K1's) as far as the CPU
reaches it:

- its arithmetic, emulated in torch: K4's one-hot contraction (per
  sub-quantizer one bf16 k-step of the LUT's 16 entries, zero past ksub,
  into float32), then MODE_K4's ``(sum + n2) + bias`` with the bias of the
  chunk's group ``cgroup[chunk]``, over each query tile's worklist walked
  as the kernel walks it: 64-query sub-blocks (a partial one where qt < 64),
  the steps up to the tile's last non-PAD one split into 1, 2 or 3 ranges,
  128-column tiles of each step's chunk, an exact top-128 per range, the
  ranges merged. It stays within chip_smoke's lane_tol of
  ivfpq_fused_dyn_ref (ids tie-aware) and agrees with faiss_tpu's Pallas
  K5 (interpret mode) on the layout of test_torch_ivfpq_kernels (200 lists
  in 2 groups, a trailing PAD chunk, worklists of each tile's probed
  chunks, then PAD), and cutting the PAD steps leaves the result equal;
- the shared worklist walk: K1 and K5 map their blocks and cut their PAD
  steps through the same recon_mma::dyn_block and ListWalk;
- the wrapper on a faked card: the instance by shape before the launch
  (ksub 16 on the tensor cores, ksub 32 through the lookup scan), the
  split count and its scratch, the PAD counter, the launch counts, the
  tensor-core refusals, and CPU tensors taking the plain version.

The CUDA kernel itself is compared with the plain version on every
sub-batch of its path on the card by chip_smoke.py (phase 13)."""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faiss_tpu.models.ivf_pq import pack_invlists_grouped
from faiss_tpu.ops.pallas_knn import ivfpq_fused_dyn_pallas
from faiss_tpu_torch.ops import fused_knn
from faiss_tpu_torch.ops.fused_knn import ivfpq_fused_dyn, ivfpq_fused_dyn_ref
from faiss_tpu_torch.ops.topk import merge_topk
from faiss_tpu_torch.utils.evaluation import ids_agree_tie_aware
from torch_threads import one_torch_thread  # noqa: F401

NQ, QT, M, NLIST, CT, NB, KC = 128, 64, 4, 200, 256, 1500, 40
LANES = 128
BM = fused_knn.ADC_TC_BLOCK  # adc_mma.cuh BM
BN = fused_knn.ADC_TC_TILE  # adc_mma.cuh BN
MASK = 1e9


# -- the layout of test_torch_ivfpq_kernels ----------------------------------


@pytest.fixture(scope="module")
def layout():
    """200 lists in G = 2 groups of chunks of CT slots and a trailing PAD
    chunk (group G - 1); queries probing 1, 2 or 40 lists; per tile of QT
    queries the ascending chunks of its probed lists, then the PAD chunk."""
    rs = np.random.RandomState(0)
    listnos = rs.randint(NLIST, size=NB).astype(np.int32)
    g = pack_invlists_grouped(listnos, NLIST, CT)
    G, S = g["ngroups"], g["S"]
    assert G == 2
    Sp = S + CT
    pos, order, lp = g["pos"], g["order"], g["list_perm"]
    col_of = np.zeros(NLIST, np.int64)
    col_of[lp[lp >= 0]] = np.where(lp >= 0)[0]
    slot_list = np.full(Sp, -1)
    slot_list[pos] = listnos[order]
    lid = np.zeros((1, Sp), np.int32)
    lid[0, :S] = g["lid"]
    nprobe = rs.choice([1, 2, 40], size=NQ)
    probed = np.zeros((NQ, G * 128), bool)
    for q in range(NQ):
        probed[q, col_of[rs.choice(NLIST, nprobe[q], replace=False)]] = True
    cgroup = np.concatenate([np.repeat(np.arange(G), g["cpg"]), [G - 1]]).astype(np.int32)
    nchunks = Sp // CT
    held = probed[:, col_of[np.maximum(slot_list, 0)]] & (slot_list >= 0)[None, :]
    cmap = np.full((NQ // QT, nchunks), nchunks - 1, np.int32)
    for t in range(NQ // QT):
        chunks = np.unique(np.where(held[t * QT : (t + 1) * QT].any(0))[0] // CT)
        cmap[t, : len(chunks)] = chunks
    assert (cmap[:, -1] == nchunks - 1).all()  # every worklist ends in PAD steps
    return dict(S=Sp, G=G, lid=lid, probed=probed, cgroup=cgroup, cmap=cmap,
                held=held, slot_list=slot_list)


def adc_inputs(L, ksub, seed):
    """numpy inputs of K5 at ``ksub``: bf16-exact LUTs, codes < ksub, n2
    (+inf on pads and the PAD chunk) and the coarse term, 1e9 off the
    probed lists."""
    rs = np.random.RandomState(seed)
    S = L["S"]
    luts = torch.from_numpy(rs.randn(NQ, M * ksub).astype(np.float32)).to(torch.bfloat16)
    codesT = rs.randint(ksub, size=(M, S)).astype(np.uint8)
    n2 = (rs.rand(1, S) * 2).astype(np.float32)
    n2[0, L["slot_list"] < 0] = np.inf
    cm2 = rs.randn(NQ, L["G"] * 128).astype(np.float32)
    biasg = np.where(L["probed"], cm2, np.float32(MASK)).astype(np.float32)
    return biasg, luts, codesT, n2, L["lid"], L["cmap"], L["cgroup"]


def torch_args(biasg, luts, codesT, n2, lid, cmap, cgroup):
    t = torch.from_numpy
    return t(biasg), luts, t(codesT), t(n2), t(lid), t(cmap), t(cgroup)


# -- the kernel's arithmetic, emulated ---------------------------------------


def tc_keys(biasg, luts, codesT, n2, lid, cols, groups):
    """The kernel's keys over the columns ``cols`` (of chunks in groups
    ``groups``): per sub-quantizer m one bf16 k-step, the LUT block [nq, 16]
    (zero past ksub) times the one-hot of the codes [16, C], added to a
    float32 accumulator from 0; then ``(acc + n2) + bias`` in float32
    (MODE_K4, the TPU kernel's ip + n2 + bias)."""
    nq, Mq = luts.shape[0], codesT.shape[0]
    ksub = luts.shape[1] // Mq
    lut16 = torch.zeros(nq, Mq, 16, dtype=torch.bfloat16)
    lut16[:, :, :ksub] = luts.view(nq, Mq, ksub)
    codes = codesT[:, cols].long()
    acc = torch.zeros(nq, len(cols))
    for m in range(Mq):
        oh = (codes[m][None, :] == torch.arange(16)[:, None]).to(torch.bfloat16)
        acc = acc + lut16[:, m].float() @ oh.float()  # one nonzero product a key
    bias = biasg[:, groups.long() * LANES + lid[0, cols].long()]
    return (acc + n2[0, cols][None, :]) + bias


def real_steps(work, pad):
    """The steps up to a worklist's last one that is not the PAD chunk."""
    real = np.where(work.numpy() != pad)[0]
    return int(real[-1]) + 1 if len(real) else 0


def tc_dyn_scan(biasg, luts, codesT, n2, lid, cmap, cgroup, qt, ct, splits=1,
                skip_pad=True):
    """The launch: per qt-query tile its 64-query sub-blocks (rows past the
    tile's zero, never written), the tile's steps up to its last non-PAD
    one (every step without ``skip_pad``) in ``splits`` ranges
    [real * p // splits, real * (p + 1) // splits), each step's chunk in
    tiles of 128 columns, an exact top-128 per (sub-block, range), the
    ranges merged. Returns (keys, slots, PAD steps skipped)."""
    nq, S = luts.shape[0], codesT.shape[1]
    pad = S // ct - 1
    keys = torch.full((nq, LANES), float("inf"))
    slots = torch.full((nq, LANES), -1, dtype=torch.int64)
    skipped = 0
    for t in range(nq // qt):
        work = cmap[t]
        real = real_steps(work, pad) if skip_pad else len(work)
        skipped += len(work) - real
        for q0 in range(t * qt, (t + 1) * qt, BM):
            rows = min(BM, (t + 1) * qt - q0)
            lz = torch.zeros(BM, luts.shape[1], dtype=torch.bfloat16)
            lz[:rows] = luts[q0 : q0 + rows]
            bz = torch.zeros(BM, biasg.shape[1])
            bz[:rows] = biasg[q0 : q0 + rows]
            bk = torch.full((BM, LANES), float("inf"))
            bs = torch.full((BM, LANES), -1, dtype=torch.int64)
            for p in range(splits):
                s0, s1 = real * p // splits, real * (p + 1) // splits
                cols = [int(work[s]) * ct + j for s in range(s0, s1) for j in range(0, ct, BN)]
                if not cols:
                    continue
                cols = torch.tensor([c + i for c in cols for i in range(BN)])
                groups = cgroup[cols // ct]
                sc = tc_keys(bz, lz, codesT, n2, lid, cols, groups)
                v, pos = torch.topk(sc, min(LANES, sc.shape[1]), dim=1, largest=False)
                bk, bs = merge_topk(bk, bs, v, cols[pos], LANES, largest=False)
            keys[q0 : q0 + rows], slots[q0 : q0 + rows] = bk[:rows], bs[:rows]
    return keys, torch.where(torch.isinf(keys), -1, slots), skipped


def lane_tol(luts, n2, keys, slots):
    """chip_smoke.py's lane_tol, with the LUT rows' absolute sum in the
    place of |q|^2 (the magnitude of a key's terms)."""
    mag = luts.float().abs().sum(1, keepdim=True).double()
    n2s = torch.where(slots >= 0, n2[0, slots.clamp_min(0)].double(), 0.0)
    fin = torch.where(torch.isfinite(keys), keys.double().abs(), 0.0)
    return 1e-4 * (mag + n2s) + 1e-6 * fin


def assert_lanes(k, s, rk, rs_, tol):
    """chip_smoke.py's compare_lanes: +inf and -1 at the same places, keys
    within tol, ids tie-aware."""
    assert torch.equal(torch.isinf(k), torch.isinf(rk))
    assert torch.equal(s == -1, torch.isinf(k))
    fin = torch.isfinite(rk)
    err = (torch.where(fin, k, 0.0).double() - torch.where(fin, rk, 0.0).double()).abs()
    assert (err <= tol).all(), float(err.max())
    assert ids_agree_tie_aware(rk.numpy(), rs_.numpy(), k.numpy(), s.numpy(),
                               torch.where(fin, tol, 0.0).max(1).values.numpy()).all()


@pytest.mark.parametrize("splits", [1, 2, 3])
@pytest.mark.parametrize("ksub", [16, 8], ids=["ksub16", "ksub8-padded"])
def test_tc_dyn_within_lane_tol_of_plain_version(layout, ksub, splits):
    """The emulated kernel against ivfpq_fused_dyn_ref on every row and
    lane; a query with fewer than 128 probed slots keeps all of them first,
    then masked keys."""
    ta = torch_args(*adc_inputs(layout, ksub, seed=splits))
    rk, rs_, _ = ivfpq_fused_dyn_ref(*ta, qt=QT, ct=CT)
    k, s, skipped = tc_dyn_scan(*ta, QT, CT, splits)
    assert skipped > 0
    assert_lanes(k, s, rk, rs_, lane_tol(ta[1], ta[3], rk, rs_))
    few = layout["held"].sum(1) < 128
    assert few.any()
    for r in np.where(few)[0]:
        n = int(layout["held"][r].sum())
        assert set(s[r, :n].tolist()) == set(np.where(layout["held"][r])[0])
        assert (k[r, n:] >= 5e8).all()


def test_partial_block_and_tile(layout):
    """qt = 16 (one sub-block of 16 rows per tile) and 72 queries of qt = 72
    (a sub-block of 64 and one of 8), with their own worklists: the same
    result as the plain version."""
    biasg, luts, codesT, n2, lid, _, cgroup = torch_args(*adc_inputs(layout, 16, seed=7))
    pad = codesT.shape[1] // CT - 1
    rs = np.random.RandomState(8)
    for nq, qt in ((64, 16), (72, 72)):
        cmap = torch.full((nq // qt, 12), pad, dtype=torch.int32)
        for t in range(nq // qt):
            n = rs.randint(1, pad + 1)  # of the pad data chunks
            cmap[t, :n] = torch.from_numpy(np.sort(rs.choice(pad, n, replace=False)))
        a = (biasg[:nq], luts[:nq], codesT, n2, lid, cmap, cgroup)
        rk, rs_, _ = ivfpq_fused_dyn_ref(*a, qt=qt, ct=CT)
        k, s, _ = tc_dyn_scan(*a, qt, CT, 2)
        assert_lanes(k, s, rk, rs_, lane_tol(a[1], a[3], rk, rs_))


def test_pad_skip_leaves_the_result(layout):
    """Cutting each tile's steps after its last non-PAD one (the PAD
    chunk's n2 is +inf) changes no key and, up to the order of equal keys,
    no slot."""
    ta = torch_args(*adc_inputs(layout, 16, seed=4))
    k, s, skipped = tc_dyn_scan(*ta, QT, CT, 2)
    kf, sf, none = tc_dyn_scan(*ta, QT, CT, 2, skip_pad=False)
    assert skipped > 0 and none == 0
    assert torch.equal(k, kf)
    assert ids_agree_tie_aware(kf.numpy(), sf.numpy(), k.numpy(), s.numpy(), 0.0).all()


def test_tc_dyn_matches_pallas_k5(layout):
    """faiss_tpu's K5 (interpret mode) on the layout: on the rows its
    eviction floor marks exact among the first KC keys, the unmasked keys
    agree within 1e-4 of the magnitude of their terms (the TPU adds the
    bias as bf16 hi + lo) and their ids tie-aware; both put the same number
    of unmasked keys first, and the emulation keeps every probed slot it
    can."""
    biasg, luts, codesT, n2, lid, cmap, cgroup = adc_inputs(layout, 16, seed=5)
    v, sv, ev = map(np.asarray, ivfpq_fused_dyn_pallas(
        jnp.asarray(biasg), jnp.asarray(luts.float().numpy(), jnp.bfloat16),
        jnp.asarray(codesT), jnp.asarray(n2), jnp.asarray(lid), jnp.asarray(cmap),
        jnp.asarray(cgroup), qt=QT, ct=CT, interpret=True,
    ))
    k, s, _ = tc_dyn_scan(*torch_args(biasg, luts, codesT, n2, lid, cmap, cgroup),
                          QT, CT, 3)
    k, s = k.numpy(), s.numpy()
    mag = (np.abs(np.where(biasg < 5e8, biasg, 0)).max(1) + 2.0
           + np.abs(luts.float().numpy()).reshape(NQ, M, 16).max(2).sum(1))
    tol = 1e-4 * mag
    e = ev.min(1) >= v[:, KC - 1]
    assert e.mean() > 0.5, e.mean()
    for r in np.where(e)[0]:
        nv, nk = int((v[r, :KC] < 5e8).sum()), int((k[r, :KC] < 5e8).sum())
        assert nv == nk, (r, nv, nk)
        assert (k[r] < 5e8).sum() == min(128, layout["held"][r].sum())
        np.testing.assert_allclose(k[r, :nk], v[r, :nk], rtol=0, atol=tol[r])
        assert ids_agree_tie_aware(v[None, r, :nk], sv[None, r, :nk],
                                   k[None, r, :nk], s[None, r, :nk], tol[r]).all()


# -- the shared walk ----------------------------------------------------------


def test_k1_and_k5_share_the_worklist_walk():
    """K5's kernel maps its blocks, cuts its PAD steps and walks its chunks
    through recon_mma.cuh's dyn_block and ListWalk, as K1's does; the
    tensor-core route takes worklists (no refusal of tc with cmap), and
    the walk's columns are chunk * ct + (t % tpc) * TBN."""
    k5 = (fused_knn.CSRC / "ivfpq_adc.cu").read_text()
    k1 = (fused_knn.CSRC / "ivf_recon_dyn.cu").read_text()
    hdr = (fused_knn.CSRC / "recon_mma.cuh").read_text()
    for src, walk in ((k5, "recon_mma::ListWalk<BN> w(b, cgroup, ct);"),
                      (k1, "recon_mma::ListWalk<BN> w(b, cgroup, ct);")):
        assert "recon_mma::dyn_block(" in src and walk in src
    assert "adc_mma::scan<adc_mma::MODE_K4>(a, maps, w, b.q0, b.rows);" in k5
    assert "(tc && dyn)" not in k5
    assert re.search(r"return static_cast<long long>\(chunk\(t\)\) \* ct \+ \(t % tpc\) \* TBN;", hdr)
    assert "if (__ldg(b.work + j) != pad_chunk) mine = j;" in hdr
    adc = (fused_knn.CSRC / "adc_mma.cuh").read_text()
    assert "template <int MODE, class Walk>\n__device__ void scan(" in adc


# -- the wrapper --------------------------------------------------------------


class FakeLibrary:
    """The built ivfpq_adc library as the wrapper sees it: the tensor-core
    kernel takes M <= 37 at ksub <= 16 (as chip_smoke.py checks the built
    one does); the calls are recorded."""

    def __init__(self):
        self.calls = []

    def ivfpq_adc_smem_bytes(self, M, ksub, tc):
        self.calls.append((M, ksub, tc))
        return 1000 if tc and M <= 37 and ksub <= 16 else -1


class Calls(list):
    """The recorded launches, and the faked library as ``lib``."""


@pytest.fixture
def fake_card(monkeypatch):
    """ivfpq_fused_dyn's CUDA route on CPU tensors: the launch is recorded,
    not made (132 SMs)."""
    calls = Calls()
    lib = FakeLibrary()
    monkeypatch.setattr(fused_knn, "build_kernel", lambda name: (lib, ""))
    monkeypatch.setattr(fused_knn, "_route", lambda name, ts: True)
    monkeypatch.setattr(fused_knn, "_sm_count", lambda index: 132)
    monkeypatch.setattr(fused_knn, "_stream", lambda device: 0)
    monkeypatch.setattr(fused_knn, "_launch", lambda name, *a: calls.append((name, a)))
    for attr in ("launches", "tc_launches", "splits"):
        monkeypatch.setattr(ivfpq_fused_dyn, attr, 0)
    calls.lib = lib
    return calls


def route_inputs(nq, Mq, ksub, qt, msteps=128, nch=64, G=2, ct=1024):
    S = (nch + 1) * ct
    cmap = torch.full((nq // qt, msteps), nch, dtype=torch.int32)
    return (torch.zeros(nq, G * 128), torch.zeros(nq, Mq * ksub, dtype=torch.bfloat16),
            torch.zeros(Mq, S, dtype=torch.uint8), torch.zeros(1, S),
            torch.zeros(1, S, dtype=torch.int32), cmap,
            torch.zeros(nch + 1, dtype=torch.int32))


@pytest.mark.parametrize("nq, qt, Mq, ksub, msteps, tc, splits", [
    (2048, 256, 32, 16, 128, 1, 4),  # PQ32x4fs, 8 tiles x 4 sub-blocks
    (8192, 256, 32, 16, 128, 1, 1),  # 128 blocks
    (64, 16, 4, 8, 3, 1, 3),         # 4 one-sub-block tiles, capped by 3 steps
    (256, 256, 8, 32, 32, 0, 1),     # ksub 32: the lookup scan, one launch
    (64, 64, 38, 16, 16, 0, 1),      # rows beyond shared memory: the lookup scan
])
def test_route_is_chosen_by_shape_before_the_launch(fake_card, nq, qt, Mq, ksub,
                                                    msteps, tc, splits):
    ivfpq_fused_dyn(*route_inputs(nq, Mq, ksub, qt, msteps), qt=qt, ct=1024)
    ((name, args),) = fake_card
    assert name == "ivfpq_adc"
    assert fake_card.lib.calls == [(Mq, ksub, 1)]
    assert args[-3:-1] == (splits, tc)
    assert (args[10] is None) == (args[11] is None) == (splits == 1)  # scratch
    # the PAD counter goes to the tensor-core instance only
    assert (args[12] is None) == (not tc)
    if tc:
        assert args[12] == fused_knn._pad_counter(torch.device("cpu"), "K5").data_ptr()
    assert args[5] is not None and args[6] is not None  # cmap, cgroup: K5
    assert args[13:18] == (nq, 256, Mq, ksub, 65 * 1024) and args[18] == msteps
    assert ivfpq_fused_dyn.launches == 1 and ivfpq_fused_dyn.tc_launches == tc
    assert ivfpq_fused_dyn.splits == splits


def test_tc_route_checks_raise(fake_card):
    """16-byte biasg, codesT, n2 and lid (TMA and the bias floor's vector
    loads) and chunks of whole 128-column tiles, on the tensor-core route
    only, before any launch."""
    base = route_inputs(64, 4, 16, 64, 8)
    for i, name in ((0, "biasg"), (2, "codesT"), (3, "n2"), (4, "lid")):
        t = base[i]
        off = 8 // t.element_size()  # 8 bytes: aligned for the contract only
        flat = torch.zeros(t.numel() + off, dtype=t.dtype)
        bad = list(base)
        bad[i] = flat[off:].view(t.shape)
        with pytest.raises(ValueError, match=f"K5: {name} must start on a 16-byte"):
            ivfpq_fused_dyn(*bad, qt=64, ct=1024)
    small = route_inputs(64, 4, 16, 64, 8, ct=64)
    with pytest.raises(ValueError, match="multiple of 128"):
        ivfpq_fused_dyn(*small, qt=64, ct=64)
    assert fake_card == []
    # the lookup scan takes what the tensor-core checks refuse
    ivfpq_fused_dyn(*route_inputs(64, 2, 32, 64, 8, ct=64), qt=64, ct=64)
    assert fake_card[0][1][-2] == 0


def test_pad_counters_are_kept_per_kernel():
    """K5's skipped PAD steps are counted apart from K1's, each read and
    reset on its own."""
    dev = torch.device("cpu")
    k1, k5 = fused_knn._pad_counter(dev), fused_knn._pad_counter(dev, "K5")
    assert k1.data_ptr() != k5.data_ptr()
    fused_knn.pad_steps_skipped(reset=True)
    fused_knn.pad_steps_skipped(reset=True, kernel="K5")
    k5 += 5
    k1 += 2
    assert fused_knn.pad_steps_skipped(kernel="K5") == 5
    assert fused_knn.pad_steps_skipped(reset=True) == 2
    assert fused_knn.pad_steps_skipped(reset=True, kernel="K5") == 5
    assert fused_knn.pad_steps_skipped(kernel="K5") == 0
    assert fused_knn.pad_steps_skipped() == 0


def test_cpu_tensors_take_the_plain_version(layout):
    """Without the fake card the wrapper runs ivfpq_fused_dyn_ref on CPU
    tensors, bit for bit, and counts no launch."""
    ta = torch_args(*adc_inputs(layout, 16, seed=9))
    before = (ivfpq_fused_dyn.launches, ivfpq_fused_dyn.tc_launches)
    got = ivfpq_fused_dyn(*ta, qt=QT, ct=CT)
    want = ivfpq_fused_dyn_ref(*ta, qt=QT, ct=CT)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    assert (ivfpq_fused_dyn.launches, ivfpq_fused_dyn.tc_launches) == before


def test_split_count_of_k5():
    """K5 splits each tile's worklist steps: 2048 queries (8 tiles of 256,
    32 blocks) into 4 splits, 8192 into none, on 132 SMs; the scratch holds
    the splits' top-128s."""
    assert fused_knn._split_count(2048 // 256 * (256 // BM), 128, 132) == 4
    assert fused_knn._split_count(8192 // 256 * (256 // BM), 128, 132) == 1
    pk, ps = fused_knn._split_scratch(4, 2048, torch.device("cpu"))
    assert pk.shape == ps.shape == (4, 2048, 128)
