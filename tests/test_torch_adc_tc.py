"""K4 on the tensor cores (faiss_tpu_torch.ops.fused_knn.ivfpq_fused,
csrc/adc_mma.cuh) as far as the CPU reaches it:

- its arithmetic, emulated in torch: per sub-quantizer one bf16 k-step of
  the LUT's 16 entries (zero past ksub) against a one-hot of the codes into
  float32, then ``(sum + n2) + bias`` in float32, over 128-column tiles
  split across blocks as the kernel splits them, with an exact top-128. It
  stays within chip_smoke's lane_tol of the plain version and agrees with
  faiss_tpu's Pallas K4 (interpret mode) on the layout of
  test_torch_ivfpq_kernels (200 lists in 2 groups of 3 chunks each, masked
  lists at 1e9, probed lists shorter than 128 slots), at ksub 16 and 8;
- the epilogue's gates: a row's LUT floor (the smallest entry of each
  sub-quantizer, summed, less the margin) plus the smallest n2, and its
  smallest bias-free key, each plus the gate's bias, never exceed a key of
  the row, so skipping a row whose bound misses its threshold drops no key;
- the header's own index expressions (read from adc_mma.cuh and evaluated
  here) against the PTX fragment layouts of mma.m16n8k16 and ldmatrix: the
  one-hot B registers assembled over 32 lanes equal the dense one-hot of
  every code; the epilogue reads each accumulator element as the query row
  and slot that the products put there, and a warp's lanes hold its 32
  columns once; each ldmatrix lane addresses its A fragment row, and the
  padded LUT rows put the 8 rows of a matrix in 8 bank groups; the
  wrapper's block and tile sizes are the header's;
- the wrapper's route as the built library answers it (the lookup scan of
  adc_scan.cuh where the tensor-core kernel does not take the shape), its
  CUDA-route checks, split count and scratch, and that the source builds
  only where nvcc is.

The CUDA kernel itself, and the library's route at PQ32x4fs, ksub > 16
and M = 37 / 38, are checked on the card by chip_smoke.py."""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faiss_tpu.models.ivf_pq import pack_invlists_grouped
from faiss_tpu.ops.pallas_knn import ivfpq_fused_pallas
from faiss_tpu_torch.ops import fused_knn
from faiss_tpu_torch.ops.fused_knn import ivfpq_fused, ivfpq_fused_ref
from faiss_tpu_torch.ops.topk import merge_topk
from faiss_tpu_torch.utils.evaluation import ids_agree_tie_aware
from torch_threads import one_torch_thread  # noqa: F401

NQ, QT, M, NLIST, CT, NB, KC = 128, 64, 4, 200, 256, 1500, 40
LANES = 128
ONE = 0x3F80  # bf16 1.0

# -- adc_mma.cuh's own expressions --------------------------------------------

HEADER = (fused_knn.CSRC / "adc_mma.cuh").read_text()


def c_expr(pattern, group=1):
    """The C integer expression that ``pattern`` captures in adc_mma.cuh
    (every match the same), as Python: unsigned suffixes dropped, division
    integral, ``lut_row_bytes(a.M)`` the name ``row_bytes``."""
    found = {m.group(group) for m in re.finditer(pattern, HEADER)}
    assert len(found) == 1, (pattern, found)
    e = re.sub(r"\b(0x[0-9A-Fa-f]+|\d+)u\b", r"\1", found.pop())
    return " ".join(e.replace("lut_row_bytes(a.M)", "row_bytes").replace("/", "//").split())


def header_consts():
    """The header's ``constexpr int`` constants, evaluated in order."""
    env = {}
    for name, e in re.findall(r"constexpr int (\w+) = ([^;]+);", HEADER):
        env[name] = eval(e.replace("/", "//"), {}, dict(env))
    return env


H = header_consts()
BM, BN = H["BM"], H["BN"]


# -- the layout of test_torch_ivfpq_kernels ----------------------------------


@pytest.fixture(scope="module")
def layout():
    rs = np.random.RandomState(0)
    listnos = rs.randint(NLIST, size=NB).astype(np.int32)
    g = pack_invlists_grouped(listnos, NLIST, CT)
    G, S = g["ngroups"], g["S"]
    assert G == 2 and g["cpg"] >= 2  # several chunks per group
    Sp = S + CT  # + the PAD chunk
    col_of = np.zeros(NLIST, np.int64)
    lp = g["list_perm"]
    col_of[lp[lp >= 0]] = np.where(lp >= 0)[0]
    slot_list = np.full(Sp, -1)
    slot_list[g["pos"]] = listnos[g["order"]]
    lid = np.zeros((1, Sp), np.int32)
    lid[0, :S] = g["lid"]
    nprobe = rs.choice([1, 2, 40], size=NQ)
    probed = np.zeros((NQ, G * 128), bool)
    for q in range(NQ):
        probed[q, col_of[rs.choice(NLIST, nprobe[q], replace=False)]] = True
    held = probed[:, col_of[np.maximum(slot_list, 0)]] & (slot_list >= 0)[None, :]
    return dict(S=Sp, G=G, lid=lid, probed=probed, slot_list=slot_list,
                held=held)


def adc_inputs(L, ksub, masked, seed):
    """numpy inputs of K4 at ``ksub``: bf16-exact LUTs, codes < ksub, n2
    (+inf on pads) and the coarse term, 1e9 off the probed lists when
    ``masked``."""
    rs = np.random.RandomState(seed)
    S = L["S"]
    luts = torch.from_numpy(rs.randn(NQ, M * ksub).astype(np.float32)).to(torch.bfloat16)
    codesT = rs.randint(ksub, size=(M, S)).astype(np.uint8)
    n2 = (rs.rand(1, S) * 2).astype(np.float32)
    n2[0, L["slot_list"] < 0] = np.inf
    cm2 = rs.randn(NQ, L["G"] * 128).astype(np.float32)
    biasg = np.where(L["probed"], cm2, np.float32(1e9)) if masked else cm2
    return biasg.astype(np.float32), luts, codesT, n2, L["lid"]


def torch_args(biasg, luts, codesT, n2, lid):
    return (torch.from_numpy(biasg), luts, torch.from_numpy(codesT),
            torch.from_numpy(n2), torch.from_numpy(lid))


# -- the kernel's arithmetic, emulated ---------------------------------------


def tc_keys(biasg, luts, codesT, n2, lid, ct, c0, c1):
    """The kernel's keys over columns [c0, c1): per sub-quantizer m one bf16
    k-step, the LUT block [nq, 16] (zero past ksub) times the one-hot of
    the codes [16, C], added to a float32 accumulator from 0; then
    ``(acc + n2) + bias`` in float32."""
    nq = luts.shape[0]
    Mq = codesT.shape[0]
    ksub = luts.shape[1] // Mq
    lut16 = torch.zeros(nq, Mq, 16, dtype=torch.bfloat16)
    lut16[:, :, :ksub] = luts.view(nq, Mq, ksub)
    codes = codesT[:, c0:c1].long()
    acc = torch.zeros(nq, c1 - c0)
    for m in range(Mq):
        oh = (codes[m][None, :] == torch.arange(16)[:, None]).to(torch.bfloat16)
        acc = acc + lut16[:, m].float() @ oh.float()  # one nonzero product a key
    G = biasg.shape[1] // LANES
    cpg = max(1, (codesT.shape[1] // ct) // G)
    grp = (torch.arange(c0, c1) // ct // cpg).clamp_max(G - 1)
    bias = biasg[:, grp * LANES + lid[0, c0:c1].long()]
    return (acc + n2[:, c0:c1]) + bias


def tc_scan(biasg, luts, codesT, n2, lid, ct, splits=1):
    """The launch: queries in blocks of 64 (rows past nq zero and never
    offered), the columns in ``splits`` ranges of whole 128-column tiles,
    an exact top-128 per split, the splits merged. Returns (keys, slots)."""
    nq, S = luts.shape[0], codesT.shape[1]
    rows = -(-nq // BM) * BM
    lz = torch.zeros(rows, luts.shape[1], dtype=torch.bfloat16)
    lz[:nq] = luts
    bz = torch.zeros(rows, biasg.shape[1])
    bz[:nq] = biasg
    tiles = S // BN
    split_cols = -(-tiles // splits) * BN
    keys = torch.full((nq, LANES), float("inf"))
    slots = torch.full((nq, LANES), -1, dtype=torch.int64)
    for p in range(splits):
        c0, c1 = p * split_cols, min(S, (p + 1) * split_cols)
        if c1 <= c0:
            continue
        sc = tc_keys(bz, lz, codesT, n2, lid, ct, c0, c1)[:nq]
        v, pos = torch.topk(sc, min(LANES, c1 - c0), dim=1, largest=False)
        keys, slots = merge_topk(keys, slots, v, pos + c0, LANES, largest=False)
    return keys, torch.where(torch.isinf(keys), -1, slots)


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


@pytest.mark.parametrize("ksub", [16, 8], ids=["ksub16", "ksub8-padded"])
@pytest.mark.parametrize("masked", [True, False], ids=["masked", "unmasked"])
def test_tc_arithmetic_within_lane_tol_of_plain_version(layout, ksub, masked):
    """The emulated kernel against ivfpq_fused_ref on every row and lane;
    with the mask, a query with fewer than 128 probed slots keeps all of
    them first, then the masked keys (which tie at float32's spacing of 64
    near 1e9)."""
    a = adc_inputs(layout, ksub, masked, seed=1)
    ta = torch_args(*a)
    rk, rs_, _ = ivfpq_fused_ref(*ta, qt=QT, ct=CT)
    k, s = tc_scan(*ta, CT)
    assert_lanes(k, s, rk, rs_, lane_tol(ta[1], ta[3], rk, rs_))
    if masked:
        few = layout["held"].sum(1) < 128
        assert few.any()
        for r in np.where(few)[0]:
            n = int(layout["held"][r].sum())
            assert set(s[r, :n].tolist()) == set(np.where(layout["held"][r])[0])
            assert (k[r, n:] >= 5e8).all()


@pytest.mark.parametrize("ksub", [16, 8], ids=["ksub16", "ksub8-padded"])
def test_tc_arithmetic_matches_pallas_k4(layout, ksub):
    """faiss_tpu's K4 (interpret mode) on the masked layout: on the rows its
    eviction floor marks exact among the first KC keys, the unmasked keys
    agree within 1e-4 of the magnitude of their terms (the TPU adds the
    bias as bf16 hi + lo) and their ids tie-aware; both put the same
    number of unmasked keys first."""
    biasg, luts, codesT, n2, lid = adc_inputs(layout, ksub, True, seed=2)
    v, sv, ev = map(np.asarray, ivfpq_fused_pallas(
        jnp.asarray(biasg), jnp.asarray(luts.float().numpy(), jnp.bfloat16),
        jnp.asarray(codesT), jnp.asarray(n2), jnp.asarray(lid),
        qt=QT, ct=CT, interpret=True,
    ))
    k, s = tc_scan(*torch_args(biasg, luts, codesT, n2, lid), CT)
    k, s = k.numpy(), s.numpy()
    mag = (np.abs(np.where(biasg < 5e8, biasg, 0)).max(1) + 2.0
           + np.abs(luts.float().numpy()).reshape(NQ, M, ksub).max(2).sum(1))
    tol = 1e-4 * mag
    e = ev.min(1) >= v[:, KC - 1]
    assert e.mean() > 0.5, e.mean()
    for r in np.where(e)[0]:
        nv, nk = int((v[r, :KC] < 5e8).sum()), int((k[r, :KC] < 5e8).sum())
        assert nv == nk, (r, nv, nk)
        np.testing.assert_allclose(k[r, :nk], v[r, :nk], rtol=0, atol=tol[r])
        assert ids_agree_tie_aware(v[None, r, :nk], sv[None, r, :nk],
                                   k[None, r, :nk], s[None, r, :nk], tol[r]).all()


@pytest.mark.parametrize("splits", [2, 3, 7])
def test_tc_splits_and_partial_block_leave_the_result(layout, splits):
    """72 queries (a second block of 8 real rows and 56 zero rows) over the
    columns split into 2, 3 or 7 ranges of whole tiles: the same keys and
    slots as one split, up to the order of equal keys."""
    biasg, luts, codesT, n2, lid = adc_inputs(layout, 16, True, seed=3)
    ta = torch_args(biasg[:72], luts[:72], codesT, n2, lid)
    k1, s1 = tc_scan(*ta, CT)
    k, s = tc_scan(*ta, CT, splits)
    assert torch.equal(k, k1)
    assert ids_agree_tie_aware(k1.numpy(), s1.numpy(), k.numpy(), s.numpy(), 0.0).all()
    rk, rs_, _ = ivfpq_fused_ref(*ta, qt=8, ct=CT)
    assert_lanes(k, s, rk, rs_, lane_tol(ta[1], ta[3], rk, rs_))


def lut_floor(luts, Mq):
    """adc_mma.cuh's lut_floor: per query the float32 sum over the
    sub-quantizers of their smallest entry, less the header's margin (its
    fraction of the sum of their largest magnitudes)."""
    m = re.search(r"return lo - mag \* \(([^)]+)\);", HEADER)
    margin = eval(re.sub(r"(\d+)\.f\b", r"\1.0", m.group(1)))
    lf = luts.float().view(luts.shape[0], Mq, -1)
    lo = torch.zeros(luts.shape[0])
    mag = torch.zeros(luts.shape[0])
    for m in range(Mq):
        lo = lo + lf[:, m].min(1).values
        mag = mag + lf[:, m].abs().max(1).values
    return lo - mag * torch.tensor(margin, dtype=torch.float32)


@pytest.mark.parametrize("ksub", [16, 8, 3])
def test_epilogue_gates_bound_every_key(layout, ksub):
    """On the masked layout, per row and 8-slot group of a thread: the LUT
    floor plus the smallest n2, and the smallest bias-free key, each plus
    the gate's bias (the list's bias where the 8 slots share a list, else
    the row's smallest bias in the group), are at most every key of the
    group, in float32 as the kernel rounds them; and on a tile that is
    masked for a row, the LUT floor alone closes the row once its threshold
    is below 1e8."""
    biasg, luts, codesT, n2, lid = torch_args(*adc_inputs(layout, ksub, True, seed=6))
    S = codesT.shape[1]
    acc = torch.zeros(NQ, S)
    lut16 = torch.zeros(NQ, M, 16, dtype=torch.bfloat16)
    lut16[:, :, :ksub] = luts.view(NQ, M, ksub)
    for m in range(M):
        acc = acc + lut16[:, m].float()[:, codesT[m].long()]
    floor = lut_floor(luts, M)
    assert (floor[:, None] <= acc).all()
    G = biasg.shape[1] // LANES
    cpg = max(1, (S // CT) // G)
    grp = (torch.arange(S) // CT // cpg).clamp_max(G - 1)
    bias = biasg[:, grp * LANES + lid[0].long()]
    keys = (acc + n2) + bias
    fin = torch.isfinite(n2[0])
    for g0 in range(0, S, 8):
        sl = slice(g0, g0 + 8)
        n2min = n2[0, sl].min()
        gl = lid[0, sl]
        one = bool((gl == gl[0]).all())
        gg = int(grp[g0])
        pen = (biasg[:, gg * LANES + int(gl[0])] if one
               else biasg[:, gg * LANES : (gg + 1) * LANES].min(1).values)
        xmin = (acc[:, sl] + n2[:, sl]).min(1).values
        for bound in ((floor + n2min) + pen, xmin + pen):
            k = keys[:, sl][:, fin[sl]]
            if k.numel():
                assert (bound[:, None] <= k).all(), g0
    masked = bias >= 5e8
    closed = ((floor[:, None] + n2) + bias)[masked & fin[None, :]]
    assert (closed >= 1e8).all()


# -- the fragments: the header's expressions against PTX's layouts ----------


def shl(x, n):
    """PTX shl.b32: the shift clamped at 32."""
    n &= 0xFFFFFFFF
    return 0 if n >= 32 else (x << n) & 0xFFFFFFFF


def byte_perm(x, y, s):
    """CUDA __byte_perm: result byte i is byte (s >> 4 i) & 7 of y:x."""
    b = (x & 0xFFFFFFFF) | (y & 0xFFFFFFFF) << 32
    return sum(((b >> 8 * ((s >> 4 * i) & 7)) & 0xFF) << 8 * i for i in range(4))


# the header's expressions the tests evaluate, by the pattern that finds them
EXPR = {
    "kb16": r"const uint32_t kb16 = ([^;]+);",
    "d": r"const uint32_t d = ([^;]+);",
    "b0": r"\n\s*b0 = (shl\([^;]+\));",
    "b1": r"\n\s*b1 = (shl\([^;]+\));",
    "word": r"codes \+ tw \* WCOLS \+ ([^;]+)\);",  # a lane's code word (bytes)
    "sel": r"__byte_perm\(w, 0u, ([^)]+)\)",  # n-tile nt's byte of it
    "row": r"const int r = (16 \* [^;]+);",  # row of a thread's j-th pair
    "s0": r"const int s0 = ([^;]+);",  # a thread's first column
    "acc": r"acc\[([^;]+?\]\[[^;]+?\]\[[^;]+?)\] \+ c\.n2\[i\]",
    "lane_addr": r"lut_lane = recon_mma::smem_u32\(lut\) \+([^;]+);",
    "ldsm_off": r"ldsm_x4\(lut_lane \+ ([^,]+), a\)",
    "row16": r"const int row16 = ([^;]+);",
    "row_bytes": r"lut_row_bytes\(int M\) \{ return ([^;]+); \}",
}


def ev(name, **env):
    """Evaluate the header's expression ``name`` with the given values."""
    return eval(c_expr(EXPR[name]), {"shl": shl}, env)


def onehot_regs(code, lane):
    """The lane's B fragment registers (b0, b1) for a column of code
    ``code``, by adc_mma.cuh's onehot() and kb16."""
    kb16 = ev("kb16", lane=lane)
    d = ev("d", c=code, kb16=kb16) & 0xFFFFFFFF
    return ev("b0", d=d), ev("b1", d=d)


def assemble_b(codes):
    """The 16 x 8 bf16 bit patterns the 32 lanes' registers hold for the 8
    columns' codes, placed where PTX's m16n8k16 B fragment puts them: lane l
    holds column l // 4, k rows 2 (l % 4) + {0, 1} in b0 (low half first)
    and + 8 in b1."""
    B = np.full((16, 8), -1, np.int64)
    for lane in range(32):
        n, k0 = lane // 4, 2 * (lane % 4)
        b0, b1 = onehot_regs(int(codes[n]), lane)
        for reg, k in ((b0, k0), (b1, k0 + 8)):
            B[k, n], B[k + 1, n] = reg & 0xFFFF, reg >> 16
    return B


def test_onehot_fragment_equals_the_dense_onehot():
    """For every code in every column (and random mixes), the header's
    fragment build assembles the dense 16 x 8 one-hot, 1.0 as bf16 0x3F80."""
    rs = np.random.RandomState(5)
    cases = [np.full(8, c) for c in range(16)] + [rs.randint(16, size=8) for _ in range(64)]
    for codes in cases:
        dense = np.where(np.arange(16)[:, None] == codes[None, :], ONE, 0)
        np.testing.assert_array_equal(assemble_b(codes), dense)


def test_code_word_and_accumulator_slots_cover_the_warp():
    """The products put the code of slot word(l) + sel(nt) of the warp's
    columns in B's column l // 4 of n-tile nt; PTX's m16n8 accumulator
    element e of lane l is row l // 4 + 8 (e // 2), column 2 (l % 4) + e % 2.
    The epilogue's accumulator for its pair j and column i must then be the
    header's row and slot s0 + i, and over the lanes of a row every one of the
    warp's 32 slots is held once."""
    word = np.arange(32, dtype=np.uint8)  # the codes of slots 0..31
    packed = word.view("<u4")
    slot_of = {}  # (n, nt) -> the slot whose code B's column n of n-tile nt holds
    for lane in range(32):
        off = ev("word", lane=lane)
        assert off % 4 == 0
        for nt in range(H["NT"]):
            code = byte_perm(int(packed[off // 4]), 0, ev("sel", nt=nt))
            slot_of[lane // 4, nt] = code
    held = {}
    for lane in range(32):
        s0 = ev("s0", tw=0, WCOLS=H["WCOLS"], lane=lane)
        for j in range(2 * H["RB"]):
            r = ev("row", j=j, lane=lane)
            for i in range(8):
                rb, nt, e = eval(f"({c_expr(EXPR['acc']).replace('][', ', ')})", {"i": i, "j": j})
                assert 16 * rb + lane // 4 + 8 * (e // 2) == r, (lane, j, i)
                assert slot_of[2 * (lane % 4) + e % 2, nt] == s0 + i, (lane, j, i)
                held.setdefault(r, []).append(s0 + i)
    assert sorted(held) == list(range(BM))
    for row, slots in held.items():
        assert sorted(slots) == list(range(H["WCOLS"])), row


@pytest.mark.parametrize("Mq", [1, 4, 8, 16, 20, 32, 37])
def test_lut_rows_ldmatrix_without_bank_conflicts(Mq):
    """ldmatrix.x4 in PTX: lanes 8 i .. 8 i + 7 address the 8 rows of
    matrix i, which becomes register a_i, and the m16n8k16 A fragment's
    a0..a3 are rows 0-7 / 8-15 at k 0-7, then at k 8-15. The header's lane
    address plus its offset of row block rb and sub-quantizer m must be that
    row's entries of m, and with its LUT row stride the 8 rows of each
    matrix lie in 8 different 16-byte bank groups."""
    row_bytes = ev("row_bytes", M=Mq)
    row16 = ev("row16", row_bytes=row_bytes)
    for rb in range(H["RB"]):
        for m in (0, 1, Mq - 1):
            for mat in range(4):
                addr = []
                for lane in range(8 * mat, 8 * mat + 8):
                    got = (ev("lane_addr", lane=lane, row_bytes=row_bytes)
                           + ev("ldsm_off", rb=rb, row16=row16, m=m))
                    row = 16 * rb + lane % 8 + 8 * (mat % 2)
                    assert got == row * row_bytes + m * 32 + 16 * (mat // 2), (lane, rb, m)
                    addr.append(got)
                assert len({(a // 16) % 8 for a in addr}) == 8, (Mq, m, mat)


def test_wrapper_sizes_are_the_headers():
    """The wrapper splits K4's columns in the header's tiles and counts its
    blocks of the header's queries."""
    assert fused_knn.ADC_TC_BLOCK == BM and fused_knn.ADC_TC_TILE == BN


# -- the wrapper --------------------------------------------------------------


class FakeLibrary:
    """The built ivfpq_adc library as the wrapper sees it: the tensor-core
    kernel takes the (M, ksub) in ``tc_shapes`` (answer its shared memory,
    else -1); the calls are recorded."""

    def __init__(self, tc_shapes):
        self.tc_shapes, self.calls = tc_shapes, []

    def ivfpq_adc_smem_bytes(self, M, ksub, tc):
        self.calls.append((M, ksub, tc))
        return 1000 if tc and (M, ksub) in self.tc_shapes else -1


def test_tc_shared_memory_and_shape_route(monkeypatch):
    """adc_on_tensor_cores asks the built library's
    ivfpq_adc_smem_bytes(M, ksub, 1) and takes the tensor cores where it
    answers a size, the lookup scan where it answers -1; in the launcher
    that answer and the launch's own refusal are one decision (tc_takes:
    ksub <= 16 and the block's shared memory within the card's)."""
    lib = FakeLibrary({(32, 16)})
    monkeypatch.setattr(fused_knn, "build_kernel", lambda name: (lib, ""))
    assert fused_knn.adc_on_tensor_cores(32, 16)
    assert not fused_knn.adc_on_tensor_cores(8, 256)
    assert not fused_knn.adc_on_tensor_cores(38, 16)
    assert lib.calls == [(32, 16, 1), (8, 256, 1), (38, 16, 1)]
    src = (fused_knn.CSRC / "ivfpq_adc.cu").read_text()
    assert re.search(r"if \(tc\) return tc_takes\(M, ksub\) \? adc_mma::smem_bytes\(M\) : -1;", src)
    assert re.search(r"if \(!tc_takes\(M, ksub\) \|\|", src)
    body = re.search(r"bool tc_takes\(int M, int ksub\) \{([^}]+)\}", src).group(1)
    assert "ksub <= 16" in body and "adc_mma::smem_bytes(M) <= adc_mma::MAX_SMEM" in body


@pytest.fixture
def fake_card(monkeypatch):
    """ivfpq_fused's CUDA route on CPU tensors: the launch is recorded, not
    made (132 SMs); the library's tensor-core kernel takes M <= 37 at
    ksub <= 16, as chip_smoke.py checks the built one does."""
    calls = []
    lib = FakeLibrary({(Mq, ks) for Mq in range(1, 38) for ks in range(1, 17)})
    monkeypatch.setattr(fused_knn, "build_kernel", lambda name: (lib, ""))
    monkeypatch.setattr(fused_knn, "_route", lambda name, ts: True)
    monkeypatch.setattr(fused_knn, "_sm_count", lambda index: 132)
    monkeypatch.setattr(fused_knn, "_stream", lambda device: 0)
    monkeypatch.setattr(fused_knn, "_launch", lambda name, *a: calls.append((name, a)))
    for attr in ("launches", "tc_launches"):
        monkeypatch.setattr(ivfpq_fused, attr, 0)
    return calls


def route_inputs(nq, Mq, ksub, S=4096, G=2, ct=1024):
    return (torch.zeros(nq, G * 128), torch.zeros(nq, Mq * ksub, dtype=torch.bfloat16),
            torch.zeros(Mq, S, dtype=torch.uint8), torch.zeros(1, S),
            torch.zeros(1, S, dtype=torch.int32))


@pytest.mark.parametrize("nq, Mq, ksub, tc, splits", [
    (2048, 32, 16, 1, 4),  # PQ32x4fs, 32 blocks: 4 column splits
    (8192, 32, 16, 1, 1),  # 128 blocks
    (128, 4, 8, 1, 32),    # capped by the 32 tiles of 128 columns
    (64, 2, 256, 0, 1),    # 8-bit codes: the lookup scan, one launch
    (64, 38, 16, 0, 1),    # rows beyond shared memory: the lookup scan
])
def test_route_is_chosen_by_shape_before_the_launch(fake_card, nq, Mq, ksub, tc, splits):
    a = route_inputs(nq, Mq, ksub)
    ivfpq_fused(*a, qt=64, ct=1024)
    ((name, args),) = fake_card
    assert name == "ivfpq_adc"
    assert args[-3:-1] == (splits, tc)
    assert (args[10] is None) == (args[11] is None) == (splits == 1)
    assert ivfpq_fused.launches == 1 and ivfpq_fused.tc_launches == tc
    assert ivfpq_fused.splits == splits


def test_tc_route_checks_raise(fake_card):
    """16-byte biasg, codesT, n2 and lid (TMA and the bias floor's vector
    loads) and chunks of whole 128-column tiles, on the CUDA route only."""
    base = route_inputs(64, 4, 16)
    ivfpq_fused(*base, qt=64, ct=1024)  # aligned inputs pass
    for i, name in enumerate(("biasg", "luts", "codesT", "n2", "lid")):
        if name == "luts":
            continue
        t = base[i]
        off = 8 // t.element_size()  # 8 bytes: aligned for the contract only
        flat = torch.zeros(t.numel() + off, dtype=t.dtype)
        bad = list(base)
        bad[i] = flat[off:].view(t.shape)
        with pytest.raises(ValueError, match=f"{name} must start on a 16-byte"):
            ivfpq_fused(*bad, qt=64, ct=1024)
    with pytest.raises(ValueError, match="multiple of 128"):
        ivfpq_fused(*route_inputs(64, 4, 16, S=4096), qt=64, ct=64)
    # the lookup scan takes what the tensor-core checks refuse
    fake_card.clear()
    ivfpq_fused(*route_inputs(64, 2, 256, S=4096), qt=64, ct=64)
    assert fake_card[0][1][-2] == 0


def test_cpu_tensors_take_the_plain_version(layout):
    """Without the fake card the wrapper runs ivfpq_fused_ref on CPU
    tensors, bit for bit, and counts no launch."""
    a = torch_args(*adc_inputs(layout, 16, True, seed=4))
    before = (ivfpq_fused.launches, ivfpq_fused.tc_launches)
    got = ivfpq_fused(*a, qt=QT, ct=CT)
    want = ivfpq_fused_ref(*a, qt=QT, ct=CT)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    assert (ivfpq_fused.launches, ivfpq_fused.tc_launches) == before


def test_split_count_of_k4():
    """K4 splits its 128-column tiles: 2048 queries (32 blocks) into 4
    splits, 8192 (128 blocks) into none, on 132 SMs."""
    tiles = 513 * 2048 // BN
    assert fused_knn._split_count(32, tiles, 132) == 4
    assert fused_knn._split_count(128, tiles, 132) == 1
    pk, ps = fused_knn._split_scratch(4, 2048, torch.device("cpu"))
    assert pk.shape == ps.shape == (4, 2048, 128)


def test_tc_source_needs_the_toolkit(monkeypatch, tmp_path):
    """ivfpq_adc.cu includes the new header, which enters the build's hash,
    and builds only where nvcc is: no CPU fallback."""
    src = (fused_knn.CSRC / "ivfpq_adc.cu").read_text()
    assert '#include "adc_mma.cuh"' in src and '#include "adc_scan.cuh"' in src
    hdr = (fused_knn.CSRC / "adc_mma.cuh").read_text()
    assert "tile_select::Select<BM, CAP, PHASE>" in hdr and "mma.sync" in hdr
    assert "adc_mma.cuh" in {h.name for h in fused_knn.CSRC.glob("*.cuh")}
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(fused_knn, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        fused_knn.build_kernel.__wrapped__("ivfpq_adc")
