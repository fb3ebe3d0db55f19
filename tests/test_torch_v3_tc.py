"""K6 on the tensor cores (faiss_tpu_torch.ops.fused_knn.ivfpq_fused_v3,
csrc/ivfpq_v3.cu over csrc/adc_mma.cuh) as far as the CPU reaches it:

- its arithmetic, emulated in torch over the codes the one-hot pass decodes:
  bf16 LUTs one k-step per sub-quantizer (its 16 entries, zero past ksub)
  into float32, then K6's order ``lut + (bias + n2)``; int8 LUTs one
  m16n8k32 k-step per pair of sub-quantizers (a zero one after an odd M)
  summed in int32, then ``(a * acc + c) + (bias + n2)``, the product and
  the sum rounded on their own; over 128-column tiles split across blocks
  as the kernel splits them, with an exact top-128. It stays within
  chip_smoke's lane tolerance of ivfpq_fused_v3_ref and agrees with
  faiss_tpu's ivfpq_fused_pallas_v3 (interpret mode) on the layout of
  test_torch_v3_kernels (200 lists, G = 2, 256-slot chunks, PAD chunk
  trimmed), ids tie-aware, with that file's tolerances; a meta whose (a, c)
  vary by lane on some rows takes the ungated path and still equals the
  plain version and float64;
- the epilogue's gates in K6's order: for uniform int8 rows and for bf16,
  the LUT floor plus (the gate's bias + the smallest n2), and the smallest
  key with the gate's bias, never exceed a key of the row;
- the header's own expressions (read from adc_mma.cuh and evaluated here)
  against PTX's m16n8k32 s8 and ldmatrix layouts: the one-hot B registers
  over 32 lanes equal the dense one-hot of every pair of codes; each lane's
  ldmatrix address hits its A fragment row; the int8 LUT rows put the 8
  rows of a matrix in 8 bank groups; the accumulator slots cover a warp's
  32 columns once; the shared memory per block and so each mode's largest M;
- the wrapper on a faked card: the instance chosen by shape before the
  launch in both modes, the split count and scratch, ``tc_launches``, the
  CUDA route's refusals, and CPU tensors taking the plain version.

The CUDA kernel itself is checked on the card by chip_smoke.py (phase 12a)."""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faiss_tpu.models.ivf_pq import pack_invlists_grouped
from faiss_tpu.ops.pallas_knn import ivfpq_fused_pallas_v3
from faiss_tpu_torch.ops import fused_knn
from faiss_tpu_torch.ops import quantize_lut as port_q
from faiss_tpu_torch.ops.fused_knn import ivfpq_fused_v3, ivfpq_fused_v3_ref
from faiss_tpu_torch.ops.topk import merge_topk
from faiss_tpu_torch.utils.evaluation import ids_agree_tie_aware
from torch_threads import one_torch_thread  # noqa: F401

NQ, QT, M, KSUB, NLIST, CT, NB, KC = 72, 8, 5, 16, 200, 256, 900, 24
LANES = 128

# -- adc_mma.cuh's own expressions --------------------------------------------

HEADER = (fused_knn.CSRC / "adc_mma.cuh").read_text()


def c_expr(pattern, group=1):
    """The C expression that ``pattern`` captures in adc_mma.cuh (every
    match the same), as Python: unsigned suffixes dropped, division
    integral."""
    found = {m.group(group) for m in re.finditer(pattern, HEADER)}
    assert len(found) == 1, (pattern, found)
    e = re.sub(r"\b(0x[0-9A-Fa-f]+|\d+)u\b", r"\1", found.pop())
    return " ".join(e.replace("/", "//").split())


def header_consts():
    """The header's ``constexpr int`` constants, evaluated in order."""
    env = {}
    for name, e in re.findall(r"constexpr int (\w+) = ([^;]+);", HEADER):
        env[name] = eval(e.replace("/", "//"), {}, dict(env))
    return env


H = header_consts()
BM, BN = H["BM"], H["BN"]


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
    "onehot8": r"onehot8\(uint32_t c, uint32_t kb16\) \{\s*return (shl\([^;]+\));",
    "b0_word": r"b\[nt\]\[0\] = onehot8\(__byte_perm\((\w+), 0u",
    "b1_word": r"b\[nt\]\[1\] = onehot8\(__byte_perm\((\w+), 0u",
    "sel8": r"b\[nt\]\[0\] = onehot8\(__byte_perm\(\w+, 0u, ([^)]+)\)",
    "w": r"const uint32_t w = cw\[(2 \* m[^\]]*)\];",
    "w1_if": r"const uint32_t w1 = ([^?]+) \? cw\[",
    "w1": r"const uint32_t w1 = [^?]+ \? cw\[([^\]]+)\] : 0u;",
    "word": r"codes \+ tw \* WCOLS \+ ([^;]+)\);",
    "nk": r"const int nk = MODE == MODE_V3_INT8 \? ([^:]+) :",
    "row": r"const int r = (16 \* [^;]+);",
    "s0": r"const int s0 = ([^;]+);",
    # K6's gate and offer read the LUT term of pair j, column i here; the
    # int8 sums are dequantized in place (the same index on both sides)
    "acc": r"xmin = fminf\(xmin, acc\[([^;]+?\]\[[^;]+?\]\[[^;]+?)\] \+ rest\);",
    "acc_key": r"const float key = acc\[([^;]+?\]\[[^;]+?\]\[[^;]+?)\] \+ rest;",
    "deq_out": r"lut\[([^=]+?)\] =\s*dequant\(acc\[",
    "deq_in": r"lut\[[^=]+?\] =\s*dequant\(acc\[([^,]+?)\],",
    "lane_addr": r"lut_lane = recon_mma::smem_u32\(lut\) \+([^;]+);",
    "ldsm_off": r"ldsm_x4\(lut_lane \+ ([^,]+), a\)",
    "row16": r"const int row16 = ([^;]+);",
    "row_bytes": r"lut_row_bytes\(int M\) \{ return ([^;]+); \}",
    "row8_bytes": r"lut8_row_bytes\(int M\) \{ return ([^;]+); \}",
    "margin": r"return lo - mag \* \(([^)]+)\);",
}


def ev(name, **env):
    """Evaluate the header's expression ``name`` with the given values."""
    return eval(c_expr(EXPR[name]), {"shl": shl}, env)


# -- the layout of test_torch_v3_kernels --------------------------------------


@pytest.fixture(scope="module")
def v3():
    """faiss_tpu's group-packed layout (200 lists, G = 2, chunks of 256
    slots, 4 data chunks; the PAD chunk trimmed), M = 5 sub-quantizers (an
    odd M: the int8 k-steps end on a zero sub-quantizer) of 16 entries, and
    NQ = 72 queries (a block of 64 and a partial one)."""
    rs = np.random.RandomState(3)
    listnos = rs.randint(NLIST, size=NB).astype(np.int32)
    g = pack_invlists_grouped(listnos, NLIST, CT)
    assert g["ngroups"] == 2 and g["S"] == 4 * CT
    S = g["S"]
    lid = g["lid"].astype(np.int32)[None]
    codesT = rs.randint(KSUB, size=(M, S)).astype(np.uint8)
    n2 = (rs.rand(1, S) * 2).astype(np.float32)
    n2[0][g["slot_map"] < 0] = np.inf
    luts3 = rs.randn(NQ, M, KSUB).astype(np.float32)
    q8, meta = port_q.quantize_luts_int8(t(luts3))
    biasg = rs.randn(NQ, 2 * LANES).astype(np.float32)
    ohT = {int8: port_q.expand_onehot(t(codesT), t(lid), KSUB, int8)
           for int8 in (False, True)}
    mag = np.abs(biasg).max(1) + 2.0 + np.abs(luts3).max(2).sum(1)
    return dict(S=S, lid=lid, codesT=codesT, n2=n2, luts3=luts3,
                lutsb=t(luts3.reshape(NQ, -1)).to(torch.bfloat16), q8=q8,
                meta=meta, biasg=biasg, ohT=ohT, mag=mag)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def v3_args(V, int8, meta=None, nq=NQ):
    luts = V["q8"] if int8 else V["lutsb"]
    if meta is None:
        meta = V["meta"] if int8 else torch.zeros(NQ, 2 * LANES)
    return (t(V["biasg"][:nq]), luts[:nq], meta[:nq], V["ohT"][int8], t(V["n2"]))


def lane_meta(V, rows):
    """V's int8 meta with (a, c) varying by lane on ``rows``: the rows that
    take the ungated path."""
    meta = V["meta"].clone()
    lane = torch.arange(LANES, dtype=torch.float32)
    meta[rows, :LANES] *= 1.0 + 0.01 * (lane % 7)
    meta[rows, LANES:] += 0.1 * (lane % 5) - 0.2
    return meta


def uniform(meta):
    """adc_mma.cuh's load_meta: a row is uniform when its 128 a's are
    equal, its 128 c's are equal and a is positive and finite."""
    a, c = meta[:, :LANES], meta[:, LANES:]
    return ((a == a[:, :1]).all(1) & (c == c[:, :1]).all(1) & (a[:, 0] > 0)
            & torch.isfinite(a[:, 0]))


# -- the kernel's arithmetic, emulated ---------------------------------------


def decode(ohT, Kpq, ksub):
    """The one-hot pass: each column's code per sub-quantizer [M, S] and its
    list id [1, S]."""
    oh = ohT.float()
    codes = oh[:Kpq].view(Kpq // ksub, ksub, -1).argmax(1)
    return codes, oh[Kpq:].argmax(0)[None]


def lut_terms(luts, meta, codes, c0, c1, int8):
    """The products over columns [c0, c1) and the LUT term of K6's key. bf16:
    per sub-quantizer one k-step, the LUT block [nq, 16] (zero past ksub)
    times the one-hot of the codes [16, C], added to float32 from 0. int8:
    per pair of sub-quantizers (a zero one after an odd M, selected by code
    0) one k-step of 32 k rows, summed exactly (int32), then ``a * acc + c``
    with (a, c) at the slot's lane, rounded twice."""
    nq, Mq = luts.shape[0], codes.shape[0]
    ksub = luts.shape[1] // Mq
    Mp = Mq + Mq % 2 if int8 else Mq
    lut = torch.zeros(nq, Mp, 16, dtype=torch.float64)
    lut[:, :Mq, :ksub] = luts.view(nq, Mq, ksub).double()
    cp = torch.zeros(Mp, c1 - c0, dtype=torch.long)
    cp[:Mq] = codes[:, c0:c1]
    if not int8:
        acc = torch.zeros(nq, c1 - c0)
        for m in range(Mq):
            oh = (cp[m][None, :] == torch.arange(16)[:, None]).double()
            acc = acc + (lut[:, m] @ oh).float()  # one nonzero product a key
        return acc
    acc = torch.zeros(nq, c1 - c0, dtype=torch.int32)
    for m in range(Mp // 2):  # one m16n8k32 k-step: 32 k rows
        a = torch.cat([lut[:, 2 * m], lut[:, 2 * m + 1]], 1)
        oh = torch.cat([(cp[2 * m][None, :] == torch.arange(16)[:, None]),
                        (cp[2 * m + 1][None, :] == torch.arange(16)[:, None])]).double()
        acc = acc + (a @ oh).round().int()  # exact: integers below 2^53
    lane = torch.arange(c0, c1) % LANES
    return meta[:, lane] * acc.float() + meta[:, LANES + lane]


def tc_keys(biasg, luts, meta, codes, lid, n2, ct, c0, c1, int8):
    """The kernel's keys over columns [c0, c1): lut + (bias + n2)."""
    S = codes.shape[1]
    G = biasg.shape[1] // LANES
    grp = torch.arange(c0, c1) // ct // ((S // ct) // G)
    assert int(grp.max()) < G  # chunk / cpg: K4's min(., G - 1) changes nothing
    bias = biasg[:, grp * LANES + lid[0, c0:c1]]
    return lut_terms(luts, meta, codes, c0, c1, int8) + (bias + n2[:, c0:c1])


def tc_scan(biasg, luts, meta, ohT, n2, ct, ksub, int8, splits=1):
    """The launch: the one-hot pass, then the columns in ``splits`` ranges of
    whole 128-column tiles, an exact top-128 per split, the splits merged.
    Returns (keys, slots)."""
    nq, S = luts.shape[0], ohT.shape[1]
    codes, lid = decode(ohT, luts.shape[1], ksub)
    tiles = S // BN
    split_cols = -(-tiles // splits) * BN
    keys = torch.full((nq, LANES), float("inf"))
    slots = torch.full((nq, LANES), -1, dtype=torch.int64)
    for p in range(splits):
        c0, c1 = p * split_cols, min(S, (p + 1) * split_cols)
        if c1 <= c0:
            continue
        sc = tc_keys(biasg, luts, meta, codes, lid, n2, ct, c0, c1, int8)
        v, pos = torch.topk(sc, min(LANES, c1 - c0), dim=1, largest=False)
        keys, slots = merge_topk(keys, slots, v, pos + c0, LANES, largest=False)
    return keys, torch.where(torch.isinf(keys), -1, slots)


def lane_tol(mag, n2, keys, slots):
    """chip_smoke.py's lane_tol, with the magnitude of a key's terms in the
    place of |q|^2."""
    n2s = torch.where(slots >= 0, n2[0, slots.clamp_min(0)].double(), 0.0)
    fin = torch.where(torch.isfinite(keys), keys.double().abs(), 0.0)
    return 1e-4 * (torch.as_tensor(mag)[:, None].double() + n2s) + 1e-6 * fin


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


def float64_keys(V, meta, int8):
    """Every key of K6's contract over the layout, in float64."""
    codes = V["codesT"].astype(np.int64)
    S = V["S"]
    cols = (np.arange(S) // CT // 2) * LANES + V["lid"][0]
    rest = V["biasg"].astype(np.float64)[:, cols] + V["n2"]
    if not int8:
        lut = V["lutsb"].float().numpy().astype(np.float64).reshape(NQ, M, KSUB)
        return sum(lut[:, m, codes[m]] for m in range(M)) + rest
    q8 = V["q8"].numpy().astype(np.int64).reshape(NQ, M, KSUB)
    acc = sum(q8[:, m, codes[m]] for m in range(M))
    mt = meta.numpy().astype(np.float64)
    lane = np.arange(S) % LANES
    return mt[:, lane] * acc + mt[:, LANES + lane] + rest


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("splits", [1, 2, 3, 7])
def test_tc_arithmetic_within_lane_tol_of_plain_version(v3, int8, splits):
    """72 queries (a block and a partial one) over the columns split into
    1, 2, 3 or 7 ranges of whole tiles: the emulated kernel against
    ivfpq_fused_v3_ref on every row and lane (int8: the same keys, since
    both sums are exact and the epilogue rounds as the plain version does),
    and the same keys for every split count."""
    V = v3
    a = v3_args(V, int8)
    rk, rs_, _ = ivfpq_fused_v3_ref(*a, qt=QT, ct=CT, ksub=KSUB)
    k, s = tc_scan(*a, CT, KSUB, int8, splits)
    assert_lanes(k, s, rk, rs_, lane_tol(V["mag"], a[4], rk, rs_))
    if int8:
        assert torch.equal(k, rk)
    k1, s1 = tc_scan(*a, CT, KSUB, int8)
    assert torch.equal(k, k1)
    assert ids_agree_tie_aware(k1.numpy(), s1.numpy(), k.numpy(), s.numpy(), 0.0).all()


def bf16_jax(x):
    """A bfloat16 torch tensor as a jax array (bit for bit)."""
    return jnp.asarray(x.view(torch.int16).numpy()).view(jnp.bfloat16)


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_tc_arithmetic_matches_pallas_k6(v3, int8):
    """faiss_tpu's K6 (interpret mode) on the first 16 queries: on the rows
    its eviction floor marks exact among the first KC keys, keys within 1e-4
    of the magnitude of their terms (faiss_tpu adds the coarse bias as bf16
    hi + lo) and ids tie-aware; every key within 1e-5 of it of float64."""
    V = v3
    nq = 16
    a = v3_args(V, int8, nq=nq)
    v, sv, evf = map(np.asarray, ivfpq_fused_pallas_v3(
        jnp.asarray(a[0].numpy()),
        jnp.asarray(a[1].numpy()) if int8 else bf16_jax(a[1]),
        jnp.asarray(a[2].numpy()),
        jnp.asarray(a[3].numpy()) if int8 else bf16_jax(a[3]),
        jnp.asarray(a[4].numpy()), qt=nq, ct=CT, interpret=True,
    ))
    k, s = (x.numpy() for x in tc_scan(*a, CT, KSUB, int8))
    tol = 1e-4 * V["mag"][:nq]
    e = evf.min(1) >= v[:, KC - 1]
    assert e.sum() >= nq // 2, e.sum()
    np.testing.assert_allclose(k[e, :KC], v[e, :KC], rtol=0, atol=tol[e].max())
    assert ids_agree_tie_aware(v[e, :KC], sv[e, :KC], k[e, :KC], s[e, :KC], tol[e]).all()
    full = float64_keys(V, V["meta"], int8)[:nq]
    np.testing.assert_allclose(k, np.sort(full, 1)[:, :LANES], rtol=0,
                               atol=1e-5 * V["mag"].max())


def test_nonuniform_meta_takes_the_ungated_path(v3):
    """A meta whose (a, c) vary by lane on every third row: those rows are
    not uniform (and a row of a = 0, a < 0 or a = inf is not either), the
    others are; the emulated kernel, reading (a, c) at each key's lane,
    equals the plain version on every row and float64 within 1e-5 of the
    magnitude of the terms."""
    V = v3
    rows = torch.arange(0, NQ, 3)
    meta = lane_meta(V, rows)
    uni = uniform(meta)
    assert not uni[rows].any() and uni.sum() == NQ - len(rows)
    assert uniform(V["meta"]).all()  # quantize_luts_int8 makes uniform rows
    for bad in (0.0, -1.0, float("inf")):
        m2 = V["meta"].clone()
        m2[5, :LANES] = bad
        assert not uniform(m2)[5] and uniform(m2).sum() == NQ - 1
    a = v3_args(V, True, meta=meta)
    rk, rs_, _ = ivfpq_fused_v3_ref(*a, qt=QT, ct=CT, ksub=KSUB)
    k, s = tc_scan(*a, CT, KSUB, True, splits=3)
    assert_lanes(k, s, rk, rs_, lane_tol(V["mag"], a[4], rk, rs_))
    assert torch.equal(k, rk)
    full = float64_keys(V, meta, True)
    np.testing.assert_allclose(k.numpy(), np.sort(full, 1)[:, :LANES], rtol=0,
                               atol=1e-5 * V["mag"].max())
    # the lane really matters on those rows: the uniform meta gives other keys
    k0, _ = tc_scan(*v3_args(V, True), CT, KSUB, True)
    assert not torch.equal(k0[rows], k[rows]) and torch.equal(k0[uni], k[uni])


def lut_floor(luts, meta, int8):
    """adc_mma.cuh's LUT floor per query: bf16 the float32 sum of the
    sub-quantizers' smallest entries less the header's margin; int8 the
    int32 sum of the smallest entries, dequantized as a key (a uniform
    row's a and c)."""
    lf = luts.float().view(luts.shape[0], M, -1)
    lo = torch.zeros(luts.shape[0])
    if int8:
        lo = lf.min(2).values.sum(1)  # small integers: exact
        return meta[:, 0] * lo + meta[:, LANES]
    mag = torch.zeros(luts.shape[0])
    for m in range(M):
        lo = lo + lf[:, m].min(1).values
        mag = mag + lf[:, m].abs().max(1).values
    margin = eval(re.sub(r"(\d+)\.f\b", r"\1.0", c_expr(EXPR["margin"])))
    return lo - mag * torch.tensor(margin, dtype=torch.float32)


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_epilogue_gates_bound_every_key(v3, int8):
    """Per row and 8-slot group of a thread, in K6's order: the LUT floor +
    (the gate's bias + the smallest n2), and min over the group of lut +
    (the gate's bias + n2), are at most every key of the group, the gate's
    bias being the list's where the 8 slots share a list (then the second
    bound is the smallest key itself), else the row's smallest bias in the
    group; rounded in float32 as the kernel rounds them."""
    V = v3
    biasg, luts, meta, ohT, n2 = v3_args(V, int8)
    S = ohT.shape[1]
    codes, lid = decode(ohT, luts.shape[1], KSUB)
    lut = lut_terms(luts, meta, codes, 0, S, int8)
    floor = lut_floor(luts, meta, int8)
    assert (floor[:, None] <= lut).all()
    grp = torch.arange(S) // CT // 2
    bias = biasg[:, grp * LANES + lid[0]]
    keys = lut + (bias + n2)
    fin = torch.isfinite(n2[0])
    tight = 0
    for g0 in range(0, S, 8):
        sl = slice(g0, g0 + 8)
        gl = lid[0, sl]
        one = bool((gl == gl[0]).all())
        gg = int(grp[g0])
        pen = (biasg[:, gg * LANES + int(gl[0])] if one
               else biasg[:, gg * LANES : (gg + 1) * LANES].min(1).values)
        gate1 = floor + (pen + n2[0, sl].min())
        gate2 = (lut[:, sl] + (pen[:, None] + n2[:, sl])).min(1).values
        k = keys[:, sl][:, fin[sl]]
        if not k.numel():
            continue
        for bound in (gate1, gate2):
            assert (bound[:, None] <= k).all(), g0
        if one:
            assert torch.equal(gate2, k.min(1).values)
            tight += 1
    assert tight > 0  # groups whose 8 slots share a list (lists of ~5 slots here)


# -- the fragments: the header's expressions against PTX's layouts ----------


def assemble_b8(c_even, c_odd):
    """The 32 x 8 int8 one-hot that the 32 lanes' registers hold for 8
    columns whose codes of the pair's sub-quantizers are c_even and c_odd,
    placed where PTX's m16n8k32 s8 B fragment puts them: lane l holds
    column l // 4, k rows 4 (l % 4) + {0..3} in b0 (byte i row + i) and
    16 + 4 (l % 4) + {0..3} in b1."""
    B = np.full((32, 8), -1, np.int64)
    for lane in range(32):
        n, k0 = lane // 4, 4 * (lane % 4)
        kb16 = ev("kb16", lane=lane)
        b0 = ev("onehot8", c=int(c_even[n]), kb16=kb16)
        b1 = ev("onehot8", c=int(c_odd[n]), kb16=kb16)
        for i in range(4):
            B[k0 + i, n] = (b0 >> 8 * i) & 0xFF
            B[16 + k0 + i, n] = (b1 >> 8 * i) & 0xFF
    return B


def test_int8_onehot_fragment_equals_the_dense_onehot():
    """For every code pair in every column (and random mixes), the header's
    m16n8k32 fragment build assembles the dense 32 x 8 one-hot: k row c of
    sub-quantizer 2m and 16 + c of 2m + 1. b0 takes the word of row 2m of
    the stage's codes and b1 that of 2m + 1, or 0 (code 0 of the zero
    sub-quantizer) after an odd M."""
    rs = np.random.RandomState(5)
    cases = [(np.full(8, c0), np.full(8, c1)) for c0 in range(16) for c1 in range(16)]
    cases += [(rs.randint(16, size=8), rs.randint(16, size=8)) for _ in range(64)]
    for c_even, c_odd in cases:
        dense = np.zeros((32, 8), np.int64)
        dense[c_even, np.arange(8)] = 1
        dense[16 + c_odd, np.arange(8)] = 1
        np.testing.assert_array_equal(assemble_b8(c_even, c_odd), dense)
    assert (c_expr(EXPR["b0_word"]), c_expr(EXPR["b1_word"])) == ("w", "w1")
    for m in range(4):
        # word offsets (in 32-bit words) from the lane's word of row 0
        assert ev("w", m=m, BN=BN) * 4 == 2 * m * BN
        assert ev("w1", m=m, BN=BN) * 4 == (2 * m + 1) * BN
    for Mq in (1, 4, 5, 32, 37):
        nk = ev("nk", M=Mq)
        assert nk == -(-Mq // 2)
        pairs = [2 * m + 1 for m in range(nk) if ev("w1_if", m=m, M=Mq)]
        assert pairs == [2 * m + 1 for m in range(Mq // 2)]


def test_code_word_and_accumulator_slots_cover_the_warp():
    """Both modes build n-tile nt's B column l // 4 from byte sel(nt) of the
    lane's code word; PTX's m16n8 accumulator element e of lane l is row
    l // 4 + 8 (e // 2), column 2 (l % 4) + e % 2 (m16n8k32 s32 as m16n8k16
    f32). K6's epilogue reads for its pair j and column i the header's row
    and slot s0 + i, and over the lanes of a row every one of the warp's 32
    slots is held once."""
    packed = np.arange(32, dtype=np.uint8).view("<u4")  # the codes of slots 0..31
    slot_of = {}
    for lane in range(32):
        off = eval(c_expr(EXPR["word"]), {}, {"lane": lane})
        assert off % 4 == 0
        for nt in range(H["NT"]):
            sel = eval(c_expr(EXPR["sel8"]), {}, {"nt": nt})
            slot_of[lane // 4, nt] = byte_perm(int(packed[off // 4]), 0, sel)
    assert c_expr(EXPR["acc"]) == c_expr(EXPR["acc_key"])
    assert c_expr(EXPR["deq_out"]) == c_expr(EXPR["deq_in"]) == c_expr(EXPR["acc"])
    held = {}
    for lane in range(32):
        s0 = eval(c_expr(EXPR["s0"]), {}, {"tw": 0, "WCOLS": H["WCOLS"], "lane": lane})
        for j in range(2 * H["RB"]):
            r = eval(c_expr(EXPR["row"]), {}, {"j": j, "lane": lane})
            for i in range(8):
                rb, nt, e = eval(f"({c_expr(EXPR['acc']).replace('][', ', ')})",
                                 {"i": i, "j": j})
                assert 16 * rb + lane // 4 + 8 * (e // 2) == r, (lane, j, i)
                assert slot_of[2 * (lane % 4) + e % 2, nt] == s0 + i, (lane, j, i)
                held.setdefault(r, []).append(s0 + i)
    assert sorted(held) == list(range(BM))
    for row, slots in held.items():
        assert sorted(slots) == list(range(H["WCOLS"])), row


@pytest.mark.parametrize("Mq", [1, 4, 8, 16, 20, 32, 37, 62])
def test_int8_lut_rows_ldmatrix_without_bank_conflicts(Mq):
    """ldmatrix.x4: lanes 8 i .. 8 i + 7 address the 8 rows of matrix i
    (register a_i), 16 bytes each; the m16n8k32 s8 A fragment's a0..a3 are
    rows 0-7 / 8-15 at k 0-15, then at k 16-31. With the int8 row stride the
    header's lane address plus its offset of row block rb and k-step m must
    be that row's bytes of the pair (2m, 2m + 1), and the 8 rows of each
    matrix lie in 8 different 16-byte bank groups."""
    row_bytes = ev("row8_bytes", M=Mq)
    assert row_bytes >= 32 * -(-Mq // 2) and (row_bytes // 16) % 2 == 1
    row16 = ev("row16", row_bytes=row_bytes)
    for rb in range(H["RB"]):
        for m in (0, 1, -(-Mq // 2) - 1):
            for mat in range(4):
                addr = []
                for lane in range(8 * mat, 8 * mat + 8):
                    got = (ev("lane_addr", lane=lane, row_bytes=row_bytes)
                           + ev("ldsm_off", rb=rb, row16=row16, m=m))
                    row = 16 * rb + lane % 8 + 8 * (mat % 2)
                    assert got == row * row_bytes + m * 32 + 16 * (mat // 2), (lane, rb, m)
                    addr.append(got)
                assert len({(a // 16) % 8 for a in addr}) == 8, (Mq, m, mat)


def smem_bytes(Mq, int8):
    """Shared memory of a block, from the header's sizes: the ring, the LUT
    rows, the select (tile_select.cuh: 8 bytes a pair and a query's count
    and threshold), the LUT floors, int8's (a, c) and the mbarriers."""
    row = ev("row8_bytes" if int8 else "row_bytes", M=Mq)
    select = 8 * BM * H["CAP"] + 8 * BM
    return (H["STAGES"] * (Mq * BN + BN * 8) + BM * row + select + BM * 4
            + (BM * 8 if int8 else 0) + H["STAGES"] * 8)


def test_shared_memory_gives_each_modes_largest_m():
    """The header's sizes: M = 32 takes 218,912 bytes in bf16 and 186,656 in
    int8, and the largest M within a block's 232,448 bytes is 37 (bf16) and
    61 (int8), as the wrapper's docstring and the faked library say."""
    assert smem_bytes(32, False) == 218912 and smem_bytes(32, True) == 186656
    for int8, top in ((False, 37), (True, 61)):
        fits = [Mq for Mq in range(1, 80) if smem_bytes(Mq, int8) <= H["MAX_SMEM"]]
        assert fits == list(range(1, top + 1))
    body = re.search(r"constexpr int smem_bytes\(int M, int mode = MODE_K4\) \{([^}]+)\}",
                     HEADER).group(1)
    assert "(mode == MODE_V3_INT8 ? BM * 8 : 0)" in body and "Select::kBytes" in body


# -- the wrapper --------------------------------------------------------------

TC_M = {False: 37, True: 61}  # the largest M of each mode (above)


class FakeLibrary:
    """The built ivfpq_v3 library as the wrapper sees it: the tensor-core
    kernel takes ksub <= 16 and M up to the mode's limit (answer its shared
    memory, else -1); the calls are recorded."""

    def __init__(self):
        self.calls = []

    def ivfpq_v3_smem_bytes(self, Mq, ksub, int8, tc):
        self.calls.append((Mq, ksub, int8, tc))
        return smem_bytes(Mq, int8) if tc and ksub <= 16 and Mq <= TC_M[bool(int8)] else -1


def route_inputs(nq, Mq, ksub, int8, S=4096, G=2):
    dt = torch.int8 if int8 else torch.bfloat16
    return (torch.zeros(nq, G * LANES), torch.zeros(nq, Mq * ksub, dtype=dt),
            torch.zeros(nq, 2 * LANES), torch.zeros(Mq * ksub + LANES, S, dtype=dt),
            torch.zeros(1, S))


class Calls(list):
    """The recorded launches, and the fake library."""


@pytest.fixture
def card(monkeypatch):
    """ivfpq_fused_v3's CUDA route on CPU tensors: the launch is recorded,
    not made (132 SMs; the count of bad columns stays 0)."""
    calls = Calls()
    calls.lib = FakeLibrary()
    monkeypatch.setattr(fused_knn, "build_kernel", lambda name: (calls.lib, ""))
    monkeypatch.setattr(fused_knn, "_route", lambda name, ts: True)
    monkeypatch.setattr(fused_knn, "_sm_count", lambda index: 132)
    monkeypatch.setattr(fused_knn, "_stream", lambda device: 0)
    monkeypatch.setattr(fused_knn, "_launch", lambda name, *a: calls.append((name, a)))
    for attr in ("launches", "int8_launches", "tc_launches", "splits"):
        monkeypatch.setattr(ivfpq_fused_v3, attr, 0)
    return calls


@pytest.mark.parametrize("nq, Mq, ksub, int8, tc, splits", [
    (2048, 32, 16, False, 1, 4),  # PQ32x4fs, 32 blocks: 4 column splits
    (2048, 32, 16, True, 1, 4),
    (8192, 32, 16, True, 1, 1),   # 128 blocks
    (128, 4, 8, False, 1, 32),    # capped by the 32 tiles of 128 columns
    (64, 8, 256, False, 0, 1),    # 8-bit codes: the lookup scan, one launch
    (64, 8, 256, True, 0, 1),
    (64, 38, 16, False, 0, 1),    # bf16 rows beyond shared memory
    (64, 38, 16, True, 1, 32),    # ... which int8 rows still fit
    (64, 62, 16, True, 0, 1),     # int8 rows beyond shared memory
])
def test_route_is_chosen_by_shape_before_the_launch(card, nq, Mq, ksub, int8, tc, splits):
    ivfpq_fused_v3(*route_inputs(nq, Mq, ksub, int8), qt=64, ct=1024, ksub=ksub)
    ((name, args),) = card
    assert name == "ivfpq_v3"
    assert card.lib.calls == [(Mq, ksub, int(int8), 1)]
    assert args[-4:-1] == (int(int8), splits, tc)
    assert (args[11] is None) == (args[12] is None) == (splits == 1)
    v3f = ivfpq_fused_v3
    assert (v3f.launches, v3f.int8_launches, v3f.tc_launches, v3f.splits) == (
        1, int(int8), tc, splits)


def test_split_count_and_scratch_of_k6():
    """K6 at 2048 queries over the 1,048,576 columns of PQ32x4fs's data
    chunks: 32 blocks, 4 splits on 132 SMs, scratch [4, 2048, 128]; 8192
    queries run one split and no scratch."""
    tiles = (1 << 20) // BN
    assert fused_knn._split_count(32, tiles, 132) == 4
    assert fused_knn._split_count(128, tiles, 132) == 1
    pk, ps = fused_knn._split_scratch(4, 2048, torch.device("cpu"))
    assert pk.shape == ps.shape == (4, 2048, 128) and ps.dtype == torch.int32
    assert fused_knn._split_scratch(1, 2048, torch.device("cpu")) == (None, None)
    assert fused_knn.ADC_TC_BLOCK == BM and fused_knn.ADC_TC_TILE == BN


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_tc_route_checks_raise(card, int8):
    """The tensor-core route needs biasg and n2 on 16-byte boundaries (the
    bias floor's vector loads, TMA); the contract asks only 8 of n2, and the
    lookup scan takes what the tensor-core checks refuse. ct must hold whole
    128-column tiles, which the contract's multiple of 256 already gives."""
    base = route_inputs(64, 4, 16, int8)
    ivfpq_fused_v3(*base, qt=64, ct=1024, ksub=16)  # aligned inputs pass
    for i, name in ((0, "biasg"), (4, "n2")):
        t_ = base[i]
        flat = torch.zeros(t_.numel() + 2)
        bad = list(base)
        bad[i] = flat[2:].view(t_.shape)  # 8 bytes off
        with pytest.raises(ValueError, match=f"K6: {name} must start on a 16-byte"):
            ivfpq_fused_v3(*bad, qt=64, ct=1024, ksub=16)
        card.clear()
        wide = list(route_inputs(64, 8, 256, int8))
        flat = torch.zeros(wide[i].numel() + 2)
        wide[i] = flat[2:].view(wide[i].shape)
        ivfpq_fused_v3(*wide, qt=64, ct=1024, ksub=256)  # the lookup scan
        assert card[0][1][-2] == 0
    with pytest.raises(ValueError, match="ct=192 must be a multiple of 128"):
        fused_knn._check_adc_tc("K6", (), 192)
    with pytest.raises(ValueError, match="ct=128 a multiple of 256"):
        ivfpq_fused_v3(*base, qt=64, ct=128, ksub=16)


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_cpu_tensors_take_the_plain_version(v3, int8):
    """Without the fake card the wrapper runs ivfpq_fused_v3_ref on CPU
    tensors, bit for bit (a non-uniform meta too), and counts no launch."""
    meta = lane_meta(v3, torch.arange(0, NQ, 2)) if int8 else None
    a = v3_args(v3, int8, meta=meta)
    v3f = ivfpq_fused_v3
    before = (v3f.launches, v3f.int8_launches, v3f.tc_launches)
    got = ivfpq_fused_v3(*a, qt=QT, ct=CT, ksub=KSUB)
    want = ivfpq_fused_v3_ref(*a, qt=QT, ct=CT, ksub=KSUB)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    assert (v3f.launches, v3f.int8_launches, v3f.tc_launches) == before


def test_v3_source_builds_on_adc_mma_and_needs_the_toolkit(monkeypatch, tmp_path):
    """ivfpq_v3.cu launches adc_mma.cuh's two K6 modes (m16n8k32 s8 for
    int8) beside the lookup scan, routes by tc_takes in both the library's
    answer and its own refusal, and builds only where nvcc is."""
    src = (fused_knn.CSRC / "ivfpq_v3.cu").read_text()
    assert '#include "adc_mma.cuh"' in src and '#include "adc_scan.cuh"' in src
    for mode in ("MODE_V3_INT8", "MODE_V3"):
        assert f"adc_mma::launch<adc_mma::{mode}>(" in src
    assert re.search(r"if \(tc\) return tc_takes\(M, ksub, int8\) \?", src)
    assert re.search(r"\(tc && \(!tc_takes\(M, ksub, int8\) \|\|", src)
    assert "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32" in HEADER
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(fused_knn, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        fused_knn.build_kernel.__wrapped__("ivfpq_v3")
