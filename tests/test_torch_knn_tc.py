"""K3 on the tensor cores (faiss_tpu_torch.ops.fused_knn.knn_fused,
csrc/knn_fused.cu, csrc/knn_mma.cuh, csrc/radix_select.cuh) as far as the
CPU reaches it:

- its arithmetic, emulated in torch: 3xTF32 (each float32 operand split
  into big = tf32(a), cvt.rna's round half away at 10 mantissa bits, and
  small = tf32(a - big); per 8-dim k-step small.big + big.small + big.big
  into float32), the column norms in float32 FMAs and the key as one
  rounding of fma(-2, ip, n2). It stays within chip_smoke's K3 tolerance
  of knn_fused_ref (1e-4 * (|q|^2 + |y_s|^2)), within Exact's 1e-5 * (|q|^2
  + max |y|^2) of float64, and agrees with faiss_tpu's knn_fused_pallas
  (interpret mode) tie-aware at the shapes of test_torch_flat_kernels;
- the two-pass threshold select, emulated: bucket minima of 32 columns,
  theta by order bits, the lt and eq regions (eq taken in a random order,
  as the atomics take it, and capped at k_lanes) and the final select. On
  the same keys it gives exactly the sorted keys and tie-aware ids of an
  exhaustive sort, and with the emulated arithmetic the values and ids of
  knn_fused_ref, in random and key-sorted column order (where lt reaches
  its bound (k_lanes - 1) * 32 and never passes it), with duplicated
  columns (ties at theta, eq overflowing), with theta = +inf (nb <
  k_lanes * 32) and ids -1 (nb < k_lanes), for L2 and IP, at k_lanes 128,
  256 and 2048 (theta finite on every row at 2048);
- knn_mma.cuh's own constants and index expressions (read from the header
  and evaluated here) against PTX's m16n8k8 TF32 fragment layouts and the
  128-byte TMA swizzle: a warp's simulated mma over the header's A
  fragments and swizzled B reads gives q . y at the row and column its
  epilogue reads, and the B reads hit 32 banks; the wrapper's block, tile,
  bucket and scratch sizes are the header's;
- the wrapper: sub-batches under the scratch cap, the launches it makes on
  a faked card, its CUDA-route checks, the CPU route, and that the source
  builds only where nvcc is.

The CUDA kernels themselves are held against knn_fused_ref on the card by
chip_smoke.py."""

import functools
import re

import numpy as np
import pytest
import torch

from faiss_tpu.ops.pallas_knn import knn_fused_pallas
from faiss_tpu_torch.ops import fused_knn
from faiss_tpu_torch.ops.fused_knn import knn_fused, knn_fused_ref
from faiss_tpu_torch.utils.evaluation import ids_agree_tie_aware
from torch_threads import one_torch_thread  # noqa: F401

HEADER = (fused_knn.CSRC / "knn_mma.cuh").read_text()
SOURCE = (fused_knn.CSRC / "knn_fused.cu").read_text()


def c_expr(pattern, text=HEADER):
    """The C integer expression that ``pattern`` captures (every match the
    same), as Python with integral division."""
    found = {m.group(1) for m in re.finditer(pattern, text)}
    assert len(found) == 1, (pattern, found)
    return " ".join(found.pop().replace("/", "//").split())


def header_consts():
    """The header's ``constexpr int`` constants, evaluated in order."""
    env = {}
    for name, e in re.findall(r"constexpr int (\w+) = ([^;]+);", HEADER):
        env[name] = eval(e.replace("/", "//"), {}, dict(env))
    return env


H = header_consts()
W = H["W"]


# -- the arithmetic, emulated -------------------------------------------------


def tf32(a):
    """cvt.rna.tf32.f32: round half away from zero at 10 mantissa bits (on
    the magnitude bits of the float32 pattern), the low 13 bits zero."""
    u = a.contiguous().numpy().view(np.uint32).astype(np.uint64)
    r = ((u + 0x1000) & 0xFFFFE000).astype(np.uint32)
    r = np.where(np.isfinite(a.numpy()), r, u.astype(np.uint32))
    return torch.from_numpy(r.view(np.float32))


def tc_ip(x, yT):
    """q . y in 3xTF32: per k-step of 8 dims, small_q.big_y, big_q.small_y,
    big_q.big_y, each added to the float32 accumulator."""
    xb, yb = tf32(x), tf32(yT)
    xs, ys = tf32(x - xb), tf32(yT - yb)
    acc = torch.zeros(x.shape[0], yT.shape[1])
    for k0 in range(0, x.shape[1], 8):
        sl = slice(k0, k0 + 8)
        acc = acc + xs[:, sl] @ yb[sl]
        acc = acc + xb[:, sl] @ ys[sl]
        acc = acc + xb[:, sl] @ yb[sl]
    return acc


def fma_norms(yT):
    """n2[s] = fmaf(y, y, n2) over the dims in order, in float32."""
    n = torch.zeros(yT.shape[1], dtype=torch.float64)
    for k in range(yT.shape[0]):
        y = yT[k].double()
        n = (n + y * y).float().double()
    return n.float()


def tc_keys(x, yT, nb, metric_l2):
    """The kernel's keys [nq, nb]: fma(-2, ip, n2) rounded once (L2), -ip
    (IP)."""
    ip = tc_ip(x, yT[:, :nb])
    if metric_l2:
        return (fma_norms(yT[:, :nb]).double()[None] - 2.0 * ip.double()).float()
    return -ip


# -- the two-pass select, emulated --------------------------------------------


def order_bits(f):
    """radix_select.cuh's order bits: unsigned order is float order."""
    u = np.asarray(f, np.float32).view(np.uint32)
    return np.where(u >> 31 == 1, ~u, u | np.uint32(0x80000000)).astype(np.uint32)


def two_pass(keys, k_lanes, seed=0):
    """K3's select on keys [nq, nb]: bucket minima, theta (the k_lanes-th
    smallest by order bits, +inf with fewer buckets), lt and eq (eq in a
    random order, capped at k_lanes), then the final select. Returns
    (sorted keys [nq, k_lanes], ids with -1 past the candidates, lt counts,
    eq counts)."""
    rs = np.random.RandomState(seed)
    k = keys.numpy()
    nq, nb = k.shape
    B = fused_knn.knn_buckets(nb)
    pad = np.full((nq, B * W), np.inf, np.float32)
    pad[:, :nb] = k
    minima = pad.reshape(nq, B, W).min(2)
    lt_cap = fused_knn.knn_lt_cap(k_lanes)
    out_k = np.full((nq, k_lanes), np.inf, np.float32)
    out_i = np.full((nq, k_lanes), -1, np.int64)
    nlt, neq = np.zeros(nq, int), np.zeros(nq, int)
    for r in range(nq):
        if B < k_lanes:
            theta = np.float32(np.inf)
        else:
            bits = np.sort(order_bits(minima[r]))[k_lanes - 1]
            theta = minima[r][order_bits(minima[r]) == bits][0]
        lt = np.nonzero(k[r] < theta)[0]
        eq = rs.permutation(np.nonzero(k[r] == theta)[0])
        nlt[r], neq[r] = len(lt), len(eq)
        assert len(lt) <= lt_cap, (r, len(lt), lt_cap)
        eq = eq[:k_lanes]
        if len(lt) > k_lanes:
            ub = order_bits(k[r][lt])
            kth = np.sort(ub)[k_lanes - 1]
            below = lt[ub < kth]
            ties = rs.permutation(lt[ub == kth])[: k_lanes - len(below)]
            win = np.concatenate([below, ties])
        else:
            win = np.concatenate([lt, eq[: k_lanes - len(lt)]])
        o = np.argsort(order_bits(k[r][win]), kind="stable")
        win = win[o]
        out_k[r, : len(win)] = k[r][win]
        out_i[r, : len(win)] = win
    out_i[~np.isfinite(out_k)] = -1
    return out_k, out_i, nlt, neq


def tc_knn(x, yT, nb, metric_l2, k_lanes, seed=0):
    """The whole emulated K3: (values, ids, lt counts, eq counts) with
    values transformed as the final select writes them."""
    keys = tc_keys(x, yT, nb, metric_l2) if nb else torch.zeros(x.shape[0], 0)
    k, i, nlt, neq = two_pass(keys, k_lanes, seed)
    k = torch.from_numpy(k)
    miss = torch.from_numpy(i < 0)
    if metric_l2:
        qn = fma_norms(x.T.contiguous())
        v = torch.where(miss, float("inf"), (k + qn[:, None]).clamp_min(0.0))
    else:
        v = torch.where(miss, float("-inf"), -k)
    return v, torch.from_numpy(i).int(), nlt, neq


def assert_matches_plain(x, yT, nb, metric_l2, k_lanes, got_v, got_i):
    """chip_smoke.py's K3 comparison: -1 and +-inf at the same places,
    values within 1e-4 * (|q|^2 + |y_s|^2), ids tie-aware at that."""
    rv, ri, rf = knn_fused_ref(x, yT, nb, metric_l2=metric_l2, qt=8,
                               k_lanes=k_lanes)
    rv, ri, v, i = (t.numpy() for t in (rv, ri, got_v, got_i))
    np.testing.assert_array_equal(ri == -1, i == -1)
    np.testing.assert_array_equal(np.isinf(rv), np.isinf(v))
    yn = (yT.double() ** 2).sum(0).numpy()
    qn = (x.double() ** 2).sum(1).numpy()
    tol = 1e-4 * (qn[:, None] + np.where(ri >= 0, yn[np.maximum(ri, 0)], 0))
    fin = np.isfinite(rv)
    err = np.abs(np.where(fin, v, 0) - np.where(fin, rv, 0))
    assert (err <= tol).all(), err.max()
    sign = 1.0 if metric_l2 else -1.0
    agree = ids_agree_tie_aware(np.where(fin, sign * rv, np.inf), ri,
                                np.where(fin, sign * v, np.inf), i,
                                np.where(fin, tol, 0).max(1))
    assert agree.all(), np.where(~agree)


def store(nb, d, seed, nbp=None, dup=1):
    """The bench's kind of store: a Gaussian mixture, with each vector
    repeated ``dup`` times (in a random column order); zero pads to nbp."""
    rs = np.random.RandomState(seed)
    cent = rs.rand(16, d).astype(np.float32)
    base = cent[rs.randint(16, size=-(-nb // dup))] + 0.2 * rs.randn(
        -(-nb // dup), d).astype(np.float32)
    xb = np.repeat(base, dup, 0)[:nb]
    xb = xb[rs.permutation(nb)]
    yT = np.zeros((d, nbp or nb), np.float32)
    yT[:, :nb] = xb.T
    xq = cent[rs.randint(16, size=16)] + 0.2 * rs.randn(16, d).astype(np.float32)
    return torch.from_numpy(xq), torch.from_numpy(yT)


@pytest.mark.parametrize("metric_l2", [True, False], ids=["L2", "IP"])
@pytest.mark.parametrize("d", [128, 20])
def test_3xtf32_within_plain_and_float64_tolerance(metric_l2, d):
    """The emulated keys against knn_fused_ref's float32 keys (1e-4 of
    |q|^2 + |y_s|^2) and float64 (Exact's 1e-5 of |q|^2 + max |y|^2); d = 20
    zero-pads its last k-step."""
    x, yT = store(3000, d, seed=1)
    keys = tc_keys(x, yT, 3000, metric_l2).double()
    x64, y64 = x.double(), yT.double()
    ip = x64 @ y64
    qn, yn = (x64**2).sum(1), (y64**2).sum(0)
    want = yn[None] - 2 * ip if metric_l2 else -ip
    assert ((keys - want).abs() <= 1e-5 * (qn[:, None] + yn.max())).all()
    ref = ((yT**2).sum(0)[None] - 2 * (x @ yT) if metric_l2 else -(x @ yT)).double()
    assert ((keys - ref).abs() <= 1e-4 * (qn[:, None] + yn[None])).all()
    # big + small carries every bit of a float32 that tf32 drops twice over
    a = x.flatten()
    big = tf32(a)
    small = tf32(a - big)
    assert ((big.numpy().view(np.uint32) & 0x1FFF) == 0).all()
    assert ((a - big - small).abs() <= a.abs() * 2.0**-21).all()


def test_tf32_rounds_half_away_from_zero():
    """Ties at bit 12 round the magnitude up, for both signs."""
    for sign in (1.0, -1.0):
        tie = np.array([sign * (1.0 + 2.0**-11)], np.float32)  # halfway between
        below = np.array([sign * (1.0 + 2.0**-11 - 2.0**-23)], np.float32)
        assert tf32(torch.from_numpy(tie)).item() == sign * (1.0 + 2.0**-10)
        assert tf32(torch.from_numpy(below)).item() == sign * 1.0


@pytest.mark.parametrize(
    "k_lanes,metric_l2", [(128, True), (256, False)], ids=["128-L2", "256-IP"],
)
def test_emulated_k3_matches_pallas_kernel(k_lanes, metric_l2):
    """test_torch_flat_kernels' K3 shapes (d=16, nq=128, qt=128, ct=512,
    nb=4000 padded to 4096): values to 1e-4 and ids tie-aware on the rows
    the Pallas kernel does not flag as lossy."""
    import jax.numpy as jnp

    rs = np.random.RandomState(5)
    d, nb, nbp, nq = 16, 4000, 4096, 128
    xb = rs.rand(nb, d).astype(np.float32)
    xq = rs.rand(nq, d).astype(np.float32)
    yT = np.zeros((d, nbp), np.float32)
    yT[:, :nb] = xb.T
    v, i, ev = map(np.asarray, knn_fused_pallas(
        jnp.asarray(xq), jnp.asarray(yT), np.int32(nb), metric_l2=metric_l2,
        qt=128, ct=512, k_lanes=k_lanes, interpret=True,
    ))
    pv, pi, _, _ = tc_knn(torch.from_numpy(xq), torch.from_numpy(yT), nb,
                          metric_l2, k_lanes)
    pv, pi = pv.numpy(), pi.numpy()
    assert (pi >= 0).all() and (pi < nb).all()
    clean = ev.min(1) >= v[:, -1] if metric_l2 else ev.max(1) <= v[:, -1]
    assert clean.mean() > 0.5, clean.mean()
    np.testing.assert_allclose(pv[clean], v[clean], rtol=1e-4, atol=1e-4)
    sign = 1.0 if metric_l2 else -1.0
    agree = ids_agree_tie_aware(sign * v[clean], i[clean], sign * pv[clean],
                                pi[clean], 1e-4)
    assert agree.all(), np.where(~agree)


def sort_columns_by_key(yT, x, nb, metric_l2):
    """The adversarial order: the columns sorted by query 0's key."""
    keys = tc_keys(x[:1], yT, nb, metric_l2)[0]
    out = yT.clone()
    out[:, :nb] = yT[:, :nb][:, torch.argsort(keys, stable=True)]
    return out


CASES = {  # name: (nb, nbp, d, dup, sorted)
    "random": (9000, 9216, 24, 1, False),
    "sorted": (9000, 9216, 24, 1, True),
    "duplicated": (9000, 9216, 24, 200, False),
    "duplicated-sorted": (9000, 9216, 24, 40, True),
    "theta-inf": (3000, 3072, 24, 1, False),
    "ids-missing": (100, 128, 24, 1, False),
}


@pytest.mark.parametrize("k_lanes", [128, 256])
@pytest.mark.parametrize("metric_l2", [True, False], ids=["L2", "IP"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_two_pass_select_matches_plain_version(case, metric_l2, k_lanes):
    nb, nbp, d, dup, by_key = CASES[case]
    x, yT = store(nb, d, seed=7, nbp=nbp, dup=dup)
    if by_key:
        yT = sort_columns_by_key(yT, x, nb, metric_l2)
    v, i, nlt, neq = tc_knn(x, yT, nb, metric_l2, k_lanes, seed=3)
    assert_matches_plain(x, yT, nb, metric_l2, k_lanes, v, i)
    lt_cap = fused_knn.knn_lt_cap(k_lanes)
    assert (nlt <= lt_cap).all()
    B = fused_knn.knn_buckets(nb)
    if case == "sorted":  # query 0's lt reaches its bound, less a bucket
        assert nlt[0] > lt_cap - W
    if case.startswith("duplicated") and k_lanes == 128:
        assert neq.max() > 1  # ties at theta
        if case == "duplicated":
            assert neq.max() > k_lanes  # the eq region overflows and drops
    if B < k_lanes:  # theta = +inf: every key lands in lt
        assert (nlt == nb).all() and (neq == 0).all()
    if case == "ids-missing":
        assert (i[:, nb:] == -1).all() and (i[:, :nb] >= 0).all()


@pytest.mark.parametrize("metric_l2", [True, False], ids=["L2", "IP"])
def test_two_pass_select_at_2048_lanes(metric_l2):
    """k_lanes 2048 over 70,000 columns: theta finite on every row."""
    nb = 70_000
    x, yT = store(nb, 8, seed=11, nbp=70_144)
    x = x[:4]
    keys = tc_keys(x, yT, nb, metric_l2)
    v, i, nlt, neq = tc_knn(x, yT, nb, metric_l2, 2048)
    assert fused_knn.knn_buckets(nb) >= 2048
    assert (nlt <= fused_knn.knn_lt_cap(2048)).all() and (nlt + neq >= 2048).all()
    assert_matches_plain(x, yT, nb, metric_l2, 2048, v, i)
    # and exactly the exhaustive sort of the same keys
    k, ids, _, _ = two_pass(keys, 2048)
    want = np.sort(keys.numpy(), 1)[:, :2048]
    np.testing.assert_array_equal(k, want)
    order = np.argsort(keys.numpy(), 1, kind="stable")[:, :2048]
    assert ids_agree_tie_aware(want, order, k, ids, 0.0).all()


@pytest.mark.parametrize("case", ["random", "duplicated-sorted", "theta-inf"])
def test_two_pass_select_is_the_exhaustive_sort(case):
    """On the same keys: the sorted keys bit for bit, ids up to ties."""
    nb, nbp, d, dup, by_key = CASES[case]
    x, yT = store(nb, d, seed=8, nbp=nbp, dup=dup)
    if by_key:
        yT = sort_columns_by_key(yT, x, nb, True)
    keys = tc_keys(x, yT, nb, True)
    for k_lanes in (128, 256):
        k, ids, _, _ = two_pass(keys, k_lanes, seed=5)
        want = np.sort(keys.numpy(), 1)[:, :k_lanes]
        np.testing.assert_array_equal(k, want)
        order = np.argsort(keys.numpy(), 1, kind="stable")[:, :k_lanes]
        assert ids_agree_tie_aware(want, order, k, ids, 0.0).all()


def test_order_bits_sort_as_floats():
    f = np.array([-np.inf, -3.5, -1e-30, -0.0, 0.0, 1e-30, 2.0, 7e8, np.inf],
                 np.float32)
    u = order_bits(f)
    assert (np.diff(u.astype(np.int64)) > 0).all()
    src = (fused_knn.CSRC / "radix_select.cuh").read_text()
    assert "u ^ ((u >> 31) ? 0xffffffffu : 0x80000000u)" in src


# -- knn_mma.cuh's fragments against PTX ---------------------------------------

EXPR = {
    "qrow": r"const int qrow = ([^;]+);",
    "qdim": r"const int qdim = ([^;]+);",
    "lane_of": r"const int lane = (i % 32), rb",
    "rb_of": r"rb = (\(i / 32\) % \(BM / 16\)), ks",
    "ks_of": r"ks = (i / \(32 \* \(BM / 16\)\));",
    "frag": r"const int frag = ([^;]+);",
    "box": r"box = stage \+ ([^;]+);",
    "r": r"const int r = (8 \* kk[^;]+);",
    "n": r"const int n = (8 \* nt[^;]+);",
    "addr": r"box \+ (r \* 128 \+ [^;]+)\);",
    "row": r"const int row = ([^;]+);",
    "col0": r"const long long col0 = ([^;]+);",
    "col": r"const long long col = ([^;]+);",
    "acc_e": r"acc\[i\]\[nt\]\[(2 \* h[^\]]*)\]",
}


@functools.lru_cache(maxsize=None)
def compiled(name):
    return compile(c_expr(EXPR[name]), name, "eval")


def ev(name, **env):
    """Evaluate the header's expression ``name`` with its constants and the
    given values."""
    return eval(compiled(name), {}, {**H, **env})


def swizzle_128b(off):
    """TMA's 128-byte swizzle: byte-address bits 4-6 XOR bits 7-9."""
    return off ^ (((off >> 7) & 7) << 4)


def test_b_reads_are_the_swizzled_box_without_bank_conflicts():
    """The header's B address of box row r, column n is where TMA's
    128-byte swizzle puts that float; per (k-step, n-tile, half) the 32
    lanes read 32 different banks."""
    for r in range(H["KC"]):
        for n in range(H["BOX"]):
            assert ev("addr", r=r, n=n) == swizzle_128b(r * 128 + 4 * n)
    for kk in range(H["KC"] // 8):
        for nt in range(H["NT"]):
            for h in range(2):
                banks = set()
                for lane in range(32):
                    g, t = lane >> 2, lane & 3
                    r = ev("r", kk=kk, t=t, h=h)
                    n = ev("n", nt=nt, g=g)
                    banks.add((ev("addr", r=r, n=n) // 4) % 32)
                assert len(banks) == 32, (kk, nt, h)


def mma_m16n8k8(a_regs, b_regs):
    """PTX mma.m16n8k8 (.tf32, row.col) over 32 lanes' registers:
    a0..a3 of lane l are A[g][t], A[g+8][t], A[g][t+4], A[g+8][t+4], b0 and
    b1 are B[t][g], B[t+4][g], and c0..c3 are D[g][2t], D[g][2t+1],
    D[g+8][2t], D[g+8][2t+1] (g = l // 4, t = l % 4)."""
    A, B = np.zeros((16, 8)), np.zeros((8, 8))
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        A[g, t], A[g + 8, t], A[g, t + 4], A[g + 8, t + 4] = a_regs[lane]
        B[t, g], B[t + 4, g] = b_regs[lane]
    D = A @ B
    return [(D[l >> 2, 2 * (l & 3)], D[l >> 2, 2 * (l & 3) + 1],
             D[(l >> 2) + 8, 2 * (l & 3)], D[(l >> 2) + 8, 2 * (l & 3) + 1])
            for l in range(32)]


def test_products_and_epilogue_follow_the_fragment_layouts():
    """The queries placed by load_queries' (lane, rb, ks) -> (qrow, qdim),
    a stage's boxes filled as TMA swizzles them, and every warp's 4 k-steps
    of simulated mma over the header's A and B reads: the accumulator the
    epilogue reads as (row, col) holds q_row . y_col over the stage's 32
    dims, and a warp's lanes cover its rows x 32 columns once."""
    rs = np.random.RandomState(0)
    BM, KC, BN, BOX = H["BM"], H["KC"], H["BN"], H["BOX"]
    Q = rs.randint(-4, 5, size=(BM, H["QSEG"])).astype(np.float64)
    Y = rs.randint(-4, 5, size=(KC, BN)).astype(np.float64)
    frag = {}
    for i in range(H["KSEG"] * (BM // 16) * 32):
        lane, rb, ks = ev("lane_of", i=i), ev("rb_of", i=i), ev("ks_of", i=i)
        frag[i] = tuple(Q[ev("qrow", rb=rb, lane=lane, e=e),
                          ev("qdim", k0=0, ks=ks, lane=lane, e=e)] for e in range(4))
    assert len(frag) == H["kQPlane"] // 16
    stage = np.zeros(H["kStage"] // 4)
    for b in range(BN // BOX):
        for r in range(KC):
            for n in range(BOX):
                stage[(b * H["kBox"] + swizzle_128b(r * 128 + 4 * n)) // 4] = Y[r, b * BOX + n]
    for ks0 in (0, 4):
        for warp in range(H["CONSUMERS"] // 32):
            box = ev("box", warp=warp)
            acc = np.zeros((32, H["RB"], H["NT"], 4))
            for kk in range(KC // 8):
                for i in range(H["RB"]):
                    for nt in range(H["NT"]):
                        a = [frag[ev("frag", ks0=ks0, kk=kk, warp=warp, i=i, lane=l)]
                             for l in range(32)]
                        b = []
                        for l in range(32):
                            g, t = l >> 2, l & 3
                            b.append(tuple(
                                stage[(box + ev("addr", r=ev("r", kk=kk, t=t, h=h),
                                                n=ev("n", nt=nt, g=g))) // 4]
                                for h in range(2)))
                        for l, d in enumerate(mma_m16n8k8(a, b)):
                            acc[l, i, nt] += d
            seen = set()
            for l in range(32):
                t = l & 3
                col0 = ev("col0", tile=0, warp=warp)
                for i in range(H["RB"]):
                    for h in range(2):
                        row = ev("row", warp=warp, i=i, lane=l, h=h)
                        for nt in range(H["NT"]):
                            for c in range(2):
                                col = ev("col", col0=col0, nt=nt, t=t, c=c)
                                e = ev("acc_e", h=h, c=c)
                                want = Q[row, 8 * ks0 : 8 * ks0 + KC] @ Y[:, col]
                                assert acc[l, i, nt, e] == want, (warp, l, row, col)
                                seen.add((row, col))
            rows = {r for r, _ in seen}
            cols = {c for _, c in seen}
            assert len(seen) == 16 * H["RB"] * W and len(rows) == 16 * H["RB"]
            assert cols == set(range(col0, col0 + W))  # one bucket


def test_header_sizes_are_the_wrappers():
    """The wrapper's block, tile and bucket are the header's; a bucket is
    one warp's box; the block's shared memory is the header's sum and fits
    a Hopper block."""
    assert (fused_knn.KNN_BLOCK, fused_knn.KNN_TILE, fused_knn.KNN_BUCKET) == (
        H["BM"], H["BN"], H["W"])
    assert H["W"] == H["BOX"] and H["BN"] // H["W"] == H["WN"]
    assert H["RB"] * 16 * H["WM"] == H["BM"]
    smem = H["STAGES"] * H["kStage"] + 2 * H["kQPlane"] + 2 * H["STAGES"] * 8
    assert smem == 163_888 <= 232_448
    assert "return STAGES * kStage + 2 * kQPlane + 2 * STAGES * 8;" in HEADER
    # the launch's scratch layout: lt_cap, then k_lanes eq pairs per row
    assert c_expr(r"a\.lt_cap = ([^;]+);", SOURCE) == "(k_lanes - 1) * knn_mma::W"
    assert "a.cand + r * (a.lt_cap + a.k_lanes)" in HEADER
    # the phases' bits are the wrapper's
    bits = dict(re.findall(r"PHASE_(\w+) = (\d+)", SOURCE))
    assert {k: int(v) for k, v in bits.items()} == {
        "N2": fused_knn.KNN_PHASE_N2, "MIN": fused_knn.KNN_PHASE_MIN,
        "THETA": fused_knn.KNN_PHASE_THETA, "APPEND": fused_knn.KNN_PHASE_APPEND,
        "FINAL": fused_knn.KNN_PHASE_FINAL}
    assert sum(int(v) for v in bits.values()) == fused_knn.KNN_ALL_PHASES


# -- the wrapper ----------------------------------------------------------------


@pytest.mark.parametrize("nq, nb, k_lanes, sub", [
    (8192, 1_000_000, 128, 8192),   # k=100 over the bench store: one launch
    (1024, 1_000_000, 2048, 1024),  # k=2000
    (8192, 1_000_000, 2048, 3200),  # a user's 8192-query bucket at k=2000
    (64, 300_000_000, 128, 56),     # whole multiples of 8 below one block
])
def test_sub_batches_stay_under_the_scratch_cap(nq, nb, k_lanes, sub):
    got = fused_knn.knn_sub_batch(nq, nb, k_lanes)
    assert got == sub
    row = fused_knn.knn_row_bytes(nb, k_lanes)
    assert got * row <= fused_knn.KNN_SCRATCH_CAP
    assert got == nq or (got + (64 if got >= 64 else 8)) * row > fused_knn.KNN_SCRATCH_CAP
    assert row == 4 * -(-nb // 32) + 12 + 8 * ((k_lanes - 1) * 32 + k_lanes)
    assert fused_knn.KNN_SCRATCH_CAP == 2 << 30


@pytest.fixture
def fake_card(monkeypatch):
    """knn_fused's CUDA route on CPU tensors: the launches are recorded, not
    made (132 SMs)."""
    calls = []
    monkeypatch.setattr(fused_knn, "_route", lambda name, ts: True)
    monkeypatch.setattr(fused_knn, "_sm_count", lambda index: 132)
    monkeypatch.setattr(fused_knn, "_stream", lambda device: 0)
    monkeypatch.setattr(fused_knn, "_launch", lambda name, *a: calls.append((name, a)))
    monkeypatch.setattr(knn_fused, "launches", 0)
    return calls


def test_launches_per_sub_batch(fake_card, monkeypatch):
    """Three sub-batches of 64 rows (a cap of three rows' scratch held to
    one block): one launch each, the norms only in the first, pointers and
    rows of the sub-batch, splits filling the card, scratch sized for one
    sub-batch and counters for all rows."""
    nq, d, nbp, nb, k_lanes = 160, 20, 4096, 4000, 256
    monkeypatch.setattr(fused_knn, "KNN_SCRATCH_CAP",
                        64 * fused_knn.knn_row_bytes(nb, k_lanes) + 5)
    x, yT = torch.zeros(nq, d), torch.zeros(d, nbp)
    knn_fused(x, yT, nb, qt=32, ct=1024, k_lanes=k_lanes)
    assert [c[0] for c in fake_card] == ["knn_fused"] * 3 and knn_fused.launches == 3
    sizes = [a[8] for _, a in fake_card]
    assert sizes == [64, 64, 32]
    xs = [a[0] for _, a in fake_card]
    assert xs == [x.data_ptr() + 4 * d * q0 for q0 in (0, 64, 128)]
    phases = [a[-2] for _, a in fake_card]
    assert phases == [31, 31 & ~1, 31 & ~1]
    splits = fake_card[0][1][-3]
    assert splits == knn_fused.splits == min(132 // 1, -(-nb // 256)) == 16
    ldm = fake_card[0][1][15]
    assert ldm == fused_knn.knn_buckets(nb)
    theta_ptrs = [a[16] for _, a in fake_card]
    assert theta_ptrs[1] - theta_ptrs[0] == 4 * 64
    assert knn_fused.counts.shape == (nq, 2)
    assert knn_fused.scratch_bytes == (4 * -(-nbp // 256) * 256 + 64 * 4 * ldm + 4 * nq
                                       + 8 * nq + 64 * 8 * fused_knn.knn_candidates(k_lanes))


def test_cuda_route_checks_raise(fake_card):
    """The 16-byte base and the row stride of a multiple of 4 columns that
    TMA needs, on the CUDA route only; the contract's checks before."""
    x = torch.zeros(16, 8)
    flat = torch.zeros(8 * 1024 + 2)
    with pytest.raises(ValueError, match="16-byte"):
        knn_fused(x, flat[2:].view(8, 1024), 1000, qt=16, ct=1024)
    wide = torch.zeros(8, 1026)
    with pytest.raises(ValueError, match="contiguous"):
        knn_fused(x, wide[:, :1024], 1000, qt=16, ct=1024)
    with pytest.raises(ValueError, match="k_lanes"):
        knn_fused(x, torch.zeros(8, 1024), 1000, qt=16, ct=1024, k_lanes=4096)
    with pytest.raises(ValueError, match="multiple of 4 columns"):
        knn_fused(x, torch.zeros(8, 1026), 1000, qt=16, ct=2)
    assert fake_card == []
    knn_fused(x, torch.zeros(8, 1024), 1000, qt=16, ct=1024)
    assert len(fake_card) == 1


def test_cpu_tensors_take_the_plain_version():
    """Without the fake card the wrapper runs knn_fused_ref on CPU tensors,
    bit for bit, and counts no launch."""
    x, yT = store(900, 12, seed=2, nbp=1024)
    before = knn_fused.launches
    for metric_l2 in (True, False):
        got = knn_fused(x, yT, 900, metric_l2=metric_l2, qt=16, ct=512, k_lanes=256)
        want = knn_fused_ref(x, yT, 900, metric_l2=metric_l2, qt=16, ct=512,
                             k_lanes=256)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert knn_fused.launches == before


def test_source_needs_the_toolkit(monkeypatch, tmp_path):
    """knn_fused.cu includes the new headers (in the build's hash), runs its
    products as mma.sync TF32 with cvt.rna, keeps no exact_select, and
    builds only where nvcc is: no CPU fallback."""
    assert '#include "knn_mma.cuh"' in SOURCE and '#include "radix_select.cuh"' in SOURCE
    assert "exact_select" not in SOURCE
    assert "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32" in HEADER
    assert "cvt.rna.tf32.f32" in HEADER
    names = {h.name for h in fused_knn.CSRC.glob("*.cuh")}
    assert {"knn_mma.cuh", "radix_select.cuh", "exact_select.cuh"} <= names
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(fused_knn, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        fused_knn.build_kernel.__wrapped__("knn_fused")
