"""K7 on the tensor cores (faiss_tpu_torch.ops.fused_knn.recon_floor,
csrc/recon_floor.cu on recon_mma.cuh) as far as the CPU reaches it:

- its arithmetic, emulated in torch: the float32 query split into bf16 hi
  + lo, the products qh.y + ql.y summed in float32, the key n2 - 2 * ip,
  per-lane running minima kept by tile parity over 64-column tiles, the
  columns split into 1, 2 or 3 ranges of whole 128-column lane groups and
  the splits merged by their minimum, queries in blocks of 64 with a
  partial last block. It stays within chip_smoke's 1e-4 * (|q|^2 + max n2)
  of the plain version and of float64, within 1e-5 * (|q|^2 + max n2) of
  the TPU kernel (benchs/archive/exp_r3c.py's floor_call in interpret
  mode: the same products, summed in another order), and its minimum over
  the lanes equals the emulated K2's first key bit for bit;
- the header's own index expressions (read from recon_mma.cuh and
  recon_floor.cu and evaluated here): products() puts a thread's
  accumulators at the rows and tile columns acc_row() and acc_col() name,
  and LaneMin's updates and writes give every (row, lane) of a block to
  exactly one consumer thread across both tile parities, in distinct
  shared-memory banks per half warp;
- the wrapper on a faked card: the split count, the tensor-core operand
  refusals raised before any launch, CPU tensors taking the plain version,
  the sizes the wrapper and the source share, and that the source builds
  only where nvcc is.

The CUDA kernel itself is compared with the plain version and with K2 on
the card by chip_smoke.py (phase 12b)."""

import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from faiss_tpu_torch.ops import fused_knn
from faiss_tpu_torch.ops.fused_knn import recon_floor, recon_floor_ref
from torch_threads import one_torch_thread  # noqa: F401

LANES = 128
HEADER = (fused_knn.CSRC / "recon_mma.cuh").read_text()
SOURCE = (fused_knn.CSRC / "recon_floor.cu").read_text()


def consts(text, base=None):
    """A source's ``constexpr int`` constants, evaluated in order over the
    ``base`` constants (those of the header it includes); those that name
    anything else are skipped."""
    env = dict(base or {})
    for name, e in re.findall(r"constexpr int (\w+) = ([^;]+);", text):
        try:
            env[name] = eval(e.replace("/", "//"), {}, dict(env))
        except (NameError, SyntaxError):  # a name or C++ of the header's own
            pass
    return env


H = consts(HEADER)
SRC = consts(SOURCE, H)  # the header's constants and recon_floor.cu's
BM, BN, NT, WN = H["BM"], H["BN"], H["NT"], H["WN"]


# -- the kernel's arithmetic, emulated ---------------------------------------


def tc_keys(xq, yT, n2, c0, c1):
    """K7's (and K2's one-plane) keys over columns [c0, c1): bf16 hi =
    bf16(q) and lo = bf16(q - hi), the bf16 products (exact in float32)
    summed in float32, then n2 - 2 * ip."""
    qh = xq.to(torch.bfloat16).float()
    ql = (xq - qh).to(torch.bfloat16).float()
    y = yT[:, c0:c1].float()
    return n2[:, c0:c1] - 2.0 * (qh @ y + ql @ y)


def tc_floor(xq, yT, n2, splits=1):
    """The launch: queries in blocks of 64 (rows past nq zero, never
    written), the columns in ``splits`` ranges of whole 128-column lane
    groups, each range walked in 64-column tiles whose parity picks the
    lanes 64 * parity .. + 63 they update, the ranges merged by their
    minimum."""
    nq, S = xq.shape[0], yT.shape[1]
    rows = -(-nq // BM) * BM
    xz = torch.zeros(rows, xq.shape[1])
    xz[:nq] = xq
    groups = S // LANES
    split_cols = -(-groups // splits) * LANES
    out = torch.full((rows, LANES), float("inf"))
    for p in range(splits):
        c0, c1 = p * split_cols, min(S, (p + 1) * split_cols)
        m = torch.full((rows, LANES), float("inf"))
        for col in range(c0, c1, BN):
            par = (col // BN) & 1
            k = tc_keys(xz, yT, n2, col, col + BN)
            m[:, BN * par : BN * par + BN] = torch.minimum(m[:, BN * par : BN * par + BN], k)
        out = torch.minimum(out, m)
    return out[:nq]


def floor_inputs(seed, nq=72, d=128, S=4096, pad=256):
    """Queries, a bf16 store with its n2, and +inf n2 on the last ``pad``
    columns (the PAD chunk) and on a tenth of the others."""
    rs = np.random.RandomState(seed)
    xq = torch.from_numpy(rs.randn(nq, d).astype(np.float32))
    yT = torch.from_numpy(rs.randn(d, S).astype(np.float32)).to(torch.bfloat16)
    n2 = yT.float().double().square().sum(0, keepdim=True).float()
    n2[0, torch.from_numpy(rs.rand(S) < 0.1)] = float("inf")
    n2[0, S - pad :] = float("inf")
    return xq, yT, n2


def tol_of(xq, n2, scale):
    fin = torch.isfinite(n2)
    return scale * (xq.double().square().sum(1) + n2[fin].max().double())


@pytest.mark.parametrize("splits", [1, 2, 3])
def test_tc_floor_within_tol_of_plain_version_and_float64(splits):
    """72 queries (a partial second block) over 4096 columns split into 1,
    2 or 3 ranges: the emulated kernel against recon_floor_ref and float64
    within 1e-4 * (|q|^2 + max n2), +inf at the same places (none here:
    every lane holds a finite key)."""
    xq, yT, n2 = floor_inputs(splits)
    got = tc_floor(xq, yT, n2, splits)
    want = recon_floor_ref(xq, yT, n2, qt=8, ct=256)
    tol = tol_of(xq, n2, 1e-4)[:, None]
    assert torch.equal(torch.isinf(got), torch.isinf(want))
    assert torch.isfinite(got).all()
    assert ((got.double() - want.double()).abs() <= tol).all()
    keys64 = n2.double() - 2.0 * (xq.double() @ yT.double())
    want64 = keys64.view(xq.shape[0], -1, LANES).amin(1)
    assert ((got.double() - want64).abs() <= tol).all()


def test_splits_leave_the_floor_bitwise():
    """A minimum is exact: the splits and their merge change no bit."""
    xq, yT, n2 = floor_inputs(4)
    one = tc_floor(xq, yT, n2, 1)
    for splits in (2, 3, 5):
        assert torch.equal(tc_floor(xq, yT, n2, splits), one)


def test_min_over_lanes_is_k2_first_key_bitwise():
    """The same keys in the same arithmetic: K2 one-plane's first key (the
    smallest key of its exact select) is the minimum over K7's lanes."""
    xq, yT, n2 = floor_inputs(5)
    k2_first = tc_keys(xq, yT, n2, 0, yT.shape[1]).min(1).values
    assert torch.equal(tc_floor(xq, yT, n2, 3).min(1).values, k2_first)


def exp_r3c_floor_call(xq, yT, n2, qt, ct):
    """benchs/archive/exp_r3c.py:81-124, ``noselect_kernel`` and the
    ``pl.pallas_call`` of ``floor_call``, copied unchanged but for the
    closure's free names (nq, qt, d, ct, S become arguments here) and
    ``interpret=True``: it is a closure inside main() there and cannot be
    imported (the copy of tests/test_torch_v3_kernels.py)."""
    nq, d = xq.shape
    S = yT.shape[1]

    def noselect_kernel(q_ref, yT_ref, n2_ref, out_ref):
        j = pl.program_id(1)

        @pl.when(j == 0)
        def _init():
            out_ref[:] = jnp.full(out_ref.shape, jnp.inf, jnp.float32)

        q = q_ref[:]
        q_hi = q.astype(jnp.bfloat16)
        q_lo = (q - q_hi.astype(jnp.float32)).astype(jnp.bfloat16)
        y = yT_ref[:]
        ip = jax.lax.dot_general(
            q_hi, y, (((1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
        ) + jax.lax.dot_general(
            q_lo, y, (((1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
        )
        skey = n2_ref[:] - 2.0 * ip
        m = skey[:, :128]
        for t_ in range(1, ct // 128):
            m = jnp.minimum(m, skey[:, t_ * 128 : (t_ + 1) * 128])
        out_ref[:] = jnp.minimum(out_ref[:], m)

    @functools.partial(jax.jit, static_argnames=())
    def floor_call(xq_dev, yT, n2):
        return pl.pallas_call(
            noselect_kernel,
            grid=(nq // qt, S // ct),
            in_specs=[
                pl.BlockSpec((qt, d), lambda i, j: (i, 0),
                             memory_space=pltpu.VMEM),
                pl.BlockSpec((d, ct), lambda i, j: (0, j),
                             memory_space=pltpu.VMEM),
                pl.BlockSpec((1, ct), lambda i, j: (0, j),
                             memory_space=pltpu.VMEM),
            ],
            out_specs=pl.BlockSpec((qt, 128), lambda i, j: (i, 0),
                                   memory_space=pltpu.VMEM),
            out_shape=jax.ShapeDtypeStruct((nq, 128), jnp.float32),
            interpret=True,
        )(xq_dev, yT, n2)

    return np.asarray(floor_call(xq, yT, n2))


def test_tc_floor_matches_tpu_kernel():
    """The TPU kernel in interpret mode computes the same qh.y + ql.y in
    float32, summed in another order: within 1e-5 * (|q|^2 + max n2), a
    tenth of the plain version's tolerance (a float32 sum of 128 terms
    rounds by at most 128 * 2^-24 of its terms' magnitudes, below 8e-6
    of |q| |y| <= (|q|^2 + |y|^2) / 2), +inf at the same places."""
    xq, yT, n2 = floor_inputs(6, nq=16, d=128, S=2048)
    yj = jnp.asarray(yT.view(torch.int16).numpy()).view(jnp.bfloat16)
    want = exp_r3c_floor_call(jnp.asarray(xq.numpy()), yj, jnp.asarray(n2.numpy()),
                              qt=8, ct=512)
    got = tc_floor(xq, yT, n2, 2).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    tol = tol_of(xq, n2, 1e-5).numpy()[:, None]
    assert (np.abs(np.where(np.isinf(got), 0, got.astype(np.float64) - want)) <= tol).all()


# -- the header's expressions ------------------------------------------------


def c_expr(pattern, text):
    """The C integer expression ``pattern`` captures in ``text`` (every
    match the same), as Python: unsigned suffixes dropped, division
    integral, shifts and masks as they are."""
    found = {m.group(1) for m in re.finditer(pattern, text)}
    assert len(found) == 1, (pattern, found)
    e = re.sub(r"\b(\d+)u\b", r"\1", found.pop())
    return " ".join(e.replace("/", "//").split())


EXPR = {  # name -> (pattern, text)
    "acc_row": (r"int acc_row\(\) \{\s*return ([^;]+);", HEADER),
    "acc_col": (r"int acc_col\(\) \{\s*return ([^;]+);", HEADER),
    "arow": (r"const int arow = ([^;]+);", HEADER),
    "nt0": (r"const int nt0 = ([^;]+);", HEADER),
    "bc": (r"const int bc = ([^;]+);", HEADER),
    "row": (r"float\* row = m \+ ([^;]+);", SOURCE),
    "upd": (r"reinterpret_cast<float2\*>\(row \+ ([^)]+)\);", SOURCE),
    "out_row": (r"float\* o = a\.okey \+ ([^;]+);", SOURCE),
    "out_off": (r"reinterpret_cast<float2\*>\(o \+ ([^)]+)\) =", SOURCE),
    "in_row": (r"const float\* mr = m \+ ([^;]+);", SOURCE),
    "in_off": (r"reinterpret_cast<const float2\*>\(mr \+ ([^)]+)\);", SOURCE),
    "par": (r"const int par = static_cast<int>\(([^;]+)\);", SOURCE),
}


def ev(name, **env):
    pattern, text = EXPR[name]
    e = c_expr(pattern, text)
    e = e.replace("threadIdx.x", "tid").replace("recon_mma::", "")
    full = {**SRC, **env}
    full["acc_row"] = lambda: ev("acc_row", tid=full["tid"])
    full["acc_col"] = lambda: ev("acc_col", tid=full["tid"])
    return eval(e, {}, full)


CONSUMERS = 32 * 4 * WN


def test_products_put_accumulators_where_acc_row_and_acc_col_say():
    """In products(), lane l of warp w loads the A rows arow (matrices 0
    and 1: rows 0-7 and 8-15 of the warp's 16) and, per p, B's 16-byte
    column chunks bc of the tile (matrices 0-1 then 2-3 feed acc[2p] and
    acc[2p + 1]): so acc[nt] is n-tile nt0 + nt, and PTX's m16n8 accumulator
    element 2 h + e of lane l is row l / 4 + 8 h, column 2 (l % 4) + e of
    it. acc_row() and acc_col() must name the same places."""
    for tid in range(CONSUMERS):
        w, lane = tid >> 5, tid & 31
        rows = {ev("arow", warp=w, m=mm, lane=8 * mm + i) for mm in range(4) for i in range(8)}
        assert rows == set(range(16 * (w % 4), 16 * (w % 4) + 16))
        nt0 = ev("nt0", warp=w, NT=NT)
        for p in range(NT // 2):
            chunks = [ev("bc", nt0=nt0, p=p, m=mm) for mm in range(4)]
            assert chunks == [nt0 + 2 * p] * 2 + [nt0 + 2 * p + 1] * 2
        r0, c0 = ev("acc_row", tid=tid), ev("acc_col", tid=tid)
        assert r0 == 16 * (w % 4) + lane // 4
        assert c0 == 8 * nt0 + 2 * (lane % 4)


def test_lane_minima_have_one_owner_each():
    """LaneMin's update of tile parity par, n-tile nt, half h and element e
    reads and writes m[r * kStride + l]; over the consumer threads and both
    parities every (row, lane) of a block, and no pad column, is updated by
    exactly one thread, that thread writes it to out[(q0 + r) * 128 + l]
    from the same place, every out place is written once, and a half
    warp's 8-byte accesses of one (par, nt, h) fall in distinct banks."""
    kstride, lanes = SRC["kStride"], SRC["LANES"]
    assert kstride >= lanes
    owner = {}
    writes = {}
    for tid in range(CONSUMERS):
        c0, r0 = ev("acc_col", tid=tid), ev("acc_row", tid=tid)
        for par in (0, 1):
            base = ev("row", c0=c0, par=par, kStride=kstride, tid=tid)
            for nt in range(NT):
                for h in (0, 1):
                    off = base + ev("upd", h=h, nt=nt, kStride=kstride)
                    for e in (0, 1):
                        r, lane = divmod(off + e, kstride)
                        assert r == r0 + 8 * h and lane == BN * par + c0 + 8 * nt + e
                        assert (r, lane) not in owner, (r, lane)
                        owner[r, lane] = tid
        for h in (0, 1):
            r = r0 + 8 * h
            o = ev("out_row", q0=0, r=r, c0=c0)
            i = ev("in_row", r=r, kStride=kstride, c0=c0)
            for par in (0, 1):
                for nt in range(NT):
                    for e in (0, 1):
                        oo = o + ev("out_off", par=par, nt=nt) + e
                        ii = i + ev("in_off", par=par, nt=nt) + e
                        rr, ll = divmod(ii, kstride)
                        assert owner[rr, ll] == tid and oo == r * lanes + ll
                        assert oo not in writes
                        writes[oo] = tid
    assert sorted(owner) == [(r, c) for r in range(BM) for c in range(lanes)]
    assert sorted(writes) == list(range(BM * lanes))
    # banks: half a warp (16 lanes) of 8-byte accesses, 32 banks of 4 bytes
    for w in range(CONSUMERS // 32):
        for half in (0, 16):
            for par in (0, 1):
                for nt in range(NT):
                    for h in (0, 1):
                        banks = []
                        for lane in range(half, half + 16):
                            tid = 32 * w + lane
                            base = ev("row", c0=ev("acc_col", tid=tid), par=par,
                                      kStride=kstride, tid=tid)
                            off = base + ev("upd", h=h, nt=nt, kStride=kstride)
                            banks += [off % 32, (off + 1) % 32]
                        assert len(set(banks)) == 32, (w, half, par, nt, h)


def test_tile_parity_is_the_lane_half():
    """A tile starts at col(t), a multiple of 64 on K7's walk (its splits
    are whole 128-column lane groups): the parity LaneMin takes, (col / BN)
    & 1, is the tile's half of the 128 lanes."""
    for col in range(0, 4096, BN):
        par = eval(c_expr(EXPR["par"][0], SOURCE).replace("w.col(t)", "col"),
                   {}, dict(col=col, BN=BN))
        assert par * BN == col % LANES


# -- the wrapper --------------------------------------------------------------


@pytest.fixture
def fake_card(monkeypatch):
    """recon_floor's CUDA route on CPU tensors: the launch is recorded, not
    made (132 SMs)."""
    calls = []
    monkeypatch.setattr(fused_knn, "_route", lambda name, ts: True)
    monkeypatch.setattr(fused_knn, "_sm_count", lambda index: 132)
    monkeypatch.setattr(fused_knn, "_stream", lambda device: 0)
    monkeypatch.setattr(fused_knn, "_launch", lambda name, *a: calls.append((name, a)))
    monkeypatch.setattr(recon_floor, "launches", 0)
    monkeypatch.setattr(recon_floor, "splits", 0)
    return calls


def floor_args(nq, S, d=128):
    return torch.zeros(nq, d), torch.zeros(d, S, dtype=torch.bfloat16), torch.zeros(1, S)


@pytest.mark.parametrize("nq, S, splits", [
    (2048, 513 * 2048, 8),  # 32 blocks of 64, two per SM: 8 splits
    (8192, 513 * 2048, 2),  # 128 blocks
    (64, 4 * 128, 4),       # capped by the 4 lane groups
    (16384, 2048, 1),
])
def test_split_count_fills_two_blocks_an_sm(fake_card, nq, S, splits):
    out = recon_floor(*floor_args(nq, S), qt=64 if nq % 256 else 256, ct=128)
    ((name, args),) = fake_card
    assert name == "recon_floor" and out.shape == (nq, 128)
    assert args[-2] == splits and recon_floor.splits == splits
    assert (args[4] is None) == (splits == 1)  # the splits' scratch
    assert args[5:8] == (nq, 128, S)
    assert recon_floor.launches == 1


def test_tensor_core_refusals_come_before_the_launch(fake_card):
    """d a multiple of 128 and 16-byte operands, checked on the CUDA route
    before any launch; the contract's own checks on both routes."""
    xq, yT, n2 = floor_args(64, 1024)
    with pytest.raises(ValueError, match="d_pad=64"):
        recon_floor(*floor_args(64, 1024, d=64), qt=64, ct=256)
    flat = torch.zeros(64 * 128 + 2)
    with pytest.raises(ValueError, match="xq must start on a 16-byte"):
        recon_floor(flat[2:].view(64, 128), yT, n2, qt=64, ct=256)
    n2w = torch.zeros(1030)
    with pytest.raises(ValueError, match="n2 must start on a 16-byte"):
        recon_floor(xq, yT, n2w[2:1026].view(1, 1024), qt=64, ct=256)
    with pytest.raises(ValueError, match="a multiple of 128"):
        recon_floor(xq, yT, n2, qt=64, ct=192)
    assert fake_card == [] and recon_floor.launches == 0
    recon_floor(xq, yT, n2, qt=64, ct=256)
    assert len(fake_card) == 1


def test_cpu_tensors_take_the_plain_version():
    xq, yT, n2 = floor_inputs(7, nq=16, d=16, S=1024)
    before = recon_floor.launches
    got = recon_floor(xq, yT, n2, qt=8, ct=256)
    assert torch.equal(got, recon_floor_ref(xq, yT, n2, qt=8, ct=256))
    assert recon_floor.launches == before


def test_sizes_the_wrapper_and_the_source_share():
    """The wrapper's blocks per SM, block and tile are the source's, the
    kernel's launch bounds take its blocks per SM, and the shared memory
    (ring, queries, minima) lets that many blocks share an SM."""
    src = SRC
    assert fused_knn.RECON_FLOOR_BLOCKS_PER_SM == src["BLOCKS_PER_SM"]
    assert fused_knn.RECON_BLOCK == BM and fused_knn.RECON_TILE == BN
    assert "__launch_bounds__(THREADS, BLOCKS_PER_SM)" in SOURCE
    assert "recon_mma::scan<false, LaneMin>" in SOURCE
    smem = (H["STAGES"] * H["KC"] * BN * 2 + H["STAGES"] * BN * 4
            + 2 * BM * H["QSEG"] * 2 + src["kBytes"] + 2 * H["STAGES"] * 8)
    assert smem == 101440
    assert src["BLOCKS_PER_SM"] * (smem + 1024) <= 233472


def test_source_needs_the_toolkit(monkeypatch, tmp_path):
    """recon_floor.cu builds on recon_mma.cuh, recon_step.cuh is gone and
    no source includes it, and without nvcc nothing builds: no CPU
    fallback."""
    assert '#include "recon_mma.cuh"' in SOURCE
    assert not (fused_knn.CSRC / "recon_step.cuh").exists()
    for f in fused_knn.CSRC.rglob("*"):  # the host sources' folder too
        if f.is_file():
            assert "recon_step" not in f.read_text(), f.name
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(fused_knn, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        fused_knn.build_kernel.__wrapped__("recon_floor")
