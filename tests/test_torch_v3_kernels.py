"""Kernels K6 (IVF-PQ ADC over a one-hot layout, bf16 and int8 LUTs) and K7
(the score-only floor) of faiss_tpu_torch.ops.fused_knn, and the LUT
quantization and one-hot staging of faiss_tpu_torch.ops.quantize_lut, each
against faiss_tpu on the same numpy inputs: K6's plain version against
ivfpq_fused_pallas_v3 (interpret mode) and an exhaustive float64 select, K7's
against a copy of the archived TPU kernel (interpret mode) and numpy float64;
and the wrappers' refusals. The CUDA kernels themselves are compared with the
plain versions on the card by chip_smoke.py.

The K6 layout is faiss_tpu's group-packed one (pack_invlists_grouped, 200
lists in G = 2 groups, chunks of 256 slots) with the trailing all-+inf PAD
chunk that faiss_tpu's _build_brute stages: 5 chunks, which do not split
into 2 groups, so faiss_tpu's K6 asserts on it; the 4 data chunks are what
both packages scan.

Tolerances. faiss_tpu's K6 selects approximately; on the rows whose floor
flags no loss among the first KC keys, keys agree within 1e-4 of the
magnitude of their terms (faiss_tpu adds the coarse bias through bf16 hi +
lo parts, ~2^-16 of |bias|; the port in float32) and ids tie-aware. Against
float64 the keys agree within 1e-5 of the same magnitude (float32 sums of a
few terms). K7: the TPU scores the query as bf16 hi + lo (~2^-16 of
|q| |y|), the port in float32: within 1e-4 * (|q|^2 + max n2)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from faiss_tpu.models.ivf_pq import pack_invlists_grouped
from faiss_tpu.ops import quantize_lut as ref_q
from faiss_tpu.ops.pallas_knn import ivfpq_fused_pallas_v3
from faiss_tpu_torch.ops import quantize_lut as port_q
from faiss_tpu_torch.ops.fused_knn import (
    ivf_recon_fused_ref,
    ivfpq_fused_ref,
    ivfpq_fused_v3,
    ivfpq_fused_v3_ref,
    recon_floor,
    recon_floor_ref,
)
from faiss_tpu_torch.utils.evaluation import ids_agree_tie_aware
from torch_threads import one_torch_thread  # noqa: F401

NQ, QT, M, KSUB, NLIST, CT, NB, KC = 16, 16, 4, 16, 200, 256, 900, 24


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def bf16_jax(x):
    """A bfloat16 torch tensor as a jax array (bit for bit)."""
    return jnp.asarray(x.view(torch.int16).numpy()).view(jnp.bfloat16)


@pytest.fixture(scope="module")
def v3():
    rs = np.random.RandomState(3)
    listnos = rs.randint(NLIST, size=NB).astype(np.int32)
    g = pack_invlists_grouped(listnos, NLIST, CT)
    assert g["ngroups"] == 2 and g["S"] == 4 * CT
    S = g["S"] + CT  # + the PAD chunk
    lid = np.zeros((1, S), np.int32)
    lid[0, : g["S"]] = g["lid"]
    codesT = rs.randint(KSUB, size=(M, S)).astype(np.uint8)
    n2 = (rs.rand(1, S) * 2).astype(np.float32)
    n2[0, g["S"]:] = np.inf
    n2[0, : g["S"]][g["slot_map"] < 0] = np.inf
    luts3 = rs.randn(NQ, M, KSUB).astype(np.float32)
    lutsb = t(luts3.reshape(NQ, -1)).to(torch.bfloat16)
    q8, meta = port_q.quantize_luts_int8(t(luts3))
    biasg = rs.randn(NQ, 2 * 128).astype(np.float32)
    ohT = {
        int8: port_q.expand_onehot(t(codesT), t(lid), KSUB, int8)
        for int8 in (False, True)
    }
    mag = np.abs(biasg).max(1) + 2.0 + np.abs(luts3).max(2).sum(1)
    return dict(S=S, Sd=g["S"], lid=lid, codesT=codesT, n2=n2, luts3=luts3,
                lutsb=lutsb, q8=q8, meta=meta, biasg=biasg, ohT=ohT, mag=mag)


def v3_args(V, int8, S=None):
    """K6's inputs over the first S columns (the data chunks by default)."""
    S = V["Sd"] if S is None else S
    luts = V["q8"] if int8 else V["lutsb"]
    meta = V["meta"] if int8 else torch.zeros(NQ, 256)
    return (t(V["biasg"]), luts, meta, V["ohT"][int8][:, :S].contiguous(),
            t(V["n2"][:, :S]))


def float64_keys(V, int8):
    """Every key of K6's contract over the data chunks, in float64."""
    S = V["Sd"]
    codes = V["codesT"][:, :S].astype(np.int64)
    cols = (np.arange(S) // CT // 2) * 128 + V["lid"][0, :S]
    rest = V["biasg"].astype(np.float64)[:, cols] + V["n2"][:, :S]
    if not int8:
        lut = V["lutsb"].float().numpy().astype(np.float64).reshape(NQ, M, KSUB)
        return sum(lut[:, m, codes[m]] for m in range(M)) + rest
    q8 = V["q8"].numpy().astype(np.int64).reshape(NQ, M, KSUB)
    acc = sum(q8[:, m, codes[m]] for m in range(M))
    meta = V["meta"].numpy().astype(np.float64)
    lane = np.arange(S) % 128
    return meta[:, lane] * acc + meta[:, 128 + lane] + rest


def test_quantize_luts_int8_matches_reference():
    """q8 equal but for rounding ties (at most 1e-4 of the entries, by one
    step), a within 2 float32 ulp, c within 4e-6 of the sum of its terms'
    magnitudes (the order of the sum differs)."""
    rs = np.random.RandomState(4)
    luts3 = (rs.randn(256, 32, 16) * 3).astype(np.float32)
    q8j, mj = map(np.asarray, ref_q.quantize_luts_int8(jnp.asarray(luts3)))
    q8t, mt = (x.numpy() for x in port_q.quantize_luts_int8(t(luts3)))
    assert q8t.dtype == np.int8 and mt.dtype == np.float32
    assert q8t.shape == q8j.shape == (256, 512) and mt.shape == (256, 256)
    diff = q8t.astype(np.int32) - q8j
    assert np.abs(diff).max() <= 1 and (diff != 0).mean() <= 1e-4
    np.testing.assert_allclose(mt[:, :128], mj[:, :128], rtol=2.4e-7, atol=0)
    assert (mt[:, :128] == mt[:, :1]).all() and (mt[:, 128:] == mt[:, 128:129]).all()
    mag = np.abs(luts3.min(-1)).sum(-1) + 128 * 32 * mj[:, 0]
    assert (np.abs(mt[:, 128] - mj[:, 128]) <= 4e-6 * mag).all()
    # the dequantized sum is the float sum within M / 2 quantization steps
    codes = rs.randint(16, size=(256, 32))
    acc = np.take_along_axis(q8t.reshape(256, 32, 16).astype(np.int64),
                             codes[..., None], 2)[..., 0].sum(1)
    true = np.take_along_axis(luts3, codes[..., None], 2)[..., 0].sum(1)
    assert (np.abs(mt[:, 0] * acc + mt[:, 128] - true) <= 16 * mt[:, 0] + 1e-4).all()


@pytest.mark.parametrize("biases", [False, True])
def test_host_quantize_api_matches_reference_bitwise(biases):
    rs = np.random.RandomState(5)
    luts = rs.randn(6, 8, 16).astype(np.float32)
    b = rs.rand(6).astype(np.float32) * 10 if biases else None
    got = port_q.quantize_LUT_and_bias(luts, b)
    want = ref_q.quantize_LUT_and_bias(luts, b)
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x, y)
    acc = rs.randint(0, 255 * 8, size=6)
    np.testing.assert_array_equal(
        port_q.dequantize_sum(acc, got[1], got[2], got[3]),
        ref_q.dequantize_sum(acc, want[1], want[2], want[3]),
    )
    one = port_q.quantize_LUT_and_bias(luts[0])
    for x, y in zip(one, ref_q.quantize_LUT_and_bias(luts[0])):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("int8", [False, True])
def test_expand_onehot_matches_reference_bitwise(v3, int8):
    """Chunked over columns (300 at a time) on both sides."""
    V = v3
    want = ref_q.expand_onehot(jnp.asarray(V["codesT"]), jnp.asarray(V["lid"]),
                               KSUB, int8, chunk=300)
    got = port_q.expand_onehot(t(V["codesT"]), t(V["lid"]), KSUB, int8, chunk=300)
    assert got.dtype == (torch.int8 if int8 else torch.bfloat16)
    assert tuple(got.shape) == (M * KSUB + 128, V["S"])
    want = np.asarray(want.astype(jnp.float32))
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_reference_k6_asserts_on_the_pad_chunk_layout(v3):
    """faiss_tpu's K6 asserts nchunks % G == 0, which the 4 + 1 chunks of
    the staged layout break (pallas_knn.py:804 against ivf_pq.py:1101-1103,
    ROADMAP queue 3); the port's wrapper refuses it too. Trimmed to the data
    chunks, both run (test_k6_plain_version_matches_pallas)."""
    V = v3
    args = v3_args(V, False, S=V["S"])
    with pytest.raises(AssertionError):
        ivfpq_fused_pallas_v3(
            jnp.asarray(args[0].numpy()), bf16_jax(args[1]),
            jnp.asarray(args[2].numpy()), bf16_jax(args[3]),
            jnp.asarray(args[4].numpy()), qt=QT, ct=CT, interpret=True,
        )
    with pytest.raises(ValueError, match="multiple of G"):
        ivfpq_fused_v3(*args, qt=QT, ct=CT, ksub=KSUB)


@pytest.mark.parametrize("int8", [False, True])
def test_k6_plain_version_matches_pallas(v3, int8):
    V = v3
    args = v3_args(V, int8)
    v, s, ev = map(np.asarray, ivfpq_fused_pallas_v3(
        jnp.asarray(args[0].numpy()),
        jnp.asarray(args[1].numpy()) if int8 else bf16_jax(args[1]),
        jnp.asarray(args[2].numpy()),
        jnp.asarray(args[3].numpy()) if int8 else bf16_jax(args[3]),
        jnp.asarray(args[4].numpy()), qt=QT, ct=CT, interpret=True,
    ))
    before = ivfpq_fused_v3.launches
    keys, slots, floor = ivfpq_fused_v3(*args, qt=QT, ct=CT, ksub=KSUB)
    assert ivfpq_fused_v3.launches == before  # CPU tensors: the plain version
    assert np.isinf(floor.numpy()).all()
    kk, ss = keys.numpy(), slots.numpy()
    np.testing.assert_array_equal(ss == -1, np.isinf(kk))
    tol = 1e-4 * V["mag"]
    e = ev.min(1) >= v[:, KC - 1]
    assert e.sum() >= NQ // 2, e.sum()
    np.testing.assert_allclose(kk[e, :KC], v[e, :KC], rtol=0, atol=tol[e].max())
    assert ids_agree_tie_aware(v[e, :KC], s[e, :KC], kk[e, :KC], ss[e, :KC],
                               tol[e]).all()
    # exact select: the 128 smallest float64 keys, each at its slot
    full = float64_keys(V, int8)
    want = np.sort(full, 1)[:, :128]
    np.testing.assert_allclose(kk, want, rtol=0, atol=1e-5 * V["mag"].max())
    fin = np.isfinite(want)
    at = np.take_along_axis(full, np.maximum(ss, 0), 1)
    np.testing.assert_allclose(at[fin], kk[fin], rtol=0, atol=1e-5 * V["mag"].max())


def test_k6_bf16_mode_equals_k4(v3):
    """With a valid one-hot, K6's bf16 keys are K4's over the codes the
    one-hot encodes (the same static groups: 4 chunks in 2 groups)."""
    V = v3
    args = v3_args(V, False)
    k6, s6, _ = ivfpq_fused_v3_ref(*args, qt=QT, ct=CT, ksub=KSUB)
    Sd = V["Sd"]
    k4, s4, _ = ivfpq_fused_ref(args[0], V["lutsb"], t(V["codesT"][:, :Sd]),
                                args[4], t(V["lid"][:, :Sd]), qt=QT, ct=CT)
    np.testing.assert_allclose(k6.numpy(), k4.numpy(), rtol=1e-6, atol=1e-6)
    assert ids_agree_tie_aware(k4.numpy(), s4.numpy(), k6.numpy(), s6.numpy(),
                               1e-6 * V["mag"]).all()


def test_wrappers_refuse_what_the_kernels_do_not_take(v3):
    V = v3
    bf, i8 = v3_args(V, False), v3_args(V, True)
    kw = dict(qt=QT, ct=CT, ksub=KSUB)
    before = (ivfpq_fused_v3.launches, recon_floor.launches)
    with pytest.raises(ValueError, match="ct=128 a multiple of 256"):
        ivfpq_fused_v3(*bf, qt=QT, ct=128, ksub=KSUB)
    with pytest.raises(ValueError, match="rows"):  # ohT vs luts width
        ivfpq_fused_v3(bf[0], bf[1][:, :48], *bf[2:], **kw)
    with pytest.raises(ValueError, match="int8"):  # bf16 LUTs, int8 one-hot
        ivfpq_fused_v3(*bf[:3], i8[3], bf[4], **kw)
    with pytest.raises(ValueError, match="int8"):  # float32 LUTs
        ivfpq_fused_v3(bf[0], bf[1].float(), *bf[2:], **kw)
    with pytest.raises(ValueError, match="ksub"):
        ivfpq_fused_v3(*bf, qt=QT, ct=CT, ksub=48)
    with pytest.raises(ValueError, match="meta"):
        ivfpq_fused_v3(*i8[:2], i8[2][:, :128].contiguous(), *i8[3:], **kw)
    with pytest.raises(ValueError, match="multiple of qt"):
        ivfpq_fused_v3(*bf, qt=24, ct=CT, ksub=KSUB)
    with pytest.raises(ValueError, match="contiguous"):
        ivfpq_fused_v3(bf[0].T.contiguous().T, *bf[1:], **kw)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        ivfpq_fused_v3(*(x.to("meta") for x in bf), **kw)
    # columns that are not a one-hot: a 2, two ones in a block, no list row
    spare = (int(V["codesT"][0, 9]) + 1) % KSUB  # a 0 in column 9's first block
    for r, c, val in ((3, 7, 2), (spare, 9, 1), (M * KSUB + V["lid"][0, 11], 11, 0)):
        oh = bf[3].clone()
        oh[r, c] = val
        with pytest.raises(ValueError, match="1 columns are not a one-hot"):
            ivfpq_fused_v3(*bf[:3], oh, bf[4], **kw)
    xq, yT, n2 = floor_inputs(np.random.RandomState(9))
    with pytest.raises(ValueError, match="multiple of qt"):
        recon_floor(xq[:12], yT, n2, qt=8, ct=CT)
    with pytest.raises(ValueError, match="a multiple of 128"):
        recon_floor(xq, yT, n2, qt=8, ct=192)
    with pytest.raises(ValueError, match="multiple of ct"):
        recon_floor(xq, yT[:, :896].contiguous(), n2[:, :896], qt=8, ct=CT)
    with pytest.raises(ValueError, match="bfloat16"):
        recon_floor(xq, yT.float(), n2, qt=8, ct=CT)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        recon_floor(*(x.to("meta") for x in (xq, yT, n2)), qt=8, ct=CT)
    assert (ivfpq_fused_v3.launches, recon_floor.launches) == before


# -- K7 --------------------------------------------------------------------


def floor_inputs(rs, nq=16, d=16, S=1024):
    xq = t(rs.randn(nq, d).astype(np.float32))
    yT = t(rs.randn(d, S).astype(np.float32)).to(torch.bfloat16)
    n2 = (yT.float().numpy().astype(np.float64) ** 2).sum(0, keepdims=True)
    n2 = n2.astype(np.float32)
    n2[0, rs.rand(S) < 0.1] = np.inf  # pads
    return xq, yT, t(n2)


def exp_r3c_floor_call(xq, yT, n2, qt, ct):
    """benchs/archive/exp_r3c.py:81-124, ``noselect_kernel`` and the
    ``pl.pallas_call`` of ``floor_call``, copied unchanged but for the
    closure's free names (nq, qt, d, ct, S become arguments here) and
    ``interpret=True``: it is a closure inside main() there and cannot be
    imported."""
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


def test_k7_plain_version_matches_tpu_kernel_and_float64():
    rs = np.random.RandomState(8)
    xq, yT, n2 = floor_inputs(rs)
    want = exp_r3c_floor_call(jnp.asarray(xq.numpy()), bf16_jax(yT),
                              jnp.asarray(n2.numpy()), qt=8, ct=CT)
    before = recon_floor.launches
    got = recon_floor(xq, yT, n2, qt=8, ct=CT).numpy()
    assert recon_floor.launches == before  # CPU tensors: the plain version
    assert got.shape == (16, 128) and got.dtype == np.float32
    n2f = n2.numpy()
    tol = 1e-4 * ((xq.numpy() ** 2).sum(1) + n2f[np.isfinite(n2f)].max())
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    assert (np.abs(np.where(np.isinf(got), 0, got - want)) <= tol[:, None]).all()
    keys64 = n2f.astype(np.float64) - 2.0 * (
        xq.numpy().astype(np.float64) @ yT.float().numpy().astype(np.float64))
    want64 = keys64.reshape(16, -1, 128).min(1)
    assert (np.abs(np.where(np.isinf(got), 0, got - want64)) <= tol[:, None]).all()
    # the minimum over the lanes is K2's first key on the same store
    k2 = ivf_recon_fused_ref(xq, yT, n2, qt=8, ct=CT)[0].numpy()
    assert (np.abs(got.min(1) - k2[:, 0]) <= tol).all()
    np.testing.assert_array_equal(got, recon_floor_ref(xq, yT, n2).numpy())
