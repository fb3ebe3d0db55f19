"""The tensor-core recon kernels K1 and K2 (faiss_tpu_torch.ops.fused_knn,
csrc/recon_mma.cuh, tile_select.cuh) as far as the CPU reaches them:

- their arithmetic, emulated in torch: the float32 query split into bf16
  hi + lo and the three bf16 products qh.yh + ql.yh + qh.yl summed in
  float32 (two, qh.y + ql.y, with one plane). It stays within chip_smoke's
  lane_tol of the plain versions and within the exact-flat certificate's
  delta (models/flat.py ``_screen_delta``) of float64, and it is the
  arithmetic of faiss_tpu's Pallas K2 and K1 (interpret mode);
- K1's PAD skip: on IVF-PQ and IVF-Flat layouts staged from trained
  faiss_tpu indexes, cutting each tile's worklist after its last non-PAD
  step, as the kernel does, leaves the plain version's result equal bit for
  bit;
- K1's real d: its plain version told the real d equals the one over the
  unpadded dims (the zero padding K1 skips adds exact zeros), and the
  wrapper refuses a d outside 1..d_pad;
- K1's warpgroup scan (recon_wgmma.cuh) as its source states it: shared
  memory within one block an SM, every warpgroup's accumulators covering
  its tile once with each warp on its select's 16 rows, and the row
  groups' hand-offs between the two warpgroups on barriers of their own;
- the wrappers' new checks (16-byte operands, the column splits and their
  scratch, the PAD chunk), and that every kernel source, the new headers
  included, builds only where nvcc is.

The CUDA kernels themselves are compared with the plain versions on the card
by chip_smoke.py."""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import faiss_tpu as ftj
from faiss_tpu.models.flat import _stage_flat_screen as jax_stage
from faiss_tpu.models.ivf_pq import pack_invlists_grouped
from faiss_tpu.ops.pallas_knn import ivf_recon_fused_dyn_pallas, ivf_recon_fused_pallas
from faiss_tpu_torch.convert import ivfflat_from_arrays, refine_flat_from_arrays
from faiss_tpu_torch.models import flat as port_flat
from faiss_tpu_torch.models import ivf_pq as port_pq
from faiss_tpu_torch.ops import fused_knn
from faiss_tpu_torch.ops.fused_knn import (
    ivf_recon_fused_dyn_ref,
    ivf_recon_fused_ref,
)
from faiss_tpu_torch.utils.evaluation import ids_agree_tie_aware
from test_torch_floor_tc import consts
from torch_threads import one_torch_thread  # noqa: F401

WG_HEADER = (fused_knn.CSRC / "recon_wgmma.cuh").read_text()


def bf16_to_torch(a):
    """numpy/JAX bfloat16 array -> torch.bfloat16 tensor, bit for bit."""
    return torch.from_numpy(np.asarray(a).view(np.int16).copy()).view(
        torch.bfloat16
    )


def jbf16(plane):
    """A torch bfloat16 tensor as a jax bfloat16 array, bit for bit."""
    return jnp.asarray(plane.view(torch.int16).numpy()).view(jnp.bfloat16)


def tc_inner(xq, hi, lo=None):
    """The kernels' q . y: bf16 hi = bf16(q), lo = bf16(q - hi); bf16
    products (exact in float32) summed in float32."""
    qh = xq.to(torch.bfloat16).float()
    ql = (xq - qh).to(torch.bfloat16).float()
    y = hi.float()
    ip = qh @ y + ql @ y
    if lo is not None:
        ip = ip + qh @ lo.float()
    return ip


def tc_topk(xq, hi, lo, n2, cols=None):
    """The kernels' keys n2 - 2 q.y over ``cols`` (all columns by default)
    and their exact top-128: (keys, slots -1 on +inf)."""
    cols = torch.arange(hi.shape[1]) if cols is None else cols
    sc = n2[:, cols] - 2.0 * tc_inner(xq, hi[:, cols], None if lo is None else lo[:, cols])
    v, p = torch.topk(sc, min(128, sc.shape[1]), dim=1, largest=False)
    return v, torch.where(torch.isinf(v), -1, cols[p])


def lane_tol(xq, n2, slots, keys):
    """chip_smoke.py's tolerance of a kernel against its plain version."""
    qn2 = (xq.double() ** 2).sum(1, keepdim=True)
    n2s = torch.where(slots >= 0, n2[0, slots.clamp_min(0)].double(), 0.0)
    fin = torch.where(torch.isfinite(keys), keys.double().abs(), 0.0)
    return 1e-4 * (qn2 + n2s) + 1e-6 * fin


def hilo_store(rs, d, nb, d_pad, scale):
    """Vectors with norms up to ~scale, staged as the flat screen does."""
    x = rs.randn(nb, d).astype(np.float32)
    x *= (scale * rs.rand(nb, 1) / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)
    hi, lo, n2, ymax = port_flat._stage_flat_screen(torch.from_numpy(x), d_pad, nb, True)
    return x, hi, lo, n2, ymax


@pytest.mark.parametrize("scale", [1.0, 1e3], ids=["norm1", "norm1e3"])
@pytest.mark.parametrize("hilo", [True, False], ids=["hilo", "one-plane"])
def test_three_products_within_lane_tol_of_plain_version(scale, hilo):
    """At d=128 and norms up to 1e3, every key of the bf16 products lies
    within lane_tol of the plain version's float32 key of the same column."""
    rs = np.random.RandomState(7)
    x, hi, lo, n2, _ = hilo_store(rs, 128, 2048, 128, scale)
    xq = torch.from_numpy(
        rs.randn(64, 128).astype(np.float32) * np.float32(scale / np.sqrt(128))
    )
    lo_ = lo if hilo else None
    keys = n2 - 2.0 * tc_inner(xq, hi, lo_)
    y = hi.float() + (lo.float() if hilo else 0.0)
    plain = n2 - 2.0 * (xq @ y)
    cols = torch.arange(2048)[None, :].expand(64, -1)
    tol = lane_tol(xq, n2, cols, plain)
    assert ((keys.double() - plain.double()).abs() <= tol).all()
    # and the top-128s agree as chip_smoke holds the kernels to them
    rk, rsl, _ = ivf_recon_fused_ref(xq, hi, n2, lo_, qt=64, ct=1024)
    k, s = tc_topk(xq, hi, lo_, n2)
    assert ((k.double() - rk.double()).abs() <= lane_tol(xq, n2, rsl, rk)).all()
    assert ids_agree_tie_aware(rk.numpy(), rsl.numpy(), k.numpy(), s.numpy(),
                               lane_tol(xq, n2, rsl, rk).max(1).values.numpy()).all()


@pytest.mark.parametrize("scale", [1.0, 1e3], ids=["norm1", "norm1e3"])
def test_three_products_within_screen_delta_of_float64(scale):
    """The hi/lo screen's keys against float64 keys of the float32 vectors:
    within models/flat.py's certificate delta, 2^-12 |q| max|y|, the bound
    the exact flat search relies on."""
    rs = np.random.RandomState(8)
    x, hi, lo, n2, ymax = hilo_store(rs, 128, 4096, 128, scale)
    xq = rs.randn(128, 128).astype(np.float32) * np.float32(scale / np.sqrt(128))
    keys = (n2 - 2.0 * tc_inner(torch.from_numpy(xq), hi, lo)).double().numpy()
    x64, q64 = x.astype(np.float64), xq.astype(np.float64)
    key64 = (x64**2).sum(1)[None, :] - 2.0 * q64 @ x64.T
    qn = torch.from_numpy((xq**2).sum(1))
    delta = port_flat._screen_delta(qn, ymax).double().numpy()
    err = np.abs(keys - key64).max(1)
    assert (err <= delta).all(), (err / delta).max()
    # the dropped ql.yl term alone is far inside it
    assert (err <= delta / 8).all(), (err / delta).max()


def test_three_products_match_pallas_k2():
    """faiss_tpu's K2 over the hi/lo screen store of test_torch_flat_kernels
    (d=24, nb=4096, nq=128, ct=512) in interpret mode: on the rows it does
    not flag as lossy, its keys equal the emulated products' within
    1e-6 * (|q|^2 + max n2) (the same bf16 products, summed in another
    order) and its ids agree tie-aware."""
    KC = 32
    rs = np.random.RandomState(21)
    d, nb, nq, d_pad = 24, 4096, 128, 128
    xb = rs.randn(nb, d).astype(np.float32)
    xq = np.zeros((nq, d_pad), np.float32)
    xq[:, :d] = rs.randn(nq, d)
    yT_hi, yT_lo, n2s, _ = jax_stage(jnp.asarray(xb), d_pad, nb, True)
    v, s, ev = map(np.asarray, ivf_recon_fused_pallas(
        jnp.asarray(xq), yT_hi, n2s, jnp.zeros((1, 1), jnp.int32), None,
        yT_lo=yT_lo, qt=128, ct=512, qdepth=3, interpret=True,
    ))
    k, sl = tc_topk(torch.from_numpy(xq), bf16_to_torch(yT_hi),
                    bf16_to_torch(yT_lo), torch.from_numpy(np.array(n2s)))
    k, sl = k.numpy(), sl.numpy()
    e = ev.min(1) >= v[:, KC - 1]
    assert e.mean() > 0.5, e.mean()
    tol = 1e-6 * ((xq**2).sum(1) + (xb**2).sum(1).max())
    assert (np.abs(k[e, :KC] - v[e, :KC]) <= tol[e, None]).all()
    assert ids_agree_tie_aware(v[e, :KC], s[e, :KC], k[e, :KC], sl[e, :KC], tol[e]).all()


def test_three_products_match_pallas_k1():
    """faiss_tpu's K1 in its soft mode over hi/lo planes (interpret mode) on
    an IVF-Flat layout in the shape of test_torch_ivfflat_kernels (d=16
    padded to 128, 256 lists, 3000 vectors, chunks of 256, two 64-query
    tiles): on its exact rows, keys within 1e-6 * (|q|^2 + max n2) of the
    emulated products over each tile's worklist, ids tie-aware."""
    NQ, QT, NLIST, CT, NB, D, KC = 128, 64, 256, 256, 3000, 16, 40
    rs = np.random.RandomState(3)
    listnos = rs.randint(NLIST, size=NB).astype(np.int32)
    g = pack_invlists_grouped(listnos, NLIST, CT)
    Sp = g["S"] + CT
    nchunks = Sp // CT
    slot_list = np.full(Sp, -1)
    slot_list[g["pos"]] = listnos[g["order"]]
    x = np.zeros((128, Sp), np.float32)
    x[:D] = rs.randn(D, Sp)
    x[:, slot_list < 0] = 0
    xt = torch.from_numpy(x)
    hi = xt.to(torch.bfloat16)
    lo = (xt - hi.float()).to(torch.bfloat16)
    n2 = (x.astype(np.float64) ** 2).sum(0, keepdims=True).astype(np.float32)
    n2[0, slot_list < 0] = np.inf
    xq = np.zeros((NQ, 128), np.float32)
    xq[:, :D] = rs.randn(NQ, D)
    cmap = np.full((NQ // QT, nchunks), nchunks - 1, np.int32)
    for tl in range(NQ // QT):
        chunks = np.sort(rs.choice(nchunks - 1, 5, replace=False))
        cmap[tl, :5] = chunks
    lid = np.zeros((1, Sp), np.int32)
    lid[0, : g["S"]] = g["lid"]
    cgroup = np.concatenate([np.repeat(np.arange(g["ngroups"]), g["cpg"]), [0]]).astype(np.int32)
    v, s, ev = map(np.asarray, ivf_recon_fused_dyn_pallas(
        None, jnp.asarray(xq), jbf16(hi), jnp.asarray(n2), jnp.asarray(lid),
        jnp.asarray(cmap), jnp.asarray(cgroup), qt=QT, ct=CT, qdepth=2,
        penalized=False, yT_lo=jbf16(lo), interpret=True,
    ))
    e = ev.min(1) >= v[:, KC - 1]
    assert e.mean() > 0.3, e.mean()
    tol = 1e-6 * ((xq**2).sum(1) + n2[np.isfinite(n2)].max())
    for tl in range(NQ // QT):
        rows = slice(tl * QT, (tl + 1) * QT)
        cols = torch.from_numpy((cmap[tl][:, None] * CT + np.arange(CT)).ravel())
        k, sl = tc_topk(torch.from_numpy(xq[rows]), hi, lo, torch.from_numpy(n2), cols)
        k, sl = k.numpy(), sl.numpy()
        et = e[rows]
        vt, st = v[rows], s[rows]
        nk = (np.isfinite(k[et, :KC])).sum(1)
        assert (nk == np.isfinite(vt[et, :KC]).sum(1)).all()
        fin = np.isfinite(vt[et, :KC])
        assert (np.abs(np.where(fin, k[et, :KC] - vt[et, :KC], 0))
                <= tol[rows][et, None]).all()
        assert ids_agree_tie_aware(
            np.where(fin, vt[et, :KC], np.inf), np.where(fin, st[et, :KC], -1),
            np.where(fin, k[et, :KC], np.inf), np.where(fin, sl[et, :KC], -1),
            tol[rows][et],
        ).all()


def mixture(rs, n, d, ncent=64):
    """Small Gaussian mixture in the shape of bench.py's generator."""
    cent = np.random.RandomState(99).rand(ncent, d).astype(np.float32)
    scales = (1.0 / (np.arange(d) + 1.0)).astype(np.float32) * 0.4
    a = rs.randint(ncent, size=n)
    return (cent[a] + rs.randn(n, d).astype(np.float32) * scales).astype(np.float32)


def trained(kind):
    """A trained faiss_tpu index served by the port (d=16, 256 lists, 3000
    vectors, chunks of 256): its staged layout, queries and decoded store
    planes (yT, and yT_lo for IVF-Flat)."""
    D, NLIST, NB, CT = 16, 256, 3000, 256
    rs = np.random.RandomState(31)
    xb, xq = mixture(rs, NB, D), mixture(rs, 256, D)
    if kind == "ivfpq":
        base = ftj.IndexIVFPQFastScan(None, D, NLIST, 4, 4)
    else:
        base = ftj.IndexIVFFlat(None, D, NLIST)
    base.cp.niter = 4
    base.cp.min_points_per_centroid = 1
    base.FUSED_CT = CT
    base.train(xb)
    base.add(xb)
    if kind == "ivfpq":
        port = refine_flat_from_arrays(
            base.quantizer.vectors(), base.pq.centroids, base._codes_host,
            base._listnos_host, base._ids_host, xb, device="cpu",
        ).base_index
    else:
        port = ivfflat_from_arrays(base.quantizer.vectors(), base._codes_host,
                                   base._listnos_host, base._ids_host, device="cpu")
    port.FUSED_CT = CT
    return port, port._build_brute(), torch.from_numpy(xq), CT


def real_steps(cmap, pad):
    """The kernel's stop per tile: one past its last non-PAD step."""
    last = torch.where(cmap != pad, torch.arange(cmap.shape[1]), -1).max(1).values
    return (last + 1).tolist()


@pytest.mark.parametrize("kind", ["ivfpq", "ivfflat"])
def test_pad_skip_leaves_k1_plain_version_equal(kind):
    """K1's plain version over each tile's whole worklist and over its steps
    up to the last non-PAD one (the kernel's cut) agree bit for bit in keys
    and floor, and in slots up to the order of exactly equal keys, soft and
    penalized, on worklists of which the PAD steps are over 30%."""
    port, br, xq, ct = trained(kind)
    qt, nprobe = 64, 1
    msteps = br["nchunks"]
    perm, pcols_s, cm2, cmap, _ = port_pq._dyn_inputs(xq, br, nprobe, qt, msteps)
    pad = br["yT"].shape[1] // ct - 1
    assert pad == br["nchunks"]
    assert torch.isinf(br["n2s"][0, pad * ct :]).all()  # the PAD chunk
    stops = real_steps(cmap, pad)
    assert all(0 < r <= msteps for r in stops) and sum(stops) < 0.7 * len(stops) * msteps
    xq_s = port_pq._pad_dims(xq[perm], br)
    lo = br.get("yT_lo")
    assert (lo is not None) == (kind == "ivfflat")
    penalties = [{}, dict(
        biasg=torch.where(port_pq._probe_mask(cm2, pcols_s), 0.0, 1e9),
        lid=br["lid"], cgroup=br["cgroup"],
    )]
    for pen in penalties:
        full = ivf_recon_fused_dyn_ref(xq_s, br["yT"], br["n2s"], cmap, qt, ct,
                                       yT_lo=lo, **pen)
        for t, r in enumerate(stops):
            rows = slice(t * qt, (t + 1) * qt)
            sub = {k: (v[rows] if k == "biasg" else v) for k, v in pen.items()}
            cut = ivf_recon_fused_dyn_ref(
                xq_s[rows], br["yT"], br["n2s"], cmap[t : t + 1, :r].contiguous(),
                qt, ct, yT_lo=lo, **sub,
            )
            assert torch.equal(full[0][rows], cut[0]), (kind, bool(pen), t)
            assert torch.equal(full[2][rows], cut[2])
            # slots: the same up to the order of equal keys (the 1e9 keys
            # of masked slots, equal PQ reconstructions)
            assert ids_agree_tie_aware(full[0][rows].numpy(), full[1][rows].numpy(),
                                       cut[0].numpy(), cut[1].numpy(), 0.0).all()


@pytest.mark.parametrize("penalized", [False, True], ids=["soft", "penalized"])
@pytest.mark.parametrize("kind", ["ivfpq", "ivfflat"])
def test_k1_plain_version_at_real_d_equals_zero_padded(kind, penalized):
    """K1 multiplies only the real dims: its plain version over queries and
    a store zero-padded from d = 16 to d_pad = 128, told the real d, equals
    bit for bit the plain version over the unpadded first 16 dims, and the
    same over all 128 dims in keys (slots up to the order of equal keys),
    on IVF-PQ and IVF-Flat layouts staged from trained faiss_tpu indexes:
    the padding adds exact zeros to every sum."""
    port, br, xq, ct = trained(kind)
    qt, nprobe, d = 64, 1, xq.shape[1]
    perm, pcols_s, cm2, cmap, _ = port_pq._dyn_inputs(xq, br, nprobe, qt, br["nchunks"])
    xq_p = port_pq._pad_dims(xq[perm], br)
    assert xq_p.shape[1] == br["yT"].shape[0] == 128 > d
    assert not br["yT"][d:].any() and not xq_p[:, d:].any()
    lo = br.get("yT_lo")
    pen = {}
    if penalized:
        pen = dict(biasg=torch.where(port_pq._probe_mask(cm2, pcols_s), 0.0, 1e9),
                   lid=br["lid"], cgroup=br["cgroup"])
    at_d = ivf_recon_fused_dyn_ref(xq_p, br["yT"], br["n2s"], cmap, qt, ct,
                                   yT_lo=lo, d=d, **pen)
    real = ivf_recon_fused_dyn_ref(
        xq_p[:, :d].contiguous(), br["yT"][:d], br["n2s"], cmap, qt, ct,
        yT_lo=None if lo is None else lo[:d], **pen)
    padded = ivf_recon_fused_dyn_ref(xq_p, br["yT"], br["n2s"], cmap, qt, ct,
                                     yT_lo=lo, **pen)
    for out in (at_d, padded):
        assert torch.equal(out[0], real[0]) and torch.equal(out[2], real[2])
        assert ids_agree_tie_aware(out[0].numpy(), out[1].numpy(),
                                   real[0].numpy(), real[1].numpy(), 0.0).all()
    assert torch.equal(at_d[1], real[1])


@pytest.mark.parametrize("d", [0, -1, 129])
def test_k1_wrapper_raises_on_real_d_out_of_range(d):
    """The real d lies in 1..d_pad: the wrapper raises before any route."""
    nq, d_pad, ct = 64, 128, 64
    xq = torch.zeros(nq, d_pad)
    yT = torch.zeros(d_pad, 2 * ct, dtype=torch.bfloat16)
    n2 = torch.zeros(1, 2 * ct)
    cmap = torch.zeros(1, 1, dtype=torch.int32)
    fused_knn.ivf_recon_fused_dyn(xq, yT, n2, cmap, nq, ct, d=d_pad)
    with pytest.raises(ValueError, match="d_pad=128"):
        fused_knn.ivf_recon_fused_dyn(xq, yT, n2, cmap, nq, ct, d=d)
    with pytest.raises(ValueError, match="d_pad=128"):
        fused_knn.ivf_recon_fused_dyn(*(t.to("meta") for t in (xq, yT, n2, cmap)),
                                      nq, ct, d=d)


def c_int_expr(pattern, **env):
    """The C++ int expression that ``pattern``'s group captures in
    recon_wgmma.cuh, evaluated with ``env`` (threadIdx.x as tid)."""
    e = re.search(pattern, WG_HEADER).group(1).replace("threadIdx.x", "tid")
    return eval(e.replace("/", "//"), {}, env)


@pytest.mark.parametrize("hilo", [False, True], ids=["one-plane", "hilo"])
def test_k1_shared_memory_keeps_one_block_per_sm(hilo):
    """The ring (stages of 128 dims x 64 columns a plane, each 1024-byte
    aligned for the swizzle) with its n2, the 64 queries' selects and the
    mbarriers stay within the mma.sync scan's 198,208 / 230,976 bytes."""
    h = consts(WG_HEADER)
    one, two = map(int, re.search(
        r"stages\(bool hilo\) \{ return hilo \? (\d+) : (\d+); \}", WG_HEADER).groups()[::-1])
    stages = two if hilo else one
    stage = (2 if hilo else 1) * h["kPlane"]
    select = 8 * h["BM"] * h["CAP"] + 8 * h["BM"]
    smem = stages * (stage + h["BN"] * 4) + select + 2 * stages * 8
    assert stage % 1024 == 0 and h["kBox"] % 1024 == 0
    assert smem <= (230976 if hilo else 198208)
    assert (fused_knn.RECON_BLOCK, fused_knn.RECON_TILE) == (h["BM"], h["BN"])
    assert h["THREADS"] == 384 and h["CONSUMERS"] == 256


def test_k1_accumulators_cover_each_tile_once():
    """Per warpgroup, d[4 j + 2 h + e] of its 128 threads (row a_row() +
    8 h, column 8 j + a_col() + e) covers the 64 x 64 tile once, and warp
    w of either warpgroup holds rows 16 (w % 4) .. + 16: the two warps that
    share a row group's select."""
    for g in range(2):
        seen = set()
        for tid in range(128 * g, 128 * (g + 1)):
            r0 = c_int_expr(r"int a_row\(\) \{\s*return ([^;]+);", tid=tid)
            c0 = c_int_expr(r"int a_col\(\) \{ return ([^;]+); \}", tid=tid)
            w = tid // 32
            for j in range(8):
                for h in range(2):
                    for e in range(2):
                        row, col = r0 + 8 * h, 8 * j + c0 + e
                        assert 16 * (w % 4) <= row < 16 * (w % 4) + 16
                        seen.add((row, col))
        assert seen == {(r, c) for r in range(64) for c in range(64)}


def test_k1_row_groups_hand_off_on_barriers_of_their_own():
    """Row group rg's turn passes from warpgroup 0 to 1 on one named
    barrier and back on another: each warpgroup waits on the barrier the
    other arrives at, no two row groups or directions share one, and none
    is barrier 0 (__syncthreads) or the consumers' BAR_ALL."""
    wait = r'"bar\.sync %0, 64;\\n" ::"r"\(([^)]+\)?)\)'
    arrive = r'"bar\.arrive %0, 64;\\n" ::"r"\(([^)]+)\)'
    ids = set()
    for rg in range(4):
        w = [c_int_expr(wait, rg=rg, g=g) for g in range(2)]
        a = [c_int_expr(arrive, rg=rg, g=g) for g in range(2)]
        assert w[1] == a[0] and w[0] == a[1] and a[0] != a[1]
        ids.update(a)
    h = consts(WG_HEADER)
    assert len(ids) == 8 and 0 not in ids and h["BAR_ALL"] not in ids
    assert max(ids | {h["BAR_ALL"]}) < 16


def test_split_count_fills_the_card():
    """One block of 64 queries per SM: a launch splits until it has a block
    per SM, never finer than one unit per split."""
    assert fused_knn._split_count(32, 128, 132) == 4  # K1, 2048 q, qt 256
    assert fused_knn._split_count(64, 15632, 132) == 2  # K2 hi/lo, 4096 q
    assert fused_knn._split_count(128, 15632, 132) == 1
    assert fused_knn._split_count(2, 100, 132) == 66
    assert fused_knn._split_count(4, 3, 132) == 3
    with pytest.raises(ValueError, match="positive"):
        fused_knn._split_count(0, 10, 132)


def test_split_scratch():
    pk, ps = fused_knn._split_scratch(3, 128, torch.device("cpu"))
    assert pk.shape == ps.shape == (3, 128, 128)
    assert pk.dtype == torch.float32 and ps.dtype == torch.int32
    assert fused_knn._split_scratch(1, 128, torch.device("cpu")) == (None, None)
    with pytest.raises(ValueError, match="at least 1"):
        fused_knn._split_scratch(0, 128, torch.device("cpu"))


def test_pad_chunk():
    assert fused_knn._pad_chunk(5 * 256, 256) == 4
    for S, ct in ((1000, 256), (0, 256), (512, 0)):
        with pytest.raises(ValueError, match="whole chunks"):
            fused_knn._pad_chunk(S, ct)


def test_mma_operand_checks_raise():
    """16-byte operands, row stride in multiples of 8 columns, d_pad in
    multiples of 128, chunks of whole 64-column tiles."""
    xq = torch.zeros(64, 128)
    yT = torch.zeros(128, 1024, dtype=torch.bfloat16)
    n2 = torch.zeros(1, 1024)
    fused_knn._check_mma_operands("K2", xq, (yT,), n2, 128, 1024)
    with pytest.raises(ValueError, match="16-byte"):
        fused_knn._check_mma_operands("K2", xq, (yT[:, 2:],), n2, 128)
    with pytest.raises(ValueError, match="16-byte"):
        fused_knn._check_mma_operands("K2", xq, (yT,), n2[:, 1:], 128)
    with pytest.raises(ValueError, match="16-byte"):
        fused_knn._check_mma_operands("K1", torch.zeros(64 * 128 + 1)[1:].view(64, 128),
                                      (yT,), n2, 128)
    odd = torch.zeros(128, 1028, dtype=torch.bfloat16)[:, :1024]
    with pytest.raises(ValueError, match="multiple of 8"):
        fused_knn._check_mma_operands("K2", xq, (odd,), n2, 128)
    with pytest.raises(ValueError, match="d_pad"):
        fused_knn._check_mma_operands("K2", torch.zeros(64, 64), (yT[:64],), n2, 64)
    with pytest.raises(ValueError, match="ct="):
        fused_knn._check_mma_operands("K1", xq, (yT,), n2, 128, 96)


def test_flat_stripes_meet_the_mma_checks():
    """Every stripe the striped large-k path passes K2 (a column slice of the
    stripe-grid store at a multiple of W) starts on a 16-byte boundary with a
    row stride of whole 16-byte chunks, and so does the lo plane and n2."""
    rs = np.random.RandomState(4)
    xb = rs.randn(130000, 8).astype(np.float32)
    index = port_flat.IndexFlatL2(8, device="cpu")
    index.add(xb)
    P, W, nbp_lk, _ = index._striped_plan(300)
    assert P > 1 and W % 1024 == 0
    yT_hi, yT_lo, n2s, _ = index._screen_lk_dev(nbp_lk)
    xqp = port_flat._pad_dims(torch.zeros(64, 8), yT_hi.shape[0]).contiguous()
    for s in range(P):
        sl = slice(s * W, (s + 1) * W)
        fused_knn._check_mma_operands("K2", xqp, (yT_hi[:, sl], yT_lo[:, sl]),
                                      n2s[:, sl], yT_hi.shape[0])


@pytest.mark.parametrize("name", sorted(fused_knn.KERNELS))
def test_every_kernel_source_needs_the_toolkit(name, monkeypatch, tmp_path):
    """No CPU fallback: without nvcc no kernel builds, K1's and K2's
    sources with their tensor-core headers included, and the headers enter
    every build's hash."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(fused_knn, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        fused_knn.build_kernel.__wrapped__(name)
    headers = {h.name for h in fused_knn.CSRC.glob("*.cuh")}
    assert {"recon_mma.cuh", "tile_select.cuh"} <= headers
    if name in ("ivf_recon", "ivf_recon_dyn"):
        src = (fused_knn.CSRC / f"{name}.cu").read_text()
        assert '#include "recon_mma.cuh"' in src
        assert "recon_step.cuh" not in src and "exact_select.cuh" not in src
