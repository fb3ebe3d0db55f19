#!/usr/bin/env python3
"""Drive the PyTorch port's two ported paths once on one CUDA card and check
them: the IVF4096,PQ32x4fs,RFlat serving path (kernel K1) and exact flat
search (kernels K2 and K3).

    python3 chip_smoke.py        # from the repository root, on a machine with a card

Phases, each of which fails the run (non-zero exit, no result line):
  1. a CUDA card is present; print its name and power limit (nvidia-smi);
  2. build K1, K2 and K3 (faiss_tpu_torch/csrc/*.cu), one nvcc per source,
     all started together, and print each one's ptxas register lines and
     dynamic shared memory per block;
  3. regenerate the 1M x 128 Gaussian mixture of bench.py (seeds 42, 1, 2, 3);
  4. train and add IndexRefineFlat(IndexIVFPQFastScan(d=128, nlist=4096,
     M=32, nbits=4), store_float16=True) on the card, then stage the search
     layout (20 k-means iterations);
  5. search the 8192 queries at nprobe=1, soft probing, k_factor=8,
     pipeline_batch=2048, with the kernels' launch counts set to 0 before and
     read after; recall@10 against bench_gt_cache.npz must reach 0.95, and
     the returned distances must be the exact squared L2 to the fp16 store;
  6. on the first real 2048-query sub-batch with its real worklists, K1 and
     its plain PyTorch version must return the same slots (tie-aware) and
     keys within 1e-4 * (|q|^2 + n2);
  7. time K1 and the plain version with CUDA events (plain, kernel, kernel,
     plain) and the search of all 8192 queries with a host clock.
The IVF-PQ index is then freed, and exact flat search follows on the same
1M x 128 store. Every search below runs with all launch counts set to 0
just before it and read just after, and must launch its path's kernel:
  8. IndexFlatL2: add and stage the hi/lo screen store;
  9. k=10 through ``search`` (screen, K2): the ids must agree tie-aware with
     bench_gt_cache.npz (float64 distances, tolerance 1e-6 * (|q|^2 +
     max |y|^2)); print recall@10;
 10. k=100 (BASELINE config 1) through ``search_submit``/``search_collect``
     (screen, K2): print the certified share and the repaired rows;
 11. k=1024 (BASELINE row 9) through ``search`` (striped, K2 per stripe):
     print the striped counters;
 12. ``flat_screen = False``: k=100 on the 8192 queries and k=2000 on 1024
     queries (fused, K3 at k_lanes 128 and 2048);
 13. IndexFlatIP: k=100 on 1024 queries (screen, K2).
     After each of 10-13, 64 rows must match a float64 brute force on the
     card: distances within 1e-5 * (|q|^2 + max |y|^2) (the float32 norm
     expansion's error scales with the norms, not with the distance) and ids
     tie-aware;
 14. K2 (hi/lo and one plane) on the first 4096-query screen sub-batch
     against the full store, K2 hi/lo on the first and the last (pad-filled)
     k=1024 stripe as the striped path passes them (column slices of the
     stripe-grid store, row stride wider than the slice), and K3 at k_lanes
     128 and 2048, against their plain versions: keys within
     1e-4 * (|q|^2 + n2), ids tie-aware;
 15. time K2 (full store and one stripe) and K3 and their plain versions
     with CUDA events (plain, kernel, kernel, plain), and ``search`` of the
     8192 queries at k=100 and k=1024 by host clock, median of 5, with QPS;
     peak device memory.
The last two lines are the card's name and power limit, then the result
line {"ok": true, "device": {...}}; the kernels' JSON line comes before.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
D, NB, NQ, NT, NLIST, M, NBITS = 128, 1_000_000, 8192, 200_000, 4096, 32, 4
NPROBE, K, K_FACTOR, BATCH, NITER = 1, 10, 8, 2048, 20
RECALL_MIN = 0.95
EXACT_ROWS = 64


def bench_data():
    """The Gaussian mixture of bench.py:228-244, copied."""
    rs = np.random.RandomState(42)
    ncent = 2048
    cent = rs.rand(ncent, D).astype(np.float32)
    scales = (1.0 / (np.arange(D) + 1.0)).astype(np.float32) * 0.4

    def gen(n, seed):
        r = np.random.RandomState(seed)
        a = r.randint(ncent, size=n)
        return (cent[a] + r.randn(n, D).astype(np.float32) * scales).astype(
            np.float32
        )

    return gen(NB, 1), gen(NT, 2), gen(NQ, 3)


def check(cond, what):
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def cuda_ms(fn, reps):
    """Mean milliseconds of fn() over reps launches, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def turns(plain, kern, reps):
    """(kernel ms, plain ms, all four) in the order plain, kernel, kernel,
    plain."""
    t = [cuda_ms(f, reps) for f in (plain, kern, kern, plain)]
    return (t[1] + t[2]) / 2, (t[0] + t[3]) / 2, t


def host_median(fn, n=5):
    times = []
    for _ in range(n):
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        times.append(time.time() - t0)
    return float(np.median(times)), times


def reset_counts(fused_knn):
    for f in (fused_knn.ivf_recon_fused_dyn, fused_knn.ivf_recon_fused,
              fused_knn.knn_fused):
        f.launches = 0


def compare_lanes(keys, slots, rkeys, rslots, tol, what, ids_agree_tie_aware):
    """Kernel against plain version: +inf and -1 at the same places, keys
    within tol [nq, 1] where finite, ids tie-aware. Returns max_abs_err."""
    kk, ks, rk, rs_ = (a.cpu().numpy() for a in (keys, slots, rkeys, rslots))
    check(((ks == -1) == ~np.isfinite(kk)).all()
          and ((rs_ == -1) == ~np.isfinite(rk)).all(),
          f"{what}: id -1 does not mark exactly the infinite keys")
    check((np.isfinite(kk) == np.isfinite(rk)).all(), f"{what}: infinite keys differ")
    fin = np.isfinite(rk)
    err = np.abs(np.where(fin, kk, 0.0) - np.where(fin, rk, 0.0))
    max_abs_err = float(err.max())
    check((err <= tol).all(), f"{what}: keys differ from the plain version by "
                              f"{max_abs_err}")
    agree = ids_agree_tie_aware(rk, rs_, kk, ks, np.where(fin, tol, 0).max(1))
    check(agree.all(), f"{what}: ids differ on {int((~agree).sum())} rows")
    return max_abs_err


def ivfpq_phases(ft, fused_knn, xb, xt, xq, gt, dev):
    """Phases 4-7: the IVF4096,PQ32x4fs,RFlat path and K1. Returns K1's
    entry of the kernels' JSON line."""
    from faiss_tpu_torch.models.ivf_pq import _k1_inputs
    from faiss_tpu_torch.utils.evaluation import ids_agree_tie_aware, recall_at_k

    base = ft.IndexIVFPQFastScan(None, D, NLIST, M, NBITS, device=dev)
    base.cp.niter = NITER
    base.nprobe = NPROBE
    base.strict_probe = False
    base.pipeline_batch = BATCH
    index = ft.IndexRefineFlat(base, store_float16=True)
    index.k_factor = K_FACTOR
    torch.cuda.synchronize()
    t0 = time.time()
    index.train(xt)
    torch.cuda.synchronize()
    t_train = time.time() - t0
    t0 = time.time()
    index.add(xb)
    torch.cuda.synchronize()
    t_add = time.time() - t0
    t0 = time.time()
    br = base._build_brute()
    index.refine_index._consolidate()
    torch.cuda.synchronize()
    t_stage = time.time() - t0
    print(f"train {t_train:.2f} s, add {t_add:.2f} s, stage {t_stage:.2f} s; "
          f"nchunks {br['nchunks']}", flush=True)

    # the main path, with the launch counts read around it
    reset_counts(fused_knn)
    t0 = time.time()
    Dm, Im = index.search(xq, K)
    t_first = time.time() - t0
    launches = fused_knn.ivf_recon_fused_dyn.launches
    msteps = base._dyn_bucket[NPROBE]
    check(launches > 0, "the main path launched K1 no time")
    check(Dm.shape == Im.shape == (NQ, K), f"result shape {Dm.shape}")
    check(np.isfinite(Dm).all() and (Im >= 0).all() and (Im < NB).all(),
          "non-finite distances or invalid ids")
    recall = recall_at_k(Im, gt, K)
    print(f"search (first, sizes the worklist) {t_first:.3f} s; K1 launches "
          f"{launches}; msteps {msteps}; recall@10 {recall:.4f}", flush=True)
    check(recall >= RECALL_MIN, f"recall@10 {recall:.4f} < {RECALL_MIN}")
    xb16 = xb[Im[:256]].astype(np.float16).astype(np.float32)
    d_chk = ((xq[:256, None, :] - xb16) ** 2).sum(-1)
    check(np.allclose(Dm[:256], d_chk, rtol=1e-4, atol=1e-3),
          "distances are not the exact L2 to the fp16 store")

    # K1 against its plain version on the first real sub-batch
    qt = 256
    xq_dev = torch.from_numpy(xq[:BATCH]).to(dev)
    _, xq_p, cmap, ndropped = _k1_inputs(xq_dev, br, NPROBE, qt, msteps)
    args = (xq_p, br["yT"], br["n2s"], cmap, qt, base.FUSED_CT)
    kk, ks, kf = fused_knn.ivf_recon_fused_dyn(*args)
    rk, rs_, _ = fused_knn.ivf_recon_fused_dyn_ref(*args)
    torch.cuda.synchronize()
    check(bool(torch.isinf(kf).all()), "K1's floor is not all +inf")
    n2 = br["n2s"][0].cpu().numpy()
    rsn = rs_.cpu().numpy()
    tol = 1e-4 * ((xq_p.cpu().numpy() ** 2).sum(1)[:, None]
                  + np.where(rsn >= 0, n2[np.maximum(rsn, 0)], 0))
    max_abs_err = compare_lanes(kk, ks, rk, rs_, tol, "K1", ids_agree_tie_aware)
    print(f"K1 vs plain on sub-batch 0 [{BATCH} q, {cmap.shape[1]} steps, "
          f"ndropped {int(ndropped)}]: max_abs_err {max_abs_err:.3e}, "
          f"slots agree on all rows", flush=True)

    # times at the main-path shape: plain, kernel, kernel, plain
    ms, plain_ms, t = turns(lambda: fused_knn.ivf_recon_fused_dyn_ref(*args),
                            lambda: fused_knn.ivf_recon_fused_dyn(*args), 20)
    print(f"K1 {t[1]:.3f} / {t[2]:.3f} ms, plain {t[0]:.3f} / {t[3]:.3f} ms "
          f"per {BATCH}-query sub-batch", flush=True)
    t_search, times = host_median(lambda: index.search(xq, K))
    print(f"search of {NQ} queries: median {t_search * 1e3:.1f} ms over 5 "
          f"({', '.join(f'{t * 1e3:.1f}' for t in times)}) -> "
          f"{NQ / t_search:.0f} QPS; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    return {
        "name": "ivf_recon_fused_dyn",
        "route": "cuda",
        "source": "faiss_tpu_torch/csrc/ivf_recon_dyn.cu",
        "replaces": "faiss_tpu/ops/pallas_knn.py:1249",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": ms,
        "plain_ms": plain_ms,
    }


class Exact:
    """float64 brute force on the card for the first EXACT_ROWS queries."""

    def __init__(self, xb, dev):
        self.y = torch.from_numpy(xb).to(dev, torch.float64)
        self.yn = self.y.square().sum(1)
        self.dev = dev

    def check(self, xq, Dp, Ip, k, metric_l2, what, ids_agree_tie_aware):
        q = torch.from_numpy(xq[:EXACT_ROWS]).to(self.dev, torch.float64)
        qn = q.square().sum(1)
        ip = q @ self.y.T
        if metric_l2:
            vals, ids = torch.topk(qn[:, None] + self.yn[None] - 2 * ip, k,
                                   largest=False)
        else:
            vals, ids = torch.topk(ip, k, largest=True)
        vals, ids = vals.cpu().numpy(), ids.cpu().numpy()
        tol = 1e-5 * (qn + self.yn.max()).cpu().numpy()
        Dp, Ip = Dp[:EXACT_ROWS], Ip[:EXACT_ROWS]
        err = np.abs(Dp - vals)
        check((err <= tol[:, None]).all(),
              f"{what}: distances differ from float64 by {err.max():.3e}")
        sign = 1.0 if metric_l2 else -1.0
        agree = ids_agree_tie_aware(sign * vals, ids, sign * Dp, Ip, tol)
        check(agree.all(), f"{what}: ids differ from float64 on "
                           f"{int((~agree).sum())} of {EXACT_ROWS} rows")
        return float(err.max())


def flat_search(fused_knn, what, fn, kernel, nq, k):
    """Run one flat search with the counts set to 0 just before and read
    just after; its path's kernel must have launched."""
    reset_counts(fused_knn)
    t0 = time.time()
    Dp, Ip = fn()
    torch.cuda.synchronize()
    dt = time.time() - t0
    launches = kernel.launches
    check(launches > 0, f"{what} launched its kernel no time")
    check(Dp.shape == Ip.shape == (nq, k), f"{what}: result shape {Dp.shape}")
    check(((Ip >= 0) & (Ip < NB)).all() and np.isfinite(Dp).all(),
          f"{what}: invalid ids or non-finite distances")
    print(f"{what}: {dt:.3f} s (first call), {launches} launches", flush=True)
    return Dp, Ip, launches


def flat_phases(ft, fused_knn, xb, xq, gt, dev):
    """Phases 8-15: exact flat search and K2/K3. Returns their entries of
    the kernels' JSON line."""
    from faiss_tpu_torch.models import flat as flat_mod
    from faiss_tpu_torch.utils.evaluation import ids_agree_tie_aware, recall_at_k

    torch.cuda.synchronize()
    t0 = time.time()
    flat = ft.IndexFlatL2(D, device=dev)
    flat.add(xb)
    flat._consolidate()
    yT_hi, yT_lo, n2s, ymax = flat._screen_dev()
    torch.cuda.synchronize()
    print(f"IndexFlatL2 add + stage {time.time() - t0:.2f} s "
          f"(screen store {tuple(yT_hi.shape)} x 2 bf16 planes)", flush=True)
    exact = Exact(xb, dev)
    k2_launches = 0

    # k=10 against the reference's ground truth (screen path)
    Dp, Ip, n = flat_search(fused_knn, "flat k=10 search",
                            lambda: flat.search(xq, 10),
                            fused_knn.ivf_recon_fused, NQ, 10)
    k2_launches += n
    y64, q64 = exact.y, torch.from_numpy(xq).to(dev, torch.float64)

    def sorted_d64(ids):
        i = torch.from_numpy(ids).to(dev)
        d = (q64[:, None, :] - y64[i]).square().sum(-1)
        d, o = torch.sort(d, 1)
        return d.cpu().numpy(), torch.gather(i, 1, o).cpu().numpy()

    d_gt, i_gt = sorted_d64(gt[:, :10])
    d_pt, i_pt = sorted_d64(Ip)
    tol = 1e-6 * (q64.square().sum(1) + exact.yn.max()).cpu().numpy()
    agree = ids_agree_tie_aware(d_gt, i_gt, d_pt, i_pt, tol)
    differ = int((np.sort(i_gt, 1) != np.sort(i_pt, 1)).any(1).sum())
    recall = recall_at_k(Ip, gt, 10)
    print(f"k=10 vs bench_gt_cache.npz: recall@10 {recall:.4f}; id sets "
          f"differ on {differ} rows, all within ties: {bool(agree.all())}",
          flush=True)
    check(agree.all(), f"k=10 ids disagree with the ground truth beyond ties "
                       f"on {int((~agree).sum())} rows")

    # k=100 (config 1) through search_submit/search_collect
    s0 = dict(flat_mod.screen_stats)
    Dp, Ip, n = flat_search(
        fused_knn, "flat k=100 search_submit/collect",
        lambda: flat.search_collect(flat.search_submit(xq, 100)),
        fused_knn.ivf_recon_fused, NQ, 100)
    k2_launches += n
    nq_s = flat_mod.screen_stats["nq"] - s0["nq"]
    flagged = flat_mod.screen_stats["flagged"] - s0["flagged"]
    check(flat_mod.screen_stats["storms"] == s0["storms"], "k=100 screen stormed")
    print(f"k=100 screen: certified {1 - flagged / nq_s:.4f} of {nq_s} rows; "
          f"{flagged} rows repaired exactly", flush=True)
    err = exact.check(xq, Dp, Ip, 100, True, "k=100", ids_agree_tie_aware)
    print(f"k=100: {EXACT_ROWS} rows exact vs float64 (max err {err:.3e})", flush=True)

    # k=1024 (BASELINE row 9): the striped path
    s0 = dict(flat_mod.striped_stats)
    P, W, nbp_lk, u = flat._striped_plan(1024)
    Dp, Ip, n = flat_search(fused_knn, "flat k=1024 search (striped)",
                            lambda: flat.search(xq, 1024),
                            fused_knn.ivf_recon_fused, NQ, 1024)
    k2_launches += n
    st = {key: flat_mod.striped_stats[key] - s0[key] for key in s0}
    check(st["storms"] == 0 and st["nq"] == NQ, f"striped path counters {st}")
    print(f"k=1024 striped: P={P} stripes of W={W}, u={u}; striped_stats "
          f"{st}", flush=True)
    err = exact.check(xq, Dp, Ip, 1024, True, "k=1024", ids_agree_tie_aware)
    print(f"k=1024: {EXACT_ROWS} rows exact vs float64 (max err {err:.3e})", flush=True)

    # the fused path: K3 at k_lanes 128 and 2048
    flat.flat_screen = False
    k3_launches = {}  # by k_lanes
    for k, nq, k_lanes in ((100, NQ, 128), (2000, 1024, 2048)):
        Dp, Ip, n = flat_search(fused_knn, f"flat k={k} fused (flat_screen=False)",
                                lambda: flat.search(xq[:nq], k),
                                fused_knn.knn_fused, nq, k)
        k3_launches[k_lanes] = n
        err = exact.check(xq, Dp, Ip, k, True, f"fused k={k}", ids_agree_tie_aware)
        print(f"fused k={k}: {EXACT_ROWS} rows exact vs float64 (max err "
              f"{err:.3e})", flush=True)
    flat.flat_screen = True

    # IndexFlatIP
    ip_index = ft.IndexFlatIP(D, device=dev)
    ip_index.add(xb)
    Dp, Ip, n = flat_search(fused_knn, "IndexFlatIP k=100 search",
                            lambda: ip_index.search(xq[:1024], 100),
                            fused_knn.ivf_recon_fused, 1024, 100)
    k2_launches += n
    err = exact.check(xq, Dp, Ip, 100, False, "IP k=100", ids_agree_tie_aware)
    print(f"IP k=100: {EXACT_ROWS} rows exact vs float64 (max err {err:.3e})",
          flush=True)
    del ip_index, exact

    # K2 and K3 against their plain versions at the main paths' shapes
    qn = torch.from_numpy(xq).to(dev).square().sum(1)
    xq4k = torch.from_numpy(xq[:4096]).to(dev)
    k2_args = (xq4k, yT_hi, n2s)
    k2_kw = dict(qt=256, ct=1024)
    k2_err = 0.0

    def k2_check(args, lo, name):
        kk, ks, kf = fused_knn.ivf_recon_fused(*args, lo, **k2_kw)
        rk, rs_, _ = fused_knn.ivf_recon_fused_ref(*args, lo, **k2_kw)
        torch.cuda.synchronize()
        check(bool(torch.isinf(kf).all()), f"{name}: floor is not all +inf")
        rsn = rs_.cpu().numpy()
        n2 = args[2][0].cpu().numpy()
        tol = 1e-4 * (qn[:4096].cpu().numpy()[:, None]
                      + np.where(rsn >= 0, n2[np.maximum(rsn, 0)], 0))
        e = compare_lanes(kk, ks, rk, rs_, tol, name, ids_agree_tie_aware)
        print(f"{name} vs plain [4096 q x {args[1].shape[1]} columns, row stride "
              f"{args[1].stride(0)}]: max_abs_err {e:.3e}, ids agree on all rows",
              flush=True)
        return e

    for lo, name in ((yT_lo, "K2 hi/lo"), (None, "K2 one plane")):
        e = k2_check(k2_args, lo, name)
        if lo is not None:
            k2_err = e
    # the striped path's shape: column slices of the stripe-grid store, with
    # row stride nbp_lk; the last stripe ends in +inf-norm pad columns
    lk_hi, lk_lo, lk_n2s, _ = flat._screen_lk_dev(nbp_lk)
    for s, what in ((0, "first"), (P - 1, "last, pad-filled")):
        sl = slice(s * W, (s + 1) * W)
        npad = min(W, max(0, (s + 1) * W - NB))
        e = k2_check((xq4k, lk_hi[:, sl], lk_n2s[:, sl]), lk_lo[:, sl],
                     f"K2 hi/lo stripe {s} ({what}, {npad} pad columns)")
        k2_err = max(k2_err, e)
    stripe_args = (xq4k, lk_hi[:, :W], lk_n2s[:, :W])
    _, _, t = turns(
        lambda: fused_knn.ivf_recon_fused_ref(*stripe_args, lk_lo[:, :W], **k2_kw),
        lambda: fused_knn.ivf_recon_fused(*stripe_args, lk_lo[:, :W], **k2_kw), 5)
    print(f"K2 hi/lo one stripe {t[1]:.2f} / {t[2]:.2f} ms, plain {t[0]:.2f} / "
          f"{t[3]:.2f} ms per 4096-query sub-batch over {W} columns", flush=True)
    del lk_hi, lk_lo, lk_n2s, stripe_args
    xbT = flat._xbT_dev()
    yn = flat._norms.cpu().numpy()
    k3_err = {}
    for k_lanes, nq in ((128, NQ), (2048, 1024)):
        x = torch.from_numpy(xq[:nq]).to(dev)
        kw = dict(metric_l2=True, qt=512, k_lanes=k_lanes)
        kv, ki, kf = fused_knn.knn_fused(x, xbT, NB, **kw)
        rv, ri, _ = fused_knn.knn_fused_ref(x, xbT, NB, **kw)
        torch.cuda.synchronize()
        check(bool(torch.isinf(kf).all()), "K3: floor is not all +inf")
        rin = ri.cpu().numpy()
        tol = 1e-4 * (qn[:nq].cpu().numpy()[:, None]
                      + np.where(rin >= 0, yn[np.maximum(rin, 0)], 0))
        e = compare_lanes(kv, ki, rv, ri, tol, f"K3 k_lanes={k_lanes}",
                          ids_agree_tie_aware)
        k3_err[k_lanes] = e
        print(f"K3 k_lanes={k_lanes} vs plain [{nq} q x {NB} columns]: "
              f"max_abs_err {e:.3e}, ids agree on all rows", flush=True)

    # times
    k2_ms, k2_plain, t = turns(
        lambda: fused_knn.ivf_recon_fused_ref(*k2_args, yT_lo, **k2_kw),
        lambda: fused_knn.ivf_recon_fused(*k2_args, yT_lo, **k2_kw), 3)
    print(f"K2 hi/lo {t[1]:.2f} / {t[2]:.2f} ms, plain {t[0]:.2f} / {t[3]:.2f} ms "
          f"per 4096-query sub-batch over {yT_hi.shape[1]} columns", flush=True)
    k3_times = {}
    for k_lanes, nq in ((128, NQ), (2048, 1024)):
        x = torch.from_numpy(xq[:nq]).to(dev)
        kw = dict(metric_l2=True, qt=512, k_lanes=k_lanes)
        k3_times[k_lanes] = turns(
            lambda: fused_knn.knn_fused_ref(x, xbT, NB, **kw),
            lambda: fused_knn.knn_fused(x, xbT, NB, **kw), 2)
        t = k3_times[k_lanes][2]
        print(f"K3 k_lanes={k_lanes} {t[1]:.2f} / {t[2]:.2f} ms, plain "
              f"{t[0]:.2f} / {t[3]:.2f} ms per {nq}-query bucket", flush=True)
    for k in (100, 1024):
        med, times = host_median(lambda: flat.search(xq, k))
        print(f"IndexFlatL2 search of {NQ} queries at k={k}: median "
              f"{med * 1e3:.1f} ms over 5 ({', '.join(f'{t * 1e3:.1f}' for t in times)})"
              f" -> {NQ / med:.0f} QPS", flush=True)
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
          flush=True)
    # K3 has one entry per k_lanes the path runs: it beats its plain version
    # at 128 and loses to it at 2048
    return [
        {
            "name": "ivf_recon_fused",
            "route": "cuda",
            "source": "faiss_tpu_torch/csrc/ivf_recon.cu",
            "replaces": "faiss_tpu/ops/pallas_knn.py:1362",
            "launches": k2_launches,
            "max_abs_err": k2_err,
            "ms": k2_ms,
            "plain_ms": k2_plain,
        },
    ] + [
        {
            "name": f"knn_fused[k_lanes={k_lanes}]",
            "route": "cuda",
            "source": "faiss_tpu_torch/csrc/knn_fused.cu",
            "replaces": "faiss_tpu/ops/pallas_knn.py:261",
            "launches": k3_launches[k_lanes],
            "max_abs_err": k3_err[k_lanes],
            "ms": k3_times[k_lanes][0],
            "plain_ms": k3_times[k_lanes][1],
        }
        for k_lanes in (128, 2048)
    ]


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import faiss_tpu_torch as ft
    from faiss_tpu_torch.ops import fused_knn

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, card: {card}", flush=True)

    t0 = time.time()
    built = fused_knn.build_all()
    print(f"build of {len(built)} kernels {time.time() - t0:.2f} s", flush=True)
    smem = {
        "ivf_recon_dyn": lambda lib: f"{lib.ivf_recon_dyn_smem_bytes(D)}",
        "ivf_recon": lambda lib: f"{lib.ivf_recon_smem_bytes(D)}",
        "knn_fused": lambda lib: ", ".join(
            f"{lib.knn_fused_smem_bytes(D, kl)} (k_lanes {kl})" for kl in (128, 2048)
        ),
    }
    for name, (lib, report) in built.items():
        print(f"{name}: ptxas " + "; ".join(
            line.split(":", 1)[-1].strip()
            for line in report.splitlines() if "registers" in line
        ) + f"; dynamic smem {smem[name](lib)} B/block", flush=True)

    t0 = time.time()
    xb, xt, xq = bench_data()
    with np.load(ROOT / "bench_gt_cache.npz") as z:
        gt = z["gt"]
    print(f"data {time.time() - t0:.2f} s", flush=True)

    dev = torch.device("cuda")
    kernels = [ivfpq_phases(ft, fused_knn, xb, xt, xq, gt, dev)]
    torch.cuda.empty_cache()
    kernels += flat_phases(ft, fused_knn, xb, xq, gt, dev)

    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
