#!/usr/bin/env python3
"""Drive the PyTorch port's IVF4096,PQ32x4fs,RFlat serving path once on one
CUDA card and check it.

    python3 chip_smoke.py        # from the repository root, on a machine with a card

Phases, each of which fails the run (non-zero exit, no result line):
  1. a CUDA card is present; print its name and power limit (nvidia-smi);
  2. build kernel K1 (faiss_tpu_torch/csrc/ivf_recon_dyn.cu) with nvcc and
     print ptxas's register line and the block's dynamic shared memory;
  3. regenerate the 1M x 128 Gaussian mixture of bench.py (seeds 42, 1, 2, 3);
  4. train and add IndexRefineFlat(IndexIVFPQFastScan(d=128, nlist=4096,
     M=32, nbits=4), store_float16=True) on the card, then stage the search
     layout (20 k-means iterations);
  5. search the 8192 queries at nprobe=1, soft probing, k_factor=8,
     pipeline_batch=2048, with K1's launch count set to 0 before and read
     after; recall@10 against bench_gt_cache.npz must reach 0.95, and the
     returned distances must be the exact squared L2 to the fp16 store;
  6. on the first real 2048-query sub-batch with its real worklists, K1 and
     its plain PyTorch version must return the same slots (tie-aware) and
     keys within 1e-4 * (|q|^2 + n2);
  7. time K1 and the plain version with CUDA events (plain, kernel, kernel,
     plain) and the search of all 8192 queries with a host clock.
The last two lines are the kernels' JSON line and the result line
{"ok": true, "device": {...}}; the card's name and power limit come before.
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


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import faiss_tpu_torch as ft
    from faiss_tpu_torch.models.ivf_pq import _k1_inputs
    from faiss_tpu_torch.ops import fused_knn
    from faiss_tpu_torch.utils.evaluation import ids_agree_tie_aware, recall_at_k

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, card: {card}", flush=True)

    t0 = time.time()
    lib, report = fused_knn.build_kernel()
    print(f"K1 build {time.time() - t0:.2f} s; ptxas: " + "; ".join(
        line.split(":", 1)[-1].strip()
        for line in report.splitlines() if "registers" in line
    ) + f"; dynamic smem {lib.ivf_recon_dyn_smem_bytes(128)} B/block", flush=True)

    t0 = time.time()
    xb, xt, xq = bench_data()
    with np.load(ROOT / "bench_gt_cache.npz") as z:
        gt = z["gt"]
    print(f"data {time.time() - t0:.2f} s", flush=True)

    dev = torch.device("cuda")
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

    # the main path, with K1's launch count read around it
    fused_knn.ivf_recon_fused_dyn.launches = 0
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
    kk, ks, rk, rs_ = (a.cpu().numpy() for a in (kk, ks, rk, rs_))
    n2 = br["n2s"][0].cpu().numpy()
    check(((ks == -1) == np.isinf(kk)).all() and ((rs_ == -1) == np.isinf(rk)).all(),
          "slot -1 does not mark exactly the +inf keys")
    check((np.isinf(kk) == np.isinf(rk)).all(), "+inf keys differ")
    check(bool(torch.isinf(kf).all()), "K1's floor is not all +inf")
    fin = np.isfinite(rk)
    qn2 = (xq_p.cpu().numpy() ** 2).sum(1)
    tol = 1e-4 * (qn2[:, None] + np.where(rs_ >= 0, n2[np.maximum(rs_, 0)], 0))
    err = np.abs(np.where(fin, kk - rk, 0.0))
    max_abs_err = float(err.max())
    check((err <= tol).all(), f"K1 keys differ from the plain version by {max_abs_err}")
    row_tol = np.where(fin, tol, 0).max(1)
    agree = ids_agree_tie_aware(rk, rs_, kk, ks, row_tol)
    check(agree.all(), f"K1 slots differ on {int((~agree).sum())} rows")
    print(f"K1 vs plain on sub-batch 0 [{BATCH} q, {cmap.shape[1]} steps, "
          f"ndropped {int(ndropped)}]: max_abs_err {max_abs_err:.3e}, "
          f"slots agree on all rows", flush=True)

    # times at the main-path shape: plain, kernel, kernel, plain
    reps = 20
    plain = lambda: fused_knn.ivf_recon_fused_dyn_ref(*args)  # noqa: E731
    kern = lambda: fused_knn.ivf_recon_fused_dyn(*args)  # noqa: E731
    t_p1, t_k1, t_k2, t_p2 = (cuda_ms(f, reps) for f in (plain, kern, kern, plain))
    ms, plain_ms = (t_k1 + t_k2) / 2, (t_p1 + t_p2) / 2
    print(f"K1 {t_k1:.3f} / {t_k2:.3f} ms, plain {t_p1:.3f} / {t_p2:.3f} ms "
          f"per {BATCH}-query sub-batch", flush=True)
    times = []
    for _ in range(5):
        t0 = time.time()
        index.search(xq, K)
        torch.cuda.synchronize()
        times.append(time.time() - t0)
    t_search = float(np.median(times))
    print(f"search of {NQ} queries: median {t_search * 1e3:.1f} ms over 5 "
          f"({', '.join(f'{t * 1e3:.1f}' for t in times)}) -> "
          f"{NQ / t_search:.0f} QPS; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)

    print(json.dumps({"kernels": [{
        "name": "ivf_recon_fused_dyn",
        "route": "cuda",
        "source": "faiss_tpu_torch/csrc/ivf_recon_dyn.cu",
        "replaces": "faiss_tpu/ops/pallas_knn.py:1249",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": ms,
        "plain_ms": plain_ms,
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
