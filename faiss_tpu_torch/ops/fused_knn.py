"""Kernel K1: the dynamic-chunk recon scan with an exact top-128.

Counterpart of faiss_tpu/ops/pallas_knn.py:ivf_recon_fused_dyn_pallas in its
soft mode (no probe penalty, one bf16 store plane). Contract, for every query
row r of a tile of ``qt`` rows:

  keys  [nq, 128] f32  the 128 smallest ``n2[s] - 2 q_r . yT[:, s]`` over all
                       slots s of the chunks ``cmap[r // qt, :]``, ascending
                       (the query norm is not added);
  slots [nq, 128] i32  the packed position ``chunk * ct + col`` of each key,
                       -1 where the key is +inf (pads, the PAD chunk, or
                       fewer than 128 finite keys);
  floor [nq, 128] f32  all +inf: an exact select never evicts (the TPU
                       kernel reports its best evicted key here).

The product is the float32 query against the bf16 store upcast to float32,
accumulated in float32. ``ivf_recon_fused_dyn`` launches the CUDA kernel
(csrc/ivf_recon_dyn.cu) for CUDA tensors and runs ``ivf_recon_fused_dyn_ref``,
the plain PyTorch version of the same contract, for CPU tensors only.

The kernel is compiled with nvcc at first use into ``_build/<source hash>/``
(a plain C interface loaded with ctypes); nothing is built at import."""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

LANES = 128  # top-K width of the kernel contract
QUERIES_PER_BLOCK = 8  # QB in csrc/ivf_recon_dyn.cu: qt must be a multiple

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "ivf_recon_dyn.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    found = str(cand) if cand.exists() else shutil.which("nvcc")
    if not found:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the K1 CUDA kernel builds only "
            "where the CUDA toolkit is installed"
        )
    return found


@functools.lru_cache(maxsize=None)
def build_kernel():
    """Compile csrc/ivf_recon_dyn.cu for sm_90a (once per source hash) and
    load it. Returns (ctypes library, ptxas report text)."""
    src = SOURCE.read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / key
    lib_path = out / "libivf_recon_dyn.so"
    report = out / "ptxas.txt"
    if not lib_path.exists():
        out.mkdir(parents=True, exist_ok=True)
        tmp = out / f"libivf_recon_dyn.{os.getpid()}.so"
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {SOURCE}:\n{proc.stderr}")
        report.write_text(proc.stdout + proc.stderr)
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.ivf_recon_dyn_launch.argtypes = [
        vp, vp, vp, vp, vp, vp, vp, ci, ci, ctypes.c_longlong, ci, ci, ci, vp,
    ]
    lib.ivf_recon_dyn_launch.restype = ci
    lib.ivf_recon_dyn_smem_bytes.argtypes = [ci]
    lib.ivf_recon_dyn_smem_bytes.restype = ctypes.c_longlong
    lib.ivf_recon_dyn_error_string.argtypes = [ci]
    lib.ivf_recon_dyn_error_string.restype = ctypes.c_char_p
    return lib, report.read_text()


def _check(xq, yT, n2, cmap, qt, ct):
    nq, d_pad = xq.shape if xq.dim() == 2 else (None, None)
    if (xq.dtype, yT.dtype, n2.dtype, cmap.dtype) != (
        torch.float32, torch.bfloat16, torch.float32, torch.int32
    ):
        raise ValueError(
            "expected xq float32, yT bfloat16, n2 float32, cmap int32; got "
            f"{xq.dtype}, {yT.dtype}, {n2.dtype}, {cmap.dtype}"
        )
    if xq.dim() != 2 or yT.dim() != 2 or yT.shape[0] != d_pad:
        raise ValueError(f"xq {tuple(xq.shape)} and yT {tuple(yT.shape)} differ in d")
    S = yT.shape[1]
    if tuple(n2.shape) != (1, S):
        raise ValueError(f"n2 must be [1, {S}], got {tuple(n2.shape)}")
    if nq == 0 or qt <= 0 or nq % qt or qt % QUERIES_PER_BLOCK:
        raise ValueError(
            f"nq={nq} must be a positive multiple of qt={qt}, itself a "
            f"multiple of {QUERIES_PER_BLOCK}"
        )
    if cmap.dim() != 2 or cmap.shape[0] != nq // qt or cmap.shape[1] < 1:
        raise ValueError(f"cmap must be [{nq // qt}, msteps], got {tuple(cmap.shape)}")
    if ct <= 0 or ct % 2 or S % ct or S >= 1 << 31 or d_pad % 4:
        raise ValueError(
            f"need ct even, S={S} a multiple of ct={ct} below 2^31 and "
            f"d_pad={d_pad} a multiple of 4"
        )
    if not all(t.is_contiguous() for t in (xq, yT, n2, cmap)):
        raise ValueError("xq, yT, n2 and cmap must be contiguous")
    if len({t.device for t in (xq, yT, n2, cmap)}) != 1:
        raise ValueError("xq, yT, n2 and cmap must be on one device")


def ivf_recon_fused_dyn(xq, yT, n2, cmap, qt: int, ct: int):
    """K1 (see the module docstring). ``xq`` [nq, d_pad] float32 (queries
    sorted by home group, dims zero-padded), ``yT`` [d_pad, S] bfloat16
    transposed decoded store whose last chunk is the all-+inf PAD chunk,
    ``n2`` [1, S] float32 (+inf on pads), ``cmap`` [nq // qt, msteps] int32
    chunk worklist per tile. Returns (keys, slots, floor).

    CPU tensors run the plain version; CUDA tensors launch the kernel on the
    current stream without synchronising; any other device raises."""
    _check(xq, yT, n2, cmap, qt, ct)
    if xq.device.type == "cpu":
        return ivf_recon_fused_dyn_ref(xq, yT, n2, cmap, qt, ct)
    if xq.device.type != "cuda":
        raise ValueError(f"K1 runs on CUDA or CPU tensors, not {xq.device}")
    lib, _ = build_kernel()
    nq, d_pad = xq.shape
    keys = torch.empty(nq, LANES, dtype=torch.float32, device=xq.device)
    slots = torch.empty(nq, LANES, dtype=torch.int32, device=xq.device)
    floor = torch.empty(nq, LANES, dtype=torch.float32, device=xq.device)
    with torch.cuda.device(xq.device):
        stream = torch.cuda.current_stream().cuda_stream
    err = lib.ivf_recon_dyn_launch(
        xq.data_ptr(), yT.data_ptr(), n2.data_ptr(), cmap.data_ptr(),
        keys.data_ptr(), slots.data_ptr(), floor.data_ptr(),
        nq, d_pad, yT.shape[1], cmap.shape[1], qt, ct, stream,
    )
    if err != 0:
        raise RuntimeError(
            "ivf_recon_dyn launch failed: "
            + lib.ivf_recon_dyn_error_string(err).decode()
        )
    ivf_recon_fused_dyn.launches += 1
    return keys, slots, floor


ivf_recon_fused_dyn.launches = 0


def ivf_recon_fused_dyn_ref(xq, yT, n2, cmap, qt: int, ct: int):
    """Plain PyTorch version of K1's contract: per tile, gather the worklist
    chunks, score ``n2 - 2 q @ y.float()`` and take ``torch.topk``."""
    nq = xq.shape[0]
    cols = torch.arange(ct, device=xq.device)
    keys = torch.full((nq, LANES), float("inf"), device=xq.device)
    slots = torch.full((nq, LANES), -1, dtype=torch.int32, device=xq.device)
    for t in range(cmap.shape[0]):
        idx = (cmap[t].long()[:, None] * ct + cols[None, :]).reshape(-1)
        sc = n2[0, idx][None, :] - 2.0 * (xq[t * qt : (t + 1) * qt] @ yT[:, idx].float())
        kk = min(LANES, sc.shape[1])
        v, pos = torch.topk(sc, kk, dim=1, largest=False, sorted=True)
        keys[t * qt : (t + 1) * qt, :kk] = v
        slots[t * qt : (t + 1) * qt, :kk] = torch.where(
            torch.isinf(v), -1, idx[pos]
        ).int()
    return keys, slots, torch.full_like(keys, float("inf"))
