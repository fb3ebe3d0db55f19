"""The port's scan kernels K1 to K7, each with its plain PyTorch version.

K1 ``ivf_recon_fused_dyn`` (csrc/ivf_recon_dyn.cu): the dynamic-chunk recon
scan, counterpart of faiss_tpu/ops/pallas_knn.py:ivf_recon_fused_dyn_pallas
over one bf16 store plane ``yT`` (IVF-PQ's decoded store) or two, ``yT`` and
its lo residual ``yT_lo`` (IVF-Flat's vectors). For every query row r of a
tile of ``qt`` rows, with y = yT (+ yT_lo) summed in float32:

  keys  [nq, 128] f32  the 128 smallest ``n2[s] - 2 q_r . y[:, s]`` over all
                       slots s of the chunks ``cmap[r // qt, :]``, ascending
                       (the query norm is not added);
  slots [nq, 128] i32  the packed position ``chunk * ct + col`` of each key,
                       -1 where the key is +inf (pads, the PAD chunk, or
                       fewer than 128 finite keys);
  floor [nq, 128] f32  all +inf: an exact select never evicts (the TPU
                       kernel reports its best evicted key here).

Without ``biasg`` it is the soft mode; with ``biasg`` [nq, G*128], ``lid``
[1, S] and ``cgroup`` [S // ct] the penalized (strict) mode adds
``biasg[r, cgroup[chunk(s)] * 128 + lid[s]]`` (0 on probed lists, 1e9
elsewhere) to every key. The TPU kernel rounds that penalty to bf16 first;
here it is added in float32 as given, which moves only the ~1e9 keys.

K2 ``ivf_recon_fused`` (csrc/ivf_recon.cu): the exhaustive recon scan,
counterpart of ivf_recon_fused_pallas. The same triple over every column of
``yT`` (one bf16 plane) or of ``yT + yT_lo`` (the hi/lo planes of the exact
flat screen); slots are columns of the given store, which may be a column
slice (a stripe) of a wider one. Its masked mode takes the whole store
only (one plane or both) and adds
``biasg[r, min(chunk(s) // cpg, G - 1) * 128 + lid[s]]``, with
``cpg = max(1, nchunks // G)``: the group of a chunk is static, and the
trailing PAD chunk clamps to the last group.

K3 ``knn_fused`` (csrc/knn_fused.cu): exact float32 brute-force k-NN,
counterpart of knn_fused_pallas. Top-``k_lanes`` values best-first WITH the
query norm (L2: ``max(||q||^2 + ||y||^2 - 2 q.y, 0)``; IP: ``q.y``, largest
first), int32 ids (-1 with +inf / -inf where none) and the floor [nq, 128]
(+inf for L2, -inf for IP). An exact top-2048 is 16 KB a query, too much
to keep in shared memory for the 64 queries a block needs on the tensor
cores, so K3 keeps no per-query state there and runs its products twice
(csrc/knn_mma.cuh: 3xTF32 on mma.sync, the float32 store by TMA, 64
queries a block, the columns split across blocks): pass 1 writes each
query's smallest key of every bucket of KNN_BUCKET consecutive columns; a
radix select (csrc/radix_select.cuh) takes the k_lanes-th smallest bucket
minimum as a threshold theta; pass 2 appends every key below theta (at most
``knn_lt_cap(k_lanes)`` pairs, since fewer than k_lanes buckets hold one)
and up to k_lanes keys equal to it to a candidate buffer in device memory;
a final select sorts the best k_lanes. The wrapper allocates that scratch
and runs query sub-batches that keep it within KNN_SCRATCH_CAP.

K4 ``ivfpq_fused`` and K5 ``ivfpq_fused_dyn`` (csrc/ivfpq_adc.cu): the
code-streaming IVF-PQ ADC scans, counterparts of ivfpq_fused_pallas and
ivfpq_fused_dyn_pallas. The triple of K1 and K2 for the key

  n2[s] + biasg[r, group * 128 + lid[s]] + sum_m luts[r, m * ksub + code[m, s]]

over every chunk (K4, group ``min(chunk // cpg, G - 1)`` as in K2's masked
mode) or over the tile's worklist ``cmap[r // qt, :]`` (K5, group
``cgroup[chunk]``). ``luts`` are bf16 (the flattened ``-2 q . codeword``
tables), ``codesT`` [M, S] uint8 holds one code per byte, and ``biasg`` is
the coarse term ``-2 q . c`` per grouped list column, 1e9 on unprobed lists.
K4 runs on the tensor cores (csrc/adc_mma.cuh): the LUT sum is the TPU
kernel's contraction of the bf16 LUTs with a one-hot of the codes, one bf16
k-step of 16 entries per sub-quantizer into float32, for 64 queries a
block, with the columns split across blocks as K2 does; then n2 and the
bias are added in float32, ``(sum + n2) + bias``. K5 runs the same
tensor-core scan in the same order over each tile's worklist, its blocks
mapped as K1's (the worklist steps split across blocks, each tile cut after
its last non-PAD step, the splits merged). Both take ksub <= 16 and an
M * 16 LUT row that fits the kernel's shared memory; the wrappers send
other shapes to the shared-memory lookup scan (csrc/adc_scan.cuh), chosen
by shape before the launch.

K6 ``ivfpq_fused_v3`` (csrc/ivfpq_v3.cu): counterpart of
ivfpq_fused_pallas_v3, K4's keys over every chunk from a precomputed one-hot
``ohT`` [M * ksub + 128, S] (ops/quantize_lut.expand_onehot: the PQ rows
``m * ksub + code``, then the 128 local-list rows) instead of the codes, with
bf16 LUTs or int8 LUTs and their per-query ``meta`` (a, c) (quantize_luts_int8):

  bf16:  luts . oh_pq + (biasg_g . oh_list + n2)
  int8:  (a * (q8 . oh_pq) + c) + (biasg_g . oh_list + n2)

with ``biasg_g`` the 128 bias columns of the chunk's group ``chunk // cpg``
(the chunks split evenly into the G groups) and (a, c) read at the slot's
lane ``s % 128``. A column that is not a one-hot is refused. A first pass
decodes the one-hot into codes and list ids (checking every column); then
the products run on the tensor cores as K4's do (csrc/adc_mma.cuh), in K6's
order of additions: bf16 LUTs one bf16 k-step per sub-quantizer into
float32, int8 LUTs one int8 k-step (mma m16n8k32) per pair of
sub-quantizers into exact int32 sums; a row whose 128 (a, c) lanes agree is
gated by its LUT floor, any other reads (a, c) per key. The wrapper sends
shapes the tensor cores do not take (ksub > 16; M > 37 bf16, M > 61 int8)
to the lookup scan, chosen by shape before the launch.

K7 ``recon_floor`` (csrc/recon_floor.cu): counterpart of the score-only
kernel of benchs/archive/exp_r3c.py:floor_call, K2's score producer with no
select: out [nq, 128] f32, per lane l the minimum of ``n2[s] - 2 q . y[:, s]``
over the columns s with ``s % 128 == l``. It runs K2's one-plane products
(csrc/recon_mma.cuh) with per-lane running minima in shared memory in
place of the select (each (row, lane) held by one thread), two blocks an
SM, the columns split across blocks in whole 128-column lane groups and
the splits' minima merged by a second pass.

K1, K2 and K7 take the TPU kernels' products on the tensor cores
(csrc/recon_mma.cuh): the float32 query split into bf16 hi + lo, then
qh.yh + ql.yh + qh.yl with the lo plane and qh.y + ql.y without, summed in
float32 (the dropped ql.yl term is below 2^-16 |q| |y|). They serve 64
queries a block, split the columns (K2, K7) or each worklist (K1) across
blocks so that a launch fills the card, and merge the splits' results in a
second pass of the same source; K1 stops each tile at its last non-PAD
step. K4's, K5's and K6's tensor-core instances do the same for their
columns or worklists. The plain
versions use float32 matrix products with TF32 off (of hi + lo summed in
float32 for K1/K2; the ADC sum as a product with a one-hot of the codes,
exact but summed in another order) and chunk over columns, so none builds a
full [nq, S] score matrix. A wrapper launches its kernel for CUDA tensors
and runs its plain version for CPU tensors only; any other device raises.
Each kernel is compiled with nvcc at first use into ``_build/<source
hash>/`` (a plain C interface loaded with ctypes); nothing is built at
import."""

from __future__ import annotations

import concurrent.futures
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from .topk import merge_topk

LANES = 128  # top-K width of the K1/K2 contract; floor width of K3
QUERIES_PER_BLOCK = 8  # QB of the lookup scan: every kernel's qt must be a multiple
RECON_BLOCK = 64  # queries per block of K1 and K2 (recon_mma.cuh BM)
RECON_TILE = 64  # columns per tile of K1 and K2 (recon_mma.cuh BN)
RECON_QSEG = 128  # K1/K2/K7 take d_pad in multiples of this (recon_mma.cuh QSEG)
RECON_FLOOR_BLOCKS_PER_SM = 2  # K7's blocks an SM holds (recon_floor.cu BLOCKS_PER_SM)
MAX_K_LANES = 2048  # K3's widest select (faiss's BlockSelect range)
REF_CHUNK = 1 << 16  # columns per score tile of the plain versions
MAX_LUT_ROW = 2048  # the lookup scan holds M * ksub float32 LUT entries per query
ADC_TC_BLOCK = 64  # queries per block of K4-K6 on the tensor cores (adc_mma.cuh BM)
ADC_TC_TILE = 128  # its columns per tile (adc_mma.cuh BN)
KNN_BLOCK = 64  # queries per block of K3's product passes (knn_mma.cuh BM)
KNN_TILE = 256  # their columns per tile (knn_mma.cuh BN)
KNN_BUCKET = 32  # columns per bucket of K3's threshold (knn_mma.cuh W)
KNN_SCRATCH_CAP = 2 << 30  # bytes of K3's per-row scratch per launch
# K3's kernels, in launch order (knn_fused.cu PHASE_*): the store's norms,
# pass 1 (bucket minima), the threshold select, pass 2 (appends), the final
# select
KNN_PHASE_N2, KNN_PHASE_MIN, KNN_PHASE_THETA, KNN_PHASE_APPEND, KNN_PHASE_FINAL = (
    1, 2, 4, 8, 16)
KNN_ALL_PHASES = 31

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_vp, _ci, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# kernel name -> (launch argtypes, smem_bytes argtypes); each library exports
# <name>_launch, <name>_smem_bytes and <name>_error_string
KERNELS = {
    "ivf_recon_dyn": (
        [_vp] * 14 + [_ci, _ci, _ll] + [_ci] * 6 + [_vp], [_ci],
    ),
    "ivf_recon": (
        [_vp, _vp, _vp, _ll] + [_vp] * 8 + [_ci, _ci, _ll, _ci, _ci, _ci, _ci, _vp],
        [_ci],
    ),
    "knn_fused": (
        [_vp, _vp, _ll, _ll, _ci, _vp, _vp, _vp] + [_ci] * 5
        + [_vp, _vp, _ll, _vp, _vp, _vp, _ci, _ci, _vp],
        [_ci, _ci],
    ),
    "ivfpq_adc": (
        [_vp] * 13 + [_ci, _ci, _ci, _ci, _ll] + [_ci] * 5 + [_vp], [_ci] * 3,
    ),
    "ivfpq_v3": (
        [_vp] * 13 + [_ci, _ci, _ci, _ci, _ll] + [_ci] * 5 + [_vp], [_ci] * 4,
    ),
    "recon_floor": ([_vp] * 5 + [_ci, _ci, _ll, _ci, _ci, _ci, _vp], [_ci]),
}


def _nvcc() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    found = str(cand) if cand.exists() else shutil.which("nvcc")
    if not found:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the CUDA kernels build only "
            "where the CUDA toolkit is installed"
        )
    return found


@functools.lru_cache(maxsize=None)
def build_kernel(name: str):
    """Compile csrc/<name>.cu for sm_90a (once per hash of the source, the
    shared headers and the flags) and load it. Returns (ctypes library,
    ptxas report text)."""
    source = CSRC / f"{name}.cu"
    digest = hashlib.sha256(source.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    out = BUILD_DIR / digest.hexdigest()[:16]
    lib_path = out / f"lib{name}.so"
    report = out / "ptxas.txt"
    if not lib_path.exists():
        out.mkdir(parents=True, exist_ok=True)
        tmp = out / f"lib{name}.{os.getpid()}.so"
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(source)],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source}:\n{proc.stderr}")
        report.write_text(proc.stdout + proc.stderr)
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    launch_args, smem_args = KERNELS[name]
    getattr(lib, f"{name}_launch").argtypes = launch_args
    getattr(lib, f"{name}_launch").restype = _ci
    getattr(lib, f"{name}_smem_bytes").argtypes = smem_args
    getattr(lib, f"{name}_smem_bytes").restype = _ll
    getattr(lib, f"{name}_error_string").argtypes = [_ci]
    getattr(lib, f"{name}_error_string").restype = ctypes.c_char_p
    return lib, report.read_text()


def build_all():
    """Build every kernel, one nvcc process per source, all started
    together. Returns {name: (library, ptxas report)}."""
    with concurrent.futures.ThreadPoolExecutor(len(KERNELS)) as pool:
        return dict(zip(KERNELS, pool.map(build_kernel, KERNELS)))


def _launch(name, *args):
    lib, _ = build_kernel(name)
    err = getattr(lib, f"{name}_launch")(*args)
    if err != 0:
        raise RuntimeError(
            f"{name} launch failed: "
            + getattr(lib, f"{name}_error_string")(err).decode()
        )


def _stream(device):
    with torch.cuda.device(device):
        return torch.cuda.current_stream().cuda_stream


def _route(name, tensors):
    """True to launch the kernel (CUDA tensors), False to run the plain
    version (CPU tensors); raises for any other device."""
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"{name}: all tensors must be on one device")
    dev = tensors[0].device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on CUDA or CPU tensors, not {dev}")
    return dev.type == "cuda"


def _check_tiles(nq, qt):
    if nq == 0 or qt <= 0 or nq % qt or qt % QUERIES_PER_BLOCK:
        raise ValueError(
            f"nq={nq} must be a positive multiple of qt={qt}, itself a "
            f"multiple of {QUERIES_PER_BLOCK}"
        )


def _check_columns(S, ct, d_pad):
    """The recon kernels' store: S columns in whole tiles of an even ct,
    slots fit int32, dims in groups of 4."""
    if ct <= 0 or ct % 2 or S % ct or S >= 1 << 31 or d_pad % 4:
        raise ValueError(
            f"need ct even, S={S} a multiple of ct={ct} below 2^31 and "
            f"d_pad={d_pad} a multiple of 4"
        )


def _check_aligned(what, t, nbytes):
    """The kernels load two adjacent columns as one vector (bf16x2, float2,
    int2 or two code bytes), so a store, code, norm or list-id row must
    start on an even column."""
    if t.data_ptr() % nbytes:
        raise ValueError(f"{what} must start on a {nbytes}-byte boundary")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _check_mma_operands(what, xq, planes, n2, d_pad, ct=None):
    """What the tensor-core recon kernels (K1, K2, K7) need of their operands
    beyond the contract: TMA reads the store planes and n2 and the prologue
    reads the queries 16 bytes at a time, so the base addresses 16-byte
    aligned and the planes' row stride a multiple of 8 columns; d_pad a
    multiple of 128 (the queries' resident block of dims); and with ``ct``,
    chunks of whole 64-column tiles (K1, K2's masked mode). Raises
    ValueError."""
    for name, t in (("xq", xq), ("n2", n2)) + tuple(
        (f"store plane {i}", p) for i, p in enumerate(planes)
    ):
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must start on a 16-byte boundary")
    ld = planes[0].stride(0)
    if ld % 8:
        raise ValueError(
            f"{what}: the store's row stride {ld} must be a multiple of 8 "
            "columns (16 bytes)"
        )
    if d_pad % RECON_QSEG:
        raise ValueError(f"{what}: d_pad={d_pad} must be a multiple of {RECON_QSEG}")
    if ct is not None and ct % RECON_TILE:
        raise ValueError(f"{what}: ct={ct} must be a multiple of {RECON_TILE}")


@functools.lru_cache(maxsize=None)
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def _split_count(blocks, units, sms):
    """Splits of the columns (K2, K4, K6, K7) or of each worklist (K1, K5)
    so that a launch of ``blocks`` blocks of 64 queries gives every one of
    ``sms`` block slots a block (one fits per SM; K7 passes two slots an
    SM), without splitting ``units`` (64-column tiles of K2's store,
    128-column tiles of K4's and K6's codes and lane groups of K7's store,
    steps of K1's and K5's worklists) finer than one each."""
    if blocks <= 0 or units <= 0 or sms <= 0:
        raise ValueError(f"blocks={blocks}, units={units}, sms={sms} must be positive")
    return max(1, min(sms // blocks, units))


def _split_scratch(splits, nq, device):
    """The per-split top-128s of a split launch, [splits, nq, 128] keys
    and slots, merged by the kernel's second pass; (None, None) for one
    split."""
    if splits < 1:
        raise ValueError(f"splits={splits} must be at least 1")
    if splits == 1:
        return None, None
    return (
        torch.empty(splits, nq, LANES, dtype=torch.float32, device=device),
        torch.empty(splits, nq, LANES, dtype=torch.int32, device=device),
    )


def _check_bias(biasg, lid, nq, S):
    """The per-(query, grouped list column) term of the masked, penalized
    and ADC scans: ``biasg`` [nq, G * 128] float32 and ``lid`` [1, S] int32,
    both contiguous. Returns G."""
    if biasg.dtype != torch.float32 or lid.dtype != torch.int32:
        raise ValueError(
            f"expected biasg float32 and lid int32, got {biasg.dtype}, {lid.dtype}"
        )
    if biasg.dim() != 2 or biasg.shape[0] != nq or biasg.shape[1] % LANES or (
        biasg.shape[1] == 0
    ):
        raise ValueError(
            f"biasg must be [{nq}, G * {LANES}], got {tuple(biasg.shape)}"
        )
    if tuple(lid.shape) != (1, S):
        raise ValueError(f"lid must be [1, {S}], got {tuple(lid.shape)}")
    if not (biasg.is_contiguous() and lid.is_contiguous()):
        raise ValueError("biasg and lid must be contiguous")
    _check_aligned("lid", lid, 8)
    return biasg.shape[1] // LANES


def _static_cpg(nchunks, G):
    """Chunks per group of the static chunk -> group map (every group spans
    cpg chunks, plus at most one trailing PAD chunk)."""
    cpg = max(1, nchunks // G)
    if nchunks - cpg * G not in (0, 1):
        raise ValueError(
            f"{nchunks} chunks do not split into {G} groups (+1 PAD chunk)"
        )
    return cpg


def _check_cgroup(cgroup, nchunks):
    if cgroup.dtype != torch.int32 or tuple(cgroup.shape) != (nchunks,) or (
        not cgroup.is_contiguous()
    ):
        raise ValueError(
            f"cgroup must be a contiguous int32 [{nchunks}], got "
            f"{cgroup.dtype} {tuple(cgroup.shape)}"
        )


def _bias_terms(biasg, rows, groups, lid_cols):
    """biasg[r, groups * 128 + lid] for the rows ``rows`` (a slice) and the
    columns whose groups and list ids are given: [len(rows), C]."""
    return biasg[rows][:, groups.long() * LANES + lid_cols.long()]


# -- K1 ----------------------------------------------------------------------


def _check_dyn(xq, yT, n2, cmap, qt, ct, yT_lo):
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
    if yT_lo is not None and (
        yT_lo.dtype != torch.bfloat16 or yT_lo.shape != yT.shape
        or yT_lo.stride() != yT.stride()
    ):
        raise ValueError(
            f"yT_lo must be a bfloat16 plane of yT's shape {tuple(yT.shape)} and "
            f"strides, got {yT_lo.dtype} {tuple(yT_lo.shape)} {yT_lo.stride()}"
        )
    S = yT.shape[1]
    if tuple(n2.shape) != (1, S):
        raise ValueError(f"n2 must be [1, {S}], got {tuple(n2.shape)}")
    _check_tiles(nq, qt)
    if cmap.dim() != 2 or cmap.shape[0] != nq // qt or cmap.shape[1] < 1:
        raise ValueError(f"cmap must be [{nq // qt}, msteps], got {tuple(cmap.shape)}")
    _check_columns(S, ct, d_pad)
    if not all(t.is_contiguous() for t in (xq, yT, n2, cmap)):
        raise ValueError("xq, yT, n2 and cmap must be contiguous")
    _check_aligned("yT", yT, 4)
    if yT_lo is not None:
        _check_aligned("yT_lo", yT_lo, 4)
    _check_aligned("n2", n2, 8)


def _check_penalty(biasg, lid, cgroup, nq, S, ct):
    """K1's penalized mode takes biasg, lid and cgroup together. Returns
    the tensors of the mode (empty in soft mode)."""
    given = [t is not None for t in (biasg, lid, cgroup)]
    if not any(given):
        return ()
    if not all(given):
        raise ValueError("the penalized mode takes biasg, lid and cgroup together")
    _check_bias(biasg, lid, nq, S)
    _check_cgroup(cgroup, S // ct)
    return biasg, lid, cgroup


def ivf_recon_fused_dyn(xq, yT, n2, cmap, qt: int, ct: int, biasg=None,
                        lid=None, cgroup=None, yT_lo=None):
    """K1 (see the module docstring). ``xq`` [nq, d_pad] float32 (queries
    sorted by home group, dims zero-padded), ``yT`` [d_pad, S] bfloat16
    transposed store whose last chunk is the all-+inf PAD chunk, optionally
    ``yT_lo`` its lo residual plane (same shape, contiguous), ``n2`` [1, S]
    float32 (+inf on pads), ``cmap`` [nq // qt, msteps] int32 chunk worklist
    per tile; for the penalized mode ``biasg`` [nq, G * 128] float32 {0,
    1e9}, ``lid`` [1, S] int32 and ``cgroup`` [S // ct] int32. Returns
    (keys, slots, floor).

    The last chunk of the store (``S // ct - 1``) is the PAD chunk: its n2
    is all +inf, and each worklist lists its tile's chunks first and fills
    the steps after them with it. The kernel stops each tile at its last
    step that is not the PAD chunk (exact: a +inf key is never selected) and
    counts the steps it skipped (:func:`pad_steps_skipped`); the plain
    version scans every step.

    CPU tensors run the plain version; CUDA tensors launch the kernel on the
    current stream without synchronising; any other device raises."""
    _check_dyn(xq, yT, n2, cmap, qt, ct, yT_lo)
    pen = _check_penalty(biasg, lid, cgroup, xq.shape[0], yT.shape[1], ct)
    lo = () if yT_lo is None else (yT_lo,)
    if not _route("K1", (xq, yT, n2, cmap) + lo + pen):
        return ivf_recon_fused_dyn_ref(xq, yT, n2, cmap, qt, ct, biasg, lid,
                                       cgroup, yT_lo)
    nq, d_pad = xq.shape
    S, msteps = yT.shape[1], cmap.shape[1]
    _check_mma_operands("K1", xq, (yT,) + lo, n2, d_pad, ct)
    blocks = nq // qt * -(-qt // RECON_BLOCK)
    splits = _split_count(blocks, msteps, _sm_count(xq.device.index or 0))
    part_key, part_slot = _split_scratch(splits, nq, xq.device)
    keys, slots, floor = _lane_outputs(nq, xq.device)
    _launch(
        "ivf_recon_dyn", xq.data_ptr(), yT.data_ptr(), _ptr(yT_lo),
        n2.data_ptr(), cmap.data_ptr(), _ptr(biasg), _ptr(lid), _ptr(cgroup),
        keys.data_ptr(), slots.data_ptr(), floor.data_ptr(), _ptr(part_key),
        _ptr(part_slot), _pad_counter(xq.device).data_ptr(), nq, d_pad, S,
        msteps, qt, ct, 0 if biasg is None else biasg.shape[1],
        _pad_chunk(S, ct), splits, _stream(xq.device),
    )
    ivf_recon_fused_dyn.launches += 1
    ivf_recon_fused_dyn.penalized_launches += bool(pen)
    ivf_recon_fused_dyn.hilo_launches += bool(lo)
    ivf_recon_fused_dyn.splits = splits
    return keys, slots, floor


ivf_recon_fused_dyn.launches = 0
ivf_recon_fused_dyn.penalized_launches = 0
ivf_recon_fused_dyn.hilo_launches = 0
ivf_recon_fused_dyn.splits = 0  # worklist splits of the last launch

_PAD_COUNTERS = {}  # (kernel, device) -> int64 [1], skipped PAD steps


def _pad_chunk(S, ct):
    """The PAD chunk of K1's store: its last chunk."""
    if ct <= 0 or S % ct or S // ct < 1:
        raise ValueError(f"S={S} must hold whole chunks of ct={ct}")
    return S // ct - 1


def _pad_counter(device, kernel="K1"):
    key = (kernel, device)
    if key not in _PAD_COUNTERS:
        _PAD_COUNTERS[key] = torch.zeros(1, dtype=torch.int64, device=device)
    return _PAD_COUNTERS[key]


def pad_steps_skipped(reset=False, kernel="K1"):
    """PAD steps the launches of ``kernel`` ("K1", or "K5" on the tensor
    cores) skipped (summed over tiles) since its last reset; reads the
    device counters (a synchronising read)."""
    mine = [c for (k, _), c in _PAD_COUNTERS.items() if k == kernel]
    n = sum(int(c.item()) for c in mine)
    if reset:
        for c in mine:
            c.zero_()
    return n


def _lane_outputs(nq, device):
    return (
        torch.empty(nq, LANES, dtype=torch.float32, device=device),
        torch.empty(nq, LANES, dtype=torch.int32, device=device),
        torch.empty(nq, LANES, dtype=torch.float32, device=device),
    )


def _tile_topk(score_tile, cmap, qt, ct, nq, device):
    """Plain versions of the worklist scans (K1, K5): per tile, the columns
    of its worklist chunks, ``score_tile(rows, chunks, idx)`` [qt, C] and
    ``torch.topk``."""
    cols = torch.arange(ct, device=device)
    keys = torch.full((nq, LANES), float("inf"), device=device)
    slots = torch.full((nq, LANES), -1, dtype=torch.int32, device=device)
    for t in range(cmap.shape[0]):
        chunks = cmap[t].long()
        idx = (chunks[:, None] * ct + cols[None, :]).reshape(-1)
        rows = slice(t * qt, (t + 1) * qt)
        sc = score_tile(rows, chunks.repeat_interleave(ct), idx)
        kk = min(LANES, sc.shape[1])
        v, pos = torch.topk(sc, kk, dim=1, largest=False, sorted=True)
        keys[rows, :kk] = v
        slots[rows, :kk] = torch.where(torch.isinf(v), -1, idx[pos]).int()
    return keys, slots, torch.full_like(keys, float("inf"))


def ivf_recon_fused_dyn_ref(xq, yT, n2, cmap, qt: int, ct: int, biasg=None,
                            lid=None, cgroup=None, yT_lo=None):
    """Plain PyTorch version of K1's contract: per tile, gather the worklist
    chunks, score ``n2 - 2 q @ (hi + lo).float()`` (plus the penalty of the
    penalized mode) and take ``torch.topk``."""

    def score(rows, chunks, idx):
        y = yT[:, idx].float()
        if yT_lo is not None:
            y = y + yT_lo[:, idx].float()
        sc = n2[0, idx][None, :] - 2.0 * (xq[rows] @ y)
        if biasg is not None:
            sc = sc + _bias_terms(biasg, rows, cgroup[chunks], lid[0, idx])
        return sc

    return _tile_topk(score, cmap, qt, ct, xq.shape[0], xq.device)


# -- K2 ----------------------------------------------------------------------


def _check_recon(xq, yT, n2, yT_lo, qt, ct):
    planes = (yT,) if yT_lo is None else (yT, yT_lo)
    if xq.dtype != torch.float32 or n2.dtype != torch.float32 or any(
        p.dtype != torch.bfloat16 for p in planes
    ):
        raise ValueError(
            "expected xq float32, yT (and yT_lo) bfloat16, n2 float32; got "
            f"{xq.dtype}, {[p.dtype for p in planes]}, {n2.dtype}"
        )
    if xq.dim() != 2 or any(p.dim() != 2 for p in planes):
        raise ValueError("xq and the store planes must be 2-D")
    nq, d_pad = xq.shape
    S = yT.shape[1]
    if any(tuple(p.shape) != (d_pad, S) for p in planes):
        raise ValueError(
            f"store planes must be [{d_pad}, S]: {[tuple(p.shape) for p in planes]}"
        )
    if tuple(n2.shape) != (1, S):
        raise ValueError(f"n2 must be [1, {S}], got {tuple(n2.shape)}")
    _check_tiles(nq, qt)
    _check_columns(S, ct, d_pad)
    if not xq.is_contiguous():
        raise ValueError("xq must be contiguous")
    # the planes may be column slices of wider stores: unit column stride,
    # one even row stride for both, n2 a unit-stride row
    ld = yT.stride(0)
    if (
        any(p.stride(1) != 1 or p.stride(0) != ld for p in planes)
        or ld % 2 or ld < S or n2.stride(1) != 1
    ):
        raise ValueError(
            "yT (and yT_lo) need unit column stride and one even row stride "
            "of at least S; n2 unit stride"
        )
    for p in planes:
        _check_aligned("yT (and yT_lo)", p, 4)
    _check_aligned("n2", n2, 8)
    return ld


def _check_mask(biasg, lid, yT, nq, S, ct):
    """K2's masked mode: biasg and lid together, over a whole store (one
    plane or hi/lo, not a column slice: ``_check_recon`` gives both planes
    one row stride). Returns the tensors of the mode."""
    if biasg is None and lid is None:
        return ()
    if biasg is None or lid is None:
        raise ValueError("the masked mode takes biasg and lid together")
    if yT.stride(0) != S:
        raise ValueError(
            "the masked mode takes the whole store, not a column slice"
        )
    _static_cpg(S // ct, _check_bias(biasg, lid, nq, S))
    return biasg, lid


def ivf_recon_fused(xq, yT, n2, yT_lo=None, *, qt: int = 512, ct: int = 1024,
                    biasg=None, lid=None):
    """K2 (see the module docstring). ``xq`` [nq, d_pad] float32 (dims
    zero-padded), ``yT`` [d_pad, S] bfloat16 transposed store and optionally
    ``yT_lo`` its lo residual plane (same shape and row stride; both may be
    column slices of a wider store), ``n2`` [1, S] float32 (+inf on pads);
    for the masked mode ``biasg`` [nq, G * 128] float32 {0, 1e9} and ``lid``
    [1, S] int32 over a whole store. Returns (keys, slots, floor),
    slots being columns of the given store.

    CPU tensors run the plain version; CUDA tensors launch the kernel on the
    current stream without synchronising; any other device raises."""
    ld = _check_recon(xq, yT, n2, yT_lo, qt, ct)
    mask = _check_mask(biasg, lid, yT, xq.shape[0], yT.shape[1], ct)
    lo = () if yT_lo is None else (yT_lo,)
    if not _route("K2", (xq, yT, n2) + lo + mask):
        return ivf_recon_fused_ref(xq, yT, n2, yT_lo, qt=qt, ct=ct,
                                   biasg=biasg, lid=lid)
    nq, d_pad = xq.shape
    S = yT.shape[1]
    _check_mma_operands("K2", xq, (yT,) + lo, n2, d_pad, ct if mask else None)
    splits = _split_count(-(-nq // RECON_BLOCK), -(-S // RECON_TILE),
                          _sm_count(xq.device.index or 0))
    part_key, part_slot = _split_scratch(splits, nq, xq.device)
    keys, slots, floor = _lane_outputs(nq, xq.device)
    _launch(
        "ivf_recon", xq.data_ptr(), yT.data_ptr(), _ptr(yT_lo), ld,
        n2.data_ptr(), _ptr(biasg), _ptr(lid), keys.data_ptr(),
        slots.data_ptr(), floor.data_ptr(), _ptr(part_key), _ptr(part_slot),
        nq, d_pad, S, qt, ct, 0 if biasg is None else biasg.shape[1], splits,
        _stream(xq.device),
    )
    ivf_recon_fused.launches += 1
    ivf_recon_fused.masked_launches += bool(mask)
    ivf_recon_fused.hilo_launches += yT_lo is not None
    ivf_recon_fused.splits = splits
    return keys, slots, floor


ivf_recon_fused.launches = 0
ivf_recon_fused.masked_launches = 0
ivf_recon_fused.hilo_launches = 0
ivf_recon_fused.splits = 0  # column splits of the last launch


def ivf_recon_fused_ref(xq, yT, n2, yT_lo=None, *, qt: int = 512, ct: int = 1024,
                        biasg=None, lid=None):
    """Plain PyTorch version of K2's contract: per column chunk, score
    ``n2 - 2 q @ (hi + lo).float()`` (plus the mask of the masked mode),
    take ``torch.topk`` and merge."""
    del qt  # a tile of the TPU kernel; the result does not depend on it
    S = yT.shape[1]

    def score(c0, c1):
        y = yT[:, c0:c1].float()
        if yT_lo is not None:
            y = y + yT_lo[:, c0:c1].float()
        sc = n2[:, c0:c1] - 2.0 * (xq @ y)
        if biasg is not None:
            groups = _static_groups(c0, c1, S, ct, biasg)
            sc = sc + _bias_terms(biasg, slice(None), groups, lid[0, c0:c1])
        return sc

    return _chunked_topk(score, xq.shape[0], S, xq.device)


def _static_groups(c0, c1, S, ct, biasg):
    """Group of columns c0..c1 of a store of S columns in chunks of ct
    under the static map of K2's masked mode and K4:
    ``min(chunk // cpg, G - 1)``, G the bias column groups."""
    G = biasg.shape[1] // LANES
    cpg = max(1, (S // ct) // G)
    cols = torch.arange(c0, c1, device=biasg.device)
    return (cols // ct // cpg).clamp_max(G - 1)


def _chunked_topk(score, nq, S, device):
    """Plain versions of the exhaustive scans (K2, K4): ``score(c0, c1)``
    [nq, c1 - c0] per chunk of REF_CHUNK columns, ``torch.topk`` and merge;
    slots -1 where the key is +inf."""
    keys = torch.full((nq, LANES), float("inf"), device=device)
    slots = torch.full((nq, LANES), -1, dtype=torch.int64, device=device)
    for c0 in range(0, S, REF_CHUNK):
        sc = score(c0, min(c0 + REF_CHUNK, S))
        v, pos = torch.topk(sc, min(LANES, sc.shape[1]), dim=1, largest=False)
        keys, slots = merge_topk(keys, slots, v, pos + c0, LANES, largest=False)
    slots = torch.where(torch.isinf(keys), -1, slots)
    return keys, slots.int(), torch.full_like(keys, float("inf"))


# -- K3 ----------------------------------------------------------------------


def _check_knn(x, yT, nb, qt, ct, k_lanes):
    if x.dtype != torch.float32 or yT.dtype != torch.float32:
        raise ValueError(f"expected x and yT float32, got {x.dtype}, {yT.dtype}")
    if x.dim() != 2 or yT.dim() != 2 or yT.shape[0] != x.shape[1]:
        raise ValueError(f"x {tuple(x.shape)} and yT {tuple(yT.shape)} differ in d")
    nbp = yT.shape[1]
    _check_tiles(x.shape[0], qt)
    if ct <= 0 or nbp % ct or nbp % 2 or nbp >= 1 << 31 or not 0 <= nb <= nbp:
        raise ValueError(
            f"need the store width {nbp} even, a multiple of ct={ct} and below "
            f"2^31, and 0 <= nb={nb} <= it"
        )
    if k_lanes % LANES or not LANES <= k_lanes <= MAX_K_LANES:
        raise ValueError(
            f"k_lanes={k_lanes} must be a multiple of {LANES} in "
            f"[{LANES}, {MAX_K_LANES}]"
        )
    if not (x.is_contiguous() and yT.is_contiguous()):
        raise ValueError("x and yT must be contiguous")
    _check_aligned("yT", yT, 8)


def _check_knn_mma(yT):
    """What the tensor-core K3 needs of its store beyond the contract: TMA
    reads it, so its base address 16-byte aligned and its row stride a
    multiple of 4 columns (16 bytes). Raises ValueError."""
    if yT.data_ptr() % 16:
        raise ValueError("K3: yT must start on a 16-byte boundary")
    if yT.stride(0) % 4:
        raise ValueError(
            f"K3: the store's row stride {yT.stride(0)} must be a multiple of "
            "4 columns (16 bytes)"
        )


def knn_buckets(nb: int) -> int:
    """K3's buckets over ``nb`` columns: runs of KNN_BUCKET consecutive
    columns, the last one partial."""
    return -(-int(nb) // KNN_BUCKET)


def knn_lt_cap(k_lanes: int) -> int:
    """Pairs of a row's lt region: fewer than k_lanes buckets have a minimum
    below the threshold, and only they hold keys below it."""
    return (k_lanes - 1) * KNN_BUCKET


def knn_candidates(k_lanes: int) -> int:
    """Pairs of a row's candidate buffer: the lt region, then k_lanes pairs
    of keys equal to the threshold (the eq region)."""
    return knn_lt_cap(k_lanes) + k_lanes


def knn_row_bytes(nb: int, k_lanes: int) -> int:
    """K3's scratch per query row: its bucket minima (float32), threshold
    (float32), two counters (int32) and candidate pairs (key, column)."""
    return 4 * knn_buckets(nb) + 4 + 8 + 8 * knn_candidates(k_lanes)


def knn_sub_batch(nq: int, nb: int, k_lanes: int) -> int:
    """Queries per K3 launch: as many as keep the per-row scratch within
    KNN_SCRATCH_CAP, in whole blocks of KNN_BLOCK queries (in whole
    multiples of 8 below one block), at least 8 and at most nq."""
    rows = KNN_SCRATCH_CAP // knn_row_bytes(nb, k_lanes)
    step = KNN_BLOCK if rows >= KNN_BLOCK else QUERIES_PER_BLOCK
    return min(nq, max(QUERIES_PER_BLOCK, rows // step * step))


def knn_fused(x, yT, nb: int, *, metric_l2: bool = True, qt: int = 512,
              ct: int = 1024, k_lanes: int = LANES):
    """K3 (see the module docstring). ``x`` [nq, d] float32, ``yT`` [d, nbp]
    float32 transposed store whose columns from ``nb`` on are zero pads.
    Returns (values [nq, k_lanes] f32, ids int32, floor [nq, 128] f32).

    CPU tensors run the plain version; CUDA tensors launch the kernel on the
    current stream without synchronising, in sub-batches of
    ``knn_sub_batch`` queries (one launch each); any other device raises.
    After a launch, ``knn_fused.counts`` [nq, 2] int32 holds each row's
    appended lt and eq pairs (the eq count before the region's cap) and
    ``knn_fused.scratch_bytes`` the scratch it allocated."""
    nb = int(nb)
    _check_knn(x, yT, nb, qt, ct, k_lanes)
    if not _route("K3", (x, yT)):
        return knn_fused_ref(x, yT, nb, metric_l2=metric_l2, qt=qt, ct=ct,
                             k_lanes=k_lanes)
    _check_knn_mma(yT)
    nq = x.shape[0]
    sub = knn_sub_batch(nq, nb, k_lanes)
    scratch = knn_scratch(yT, nb, sub, nq, k_lanes)
    splits = _split_count(-(-sub // KNN_BLOCK), max(1, -(-nb // KNN_TILE)),
                          _sm_count(x.device.index or 0))
    vals = torch.empty(nq, k_lanes, dtype=torch.float32, device=x.device)
    ids = torch.empty(nq, k_lanes, dtype=torch.int32, device=x.device)
    floor = torch.empty(nq, LANES, dtype=torch.float32, device=x.device)
    for q0 in range(0, nq, sub):
        q1 = min(nq, q0 + sub)
        knn_fused_launch(
            x[q0:q1], yT, nb, metric_l2, k_lanes, qt, ct, scratch, q0,
            (vals[q0:q1], ids[q0:q1], floor[q0:q1]), splits,
            KNN_ALL_PHASES if q0 == 0 else KNN_ALL_PHASES & ~KNN_PHASE_N2,
        )
        knn_fused.launches += 1
    knn_fused.counts = scratch["counts"]
    knn_fused.scratch_bytes = sum(t.numel() * t.element_size()
                                  for t in scratch.values())
    knn_fused.splits = splits
    return vals, ids, floor


knn_fused.launches = 0
knn_fused.counts = None
knn_fused.scratch_bytes = 0
knn_fused.splits = 1


def knn_scratch(yT, nb, sub, nq, k_lanes):
    """K3's scratch, from torch.empty (the kernels allocate nothing): the
    store's column norms ``n2`` (every tile's columns), the bucket minima
    and candidate pairs of one sub-batch of ``sub`` rows, and the
    thresholds and counters of all ``nq`` rows."""
    dev = yT.device
    ncols = max(1, -(-yT.shape[1] // KNN_TILE)) * KNN_TILE
    return {
        "n2": torch.empty(ncols, dtype=torch.float32, device=dev),
        "minima": torch.empty(sub, max(1, knn_buckets(nb)), dtype=torch.float32,
                              device=dev),
        "theta": torch.empty(nq, dtype=torch.float32, device=dev),
        "counts": torch.empty(nq, 2, dtype=torch.int32, device=dev),
        "cand": torch.empty(sub, knn_candidates(k_lanes), 2, dtype=torch.int32,
                            device=dev),
    }


def knn_fused_launch(x, yT, nb, metric_l2, k_lanes, qt, ct, scratch, row0, out,
                     splits, phases):
    """One launch of K3's kernels (the ``phases`` bits of KNN_ALL_PHASES, in
    order) for the rows ``x`` (a sub-batch starting at row ``row0`` of the
    call) into ``out`` = (values, ids, floor) of those rows, on the
    scratch of knn_scratch. knn_fused calls it with every phase (n2 only on
    its first sub-batch); chip_smoke.py times the phases with it. Counts no
    launch."""
    vals, ids, floor = out
    nq, d = x.shape
    _launch(
        "knn_fused", x.data_ptr(), yT.data_ptr(), yT.stride(0), nb,
        int(metric_l2), vals.data_ptr(), ids.data_ptr(), floor.data_ptr(),
        nq, d, k_lanes, qt, ct, scratch["n2"].data_ptr(),
        scratch["minima"].data_ptr(), scratch["minima"].shape[1],
        scratch["theta"][row0:].data_ptr(), scratch["counts"][row0:].data_ptr(),
        scratch["cand"].data_ptr(), splits, phases, _stream(x.device),
    )


def knn_fused_ref(x, yT, nb: int, *, metric_l2: bool = True, qt: int = 512,
                  ct: int = 1024, k_lanes: int = LANES):
    """Plain PyTorch version of K3's contract: per column chunk below ``nb``,
    score ``||y||^2 - 2 x @ y`` (L2) or ``-x @ y`` (IP), take ``torch.topk``
    and merge; then add ``||x||^2`` (L2) or negate (IP)."""
    del qt, ct  # tiles of the TPU kernel; the result does not depend on them
    nq = x.shape[0]
    keys = torch.full((nq, k_lanes), float("inf"), device=x.device)
    ids = torch.full((nq, k_lanes), -1, dtype=torch.int64, device=x.device)
    for c0 in range(0, int(nb), REF_CHUNK):
        y = yT[:, c0 : min(c0 + REF_CHUNK, int(nb))]
        ip = x @ y
        sc = y.square().sum(0)[None, :] - 2.0 * ip if metric_l2 else -ip
        v, pos = torch.topk(sc, min(k_lanes, sc.shape[1]), dim=1, largest=False)
        keys, ids = merge_topk(keys, ids, v, pos + c0, k_lanes, largest=False)
    missing = torch.isinf(keys)
    ids = torch.where(missing, -1, ids).int()
    if metric_l2:
        vals = (keys + x.square().sum(1)[:, None]).clamp_min(0.0)
        vals = torch.where(missing, float("inf"), vals)
        floor = torch.full((nq, LANES), float("inf"), device=x.device)
    else:
        vals = torch.where(missing, float("-inf"), -keys)
        floor = torch.full((nq, LANES), float("-inf"), device=x.device)
    return vals, ids, floor


# -- K4 and K5 ---------------------------------------------------------------


def _check_adc(biasg, luts, codesT, n2, lid, qt, ct):
    """The ADC scans' inputs. Returns (M, ksub, G)."""
    if (luts.dtype, codesT.dtype, n2.dtype) != (
        torch.bfloat16, torch.uint8, torch.float32
    ):
        raise ValueError(
            "expected luts bfloat16, codesT uint8, n2 float32; got "
            f"{luts.dtype}, {codesT.dtype}, {n2.dtype}"
        )
    if luts.dim() != 2 or codesT.dim() != 2:
        raise ValueError("luts and codesT must be 2-D")
    nq = luts.shape[0]
    M, S = codesT.shape
    ksub = luts.shape[1] // max(M, 1)
    if M == 0 or M * ksub != luts.shape[1] or not 1 <= ksub <= 256:
        raise ValueError(
            f"luts {tuple(luts.shape)} must be [nq, M * ksub] for the M={M} "
            "rows of codesT, with ksub <= 256 (one code per byte)"
        )
    if M * ksub > MAX_LUT_ROW:
        raise ValueError(f"M * ksub = {M * ksub} exceeds {MAX_LUT_ROW}")
    if tuple(n2.shape) != (1, S):
        raise ValueError(f"n2 must be [1, {S}], got {tuple(n2.shape)}")
    _check_tiles(nq, qt)
    if ct <= 0 or ct % 2 or S % ct or S >= 1 << 31:
        raise ValueError(
            f"need ct even and S={S} a multiple of ct={ct} below 2^31"
        )
    if not all(t.is_contiguous() for t in (luts, codesT, n2)):
        raise ValueError("luts, codesT and n2 must be contiguous")
    _check_aligned("codesT", codesT, 2)
    _check_aligned("n2", n2, 8)
    G = _check_bias(biasg, lid, nq, S)
    return M, ksub, G


def _adc_keys(biasg, lf, codes, n2c, lidc, groups, rows):
    """Plain ADC keys ``n2 + bias + sum_m lut[m * ksub + code_m]`` for the
    queries ``rows`` and columns with codes [M, C]: the LUT sum as a float32
    product with a one-hot of the codes (every term is exact; the order of
    the M additions differs from the kernel's)."""
    M, C = codes.shape
    ksub = lf.shape[1] // M
    onehot = torch.zeros(C, M * ksub, device=lf.device)
    offs = torch.arange(M, device=lf.device)[:, None] * ksub
    onehot.scatter_(1, (codes.long() + offs).T, 1.0)
    return n2c[None, :] + _bias_terms(biasg, rows, groups, lidc) + lf[rows] @ onehot.T


def adc_on_tensor_cores(M, ksub):
    """K4's and K5's instance for a shape, as the built kernel library decides it:
    True for the tensor-core kernel (ksub <= 16, the 16 entries of a
    sub-quantizer being one bf16 k-step, and 64 LUT rows of M * 16 entries
    that fit a block's shared memory, M <= 37), False for the shared-memory
    lookup scan of adc_scan.cuh. ``ivfpq_adc_smem_bytes(M, ksub, 1)`` is -1
    where the tensor-core kernel does not take the shape."""
    lib, _ = build_kernel("ivfpq_adc")
    return lib.ivfpq_adc_smem_bytes(M, ksub, 1) >= 0


def _check_adc_tc(what, named, ct):
    """What the tensor-core ADC kernel (K4-K6) needs beyond the contract:
    TMA reads the codes, n2 and the list ids and the bias floor reads biasg
    16 bytes at a time, so the base addresses of the ``named`` (name,
    tensor) pairs 16-byte aligned; chunks of whole 128-column tiles (a tile
    lies in one chunk, so in one bias group). Raises ValueError."""
    for name, t in named:
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must start on a 16-byte boundary")
    if ct % ADC_TC_TILE:
        raise ValueError(f"{what}: ct={ct} must be a multiple of {ADC_TC_TILE}")


def ivfpq_fused(biasg, luts, codesT, n2, lid, *, qt: int = 256, ct: int = 1024):
    """K4 (see the module docstring). ``biasg`` [nq, G * 128] float32 coarse
    term per grouped list column (1e9 on unprobed lists), ``luts`` [nq,
    M * ksub] bfloat16, ``codesT`` [M, S] uint8 group-packed codes, ``n2``
    [1, S] float32 (+inf on pads), ``lid`` [1, S] int32 local list ids.
    Returns (keys, slots, floor); the keys lack ||q||^2.

    CPU tensors run the plain version; CUDA tensors launch the kernel on the
    current stream without synchronising; any other device raises. On the
    card the instance is chosen by shape before the launch, as the built
    library answers :func:`adc_on_tensor_cores`: the tensor-core kernel for
    ksub <= 16 and
    M <= 37 (every IVF-PQ FastScan path: 4-bit codes), checked by
    :func:`_check_adc_tc`; the lookup scan of adc_scan.cuh for wider codes
    or rows. A failed build or launch raises."""
    M, ksub, G = _check_adc(biasg, luts, codesT, n2, lid, qt, ct)
    _static_cpg(codesT.shape[1] // ct, G)
    if not _route("K4", (biasg, luts, codesT, n2, lid)):
        return ivfpq_fused_ref(biasg, luts, codesT, n2, lid, qt=qt, ct=ct)
    nq, S = luts.shape[0], codesT.shape[1]
    tc = adc_on_tensor_cores(M, ksub)
    splits = 1
    if tc:
        _check_adc_tc("K4", (("biasg", biasg), ("codesT", codesT), ("n2", n2),
                             ("lid", lid)), ct)
        splits = _split_count(-(-nq // ADC_TC_BLOCK), S // ADC_TC_TILE,
                              _sm_count(luts.device.index or 0))
    part_key, part_slot = _split_scratch(splits, nq, luts.device)
    keys, slots, floor = _lane_outputs(nq, luts.device)
    _launch(
        "ivfpq_adc", biasg.data_ptr(), luts.data_ptr(), codesT.data_ptr(),
        n2.data_ptr(), lid.data_ptr(), None, None, keys.data_ptr(),
        slots.data_ptr(), floor.data_ptr(), _ptr(part_key), _ptr(part_slot),
        None, nq, biasg.shape[1], M, ksub, S, 0, qt, ct, splits, int(tc),
        _stream(luts.device),
    )
    ivfpq_fused.launches += 1
    ivfpq_fused.tc_launches += tc
    ivfpq_fused.splits = splits
    return keys, slots, floor


ivfpq_fused.launches = 0
ivfpq_fused.tc_launches = 0  # launches of the tensor-core instance
ivfpq_fused.splits = 0  # column splits of the last launch


def ivfpq_fused_ref(biasg, luts, codesT, n2, lid, *, qt: int = 256, ct: int = 1024):
    """Plain PyTorch version of K4's contract: per column chunk, the ADC
    keys of every query, ``torch.topk`` and merge."""
    del qt  # a tile of the TPU kernel; the result does not depend on it
    S = codesT.shape[1]
    lf = luts.float()

    def score(c0, c1):
        return _adc_keys(biasg, lf, codesT[:, c0:c1], n2[0, c0:c1],
                         lid[0, c0:c1], _static_groups(c0, c1, S, ct, biasg),
                         slice(None))

    return _chunked_topk(score, luts.shape[0], S, luts.device)


def ivfpq_fused_dyn(biasg, luts, codesT, n2, lid, cmap, cgroup, *, qt: int = 256,
                    ct: int = 1024):
    """K5 (see the module docstring): K4's inputs for queries sorted by home
    group, plus ``cmap`` [nq // qt, msteps] int32 chunk worklist per tile
    and ``cgroup`` [S // ct] int32 group of each chunk. Returns (keys,
    slots, floor).

    The last chunk of the store (``S // ct - 1``) is the PAD chunk, as for
    K1: its n2 is all +inf, and each worklist fills the steps after its
    tile's chunks with it. On the tensor cores the kernel stops each tile at
    its last step that is not the PAD chunk (exact: a +inf key is never
    selected) and counts the steps it skipped
    (``pad_steps_skipped(kernel="K5")``); the plain version scans every
    step.

    CPU tensors run the plain version; CUDA tensors launch the kernel on the
    current stream without synchronising; any other device raises. On the
    card the instance is chosen by shape before the launch, as for K4
    (:func:`adc_on_tensor_cores`): the tensor-core kernel, checked by
    :func:`_check_adc_tc`, each tile's worklist steps split across blocks;
    the lookup scan of adc_scan.cuh for ksub > 16 or M > 37. A failed
    build or launch raises."""
    M, ksub, _ = _check_adc(biasg, luts, codesT, n2, lid, qt, ct)
    nq = luts.shape[0]
    if cmap.dtype != torch.int32 or cmap.dim() != 2 or (
        cmap.shape[0] != nq // qt or cmap.shape[1] < 1 or not cmap.is_contiguous()
    ):
        raise ValueError(
            f"cmap must be a contiguous int32 [{nq // qt}, msteps], got "
            f"{cmap.dtype} {tuple(cmap.shape)}"
        )
    _check_cgroup(cgroup, codesT.shape[1] // ct)
    if not _route("K5", (biasg, luts, codesT, n2, lid, cmap, cgroup)):
        return ivfpq_fused_dyn_ref(biasg, luts, codesT, n2, lid, cmap, cgroup,
                                   qt=qt, ct=ct)
    dev, msteps = luts.device, cmap.shape[1]
    tc = adc_on_tensor_cores(M, ksub)
    splits, skipped = 1, None
    if tc:
        _check_adc_tc("K5", (("biasg", biasg), ("codesT", codesT), ("n2", n2),
                             ("lid", lid)), ct)
        blocks = nq // qt * -(-qt // ADC_TC_BLOCK)
        splits = _split_count(blocks, msteps, _sm_count(dev.index or 0))
        skipped = _pad_counter(dev, "K5").data_ptr()
    part_key, part_slot = _split_scratch(splits, nq, dev)
    keys, slots, floor = _lane_outputs(nq, dev)
    _launch(
        "ivfpq_adc", biasg.data_ptr(), luts.data_ptr(), codesT.data_ptr(),
        n2.data_ptr(), lid.data_ptr(), cmap.data_ptr(), cgroup.data_ptr(),
        keys.data_ptr(), slots.data_ptr(), floor.data_ptr(), _ptr(part_key),
        _ptr(part_slot), skipped, nq, biasg.shape[1], M, ksub, codesT.shape[1],
        msteps, qt, ct, splits, int(tc), _stream(dev),
    )
    ivfpq_fused_dyn.launches += 1
    ivfpq_fused_dyn.tc_launches += tc
    ivfpq_fused_dyn.splits = splits
    return keys, slots, floor


ivfpq_fused_dyn.launches = 0
ivfpq_fused_dyn.tc_launches = 0  # launches of the tensor-core instance
ivfpq_fused_dyn.splits = 0  # worklist splits of the last launch


def ivfpq_fused_dyn_ref(biasg, luts, codesT, n2, lid, cmap, cgroup, *,
                        qt: int = 256, ct: int = 1024):
    """Plain PyTorch version of K5's contract: per tile, the ADC keys over
    its worklist chunks and ``torch.topk``."""
    lf = luts.float()

    def score(rows, chunks, idx):
        return _adc_keys(biasg, lf, codesT[:, idx], n2[0, idx], lid[0, idx],
                         cgroup[chunks], rows)

    return _tile_topk(score, cmap, qt, ct, luts.shape[0], luts.device)


# -- K6 ----------------------------------------------------------------------


def _check_v3(biasg, luts, meta, ohT, n2, qt, ct, ksub):
    """K6's contract. Returns (M, G, int8)."""
    int8 = luts.dtype == torch.int8
    want = torch.int8 if int8 else torch.bfloat16
    if luts.dtype not in (torch.bfloat16, torch.int8) or ohT.dtype != want:
        raise ValueError(
            "expected luts bfloat16 with ohT bfloat16, or luts int8 with ohT "
            f"int8; got {luts.dtype}, {ohT.dtype}"
        )
    if (biasg.dtype, meta.dtype, n2.dtype) != (torch.float32,) * 3:
        raise ValueError(
            "expected biasg, meta and n2 float32; got "
            f"{biasg.dtype}, {meta.dtype}, {n2.dtype}"
        )
    if luts.dim() != 2 or ohT.dim() != 2:
        raise ValueError("luts and ohT must be 2-D")
    nq, Kpq = luts.shape
    S = ohT.shape[1]
    if ohT.shape[0] != Kpq + LANES:
        raise ValueError(
            f"ohT must have luts.shape[1] + {LANES} = {Kpq + LANES} rows, got "
            f"{ohT.shape[0]}"
        )
    if not 1 <= ksub <= 256 or Kpq % ksub or Kpq == 0 or Kpq > MAX_LUT_ROW:
        raise ValueError(
            f"luts' {Kpq} columns must be M * ksub with ksub={ksub} <= 256 "
            f"and M * ksub <= {MAX_LUT_ROW}"
        )
    if tuple(meta.shape) != (nq, 2 * LANES):
        raise ValueError(f"meta must be [{nq}, {2 * LANES}], got {tuple(meta.shape)}")
    if tuple(n2.shape) != (1, S):
        raise ValueError(f"n2 must be [1, {S}], got {tuple(n2.shape)}")
    if biasg.dim() != 2 or biasg.shape[0] != nq or biasg.shape[1] % LANES or (
        biasg.shape[1] == 0
    ):
        raise ValueError(f"biasg must be [{nq}, G * {LANES}], got {tuple(biasg.shape)}")
    _check_tiles(nq, qt)
    G = biasg.shape[1] // LANES
    if ct <= 0 or ct % 256 or S % ct or S >= 1 << 31 or (S // ct) % G:
        raise ValueError(
            f"need ct={ct} a multiple of 256, S={S} a multiple of ct below "
            f"2^31 and its {S // max(ct, 1)} chunks a multiple of G={G}"
        )
    if not all(t.is_contiguous() for t in (biasg, luts, meta, ohT, n2)):
        raise ValueError("biasg, luts, meta, ohT and n2 must be contiguous")
    _check_aligned("ohT", ohT, 16)
    _check_aligned("n2", n2, 8)
    return Kpq // ksub, G, int8


def v3_on_tensor_cores(M, ksub, int8):
    """K6's instance for a shape and LUT type, as the built kernel library
    decides it: True for the tensor-core kernel (ksub <= 16 and 64 LUT rows
    that fit a block's shared memory: M <= 37 with bf16 LUTs, M <= 61 with
    int8), False for the shared-memory lookup scan of adc_scan.cuh.
    ``ivfpq_v3_smem_bytes(M, ksub, int8, 1)`` is -1 where the tensor-core
    kernel does not take the shape."""
    lib, _ = build_kernel("ivfpq_v3")
    return lib.ivfpq_v3_smem_bytes(M, ksub, int(int8), 1) >= 0


def ivfpq_fused_v3(biasg, luts, meta, ohT, n2, *, qt: int = 256, ct: int = 1024,
                   ksub: int = 16):
    """K6 (see the module docstring). ``biasg`` [nq, G * 128] float32 coarse
    term per grouped list column, ``luts`` [nq, M * ksub] bfloat16 LUTs or
    int8 quantized LUTs, ``meta`` [nq, 256] float32 (a in columns 0:128, c
    in 128:256; read in int8 mode only), ``ohT`` [M * ksub + 128, S] one-hot
    of the luts' type, ``n2`` [1, S] float32 (+inf on pads); ``ksub`` is
    the size of the one-hot's row blocks. Returns (keys, slots, floor); the
    keys lack ||q||^2.

    CPU tensors run the plain version; CUDA tensors launch the kernel on the
    current stream and read the kernel's count of non-one-hot columns once
    (a synchronisation) to raise on them; any other device raises. On the
    card the instance is chosen by shape before the launch, as the built
    library answers :func:`v3_on_tensor_cores`: the tensor-core kernel for
    ksub <= 16 and M <= 37 (bf16) or 61 (int8), checked by
    :func:`_check_adc_tc`, its columns split across blocks; the lookup scan
    of adc_scan.cuh for wider codes or rows. A failed build or launch
    raises."""
    M, G, int8 = _check_v3(biasg, luts, meta, ohT, n2, qt, ct, ksub)
    if not _route("K6", (biasg, luts, meta, ohT, n2)):
        return ivfpq_fused_v3_ref(biasg, luts, meta, ohT, n2, qt=qt, ct=ct,
                                  ksub=ksub)
    nq, S, dev = luts.shape[0], ohT.shape[1], luts.device
    tc = v3_on_tensor_cores(M, ksub, int8)
    splits = 1
    if tc:
        _check_adc_tc("K6", (("biasg", biasg), ("n2", n2)), ct)
        splits = _split_count(-(-nq // ADC_TC_BLOCK), S // ADC_TC_TILE,
                              _sm_count(dev.index or 0))
    part_key, part_slot = _split_scratch(splits, nq, dev)
    codes = torch.empty(M, S, dtype=torch.uint8, device=dev)
    lid = torch.empty(1, S, dtype=torch.int32, device=dev)
    bad = torch.zeros(1, dtype=torch.int32, device=dev)
    keys, slots, floor = _lane_outputs(nq, dev)
    _launch(
        "ivfpq_v3", biasg.data_ptr(), luts.data_ptr(), meta.data_ptr(),
        ohT.data_ptr(), n2.data_ptr(), codes.data_ptr(), lid.data_ptr(),
        bad.data_ptr(), keys.data_ptr(), slots.data_ptr(), floor.data_ptr(),
        _ptr(part_key), _ptr(part_slot), nq, biasg.shape[1], M, ksub, S, qt,
        ct, int(int8), splits, int(tc), _stream(dev),
    )
    ivfpq_fused_v3.launches += 1
    ivfpq_fused_v3.int8_launches += int8
    ivfpq_fused_v3.tc_launches += tc
    ivfpq_fused_v3.splits = splits
    nbad = int(bad.item())
    if nbad:
        raise ValueError(f"ohT: {nbad} columns are not a one-hot")
    return keys, slots, floor


ivfpq_fused_v3.launches = 0
ivfpq_fused_v3.int8_launches = 0
ivfpq_fused_v3.tc_launches = 0  # launches of the tensor-core instances
ivfpq_fused_v3.splits = 0  # column splits of the last launch


def _check_onehot(oh, Kpq, ksub):
    """Raise unless every column of ``oh`` (float32 [Kpq + 128, C]) holds
    only 0s and 1s, exactly one 1 in each block of ksub PQ rows and exactly
    one in the 128 list rows."""
    binary = ((oh == 0) | (oh == 1)).all(dim=0)
    pq = oh[:Kpq].reshape(Kpq // ksub, ksub, -1).sum(dim=1)
    good = binary & (pq == 1).all(dim=0) & (oh[Kpq:].sum(dim=0) == 1)
    nbad = int((~good).sum())
    if nbad:
        raise ValueError(f"ohT: {nbad} columns are not a one-hot")


def ivfpq_fused_v3_ref(biasg, luts, meta, ohT, n2, *, qt: int = 256,
                       ct: int = 1024, ksub: int = 16):
    """Plain PyTorch version of K6's contract: per column chunk, the literal
    contraction of the LUTs with the PQ rows of the one-hot (a float32
    product; in int8 mode every partial sum is an integer below 2^24, so
    the sum is exact) and of each chunk group's bias columns with the list
    rows, the key of the mode, ``torch.topk`` and merge. Refuses a column
    that is not a one-hot, as the kernel does."""
    del qt  # a tile of the TPU kernel; the result does not depend on it
    Kpq, S = luts.shape[1], ohT.shape[1]
    span = ct * ((S // ct) // (biasg.shape[1] // LANES))  # columns per group
    lf = luts.float()

    def score(c0, c1):
        oh = ohT[:, c0:c1].float()
        _check_onehot(oh, Kpq, ksub)
        acc = lf @ oh[:Kpq]
        bias = torch.empty_like(acc)
        for g in range(c0 // span, (c1 - 1) // span + 1):
            a, b = max(c0, g * span), min(c1, (g + 1) * span)
            bias[:, a - c0 : b - c0] = (
                biasg[:, g * LANES : (g + 1) * LANES] @ oh[Kpq:, a - c0 : b - c0]
            )
        rest = bias + n2[:, c0:c1]
        if luts.dtype != torch.int8:
            return acc + rest
        lane = torch.arange(c0, c1, device=luts.device) % LANES
        return (meta[:, lane] * acc + meta[:, LANES + lane]) + rest

    return _chunked_topk(score, luts.shape[0], S, luts.device)


# -- K7 ----------------------------------------------------------------------


def _check_floor(xq, yT, n2, qt, ct):
    if (xq.dtype, yT.dtype, n2.dtype) != (torch.float32, torch.bfloat16,
                                          torch.float32):
        raise ValueError(
            "expected xq float32, yT bfloat16, n2 float32; got "
            f"{xq.dtype}, {yT.dtype}, {n2.dtype}"
        )
    if xq.dim() != 2 or yT.dim() != 2 or yT.shape[0] != xq.shape[1]:
        raise ValueError(f"xq {tuple(xq.shape)} and yT {tuple(yT.shape)} differ in d")
    S = yT.shape[1]
    if tuple(n2.shape) != (1, S):
        raise ValueError(f"n2 must be [1, {S}], got {tuple(n2.shape)}")
    _check_tiles(xq.shape[0], qt)
    if ct <= 0 or ct % LANES or S % ct or S >= 1 << 31 or xq.shape[1] % 4:
        raise ValueError(
            f"need ct={ct} a multiple of {LANES}, S={S} a multiple of ct below "
            f"2^31 and d={xq.shape[1]} a multiple of 4"
        )
    if not all(t.is_contiguous() for t in (xq, yT, n2)):
        raise ValueError("xq, yT and n2 must be contiguous")
    _check_aligned("yT", yT, 4)
    _check_aligned("n2", n2, 8)


def recon_floor(xq, yT, n2, *, qt: int = 256, ct: int = 1024):
    """K7 (see the module docstring). ``xq`` [nq, d] float32, ``yT`` [d, S]
    bfloat16 transposed store, ``n2`` [1, S] float32 (+inf on pads).
    Returns out [nq, 128] float32.

    CPU tensors run the plain version; CUDA tensors launch the tensor-core
    kernel on the current stream without synchronising, after the checks of
    :func:`_check_mma_operands` (16-byte operands, d a multiple of 128),
    which raise before the launch; any other device raises. The columns
    split across blocks (``recon_floor.splits``) so that a launch gives
    every block slot of the card (two an SM) a block."""
    _check_floor(xq, yT, n2, qt, ct)
    if not _route("K7", (xq, yT, n2)):
        return recon_floor_ref(xq, yT, n2, qt=qt, ct=ct)
    nq, d = xq.shape
    S, dev = yT.shape[1], xq.device
    _check_mma_operands("K7", xq, (yT,), n2, d)
    splits = _split_count(-(-nq // RECON_BLOCK), S // LANES,
                          _sm_count(dev.index or 0) * RECON_FLOOR_BLOCKS_PER_SM)
    part = None if splits == 1 else torch.empty(
        splits, nq, LANES, dtype=torch.float32, device=dev)
    out = torch.empty(nq, LANES, dtype=torch.float32, device=dev)
    _launch("recon_floor", xq.data_ptr(), yT.data_ptr(), n2.data_ptr(),
            out.data_ptr(), _ptr(part), nq, d, S, qt, ct, splits, _stream(dev))
    recon_floor.launches += 1
    recon_floor.splits = splits
    return out


recon_floor.launches = 0
recon_floor.splits = 0  # column splits of the last launch


def recon_floor_ref(xq, yT, n2, *, qt: int = 256, ct: int = 1024):
    """Plain PyTorch version of K7's contract: per column chunk the float32
    product ``n2 - 2 q @ y``, then the minimum of every lane over the
    chunk's columns (``amin`` over ``view(nq, -1, 128)``)."""
    del qt, ct  # tiles of the TPU kernel; the result does not depend on them
    nq, S = xq.shape[0], yT.shape[1]
    out = torch.full((nq, LANES), float("inf"), device=xq.device)
    for c0 in range(0, S, REF_CHUNK):
        c1 = min(c0 + REF_CHUNK, S)
        sc = n2[:, c0:c1] - 2.0 * (xq @ yT[:, c0:c1].float())
        out = torch.minimum(out, sc.view(nq, -1, LANES).amin(dim=1))
    return out
