"""uint8 LUT quantization and the one-hot layout of K6 (counterpart of
faiss_tpu/ops/quantize_lut.py).

FastScan quantizes the per-query ADC tables to 8 bits with one scale per
query and one bias per (query, sub-quantizer) (faiss/utils/quantize_lut.h).
K6 (ops/fused_knn.ivfpq_fused_v3) sums int8 LUT entries exactly in int32 and
dequantizes the sum with the (a, c) metadata made here:

    true_sum ~= a * acc + c        acc = sum_m q8[m, code_m]  (int32)

where q8 = round((lut - b_m) / a) - 128 (int8), c = sum_m b_m + 128 * M * a.
``quantize_LUT_and_bias`` and ``dequantize_sum`` are the host (numpy) parity
API, copied unchanged from faiss_tpu."""

from __future__ import annotations

import numpy as np
import torch

LANES = 128  # width of each half of meta


def quantize_luts_int8(luts3: torch.Tensor):
    """Quantize per-query ADC tables for K6's int8 mode. ``luts3`` [nq, M,
    ksub] float32 (any sign). Returns (q8 [nq, M * ksub] int8, meta [nq,
    256] float32) where meta[:, 0:128] broadcasts the per-query scale ``a``
    and meta[:, 128:256] the dequantization constant ``c``. Rounding is to
    nearest even, as jnp.round."""
    nq, M, ksub = luts3.shape
    bmin = luts3.amin(dim=-1)  # [nq, M] per-(q, m) bias
    rel = luts3 - bmin[..., None]
    a = (rel.amax(dim=(-2, -1)) / 255.0).clamp_min(1e-30)  # [nq] scale
    q = torch.round(rel / a[:, None, None]) - 128.0
    q8 = q.clamp(-128, 127).to(torch.int8).reshape(nq, M * ksub)
    c = bmin.sum(dim=-1) + a * (128.0 * M)
    meta = torch.cat(
        [a[:, None].expand(nq, LANES), c[:, None].expand(nq, LANES)], dim=1
    ).float().contiguous()
    return q8, meta


def quantize_LUT_and_bias(luts: np.ndarray, biases: np.ndarray | None = None):
    """Host parity API (faiss utils/quantize_lut.h:47 quantize_LUT_and_bias).

    luts: [nprobe, M, ksub] (or [M, ksub]) f32; biases: optional [nprobe]
    coarse terms folded into the quantized domain. Returns
    (lut_u8, bias_u16, a, b) such that
    ``a * (sum_m lut_u8[m, code_m] + bias_u16) + b`` reproduces the float
    ADC sum + bias to within M/2 quantization steps.
    """
    luts = np.asarray(luts, np.float32)
    squeeze = luts.ndim == 2
    if squeeze:
        luts = luts[None]
    nprobe, M, ksub = luts.shape
    bmin = luts.min(-1)  # [nprobe, M]
    rng_lut = (luts - bmin[..., None]).max()
    if biases is not None:
        biases = np.asarray(biases, np.float32)
        bias_shift = biases.min()
        rng_bias = (biases - bias_shift).max()
    else:
        bias_shift = 0.0
        rng_bias = 0.0
    a = max(rng_lut / 255.0, rng_bias / 65535.0, 1e-30)
    lut_u8 = np.clip(
        np.round((luts - bmin[..., None]) / a), 0, 255
    ).astype(np.uint8)
    if biases is not None:
        bias_u16 = np.clip(
            np.round((biases - bias_shift) / a), 0, 65535
        ).astype(np.uint16)
    else:
        bias_u16 = np.zeros(nprobe, np.uint16)
    b = bmin.sum(-1) + bias_shift  # [nprobe]
    if squeeze:
        lut_u8, bias_u16, b = lut_u8[0], bias_u16[0], float(b[0])
    return lut_u8, bias_u16, a, b


def dequantize_sum(acc, bias_u16, a, b):
    """Invert quantize_LUT_and_bias: float score from integer accumulator."""
    return a * (np.asarray(acc, np.float64) + np.asarray(bias_u16, np.float64)) + b


def expand_onehot(codesT: torch.Tensor, lid: torch.Tensor, ksub: int,
                  int8: bool, chunk: int = 1 << 17) -> torch.Tensor:
    """Stage the [M * ksub + 128, S] one-hot layout of K6 on the device of
    ``codesT`` [M, S] (uint8 codes) and ``lid`` [1, S] (local list ids
    0..127): row ``m * ksub + codesT[m, s]`` and row ``M * ksub + lid[s]``
    of column s are 1, every other entry 0; int8 or bfloat16. Written into
    one preallocated tensor in column chunks, so no transient holds more
    than ``chunk`` columns."""
    M, S = codesT.shape
    Kpq = M * ksub
    dt = torch.int8 if int8 else torch.bfloat16
    out = torch.zeros(Kpq + LANES, S, dtype=dt, device=codesT.device)
    for s in range(0, S, chunk):
        c = min(chunk, S - s)
        oh = torch.zeros(Kpq + LANES, c, dtype=dt, device=codesT.device)
        oh[:Kpq].view(M, ksub, c).scatter_(
            1, codesT[:, None, s : s + c].long(), 1
        )
        oh[Kpq:].scatter_(0, lid[:, s : s + c].long(), 1)
        out[:, s : s + c] = oh
    return out
