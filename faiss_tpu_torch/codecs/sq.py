"""ScalarQuantizer (counterpart of faiss_tpu/codecs/sq.py; reference:
faiss/impl/ScalarQuantizer.{h,cpp}).

Every quantizer type of faiss_tpu: per-dimension or uniform linear codes of
8, 6 and 4 bits over trained ranges (every RangeStat: min/max, mean +- k
std, quantiles; RS_optim trains as min/max, as in faiss_tpu), fp16 and bf16
passthrough, 8-bit direct and direct-signed, QT_0bit (no code: an IVF list
centroid stands for its vectors), the TurboQuant MSE types (Lloyd-Max
levels of N(0, 1), bit-plane packed) and the full TurboQuant types (an
(n-1)-bit MSE code of the normalized row, a 1-bit QJL sign code of its
residual, and the row's norm and residual norm as float32).

The codec is host numpy, copied from faiss_tpu, so both packages give the
same codes bit for bit; the indexes move decoded rows to their device
(IndexFlatSQ8 dequantizes its 8-bit codes there)."""

from __future__ import annotations

import enum
import math
from typing import Optional

import numpy as np


class QuantizerType(enum.IntEnum):
    """reference: ScalarQuantizer.h:27 (the values of faiss_tpu's enum)."""

    QT_8bit = 0
    QT_4bit = 1
    QT_8bit_uniform = 2
    QT_4bit_uniform = 3
    QT_fp16 = 4
    QT_8bit_direct = 5
    QT_6bit = 6
    QT_bf16 = 7
    QT_8bit_direct_signed = 8
    QT_0bit = 9  # centroid-only distance, IVF use (ScalarQuantizer.h:40)
    QT_1bit_tqmse = 10  # TurboQuant MSE-optimal Lloyd-Max (h:41-45)
    QT_2bit_tqmse = 11
    QT_3bit_tqmse = 12
    QT_4bit_tqmse = 13
    QT_8bit_tqmse = 14
    QT_2bit_tq = 15  # full TurboQuant: (n-1)-bit MSE + 1-bit QJL (h:46-49)
    QT_3bit_tq = 16
    QT_4bit_tq = 17
    QT_5bit_tq = 18


class RangeStat(enum.IntEnum):
    """reference: ScalarQuantizer.h:54."""

    RS_minmax = 0
    RS_meanstd = 1
    RS_quantiles = 2
    RS_optim = 3


# the trained linear types and their bits
_BITS = {
    QuantizerType.QT_8bit: 8,
    QuantizerType.QT_4bit: 4,
    QuantizerType.QT_8bit_uniform: 8,
    QuantizerType.QT_4bit_uniform: 4,
    QuantizerType.QT_6bit: 6,
}
_UNIFORM = (QuantizerType.QT_8bit_uniform, QuantizerType.QT_4bit_uniform)

# The tqmse types quantize the RAW components against the fixed N(0, 1)
# Lloyd-Max table, with no normalization (the reference QuantizerLloydMax,
# quantizers.h:205): data far from unit scale clips to the extreme levels,
# and train() does nothing for them.
_TQMSE_BITS = {
    QuantizerType.QT_1bit_tqmse: 1,
    QuantizerType.QT_2bit_tqmse: 2,
    QuantizerType.QT_3bit_tqmse: 3,
    QuantizerType.QT_4bit_tqmse: 4,
    QuantizerType.QT_8bit_tqmse: 8,
}

_TQ_BITS = {  # total bits: total - 1 MSE planes and one QJL sign plane
    QuantizerType.QT_2bit_tq: 2,
    QuantizerType.QT_3bit_tq: 3,
    QuantizerType.QT_4bit_tq: 4,
    QuantizerType.QT_5bit_tq: 5,
}

_lloyd_max_cache: dict = {}


def lloyd_max_gaussian(nbits: int):
    """The MSE-optimal (Lloyd-Max) scalar quantizer of N(0, 1): (centroids
    [2^nbits], boundaries [2^nbits - 1]) float32, by fixed-point iteration
    of the optimality conditions c_i = E[X | b_{i-1} < X <= b_i],
    b_i = (c_i + c_{i+1}) / 2 (the reference bakes the converged values into
    ScalarQuantizer.cpp:30)."""
    if nbits in _lloyd_max_cache:
        return _lloyd_max_cache[nbits]
    k = 1 << nbits
    erf = np.frompyfunc(math.erf, 1, 1)

    def cdf(x):
        return 0.5 * (1.0 + erf(x / math.sqrt(2.0)).astype(np.float64))

    def pdf(x):
        return np.exp(-0.5 * x * x) / math.sqrt(2.0 * math.pi)

    c = np.linspace(-3.0, 3.0, k).astype(np.float64)
    for _ in range(40 * k + 200):
        b = 0.5 * (c[1:] + c[:-1])
        lo = np.concatenate([[-np.inf], b])
        hi = np.concatenate([b, [np.inf]])
        mass = np.maximum(cdf(hi) - cdf(lo), 1e-300)
        c_new = (pdf(lo) - pdf(hi)) / mass
        if np.max(np.abs(c_new - c)) < 1e-14:
            c = c_new
            break
        c = c_new
    b = 0.5 * (c[1:] + c[:-1])
    out = (c.astype(np.float32), b.astype(np.float32))
    _lloyd_max_cache[nbits] = out
    return out


def _pack_bit_planes(q: np.ndarray, nb: int) -> np.ndarray:
    """[n, d] small ints -> bit-plane-major uint8 [n, nb * ceil(d / 8)]: all
    of bit p of the row, then bit p + 1 (the reference's TurboQuant layout,
    quantizers.h:558 store_mse_index), little-endian within a byte."""
    return np.concatenate(
        [np.packbits((q >> p) & 1, axis=1, bitorder="little") for p in range(nb)],
        axis=1,
    )


def _unpack_bit_planes(codes: np.ndarray, nb: int, d: int) -> np.ndarray:
    pb = (d + 7) // 8
    q = np.zeros((len(codes), d), np.uint8)
    for p in range(nb):
        bits = np.unpackbits(
            codes[:, p * pb : (p + 1) * pb], axis=1, bitorder="little"
        )[:, :d]
        q |= bits << p
    return q


def _tq_rotation(d: int, seed: int) -> np.ndarray:
    """The seeded random orthogonal QJL projection [d, d] (the reference's
    qjl_type=2 random-rotation mode, quantizers.h:644)."""
    rng = np.random.RandomState(seed)
    qm, r = np.linalg.qr(rng.randn(d, d))
    qm *= np.sign(np.diag(r))[None, :]
    return qm.astype(np.float32)


class ScalarQuantizer:
    """reference: impl/ScalarQuantizer.h:20. ``trained`` holds [vmin, vdiff]
    float32 [2, d] (per dimension) or [2, 1] (uniform types); the types
    without training hold zeros [2, 1] once trained."""

    QT_8bit = QuantizerType.QT_8bit
    QT_4bit = QuantizerType.QT_4bit
    QT_8bit_uniform = QuantizerType.QT_8bit_uniform
    QT_4bit_uniform = QuantizerType.QT_4bit_uniform
    QT_fp16 = QuantizerType.QT_fp16
    QT_8bit_direct = QuantizerType.QT_8bit_direct
    QT_6bit = QuantizerType.QT_6bit
    QT_bf16 = QuantizerType.QT_bf16
    QT_8bit_direct_signed = QuantizerType.QT_8bit_direct_signed
    QT_0bit = QuantizerType.QT_0bit
    QT_1bit_tqmse = QuantizerType.QT_1bit_tqmse
    QT_2bit_tqmse = QuantizerType.QT_2bit_tqmse
    QT_3bit_tqmse = QuantizerType.QT_3bit_tqmse
    QT_4bit_tqmse = QuantizerType.QT_4bit_tqmse
    QT_8bit_tqmse = QuantizerType.QT_8bit_tqmse
    QT_2bit_tq = QuantizerType.QT_2bit_tq
    QT_3bit_tq = QuantizerType.QT_3bit_tq
    QT_4bit_tq = QuantizerType.QT_4bit_tq
    QT_5bit_tq = QuantizerType.QT_5bit_tq
    RS_minmax = RangeStat.RS_minmax
    RS_meanstd = RangeStat.RS_meanstd
    RS_quantiles = RangeStat.RS_quantiles
    RS_optim = RangeStat.RS_optim

    def __init__(self, d: int, qtype: QuantizerType = QuantizerType.QT_8bit):
        self.d = int(d)
        self.qtype = QuantizerType(qtype)
        self.rangestat = RangeStat.RS_minmax
        self.rangestat_arg = 0.0
        self.tq_seed = 123  # QJL projection seed (TurboQuantRefine.seed)
        t = self.qtype
        self.bits = _BITS.get(t, 16 if t in (
            QuantizerType.QT_fp16, QuantizerType.QT_bf16) else 8)
        if t in (QuantizerType.QT_fp16, QuantizerType.QT_bf16):
            self.code_size = self.d * 2
        elif t in (QuantizerType.QT_8bit, QuantizerType.QT_8bit_uniform,
                   QuantizerType.QT_8bit_direct,
                   QuantizerType.QT_8bit_direct_signed,
                   QuantizerType.QT_8bit_tqmse):
            self.code_size = self.d
        elif t == QuantizerType.QT_0bit:
            self.bits = 0
            self.code_size = 0
        elif t in _TQMSE_BITS:
            self.bits = _TQMSE_BITS[t]
            self.code_size = self.bits * ((self.d + 7) // 8)
        elif t in _TQ_BITS:
            self.bits = _TQ_BITS[t]
            # the bit planes, then (norm, gamma) as two float32
            self.code_size = self.bits * ((self.d + 7) // 8) + 8
        else:
            self.code_size = (self.d * self.bits + 7) // 8
        self.trained: Optional[np.ndarray] = None
        self._needs_train = t in _BITS

    @property
    def is_trained(self) -> bool:
        return not self._needs_train or self.trained is not None

    # -- training (scalar_quantizer/training.cpp; faiss_tpu :229) -------------
    def train(self, x) -> None:
        """The range of each dimension (of all values for the uniform types)
        by ``rangestat``: min/max (also RS_optim), mean -/+ rangestat_arg
        (default 1) std, or the rangestat_arg (default 0.01) and 1 - arg
        quantiles; vdiff is at least 1e-20."""
        x = np.ascontiguousarray(x, np.float32)
        if not self._needs_train:
            self.trained = np.zeros((2, 1), np.float32)
            return
        uniform = self.qtype in _UNIFORM
        axis = None if uniform else 0
        if self.rangestat == RangeStat.RS_quantiles:
            lo = self.rangestat_arg if self.rangestat_arg > 0 else 0.01
            vmin = np.quantile(x, lo, axis=axis)
            vmax = np.quantile(x, 1 - lo, axis=axis)
        elif self.rangestat == RangeStat.RS_meanstd:
            arg = self.rangestat_arg if self.rangestat_arg > 0 else 1.0
            mean, std = x.mean(axis=axis), x.std(axis=axis)
            vmin, vmax = mean - arg * std, mean + arg * std
        else:
            vmin, vmax = x.min(axis=axis), x.max(axis=axis)
        vdiff = np.maximum(np.asarray(vmax) - np.asarray(vmin), 1e-20)
        self.trained = np.stack([
            np.broadcast_to(np.asarray(vmin, np.float32),
                            np.shape(vdiff)).reshape(-1),
            np.asarray(vdiff, np.float32).reshape(-1),
        ]).astype(np.float32)

    # -- codec (faiss_tpu :265-365) --------------------------------------------
    def _quantize_units(self, x) -> np.ndarray:
        """x -> integer levels [n, d] over the trained range."""
        vmin, vdiff = self.trained[0], self.trained[1]
        levels = 1 << self.bits
        q = np.floor((x - vmin) / vdiff * levels)
        return np.clip(q, 0, levels - 1).astype(np.uint8)

    def _dequantize_units(self, q) -> np.ndarray:
        """Levels -> the centres of their bins."""
        vmin, vdiff = self.trained[0], self.trained[1]
        levels = 1 << self.bits
        return ((q.astype(np.float32) + 0.5) / levels * vdiff + vmin).astype(
            np.float32)

    def compute_codes(self, x) -> np.ndarray:
        """uint8 codes [n, code_size]."""
        x = np.ascontiguousarray(x, np.float32)
        n = len(x)
        t = self.qtype
        if t == QuantizerType.QT_fp16:
            return x.astype(np.float16).view(np.uint8).reshape(n, -1)
        if t == QuantizerType.QT_bf16:
            return (x.view(np.uint32) >> 16).astype("<u2").view(
                np.uint8).reshape(n, -1)
        if t == QuantizerType.QT_8bit_direct:
            return np.clip(np.round(x), 0, 255).astype(np.uint8)
        if t == QuantizerType.QT_8bit_direct_signed:
            return (np.clip(np.round(x), -128, 127) + 128).astype(np.uint8)
        if t == QuantizerType.QT_0bit:
            return np.zeros((n, 0), np.uint8)
        if t in _TQMSE_BITS:
            nb = _TQMSE_BITS[t]
            _, b = lloyd_max_gaussian(nb)
            idx = np.searchsorted(b, x.ravel(), side="right").reshape(
                n, self.d).astype(np.uint8)
            return idx if nb == 8 else _pack_bit_planes(idx, nb)
        if t in _TQ_BITS:
            return self._encode_tq(x)
        q = self._quantize_units(x)
        if self.bits == 8:
            return q
        if self.bits == 4:  # two dimensions a byte, the even one low
            if self.d % 2:
                q = np.concatenate([q, np.zeros((n, 1), np.uint8)], 1)
            return (q[:, 0::2] | (q[:, 1::2] << 4)).astype(np.uint8)
        out = np.zeros((n, self.code_size), np.uint8)  # 6 bits, LSB first
        bit = 0
        for j in range(self.d):
            for b in range(6):
                byte, off = divmod(bit, 8)
                out[:, byte] |= (((q[:, j] >> b) & 1) << off).astype(np.uint8)
                bit += 1
        return out

    def decode(self, codes) -> np.ndarray:
        """float32 [n, d] of codes [n, code_size]."""
        codes = np.ascontiguousarray(codes, np.uint8)
        n = len(codes)
        t = self.qtype
        if t == QuantizerType.QT_fp16:
            return codes.view(np.float16).astype(np.float32).reshape(n, self.d)
        if t == QuantizerType.QT_bf16:
            u = codes.view("<u2").astype(np.uint32) << 16
            return u.view(np.float32).reshape(n, self.d)
        if t == QuantizerType.QT_8bit_direct:
            return codes.astype(np.float32).reshape(n, self.d)
        if t == QuantizerType.QT_8bit_direct_signed:
            return (codes.astype(np.float32) - 128).reshape(n, self.d)
        if t == QuantizerType.QT_0bit:
            return np.zeros((n, self.d), np.float32)
        if t in _TQMSE_BITS:
            nb = _TQMSE_BITS[t]
            c, _ = lloyd_max_gaussian(nb)
            idx = (codes.reshape(n, self.d) if nb == 8
                   else _unpack_bit_planes(codes, nb, self.d))
            return c[idx].astype(np.float32)
        if t in _TQ_BITS:
            return self._decode_tq(codes)
        if self.bits == 8:
            q = codes
        elif self.bits == 4:
            q = np.empty((n, self.d), np.uint8)
            q[:, 0::2] = codes[:, : (self.d + 1) // 2] & 0xF
            q[:, 1::2] = codes[:, : self.d // 2] >> 4
        else:
            q = np.zeros((n, self.d), np.uint8)
            bit = 0
            for j in range(self.d):
                for b in range(6):
                    byte, off = divmod(bit, 8)
                    q[:, j] |= ((codes[:, byte] >> off) & 1).astype(np.uint8) << b
                    bit += 1
        return self._dequantize_units(q.reshape(n, self.d))

    # -- full TurboQuant: (nb-1)-bit MSE + 1-bit QJL + per-row factors
    # (reference: QuantizerTurboQuantFull, scalar_quantizer/quantizers.h:409)
    def _encode_tq(self, x: np.ndarray) -> np.ndarray:
        n, d = len(x), self.d
        nb = _TQ_BITS[self.qtype]
        c, b = lloyd_max_gaussian(nb - 1)
        sqd = np.float32(np.sqrt(d))
        xn = np.maximum(np.linalg.norm(x, axis=1, keepdims=True),
                        1e-30).astype(np.float32)
        v = x / xn
        idx = np.searchsorted(b, (v * sqd).ravel(), side="right").reshape(
            n, d).astype(np.uint8)
        resid = v - c[idx] / sqd
        signs = (resid @ _tq_rotation(d, self.tq_seed).T) > 0
        gamma = np.linalg.norm(resid, axis=1).astype(np.float32)
        mse = _pack_bit_planes(idx, nb - 1)
        qjl = np.packbits(signs.astype(np.uint8), axis=1, bitorder="little")
        factors = np.stack([xn[:, 0], gamma], axis=1).astype(
            np.float32).view(np.uint8)
        return np.concatenate([mse, qjl, factors], axis=1)

    def _decode_tq(self, codes: np.ndarray) -> np.ndarray:
        n, d = len(codes), self.d
        nb = _TQ_BITS[self.qtype]
        pb = (d + 7) // 8
        c, _ = lloyd_max_gaussian(nb - 1)
        sqd = np.float32(np.sqrt(d))
        idx = _unpack_bit_planes(codes[:, : (nb - 1) * pb], nb - 1, d)
        qjl = np.unpackbits(codes[:, (nb - 1) * pb : nb * pb], axis=1,
                            bitorder="little")[:, :d].astype(np.float32)
        factors = np.ascontiguousarray(codes[:, nb * pb :]).view(np.float32)
        norm, gamma = factors[:, 0], factors[:, 1]
        out = c[idx].astype(np.float32) / sqd
        # the QJL estimator: sqrt(pi / 2) / d * gamma * sign(R r) R
        s = (qjl * 2.0 - 1.0) / sqd
        out = out + (np.sqrt(np.pi / 2.0) / d * gamma)[:, None] * (
            s @ _tq_rotation(d, self.tq_seed))
        return (out * norm[:, None]).astype(np.float32)
