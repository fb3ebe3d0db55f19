"""RaBitQ (counterpart of faiss_tpu/codecs/rabitq.py; reference:
faiss/impl/RaBitQuantizer.{h,cpp}, RaBitQuantizerMultiBit.{h,cpp}; Gao &
Long, SIGMOD'24).

Encoding of a residual x_r = x - c: rotate by a shared random orthogonal P
(``transforms._random_orthogonal``, seed 1234, faiss_tpu's matrix bit for
bit), keep the sign bits b = (P x_r > 0), o_bar = (2b - 1) / sqrt(d), and two
float32 factors |x_r| and f = <P x_r / |x_r|, o_bar>. The estimator:

    <q_r, x_r> ~= |x_r| <q_r, o_bar> / f,   |q - x|^2 ~= |q_r|^2 + |x_r|^2 - 2 est

The codecs are faiss_tpu's host numpy, copied. One step runs on the codec's
device: the multi-bit grid search for the scale t (``_optimal_t``), a [rows,
128, d] search that takes minutes in numpy at 1M rows; it sums in float64
in numpy's pairwise order (``_np_pairwise_sum``), so its result is the
numpy function's bit for bit."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..base import require_device
from ..transforms import _random_orthogonal


class RaBitQuantizer:
    """reference: impl/RaBitQuantizer.h:21 (one bit a dimension)."""

    def __init__(self, d: int, seed: int = 1234):
        self.d = int(d)
        # bits packed little-endian + two float32 factors (norm, f)
        self.code_size = (d + 7) // 8 + 8
        self.P = _random_orthogonal(d, d, seed)  # the shared rotation
        self.center: Optional[np.ndarray] = None  # [d] (flat: the mean)

    def train(self, x) -> None:
        self.center = np.ascontiguousarray(x, np.float32).mean(0)

    @property
    def is_trained(self) -> bool:
        return self.center is not None

    def encode_parts(self, x, centers=None) -> Tuple[np.ndarray, np.ndarray]:
        """(packed bits [n, d/8], factors [n, 2] = (|x_r|, f))."""
        x = np.ascontiguousarray(x, np.float32)
        c = self.center if centers is None else centers
        xr = (x - c) @ self.P.T
        norms = np.linalg.norm(xr, axis=1)
        safe = np.maximum(norms, 1e-20)
        signs = np.where(xr > 0, 1.0, -1.0).astype(np.float32)
        o_bar = signs / np.sqrt(self.d)
        f = (xr / safe[:, None] * o_bar).sum(1).astype(np.float32)
        f = np.where(np.abs(f) < 1e-6, 1e-6, f)
        bits = np.packbits(xr > 0, axis=1, bitorder="little")
        factors = np.stack([norms.astype(np.float32), f], axis=1)
        return bits, factors

    def compute_codes(self, x) -> np.ndarray:
        bits, factors = self.encode_parts(x)
        return np.concatenate([bits, factors.view(np.uint8)], axis=1)

    def decode(self, codes) -> np.ndarray:
        """|x_r| f o_bar rotated back, plus the center."""
        codes = np.ascontiguousarray(codes, np.uint8)
        nbytes = (self.d + 7) // 8
        bits = np.unpackbits(codes[:, :nbytes], axis=1, bitorder="little")[:, : self.d]
        factors = codes[:, nbytes:].copy().view(np.float32)
        o_bar = (2.0 * bits - 1.0) / np.sqrt(self.d)
        xr = o_bar * (factors[:, 0] * factors[:, 1])[:, None]
        return (xr @ self.P + self.center).astype(np.float32)

    def rotate_queries(self, xq, centers=None) -> Tuple[np.ndarray, np.ndarray]:
        """(q_r [nq, d], |q_r|^2 [nq])."""
        c = self.center if centers is None else centers
        qr = (np.ascontiguousarray(xq, np.float32) - c) @ self.P.T
        return qr.astype(np.float32), (qr**2).sum(1).astype(np.float32)


def quantize_query_sq(qr: np.ndarray, qb: int, centered: bool = False):
    """qb-bit scalar quantize-dequantize of rotated queries (faiss_tpu
    rabitq.py:89; RaBitQDistanceComputerQ, RaBitQuantizer.cpp:439): the
    integer-domain estimate of the reference equals the float product with
    the dequantized query. ``centered``: the zero-symmetric range."""
    if qb <= 0:
        return qr
    levels = float((1 << int(qb)) - 1)
    qr = np.ascontiguousarray(qr, np.float32)
    if centered:
        amax = np.maximum(np.abs(qr).max(1, keepdims=True), 1e-20)
        u = np.round((qr + amax) / (2.0 * amax) * levels)
        return (u * (2.0 * amax / levels) - amax).astype(np.float32)
    lo = qr.min(1, keepdims=True)
    step = np.maximum(qr.max(1, keepdims=True) - lo, 1e-20) / levels
    return (np.round((qr - lo) / step) * step + lo).astype(np.float32)


def quantize_query_sq_dev(q: torch.Tensor, qb: int, centered: bool = False):
    """:func:`quantize_query_sq`'s arithmetic on device rows (faiss_tpu
    models/rabitq.py:380-397, the IVF scan's quantized ``P q``)."""
    if qb <= 0:
        return q
    levels = float((1 << int(qb)) - 1)
    if centered:
        amax = q.abs().amax(1, keepdim=True).clamp_min(1e-20)
        u = torch.round((q + amax) / (2.0 * amax) * levels)
        return u * (2.0 * amax / levels) - amax
    lo = q.amin(1, keepdim=True)
    step = (q.amax(1, keepdim=True) - lo).clamp_min(1e-20) / levels
    return torch.round((q - lo) / step) * step + lo


def _np_pairwise_sum(a: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in numpy's order for a contiguous float
    reduction (pairwise_sum: 8 running sums up to 128 elements, halves above
    at multiples of 8), so float64 sums equal numpy's bit for bit."""
    n = a.shape[-1]
    if n < 8:
        res = torch.zeros(a.shape[:-1], dtype=a.dtype, device=a.device)
        for i in range(n):
            res = res + a[..., i]
        return res
    if n <= 128:
        n8 = n - n % 8
        r = a[..., 0:8]
        for i in range(8, n8, 8):
            r = r + a[..., i : i + 8]
        res = ((r[..., 0] + r[..., 1]) + (r[..., 2] + r[..., 3])) + (
            (r[..., 4] + r[..., 5]) + (r[..., 6] + r[..., 7]))
        for i in range(n8, n):
            res = res + a[..., i]
        return res
    n2 = n // 2
    n2 -= n2 % 8
    return _np_pairwise_sum(a[..., :n2]) + _np_pairwise_sum(a[..., n2:])


class MultiBitRaBitQ:
    """Multi-bit RaBitQ (reference: impl/RaBitQuantizerMultiBit.{h,cpp};
    faiss_tpu rabitq.py:113): per rotated dimension a sign bit and
    nb_bits - 1 magnitude bits on the ladder u = code - (2^nb - 1) / 2,
    scaled per vector by t, found by a 128-point grid search over faiss_tpu's
    [t_start, t_end]. Factors per code: L2 (f_add = |r|^2, f_rescale =
    -2 |r| / ipnorm), IP (<c, r>, |r| / ipnorm); the estimator is base(q) +
    f_add + f_rescale <P(q - c), u>."""

    TIGHT_START = [0.0, 0.15, 0.20, 0.52, 0.59, 0.71, 0.75, 0.77, 0.81]
    T_GRID = 128
    # rows of one grid-search tile [rows, T_GRID, d] (float64 sums)
    T_TILE = 1 << 25

    def __init__(self, d: int, nb_bits: int, seed: int = 1234, *, device="cuda"):
        if not 2 <= nb_bits <= 9:
            raise ValueError("multi-bit RaBitQ needs nb_bits in [2, 9]")
        self.d = int(d)
        self.nb_bits = int(nb_bits)
        self.ex_bits = nb_bits - 1
        self.device = require_device(device)
        self.P = _random_orthogonal(d, d, seed)
        self.center: Optional[np.ndarray] = None
        self.code_size = (d * nb_bits + 7) // 8 + 8

    def train(self, x) -> None:
        self.center = np.ascontiguousarray(x, np.float32).mean(0)

    @property
    def is_trained(self) -> bool:
        return self.center is not None

    def _optimal_t(self, o_abs: np.ndarray) -> np.ndarray:
        """The per-row grid search of faiss_tpu (rabitq.py:154) on the
        device: the same float32 products and float64 sums in numpy's order,
        the first grid point of the largest num / den."""
        eps = 1e-5
        max_code = (1 << self.ex_bits) - 1
        max_o = np.maximum(o_abs.max(1), 1e-20)
        t_end = (max_code + 10) / max_o
        t_start = t_end * self.TIGHT_START[self.ex_bits]
        grid = np.linspace(0.0, 1.0, self.T_GRID, dtype=np.float32)
        out = np.empty(len(o_abs), np.float32)
        chunk = max(1, self.T_TILE // (self.T_GRID * o_abs.shape[1]))
        for s in range(0, len(o_abs), chunk):
            sl = slice(s, s + chunk)
            ts = t_start[sl, None] + (t_end - t_start)[sl, None] * grid[None, :]
            oa = torch.from_numpy(np.ascontiguousarray(o_abs[sl])).to(self.device)
            tc = torch.from_numpy(ts).to(self.device)
            mag = ((tc[:, :, None] * oa[:, None, :] + eps).to(torch.int32)
                   ).clamp_max(max_code)
            num = _np_pairwise_sum((mag.double() + 0.5) * oa[:, None, :].double())
            den = torch.sqrt(oa.shape[1] * 0.25
                             + (mag.long() * (mag.long() + 1)).sum(-1).double())
            best = torch.argmax(num / den, dim=1)
            out[s : s + chunk] = torch.gather(tc, 1, best[:, None])[:, 0].cpu().numpy()
        return out

    def encode_parts(self, x, centers=None, metric="L2"):
        """(codes [n, d] uint8 sign + magnitude, factors [n, 2])."""
        x = np.ascontiguousarray(x, np.float32)
        c = self.center if centers is None else centers
        r = x - c
        xr = r @ self.P.T
        norm = np.linalg.norm(xr, axis=1)
        ok = norm > 1e-10
        o = xr / np.maximum(norm, 1e-20)[:, None]
        o_abs = np.abs(o)
        t = self._optimal_t(o_abs)
        max_code = (1 << self.ex_bits) - 1
        mag = np.minimum((t[:, None] * o_abs + 1e-5).astype(np.int32), max_code)
        ipnorm = ((mag + 0.5) * o_abs).sum(1)
        # a negative dimension flips the magnitude: code = sign * 2^ex + mag'
        # lands on the symmetric ladder (RaBitQuantizerMultiBit.cpp:305)
        neg = xr < 0
        magf = np.where(neg, max_code - mag, mag)
        codes = (np.where(neg, 0, 1 << self.ex_bits) + magf).astype(self._code_dtype)
        with np.errstate(divide="ignore", invalid="ignore"):
            inv = 1.0 / ipnorm
        inv = np.where(np.isfinite(inv) & ok, inv, 0.0)
        if metric == "L2":
            f_add = norm * norm
            f_rescale = -2.0 * norm * inv
        else:
            f_add = (r * np.asarray(np.broadcast_to(c, r.shape))).sum(1)
            f_rescale = norm * inv
        factors = np.stack([np.where(ok, f_add, 0.0), np.where(ok, f_rescale, 0.0)],
                           axis=1).astype(np.float32)
        return codes, factors

    @property
    def _code_dtype(self):
        """uint8, or uint16 for 9 bits (faiss_tpu keeps uint8 there, whose
        codes wrap: ROADMAP queue 3)."""
        return np.uint8 if self.nb_bits <= 8 else np.uint16

    def u_values(self, codes: np.ndarray) -> np.ndarray:
        """Codes -> the symmetric ladder values u [n, d] float32."""
        return codes.astype(np.float32) - ((1 << self.nb_bits) - 1) / 2.0

    def implied_vectors(self, codes, factors, metric="L2") -> np.ndarray:
        """y such that the estimator is base(q) + f_add -/+ 2 <q - c, y>:
        the scaled, back-rotated ladder vector."""
        scale = -0.5 * factors[:, 1] if metric == "L2" else factors[:, 1]
        return (self.u_values(codes) * scale[:, None]) @ self.P

    def decode(self, codes, factors, centers=None, metric="L2") -> np.ndarray:
        c = self.center if centers is None else centers
        return (self.implied_vectors(codes, factors, metric) + c).astype(np.float32)

    def rotate_queries(self, xq, centers=None):
        c = self.center if centers is None else centers
        qr = (np.ascontiguousarray(xq, np.float32) - c) @ self.P.T
        return qr.astype(np.float32), (qr**2).sum(1).astype(np.float32)

    # -- packed bytes (faiss_tpu's own bit layout) ------------------------------
    def pack(self, codes: np.ndarray, factors: np.ndarray) -> np.ndarray:
        n = len(codes)
        nbytes = (self.d * self.nb_bits + 7) // 8
        c = np.ascontiguousarray(codes, self._code_dtype).astype("<u2")
        bits = np.unpackbits(c.view(np.uint8).reshape(n, self.d, 2), axis=2,
                             bitorder="little")[:, :, : self.nb_bits]
        packed = np.packbits(bits.reshape(n, -1), axis=1, bitorder="little")
        out = np.zeros((n, self.code_size), np.uint8)
        out[:, :nbytes] = packed[:, :nbytes]
        out[:, nbytes:] = factors.astype(np.float32).view(np.uint8)
        return out

    def unpack(self, data: np.ndarray):
        n = len(data)
        nbytes = (self.d * self.nb_bits + 7) // 8
        bits = np.unpackbits(data[:, :nbytes], axis=1, bitorder="little")[
            :, : self.d * self.nb_bits].reshape(n, self.d, self.nb_bits)
        weights = (1 << np.arange(self.nb_bits)).astype(np.int64)
        codes = (bits.astype(np.int64) * weights).sum(-1).astype(self._code_dtype)
        factors = np.ascontiguousarray(data[:, nbytes:]).view(np.float32).reshape(n, 2)
        return codes, factors
