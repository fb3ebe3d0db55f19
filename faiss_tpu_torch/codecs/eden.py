"""EDEN quantizer: per-vector-scaled Lloyd-Max scalar codes (counterpart of
faiss_tpu/codecs/eden.py; reference: faiss/impl/EDENQuantizer.{h,cpp}).

  r          = x - centroid
  normalized = r * sqrt(d) / ||r||
  code[j]    = LloydMax_assign(normalized[j])       (unit-Gaussian codebook)
  q          = LloydMax_centroids[code]
  UNBIASED:  scale = ||r||^2 / <q, r>,  l2_norm_term = ||r||^2
  BIASED:    scale = <q, r> / ||q||^2,  l2_norm_term = scale^2 ||q||^2
  decode     = centroid + scale * q
  L2 dist    = ||query - centroid||^2 + l2_norm_term
               - 2 scale <query - centroid, q>

The Lloyd-Max tables of N(0, 1) are computed on the host at first use by the
same fixed point as faiss_tpu's (a copy of it: equal bit for bit). Encoding
runs on the quantizer's device in float64 where faiss_tpu's host numpy does,
in chunks of rows; decoding is a table gather times the scale in float32.
The packed byte format of ``sa_encode`` is faiss_tpu's: the codes'
bitstring big-endian, then the two float32 factors."""

from __future__ import annotations

import functools
import math
from enum import IntEnum
from typing import Optional, Tuple

import numpy as np
import torch

# rows a device encode chunk holds ([rows, d] float64 transients)
ENCODE_ROWS = 1 << 18


class EDENScaleType(IntEnum):
    """reference: impl/EDENQuantizer.h:21."""

    UNBIASED = 1
    BIASED = 2


@functools.lru_cache(maxsize=None)
def lloyd_max_gaussian(bits: int) -> Tuple[np.ndarray, np.ndarray]:
    """The MSE-optimal scalar quantizer of N(0, 1): (centroids [2^bits],
    boundaries [2^bits - 1]) float32, by the Lloyd-Max fixed point from
    Gaussian quantiles (faiss_tpu codecs/eden.py:48)."""
    if not 1 <= bits <= 8:
        raise ValueError("EDEN supports 1..8 bits")
    k = 1 << bits
    from math import erf, sqrt

    def cdf(t):
        return 0.5 * (1.0 + erf(t / sqrt(2.0)))

    def pdf(t):
        return math.exp(-0.5 * t * t) / sqrt(2.0 * math.pi)

    c = np.array(
        [_gaussian_quantile((i + 0.5) / k) for i in range(k)], np.float64
    )
    for _ in range(200):
        b = 0.5 * (c[:-1] + c[1:])
        edges = np.concatenate([[-np.inf], b, [np.inf]])
        new_c = np.empty_like(c)
        for i in range(k):
            lo, hi = edges[i], edges[i + 1]
            plo = 0.0 if lo == -np.inf else pdf(lo)
            phi = 0.0 if hi == np.inf else pdf(hi)
            clo = 0.0 if lo == -np.inf else cdf(lo)
            chi = 1.0 if hi == np.inf else cdf(hi)
            new_c[i] = (plo - phi) / max(chi - clo, 1e-300)
        if np.max(np.abs(new_c - c)) < 1e-12:
            c = new_c
            break
        c = new_c
    b = 0.5 * (c[:-1] + c[1:])
    return c.astype(np.float32), b.astype(np.float32)


def _gaussian_quantile(p: float) -> float:
    """The p-quantile of N(0, 1) by 80 bisection steps over [-10, 10]."""
    lo, hi = -10.0, 10.0
    from math import erf, sqrt

    for _ in range(80):
        mid = 0.5 * (lo + hi)
        if 0.5 * (1.0 + erf(mid / sqrt(2.0))) < p:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


class EDENQuantizer:
    """The EDEN codec on ``device``: codes unpacked ([n, d] uint8) with the
    per-vector factors [n, 2] = (l2_norm_term, scale) float32; ``pack`` /
    ``unpack`` give faiss_tpu's byte format (host numpy)."""

    def __init__(self, d: int, nb_bits: int = 1,
                 scale_type: EDENScaleType = EDENScaleType.UNBIASED, *,
                 device="cuda"):
        self.d = int(d)
        self.nb_bits = int(nb_bits)
        self.scale_type = EDENScaleType(scale_type)
        self.device = torch.device(device)
        self.centroids, self.boundaries = lloyd_max_gaussian(self.nb_bits)
        self._cent_dev = torch.from_numpy(self.centroids).to(self.device)
        self._bound_dev = torch.from_numpy(self.boundaries).to(self.device).double()
        self.packed_size = (self.d * self.nb_bits + 7) // 8
        self.code_size = self.packed_size + 8  # + 2 float32 factors

    def encode(self, x: torch.Tensor, centroid: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x [n, d] float32 on the device (and a centroid [d] or [n, d]) ->
        (codes [n, d] uint8, factors [n, 2] float32), in row chunks."""
        x = torch.as_tensor(x, device=self.device).float()
        codes, factors = [], []
        for s in range(0, len(x), ENCODE_ROWS):
            c = centroid
            if c is not None and c.dim() == 2:
                c = c[s : s + ENCODE_ROWS]
            out = self._encode_rows(x[s : s + ENCODE_ROWS], c)
            codes.append(out[0])
            factors.append(out[1])
        if not codes:
            return (torch.empty(0, self.d, dtype=torch.uint8, device=self.device),
                    torch.empty(0, 2, device=self.device))
        return torch.cat(codes), torch.cat(factors)

    def _encode_rows(self, x, centroid):
        r = x if centroid is None else x - centroid.float()
        norm2 = r.double().square().sum(1)
        ok = norm2 > float(np.finfo(np.float32).eps)
        inv = torch.where(ok, 1.0 / norm2.clamp_min(1e-300).sqrt(), 0.0)
        normalized = r.double() * (math.sqrt(self.d) * inv)[:, None]
        codes = torch.searchsorted(self._bound_dev, normalized).to(torch.uint8)
        q = self._cent_dev[codes.long()].double()
        cip = (q * r.double()).sum(1)
        cn2 = q.square().sum(1)
        if self.scale_type == EDENScaleType.BIASED:
            scale = cip / cn2
            l2 = scale * scale * cn2
        else:
            scale = norm2 / cip
            l2 = norm2
        bad = ~(torch.isfinite(scale) & ok)
        scale = torch.where(bad, 0.0, scale)
        l2 = torch.where(bad, 0.0, l2)
        return codes, torch.stack([l2, scale], 1).float()

    def scaled(self, codes: torch.Tensor, factors: torch.Tensor) -> torch.Tensor:
        """y = scale * q [n, d] float32: the decoded residuals."""
        return self._cent_dev[codes.long()] * factors[:, 1:2]

    def decode(self, codes: torch.Tensor, factors: torch.Tensor,
               centroid: Optional[torch.Tensor] = None) -> torch.Tensor:
        out = self.scaled(codes, factors)
        return out if centroid is None else out + centroid

    # -- packed byte format (faiss_tpu codecs/eden.py:172-186) ---------------
    def pack(self, codes: np.ndarray, factors: np.ndarray) -> np.ndarray:
        codes = np.asarray(codes, np.uint8)
        n = len(codes)
        bits = np.unpackbits(codes[:, :, None], axis=2, count=8,
                             bitorder="big")[:, :, 8 - self.nb_bits :]
        packed = np.packbits(bits.reshape(n, -1), axis=1,
                             bitorder="big")[:, : self.packed_size]
        out = np.zeros((n, self.code_size), np.uint8)
        out[:, : self.packed_size] = packed
        out[:, self.packed_size :] = np.asarray(factors, np.float32).view(np.uint8)
        return out

    def unpack(self, data: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        data = np.ascontiguousarray(data, np.uint8)
        n = len(data)
        bits = np.unpackbits(data[:, : self.packed_size], axis=1, bitorder="big")[
            :, : self.d * self.nb_bits].reshape(n, self.d, self.nb_bits)
        weights = (1 << np.arange(self.nb_bits - 1, -1, -1)).astype(np.int64)
        codes = (bits.astype(np.int64) * weights).sum(-1).astype(np.uint8)
        factors = np.ascontiguousarray(data[:, self.packed_size :]).view(
            np.float32).reshape(n, 2)
        return codes, factors
