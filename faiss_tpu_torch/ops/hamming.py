"""Hamming distances over bit codes (counterpart of faiss_tpu/ops/hamming.py;
reference: faiss/utils/hamming.{h,cpp}).

Binary vectors are uint8 rows of d / 8 bytes, bit i of a row being bit
i % 8 of byte i // 8 (numpy's ``bitorder="little"``). torch has no
population count, so the port counts bits two ways, both exact and equal
to ``np.unpackbits`` counts bit for bit:

  - ``swar``: the rows as little-endian int32 words, XOR, then a SWAR bit
    count (shifts, masks and adds; ``>>`` on int32 is arithmetic, so every
    shift is masked) summed over the words, in tiles of [queries, columns,
    words] held under ``SWAR_TILE`` elements;
  - ``product``: the rows unpacked to 0/1 int8 bits, and
    |a| + |b| - 2 a . b with the dot products from one int8 matrix product
    with int32 sums (``torch._int_mm``, the tensor cores' int8 rate on the
    card), in column chunks.

The k-NN searches take the product: 18x faster than SWAR on an H100 for
8192 queries over 1M codes of 256 bits (chip_smoke phase J6). SWAR serves
the scans that gather each query's own rows (IndexBinaryIVF's probes,
IVF-PQ's polysemous filter) and the range search's tiles.

Plain PyTorch: faiss_tpu computes these with XLA, not a Pallas kernel."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .topk import merge_topk

# elements of one SWAR tile [nq, columns, words]
SWAR_TILE = 1 << 26
# columns of one chunk of the product route
PRODUCT_CHUNK = 1 << 16
# "no result" distance of the binary indexes (faiss_tpu models/binary.py:57)
HAMMING_MISSING = 2**31 - 1

_M1, _M2, _M4 = 0x55555555, 0x33333333, 0x0F0F0F0F


def pack_bits(x: np.ndarray) -> np.ndarray:
    """float/bool [n, d] -> uint8 codes [n, d/8] (sign/threshold packing)."""
    return np.packbits(np.asarray(x) > 0, axis=1, bitorder="little")


def pack_bits_tensor(bits: torch.Tensor) -> torch.Tensor:
    """bool [n, nbits] -> uint8 [n, ceil(nbits / 8)], bit i at bit i % 8 of
    byte i // 8 (``np.packbits(..., bitorder="little")`` on the device)."""
    n, nbits = bits.shape
    pad = (-nbits) % 8
    b = bits.to(torch.int32)
    if pad:
        b = torch.cat([b, b.new_zeros(n, pad)], dim=1)
    weights = 1 << torch.arange(8, dtype=torch.int32, device=bits.device)
    return (b.reshape(n, -1, 8) * weights).sum(-1).to(torch.uint8)


def to_words(codes: torch.Tensor) -> torch.Tensor:
    """uint8 [n, nbytes] -> int32 words [n, ceil(nbytes / 4)], little-endian,
    the last word zero-padded (faiss_tpu :27)."""
    n, nbytes = codes.shape
    pad = (-nbytes) % 4
    if pad:
        codes = torch.cat(
            [codes, codes.new_zeros(n, pad)], dim=1)
    c = codes.to(torch.int32).reshape(n, -1, 4)
    return c[..., 0] | (c[..., 1] << 8) | (c[..., 2] << 16) | (c[..., 3] << 24)


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Bits set in each int32 (SWAR; each shift masked, as ``>>`` keeps the
    sign)."""
    x = x - ((x >> 1) & _M1)
    x = (x & _M2) + ((x >> 2) & _M2)
    x = (x + (x >> 4)) & _M4
    x = x + (x >> 8)
    x = x + (x >> 16)
    return x & 0x3F


def hamming_words(qw: torch.Tensor, bw: torch.Tensor) -> torch.Tensor:
    """[nq, w] x [nb, w] int32 words -> [nq, nb] int32 Hamming distances
    (faiss_tpu :37), in tiles of at most SWAR_TILE elements."""
    nq, w = qw.shape
    cols = max(1, SWAR_TILE // max(1, nq * w))
    out = torch.empty(nq, bw.shape[0], dtype=torch.int32, device=qw.device)
    for c0 in range(0, bw.shape[0], cols):
        x = qw[:, None, :] ^ bw[None, c0 : c0 + cols, :]
        out[:, c0 : c0 + cols] = popcount32(x).sum(-1, dtype=torch.int32)
    return out


def unpack_bits(codes: torch.Tensor) -> torch.Tensor:
    """uint8 [n, nbytes] -> 0/1 int8 [n, 8 * nbytes], bit i of the row at
    column i."""
    shifts = torch.arange(8, dtype=torch.uint8, device=codes.device)
    bits = (codes[:, :, None] >> shifts) & 1
    return bits.reshape(codes.shape[0], -1).to(torch.int8)


def code_bits(codes: torch.Tensor, nbits: int) -> torch.Tensor:
    """Integer codes [n, M] of ``nbits`` bits each -> 0/1 int8
    [n, M * nbits], the bits of code m at columns m * nbits.. (least
    significant first): the Hamming distance of two rows is the sum over m
    of popcount(a_m ^ b_m)."""
    shifts = torch.arange(nbits, dtype=torch.int32, device=codes.device)
    bits = (codes.to(torch.int32)[:, :, None] >> shifts) & 1
    return bits.reshape(codes.shape[0], -1).to(torch.int8)


def _pad_to(t: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    if t.shape == (rows, cols):
        return t.contiguous()
    out = t.new_zeros(rows, cols)
    out[: t.shape[0], : t.shape[1]] = t
    return out


def hamming_product(qbits: torch.Tensor, bbits: torch.Tensor) -> torch.Tensor:
    """[nq, nbit] x [nb, nbit] 0/1 int8 -> [nq, nb] int32 Hamming distances
    |a| + |b| - 2 a . b, the dot products from one int8 product with int32
    sums. The operands are zero-padded to the product's shape rules (rows
    above 16 and sizes that are multiples of 8), which adds no bit."""
    nq, nbit = qbits.shape
    nb = bbits.shape[0]
    m = max(32, -(-nq // 8) * 8)
    kk = -(-nbit // 8) * 8
    n = -(-nb // 8) * 8
    dot = torch._int_mm(_pad_to(qbits, m, kk), _pad_to(bbits, n, kk).T.contiguous())
    na = qbits.sum(1, dtype=torch.int32)
    nbb = bbits.sum(1, dtype=torch.int32)
    return na[:, None] + nbb[None, :] - 2 * dot[:nq, :nb]


def hamming_knn(
    xq: torch.Tensor,  # [nq, nbytes] uint8
    xb: torch.Tensor,  # [nb, nbytes] uint8
    k: int,
    method: str = "product",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """k-NN under Hamming distance (faiss_tpu :48, hammings_knn_hc): exact
    ``torch.topk`` per column chunk and a merge. Returns (dists int32
    [nq, k], ids int64 [nq, k]), HAMMING_MISSING and -1 past nb. Among
    equal distances the order is the select's."""
    nq, nb = xq.shape[0], xb.shape[0]
    kk = min(k, nb)
    vals = torch.full((nq, kk), HAMMING_MISSING, dtype=torch.int32, device=xq.device)
    ids = torch.full((nq, kk), -1, dtype=torch.int64, device=xq.device)
    if method == "swar":
        qw, chunk = to_words(xq), 1 << 20
    elif method == "product":
        qb, chunk = unpack_bits(xq), PRODUCT_CHUNK
    else:
        raise ValueError(f"unknown Hamming method {method!r}")
    for c0 in range(0, nb, chunk):
        cb = xb[c0 : c0 + chunk]
        d = (hamming_words(qw, to_words(cb)) if method == "swar"
             else hamming_product(qb, unpack_bits(cb)))
        v, pos = torch.topk(d, min(kk, d.shape[1]), dim=1, largest=False)
        vals, ids = merge_topk(vals, ids, v, pos + c0, kk, largest=False)
    if kk < k:
        vals = torch.cat([vals, vals.new_full((nq, k - kk), HAMMING_MISSING)], 1)
        ids = torch.cat([ids, ids.new_full((nq, k - kk), -1)], 1)
    return vals, ids


def hamming_knn_host(xq: np.ndarray, xb: np.ndarray, k: int, *, device,
                     method: str = "product"):
    """Host API: uint8 codes in, (int32 dists, int64 ids) out, computed on
    ``device``."""
    qd = torch.from_numpy(np.ascontiguousarray(xq, np.uint8)).to(device)
    bd = torch.from_numpy(np.ascontiguousarray(xb, np.uint8)).to(device)
    d, i = hamming_knn(qd, bd, k, method)
    return d.cpu().numpy(), i.cpu().numpy()
