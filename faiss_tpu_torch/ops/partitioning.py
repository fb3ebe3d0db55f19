"""Batched fuzzy partitioning and shifted histograms (counterpart of
faiss_tpu/ops/partitioning.py; reference: faiss/utils/partitioning.h:25
``partition_fuzzy``, :46 ``simd_histogram_8/16``).

One row per query. Each row's values map to unsigned keys whose order is the
values' order (the float sign flip; 16-bit integers biased into 16 bits;
other integers as int32 with the sign bit flipped), as faiss_tpu maps them.
faiss_tpu finds the q_min-th smallest key by a bitwise radix descent; here
``torch.kthvalue`` finds the same key. Ties at the threshold are admitted up
to q_max, and the row is reordered by a stable sort of its keep mask: the kept
elements first, then the tail, each in its original order. Plain PyTorch on
the index's device: faiss_tpu runs this through XLA, not a Pallas kernel."""

from __future__ import annotations

from typing import Optional

import torch

_SIGN = 0x80000000
_U32 = 0xFFFFFFFF
_FLOATS = (torch.float16, torch.bfloat16, torch.float32, torch.float64)


def _orderable_key(vals: torch.Tensor):
    """(keys int64 holding uint32 values whose order is the values' order,
    nbits): every key fits in the low nbits (faiss_tpu partitioning.py:31)."""
    if vals.dtype in _FLOATS:
        b = vals.to(torch.float32).view(torch.int32).to(torch.int64) & _U32
        return torch.where(b >= _SIGN, ~b & _U32, b | _SIGN), 32
    if vals.dtype == torch.uint8:
        return vals.to(torch.int64), 16
    if vals.dtype in (torch.int16, torch.int8):
        bias = 32768 if vals.dtype == torch.int16 else 128
        return vals.to(torch.int64) + bias, 16
    b = vals.to(torch.int32).to(torch.int64) & _U32
    return b ^ _SIGN, 32


def _decode_key(key: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The value of ``dtype`` whose key is ``key`` (int64 uint32 values)."""
    if dtype in _FLOATS:
        b = torch.where(key >= _SIGN, key ^ _SIGN, ~key & _U32)
        b = torch.where(b >= _SIGN, b - (1 << 32), b).to(torch.int32)
        return b.view(torch.float32).to(dtype)
    if dtype == torch.uint8:
        return key.to(dtype)
    if dtype in (torch.int16, torch.int8):
        bias = 32768 if dtype == torch.int16 else 128
        return (key - bias).to(dtype)
    b = key ^ _SIGN
    return torch.where(b >= _SIGN, b - (1 << 32), b).to(dtype)


def histogram_shifted(data: torch.Tensor, vmin, shift, nbins: int = 16
                      ) -> torch.Tensor:
    """Batched ``simd_histogram_8/16`` (faiss_tpu partitioning.py:58):
    ``data`` [..., n] integers, bin = (x - vmin) >> shift as a logical
    shift of the int32 difference; values outside [0, nbins) are ignored.
    Returns [..., nbins] int32 counts."""
    x = data.to(torch.int32)
    vmin = torch.as_tensor(vmin, device=x.device).to(torch.int32)
    shift = torch.as_tensor(shift, device=x.device).to(torch.int64)
    diff = (x - vmin).to(torch.int64) & _U32  # the int32 difference's bits
    bins = diff >> shift
    valid = bins < nbins
    onehot = (bins[..., None] == torch.arange(nbins, device=x.device)) & valid[..., None]
    return onehot.sum(dim=-2, dtype=torch.int32)


def partition_fuzzy(vals, ids: Optional[torch.Tensor] = None,
                    q_min: Optional[int] = None, q_max: Optional[int] = None, *,
                    keep_max: bool = False):
    """Batched fuzzy partition (faiss_tpu partitioning.py:124): each row of
    ``vals`` [..., n] reordered so its first q elements are all <= (>= with
    ``keep_max``) the rest, q in [q_min, q_max] chosen to take in the ties
    at the threshold. Returns (vals_out, ids_out or None, thresh [...],
    q_out [...] int32); the tail is kept, in its original order."""
    vals = torch.as_tensor(vals)
    if q_min is None:
        raise ValueError("q_min is required")
    if q_max is None:
        q_max = q_min
    n = vals.shape[-1]
    if not 0 < q_min <= q_max <= n:
        raise ValueError(f"need 0 < q_min <= q_max <= n, got {q_min},{q_max},{n}")
    keys, nbits = _orderable_key(vals)
    inv_mask = _U32 if nbits == 32 else (1 << nbits) - 1
    if keep_max:  # the q largest: reverse the key order within nbits
        keys = keys ^ inv_mask
    thresh_key = torch.kthvalue(keys, q_min, dim=-1, keepdim=True).values
    lt = keys < thresh_key
    is_eq = keys == thresh_key
    count_lt = lt.sum(-1, dtype=torch.int32)
    n_eq = is_eq.sum(-1, dtype=torch.int32)
    q_out = torch.clamp(count_lt + n_eq, q_min, q_max)
    tie_rank = torch.cumsum(is_eq.to(torch.int32), dim=-1) - 1
    keep = lt | (is_eq & (tie_rank < (q_out - count_lt)[..., None]))
    order = torch.sort((~keep).to(torch.uint8), dim=-1, stable=True).indices
    tk = thresh_key.squeeze(-1)
    if keep_max:
        tk = tk ^ inv_mask
    vals_out = torch.gather(vals, -1, order)
    ids_out = None
    if ids is not None:
        ids_out = torch.gather(torch.as_tensor(ids, device=vals.device), -1, order)
    return vals_out, ids_out, _decode_key(tk, vals.dtype), q_out
