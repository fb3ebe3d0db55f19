"""The per-probe IVF list scans (counterpart of faiss_tpu/ops/ivf_ops.py:32
and :124).

The inverted lists are padded dense tensors ``codes [nlist, max_len, ...]``
with per-list lengths; a probe step gathers each query's p-th list, scores
it (IVF-Flat: one batched float32 product; IVF-PQ: table gathers) and merges
it into the running top-k. A
Python loop over the nprobe axis takes the place of faiss_tpu's
``lax.scan``. Plain PyTorch: faiss_tpu runs this scan through XLA, not a
Pallas kernel. Slots are int32 positions; the index maps them to ids."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..metric import MetricType
from .topk import merge_topk

# Bytes of one probe's [rows, max_len, d] float32 gather: the queries are
# scanned in chunks of rows that keep it below this. The results do not
# depend on the chunking.
SCAN_GATHER_BYTES = 1 << 30


def ivf_flat_scan(
    xq: torch.Tensor,  # [nq, d] float32
    probes: torch.Tensor,  # [nq, nprobe] int (-1 = no probe)
    codes: torch.Tensor,  # [nlist, max_len, d] float32 padded lists
    slot_ids: torch.Tensor,  # [nlist, max_len] int32 (-1 on pads)
    lengths: torch.Tensor,  # [nlist] int
    k: int,
    metric: MetricType = MetricType.L2,
    code_norms: Optional[torch.Tensor] = None,  # [nlist, max_len] (L2)
    sel_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scan each query's probed lists: (dists [nq, k] float32, slots [nq, k]
    int32), best-first (smallest L2, largest inner product), +inf (-inf) and
    -1 where a query has fewer than k candidates. L2 distances are
    ``max(||q||^2 + ||c||^2 - 2 q.c, 0)``, with ``code_norms`` when given."""
    if sel_mask is not None:
        raise NotImplementedError("ID selectors are ROADMAP queue 1 item 1")
    nq, d = xq.shape
    max_len = codes.shape[1]
    rows = max(1, SCAN_GATHER_BYTES // max(1, max_len * d * 4))
    parts = [
        _scan_rows(xq[r : r + rows], probes[r : r + rows], codes, slot_ids,
                   lengths, k, metric, code_norms)
        for r in range(0, max(nq, 1), rows)
    ]
    return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])


def _scan_rows(xq, probes, codes, slot_ids, lengths, k, metric, code_norms):
    nq = xq.shape[0]
    largest = metric == MetricType.INNER_PRODUCT
    sentinel = float("-inf") if largest else float("inf")
    col = torch.arange(codes.shape[1], device=xq.device)
    x_norms = xq.square().sum(-1) if metric == MetricType.L2 else None
    vals = torch.full((nq, k), sentinel, device=xq.device)
    ids = torch.full((nq, k), -1, dtype=torch.int32, device=xq.device)
    for p in range(probes.shape[1]):
        ln = probes[:, p].long()
        safe = ln.clamp_min(0)
        cl = codes[safe]  # [nq, max_len, d]
        ip = torch.bmm(cl, xq[:, :, None])[:, :, 0]
        if metric == MetricType.L2:
            cn = code_norms[safe] if code_norms is not None else cl.square().sum(-1)
            dist = (x_norms[:, None] + cn - 2.0 * ip).clamp_min(0.0)
        else:
            dist = ip
        valid = (col[None, :] < lengths[safe][:, None]) & (ln[:, None] >= 0)
        dist = torch.where(valid, dist, sentinel)
        sl = torch.where(valid, slot_ids[safe], -1)
        vals, ids = merge_topk(vals, ids, dist, sl, k, largest=largest)
    return vals, ids


def ivf_pq_scan(
    luts: torch.Tensor,  # [nq, M, ksub] query-side ADC tables
    probes: torch.Tensor,  # [nq, nprobe] int (-1 = no probe)
    bias: torch.Tensor,  # [nq, nprobe] float32 per-(query, probe) term
    codes: torch.Tensor,  # [nlist, max_len, M] uint8 padded lists
    slot_ids: torch.Tensor,  # [nlist, max_len] int32 (-1 on pads)
    lengths: torch.Tensor,  # [nlist] int
    k: int,
    term2: Optional[torch.Tensor] = None,  # [nlist, M, ksub] list-side tables
) -> Tuple[torch.Tensor, torch.Tensor]:
    """IVF-PQ ADC scan of each query's probed lists (L2), the decomposition
    of IndexIVFPQ's precomputed tables (IndexIVFPQ.cpp:407):

        d(q, c + y) = bias[q, p] + sum_m (luts[q, m, y_m] + term2[c, m, y_m])

    with bias = ||q - c||^2, term2 = ||y_m||^2 + 2 c_m . y_m and luts =
    -2 q_m . y_m by residual, or bias = 0 and luts the full distance tables
    without. The M table entries are summed in order of m, then the bias
    added, as faiss_tpu does. Returns (dists [nq, k] float32 ascending,
    slots [nq, k] int32), +inf and -1 where a query has fewer than k
    candidates."""
    nq = luts.shape[0]
    max_len, M = codes.shape[1], codes.shape[2]
    rows = max(1, SCAN_GATHER_BYTES // max(1, max_len * M * 8))
    parts = [
        _pq_scan_rows(luts[r : r + rows], probes[r : r + rows],
                      bias[r : r + rows], codes, slot_ids, lengths, k, term2)
        for r in range(0, max(nq, 1), rows)
    ]
    return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])


def _pq_scan_rows(luts, probes, bias, codes, slot_ids, lengths, k, term2):
    nq = luts.shape[0]
    col = torch.arange(codes.shape[1], device=luts.device)
    vals = torch.full((nq, k), float("inf"), device=luts.device)
    ids = torch.full((nq, k), -1, dtype=torch.int32, device=luts.device)
    for p in range(probes.shape[1]):
        ln = probes[:, p].long()
        safe = ln.clamp_min(0)
        cl = codes[safe]  # [nq, max_len, M]
        tab = luts if term2 is None else luts + term2[safe]
        dist = torch.zeros(nq, codes.shape[1], device=luts.device)
        for m in range(codes.shape[2]):
            dist = dist + torch.gather(tab[:, m, :], 1, cl[:, :, m].long())
        dist = dist + bias[:, p, None]
        valid = (col[None, :] < lengths[safe][:, None]) & (ln[:, None] >= 0)
        dist = torch.where(valid, dist, float("inf"))
        sl = torch.where(valid, slot_ids[safe], -1)
        vals, ids = merge_topk(vals, ids, dist, sl, k, largest=False)
    return vals, ids
