"""The per-probe IVF list scans (counterpart of faiss_tpu/ops/ivf_ops.py:32
and :124).

IVF-Flat's inverted lists are padded dense tensors ``codes [nlist, max_len,
d]`` with per-list lengths, scored by L2, inner product or an extra metric
(elementwise over the gathered rows, exactly: faiss_tpu scores every metric
but L2 as an inner product there, ROADMAP queue 3); IVF-PQ's are one CSR, a :class:`RaggedLists`
(an IMI's 2^20 skewed lists would not fit padded). A probe step gathers
each query's p-th list, scores it (IVF-Flat: one batched float32 product;
IVF-PQ: table gathers, over the lists padded only to the longest list of
that step; 1-bit RaBitQ: the list's sign bits unpacked, one batched product
with the rotated queries and the estimator) and merges it into the running
top-k. A Python loop over the
nprobe axis takes the place of faiss_tpu's ``lax.scan``. Plain PyTorch:
faiss_tpu runs this scan through XLA, not a Pallas kernel. Slots are int32
positions; the index maps them to ids."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..metric import MetricType, is_similarity_metric
from .distances import _metric_reduce
from .hamming import popcount32
from .topk import merge_topk

# Bytes of one probe's [rows, max_len, d] float32 gather: the queries are
# scanned in chunks of rows that keep it below this. The results do not
# depend on the chunking.
SCAN_GATHER_BYTES = 1 << 30


class RaggedLists:
    """The inverted lists as one CSR: ``codes`` [n, ...] and ``slot_ids``
    [n] int32 in list order (add order within a list), each list's
    ``offsets`` and ``lengths`` [nlist] int64. ``shape`` is (nlist, max_len,
    code width), max_len the longest list padded to 128, by which the scans
    size their query chunks."""

    def __init__(self, codes, slot_ids, offsets, lengths, max_len: int):
        self.codes, self.slot_ids = codes, slot_ids
        self.offsets, self.lengths = offsets, lengths
        self.shape = (len(lengths), int(max_len)) + tuple(codes.shape[1:])

    def step(self, ln, sel_mask=None):
        """One probe step over each query's list ``ln`` (-1 = no probe):
        (codes [nq, W, ...], zeros past the list's length; valid [nq, W]
        bool; slots [nq, W] int32, -1 where not valid), W the longest of
        these lists (at least 1); with ``sel_mask`` the slots that the ID
        selector clears are not valid."""
        safe = ln.clamp_min(0)
        length = torch.where(ln >= 0, self.lengths[safe], 0)
        width = max(1, int(length.max())) if len(ln) else 1
        col = torch.arange(width, device=ln.device)
        valid = col[None, :] < length[:, None]
        rows = torch.where(valid, self.offsets[safe][:, None] + col[None, :], 0)
        shape = valid.shape + (1,) * (self.codes.dim() - 1)
        codes = torch.where(valid.view(shape), self.codes[rows], 0)
        sl = self.slot_ids[rows]
        if sel_mask is not None:
            valid = valid & sel_mask[sl.clamp_min(0).long()]
        return codes, valid, torch.where(valid, sl, -1)


def ivf_flat_scan(
    xq: torch.Tensor,  # [nq, d] float32
    probes: torch.Tensor,  # [nq, nprobe] int (-1 = no probe)
    codes: torch.Tensor,  # [nlist, max_len, d] float32 padded lists
    slot_ids: torch.Tensor,  # [nlist, max_len] int32 (-1 on pads)
    lengths: torch.Tensor,  # [nlist] int
    k: int,
    metric: MetricType = MetricType.L2,
    code_norms: Optional[torch.Tensor] = None,  # [nlist, max_len] (L2)
    sel_mask: Optional[torch.Tensor] = None,  # [ntotal] bool over slots
    metric_arg: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scan each query's probed lists: (dists [nq, k] float32, slots [nq, k]
    int32), best-first (smallest distance, largest similarity), +inf (-inf)
    and -1 where a query has fewer than k candidates. L2 distances are
    ``max(||q||^2 + ||c||^2 - 2 q.c, 0)``, with ``code_norms`` when given.
    ``sel_mask`` (an ID selector over slots) drops the slots it clears."""
    nq, d = xq.shape
    max_len = codes.shape[1]
    # an extra metric's elementwise terms are a few gathers' size each
    extra = metric not in (MetricType.L2, MetricType.INNER_PRODUCT)
    rows = max(1, SCAN_GATHER_BYTES // max(1, max_len * d * (16 if extra else 4)))
    parts = [
        _scan_rows(xq[r : r + rows], probes[r : r + rows], codes, slot_ids,
                   lengths, k, metric, code_norms, sel_mask, metric_arg)
        for r in range(0, max(nq, 1), rows)
    ]
    return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])


def probe_slots(ln, slot_ids, lengths, sel_mask=None):
    """(valid [nq, max_len] bool, slots [nq, max_len] int32 with -1 where
    not valid) of one probe step over the padded layout: the slots of each
    query's list ``ln`` (-1 = no probe) within the list's length and, with
    ``sel_mask``, kept by the ID selector."""
    safe = ln.clamp_min(0)
    col = torch.arange(slot_ids.shape[1], device=ln.device)
    valid = (col[None, :] < lengths[safe][:, None]) & (ln[:, None] >= 0)
    sl = slot_ids[safe]
    if sel_mask is not None:
        valid = valid & sel_mask[sl.clamp_min(0).long()]
    return valid, torch.where(valid, sl, -1)


def flat_probe_dists(xq, ln, codes, metric, x_norms=None, code_norms=None,
                     metric_arg=0.0):
    """[nq, max_len] distances of each query to every slot of its list
    ``ln`` (pads and -1 probes included; probe_slots masks them): one
    batched float32 product, the L2 norm expansion clamped at 0, or the
    inner product; an extra metric elementwise over the gathered rows."""
    safe = ln.clamp_min(0).long()
    cl = codes[safe]  # [nq, max_len, d]
    if metric not in (MetricType.L2, MetricType.INNER_PRODUCT):
        return _metric_reduce(xq[:, None, :], cl, metric, metric_arg, cl.shape[-1])
    ip = torch.bmm(cl, xq[:, :, None])[:, :, 0]
    if metric != MetricType.L2:
        return ip
    cn = code_norms[safe] if code_norms is not None else cl.square().sum(-1)
    xn = x_norms if x_norms is not None else xq.square().sum(-1)
    return (xn[:, None] + cn - 2.0 * ip).clamp_min(0.0)


def pq_probe_dists(luts, ln, bias, cl, term2=None):
    """[nq, W] ADC values of each query against the codes ``cl`` [nq, W, M]
    of its list ``ln`` (one :meth:`RaggedLists.step`): the M table entries
    (query-side ``luts`` plus the list's ``term2``) summed in order of m,
    then the per-query ``bias`` [nq] added, as faiss_tpu does."""
    tab = luts if term2 is None else luts + term2[ln.clamp_min(0).long()]
    dist = torch.zeros(cl.shape[0], cl.shape[1], device=luts.device)
    for m in range(cl.shape[2]):
        dist = dist + torch.gather(tab[:, m, :], 1, cl[:, :, m].long())
    return dist + bias[:, None]


def unpack_signs(packed: torch.Tensor, d: int) -> torch.Tensor:
    """uint8 [..., nbytes] little-endian bits -> float32 [..., d] of +-1
    (faiss_tpu models/rabitq.py:27)."""
    shifts = torch.arange(8, dtype=torch.uint8, device=packed.device)
    bits = (packed[..., None] >> shifts) & 1
    bits = bits.reshape(*packed.shape[:-1], packed.shape[-1] * 8)[..., :d]
    return 2.0 * bits.float() - 1.0


def rabitq_sqrt_d(d: int) -> float:
    """sqrt(d) rounded to float32, faiss_tpu's divisor of <q, signs>."""
    return float(np.sqrt(np.float32(d)))


def rabitq_probe_dists(qP, ln, bias, packed, factors, d):
    """[nq, max_len] 1-bit RaBitQ estimates of each query against its list
    ``ln`` (faiss_tpu models/rabitq.py:199, one probe step): the list's sign
    rows unpacked, <Pq, o_bar> by one batched float32 product with the
    rotated queries ``qP`` [nq, d], then with the factors (|x_r|, f, g =
    <Pc, o_bar>) est = |x_r| (<Pq, o_bar> - g) / f and ``bias`` (|q - c|^2)
    + |x_r|^2 - 2 est."""
    safe = ln.clamp_min(0).long()
    signs = unpack_signs(packed[safe], d)  # [nq, max_len, d]
    ipq = torch.bmm(signs, qP[:, :, None])[:, :, 0] / rabitq_sqrt_d(d)
    fc = factors[safe]
    nr, f, g = fc[..., 0], fc[..., 1], fc[..., 2]
    est = nr * (ipq - g) / f
    return bias[:, None] + nr * nr - 2.0 * est


def ivf_rabitq_scan(
    qP: torch.Tensor,  # [nq, d] rotated queries P q (probe-independent)
    probes: torch.Tensor,  # [nq, nprobe] int (-1 = no probe)
    bias: torch.Tensor,  # [nq, nprobe] |q - c|^2 of each probe
    packed: torch.Tensor,  # [nlist, max_len, d / 8] uint8 sign bits
    factors: torch.Tensor,  # [nlist, max_len, 3] float32 (|x_r|, f, g)
    slot_ids: torch.Tensor,  # [nlist, max_len] int32 (-1 on pads)
    lengths: torch.Tensor,  # [nlist] int
    k: int,
    sel_mask: Optional[torch.Tensor] = None,  # [ntotal] bool over slots
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The 1-bit IVF RaBitQ scan by probe (faiss_tpu models/rabitq.py:199):
    :func:`rabitq_probe_dists` per probe, the slots the lists' lengths and
    ``sel_mask`` keep, merged into the running top-k. Queries go in chunks
    whose unpacked [rows, max_len, d] float32 signs stay under
    SCAN_GATHER_BYTES. Returns (dists [nq, k] ascending, slots [nq, k]
    int32), +inf and -1 past the candidates."""
    nq, d = qP.shape
    rows = max(1, SCAN_GATHER_BYTES // max(1, packed.shape[1] * d * 4))
    parts = []
    for r in range(0, max(nq, 1), rows):
        q, pr, b = qP[r : r + rows], probes[r : r + rows], bias[r : r + rows]
        vals = torch.full((q.shape[0], k), float("inf"), device=qP.device)
        ids = torch.full((q.shape[0], k), -1, dtype=torch.int32, device=qP.device)
        for p in range(pr.shape[1]):
            ln = pr[:, p].long()
            dist = rabitq_probe_dists(q, ln, b[:, p], packed, factors, d)
            valid, sl = probe_slots(ln, slot_ids, lengths, sel_mask)
            dist = torch.where(valid, dist, float("inf"))
            vals, ids = merge_topk(vals, ids, dist, sl, k, largest=False)
        parts.append((vals, ids))
    return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])


def pq_probe_hamming(qcodes, cl):
    """[nq, W] int32 Hamming distances between each query's code ``qcodes``
    [nq, M] and the codes ``cl`` [nq, W, M] of its list: the bits of
    qcode_m ^ code_m counted and summed over m (faiss_tpu
    ivf_ops.py:183)."""
    x = qcodes.to(torch.int32)[:, None, :] ^ cl.to(torch.int32)
    return popcount32(x).sum(-1, dtype=torch.int32)


def _scan_rows(xq, probes, codes, slot_ids, lengths, k, metric, code_norms,
               sel_mask, metric_arg=0.0):
    nq = xq.shape[0]
    largest = is_similarity_metric(metric)
    sentinel = float("-inf") if largest else float("inf")
    x_norms = xq.square().sum(-1) if metric == MetricType.L2 else None
    vals = torch.full((nq, k), sentinel, device=xq.device)
    ids = torch.full((nq, k), -1, dtype=torch.int32, device=xq.device)
    for p in range(probes.shape[1]):
        ln = probes[:, p].long()
        dist = flat_probe_dists(xq, ln, codes, metric, x_norms, code_norms,
                                metric_arg)
        valid, sl = probe_slots(ln, slot_ids, lengths, sel_mask)
        dist = torch.where(valid, dist, sentinel)
        vals, ids = merge_topk(vals, ids, dist, sl, k, largest=largest)
    return vals, ids


def ivf_pq_scan(
    luts: torch.Tensor,  # [nq, M, ksub] query-side ADC tables
    probes: torch.Tensor,  # [nq, nprobe] int (-1 = no probe)
    bias: torch.Tensor,  # [nq, nprobe] float32 per-(query, probe) term
    lists: RaggedLists,  # codes [n, M] (uint8, int32) and slots, as a CSR
    k: int,
    term2: Optional[torch.Tensor] = None,  # [nlist, M, ksub] list-side tables
    sel_mask: Optional[torch.Tensor] = None,  # [ntotal] bool over slots
    largest: bool = False,
    qcodes: Optional[torch.Tensor] = None,  # [nq, nprobe, M] residual codes
    ht: int = 0,  # polysemous Hamming threshold (0 = off)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """IVF-PQ ADC scan of each query's probed lists, the decomposition of
    IndexIVFPQ's precomputed tables (IndexIVFPQ.cpp:407):

        d(q, c + y) = bias[q, p] + sum_m (luts[q, m, y_m] + term2[c, m, y_m])

    L2 by residual: bias = ||q - c||^2, term2 = ||y_m||^2 + 2 c_m . y_m and
    luts = -2 q_m . y_m; without residuals bias = 0 and luts the full
    distance tables. Inner product (``largest``): luts = q_m . y_m, bias =
    q . c by residual (else 0), no term2. The M table entries are summed in
    order of m, then the bias added, as faiss_tpu does. ``sel_mask`` (an ID
    selector over slots) drops the slots it clears; with ``ht`` and
    ``qcodes`` (the codes of the query's residual to each probed list) the
    polysemous filter drops every slot whose code lies at Hamming distance
    ``ht`` or more from the query's (IndexIVFPQ.h:47, faiss_tpu
    ivf_ops.py:183), before the merge. Returns (dists [nq, k]
    float32 best-first, slots [nq, k] int32), the sentinel (+inf, -inf for
    ``largest``) and -1 where a query has fewer than k candidates."""
    nq = luts.shape[0]
    max_len, M = lists.shape[1], lists.shape[2]
    rows = max(1, SCAN_GATHER_BYTES // max(1, max_len * M * 8))
    if not ht:
        qcodes = None
    parts = [
        _pq_scan_rows(luts[r : r + rows], probes[r : r + rows],
                      bias[r : r + rows], lists, k, term2, sel_mask, largest,
                      None if qcodes is None else qcodes[r : r + rows], ht)
        for r in range(0, max(nq, 1), rows)
    ]
    return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])


def _pq_scan_rows(luts, probes, bias, lists, k, term2, sel_mask, largest,
                  qcodes, ht):
    nq = luts.shape[0]
    sentinel = float("-inf") if largest else float("inf")
    vals = torch.full((nq, k), sentinel, device=luts.device)
    ids = torch.full((nq, k), -1, dtype=torch.int32, device=luts.device)
    for p in range(probes.shape[1]):
        ln = probes[:, p].long()
        cl, valid, sl = lists.step(ln, sel_mask)
        dist = pq_probe_dists(luts, ln, bias[:, p], cl, term2)
        if qcodes is not None:
            valid = valid & (pq_probe_hamming(qcodes[:, p], cl) < ht)
            sl = torch.where(valid, sl, -1)
        dist = torch.where(valid, dist, sentinel)
        vals, ids = merge_topk(vals, ids, dist, sl, k, largest=largest)
    return vals, ids
