"""IVF-PQ search (counterpart of faiss_tpu/models/ivf_pq.py).

For big batches every index is laid out group-packed: lists bin-packed into
spatially coherent groups of 128, cut into chunks of FUSED_CT slots. Two
stores back the scans: the codes (``codesT``, read by the code-streaming ADC
kernels K4 and K5) and, within ``recon_scan_max_bytes``, the bf16 decoded
reconstructions (``yT``, read by the recon kernels K1 and K2).

  - ``IndexIVFPQ.search`` (unrefined, nq >= big_batch_threshold, by
    residual, no ``max_codes``): K4 over every chunk, unprobed lists masked
    by a 1e9 coarse term, for k <= 128 at ksub <= 16; otherwise the XLA ADC
    scan (``_big_batch_xla``: ops/pq_ops.ivfpq_brute_adc_knn over the codes
    in input order, plain torch ops);
  - every other ``search``, and ``search_preassigned``: the per-probe ADC
    scan (IndexIVF.search, ops/ivf_ops.ivf_pq_scan over the lists as one
    CSR, with IndexIVFPQ's precomputed tables by residual);
  - ``IndexRefineFlat`` over it (``_sbbr_submit``): at a selective nprobe
    whose per-tile worklists stay within the engage fraction, queries are
    sorted by home group and each 256-query tile scans only the chunks of
    its probed lists (the implem_12 semantics of IndexIVFFastScan.cpp:1166)
    through K1 (decoded store; penalized with strict probing, soft without)
    or K5 (codes); otherwise every chunk through K2 (decoded store, masked
    when nprobe > 0) or K4. The top candidates are re-ranked exactly
    against the refine store (float32, fp16, or SQ8 codes dequantized after
    the gather: Refine(SQ8)). 8-bit PQ without a decoded store has no
    kernel: IndexRefine re-ranks the candidates of its own search;
  - ``IndexIVFPQR``: IVF-PQ candidates re-ranked with a second PQ of the
    residual left after IVF-PQ reconstruction.

Inner product and ID selectors go by probe, as in faiss_tpu: the big-batch
paths serve L2 without a selector. The inner-product scan takes tables
q . y with the bias q . c (by residual), largest first.

Results come back as float32 D and int64 I. Still raising: the polysemous
filter (``polysemous_ht``, ``do_polysemous_training``: ROADMAP queue 1 item
10).

Left out on purpose: the int8/fp16 query staging, the single-read ``carry``
chain, the packed f16 readback and ``rt_econ`` of faiss_tpu exist because
its TPU sat behind a remote link; the recon kernels' flush schedule knobs
(``fmax``, ``sort_rot``, ``cheap_after``, ``qdepth``) tune an approximate
select that the port does not have (ROADMAP: port them only if the H100
shows they help).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import tracing
from ..base import query_buckets
from ..codecs.pq import ProductQuantizer, codes_numpy, codes_tensor
from ..metric import MetricType
from ..ops import pq_ops
from ..ops.distances import rerank_exact
from ..ops.fused_knn import (
    LANES,
    ivf_recon_fused,
    ivf_recon_fused_dyn,
    ivfpq_fused,
    ivfpq_fused_dyn,
)
from ..ops.ivf_ops import RaggedLists, ivf_pq_scan, pq_probe_dists
from ..ops.topk import topk
from .ivf import IndexIVF

# _proximity_group_lists and pack_invlists_grouped are host numpy, copied
# unchanged from faiss_tpu/models/ivf_pq.py:31-195 so both packages build the
# same layout from the same lists.


def _proximity_group_lists(centroids, lengths, ngroups, lam=0.25, iters=8):
    """Assign lists to ngroups groups of <=128, spatially coherent and
    roughly slot-balanced: k-means over the coarse centroids, then greedy
    capacity-constrained assignment (longest lists first, nearest cluster
    with room, slot load as a tie-break penalty). Spatial coherence is what
    makes per-tile probed-chunk unions small in the dynamic-chunk scan."""
    nlist, d = centroids.shape
    rs = np.random.RandomState(7)
    means = centroids[rs.choice(nlist, ngroups, replace=False)].copy()
    c2 = (centroids**2).sum(1)

    def dists(means):  # |c - m|^2 via the GEMM identity (broadcasting a
        # [nlist, G, d] temp is ~50x slower at this size)
        return (
            c2[:, None] + (means**2).sum(1)[None] - 2.0 * centroids @ means.T
        )

    for _ in range(iters):
        lab = dists(means).argmin(1)
        for g in range(ngroups):
            sel = lab == g
            if sel.any():
                means[g] = centroids[sel].mean(0)
    d2 = dists(means)  # [nlist, G]
    scale = np.median(d2) + 1e-9
    cap = np.full(ngroups, 128, np.int64)
    load = np.zeros(ngroups, np.float64)
    budget = max(1.0, lengths.sum() / ngroups)
    group_lists = [[] for _ in range(ngroups)]
    for li in np.argsort(-lengths, kind="stable"):
        cost = d2[li] / scale + lam * (load / budget)
        cost[cap <= 0] = np.inf
        g = int(cost.argmin())
        group_lists[g].append(int(li))
        cap[g] -= 1
        load[g] += lengths[li]
    # balance repair: the exhaustive kernel pads every group to the MAX
    # group's chunk count, so overload directly inflates the scan. When
    # nlist == 128*ngroups every group is at its list-count cap, so balance
    # by SWAPPING a longer list from the heaviest group with a shorter one
    # from the lightest (the pair whose length delta best halves the gap).
    for _ in range(8 * ngroups):
        g_hi = int(load.argmax())
        g_lo = int(load.argmin())
        if load[g_hi] - budget <= budget * 0.02:
            break
        A = np.asarray(group_lists[g_hi])
        B = np.asarray(group_lists[g_lo])
        delta = lengths[A][:, None] - lengths[B][None, :]
        target = (load[g_hi] - load[g_lo]) / 2.0
        i, j = np.unravel_index(
            np.abs(delta - target).argmin(), delta.shape
        )
        if delta[i, j] <= 0:
            break
        a, b = int(A[i]), int(B[j])
        group_lists[g_hi][group_lists[g_hi].index(a)] = b
        group_lists[g_lo][group_lists[g_lo].index(b)] = a
        load[g_hi] -= delta[i, j]
        load[g_lo] += delta[i, j]
    return group_lists


def pack_invlists_grouped(listnos, nlist, ct, seed=0xFA155, centroids=None):
    """Group-packed layout for the fused ADC kernel (pallas_knn docstring).

    Lists are bin-packed into groups of <=128 lists balanced by slot count
    (greedy longest-first), every group padded to a COMMON chunk count so
    chunk->group is the static map ``j // cpg``. Lists stay CONTIGUOUS
    (a list's candidates then arrive in the same grid step spread across
    lanes — measured to halve queue-eviction losses vs random placement)
    but the order WITHIN each list is shuffled, and the kernel pairs slots
    ct/2 apart, so same-list top-k candidates essentially never collide in
    the pair-reduction.

    With ``centroids`` given, groups are additionally SPATIALLY COHERENT
    (_proximity_group_lists): a query's nprobe-nearest lists then fall in
    few groups/chunks, which is what the dynamic-chunk kernel
    (ivfpq_fused_dyn_pallas) exploits to skip unprobed chunks.

    Returns a dict with:
      pos       [n]    packed position of every input slot
      order     [n]    input slot per packed rank (pos[i] places order-th)
      slot_map  [S]    input slot per packed position (-1 = pad)
      lid       [S]    local list id (0..127) within the group (<- 0 on pads)
      list_perm [ngroups*128] original list id per grouped column (-1 unused)
      col_start [ngroups*128] packed start position of each grouped column
      col_len   [ngroups*128] packed slot count of each grouped column
      ngroups, cpg, S
    """
    import heapq

    n = len(listnos)
    lengths = np.bincount(listnos, minlength=nlist).astype(np.int64)
    ngroups = max(1, -(-nlist // 128))
    if centroids is not None:
        group_lists = _proximity_group_lists(
            np.asarray(centroids, np.float32), lengths, ngroups
        )
    else:
        # greedy balance: longest lists first into the lightest group
        heap = [(0, 0, g) for g in range(ngroups)]
        heapq.heapify(heap)
        group_lists = [[] for _ in range(ngroups)]
        for li in np.argsort(-lengths, kind="stable"):
            slots, cnt, g = heapq.heappop(heap)
            group_lists[g].append(int(li))
            cnt += 1
            if cnt < 128:
                heapq.heappush(heap, (slots + int(lengths[li]), cnt, g))
    cpg = max(
        1,
        max(
            -(-int(sum(lengths[li] for li in gl)) // ct)
            for gl in group_lists
        ),
    )
    S = ngroups * cpg * ct
    group_of = np.zeros(nlist, np.int32)
    local_of = np.zeros(nlist, np.int32)
    list_perm = np.full(ngroups * 128, -1, np.int64)
    for g, gl in enumerate(group_lists):
        for loc, li in enumerate(gl):
            group_of[li] = g
            local_of[li] = loc
            list_perm[g * 128 + loc] = li

    rng = np.random.RandomState(seed)
    g_of = group_of[listnos]  # [n] group of every slot
    # order: by group, lists contiguous within the group, random inside
    # each list
    order = np.lexsort((rng.rand(n), listnos, g_of))
    cnt = np.bincount(g_of, minlength=ngroups).astype(np.int64)
    start_of = np.zeros(ngroups, np.int64)
    np.cumsum(cnt[:-1], out=start_of[1:])
    g_sorted = g_of[order]
    rank_in_group = np.arange(n, dtype=np.int64) - start_of[g_sorted]
    pos = g_sorted.astype(np.int64) * (cpg * ct) + rank_in_group
    slot_map = np.full(S, -1, np.int64)
    slot_map[pos] = order
    lid = np.zeros(S, np.int32)
    lid[pos] = local_of[listnos[order]]
    # packed span of each grouped column (lists are contiguous within a
    # group, appearing in ascending list-id order — matches the lexsort)
    col_start = np.zeros(ngroups * 128, np.int64)
    col_len = np.zeros(ngroups * 128, np.int64)
    for g, gl in enumerate(group_lists):
        off = g * cpg * ct
        for li in sorted(gl):
            col = g * 128 + local_of[li]
            col_start[col] = off
            col_len[col] = lengths[li]
            off += lengths[li]
    return {
        "pos": pos,
        "order": order,
        "slot_map": slot_map,
        "lid": lid,
        "list_perm": list_perm,
        "col_start": col_start,
        "col_len": col_len,
        "ngroups": ngroups,
        "cpg": cpg,
        "S": S,
    }


# packed slots staged per window (a [CH, d] float32 decode transient)
_STAGE_CH = 1 << 18

# keys at or above this carry the 1e9 mask of an unprobed list
_MASKED_KEY = 5e8

# cap on the term-2 precomputed table (faiss_tpu :923, faiss's
# precomputed_table_max_bytes, IndexIVFPQ.cpp:375)
precomputed_table_max_bytes = 2 << 30


class IMITerm2:
    """term2[c, m, k] = ||y_mk||^2 + 2 c_m . y_mk of an IVF-PQ over an IMI
    quantizer without its [nlist, M, ksub] table (faiss's
    use_precomputed_table = 2, IndexIVFPQ.cpp:375): where every PQ
    sub-vector lies inside one IMI block b(m), c_m is a row of block b(m)'s
    codebook, chosen by cell c's digit of that block, so a [ksub_imi, M,
    ksub] table computed as precompute_table computes each entry holds
    every row. Indexing by list numbers (or by (lists, m, codes), as
    ``_slot_norms`` does) gathers the full table's entries."""

    def __init__(self, small: torch.Tensor, weights: torch.Tensor, ksub_imi: int):
        self.small = small  # [ksub_imi, M, ksub]
        self.weights = weights  # [M] int64: ksub_imi ** b(m)
        self.ksub_imi = ksub_imi

    @classmethod
    def build(cls, quantizer, pq):
        """The factored tables, or None where ``quantizer`` is no IMI or its
        blocks split a PQ sub-vector."""
        from .imi import MultiIndexQuantizer

        if not isinstance(quantizer, MultiIndexQuantizer):
            return None
        mi, ksub_imi = quantizer.pq.M, quantizer.pq.ksub
        if pq.M % mi:
            return None
        per = pq.M // mi  # PQ sub-vectors per IMI block
        cb_imi = quantizer.pq.centroids  # [mi, ksub_imi, d / mi]
        cmk = np.stack([
            cb_imi[m // per][:, (m % per) * pq.dsub : (m % per + 1) * pq.dsub]
            for m in range(pq.M)], axis=1)  # [ksub_imi, M, dsub]
        cb = pq.centroids
        y_norms = np.sum(cb**2, axis=-1)
        small = (y_norms[None] + 2.0 * np.einsum("cmd,mkd->cmk", cmk, cb)
                 ).astype(np.float32)
        dev = pq.device
        weights = torch.tensor([ksub_imi ** (m // per) for m in range(pq.M)],
                               dtype=torch.int64, device=dev)
        return cls(torch.from_numpy(small).to(dev), weights, ksub_imi)

    def _digits(self, lists, m):
        return torch.div(lists, self.weights[m], rounding_mode="floor") % self.ksub_imi

    def __getitem__(self, key):
        if isinstance(key, tuple):  # (lists, m, codes), broadcast together
            lists, m, k = key
            return self.small[self._digits(lists, m), m, k]
        m = torch.arange(self.small.shape[1], device=self.small.device)
        return self.small[self._digits(key[..., None], m), m]


def _slot_norms(codes, listnos, term2, cn2):
    """||c_list||^2 + sum_m term2[list, m, code_m] of every slot in input
    order (faiss_tpu :912), window by window: the norm of the float32
    reconstruction, not of the bf16 store."""
    n2 = torch.empty(codes.shape[0], device=codes.device)
    mi = torch.arange(codes.shape[1], device=codes.device)[None, :]
    for s in range(0, codes.shape[0], _STAGE_CH):
        cw = codes[s : s + _STAGE_CH].long()
        ln = listnos[s : s + _STAGE_CH]
        n2[s : s + len(cw)] = cn2[ln] + term2[ln[:, None], mi, cw].sum(dim=1)
    return n2


def _stage_brute_device(codes, listnos, n2, slot_map, local_of):
    """Group-packed layout of the ADC kernels and the strict masks
    (faiss_tpu :892, and its windowed form :859): codesT [M, S_pad] of the
    codes' type (uint8 up to 8 bits, which the kernels read at ksub <= 16),
    n2s [1, S_pad] float32 (+inf on pads) and lid [1, S_pad] int32 (local
    list id within its 128-list group, 0 on pads), gathered from the input
    order codes, lists and norms ``n2`` through ``slot_map`` (packed
    position -> input slot, -1 = pad) window by window."""
    S_pad = slot_map.shape[0]
    M = codes.shape[1]
    dev = codes.device
    codesT = torch.zeros(M, S_pad, dtype=codes.dtype, device=dev)
    n2s = torch.full((1, S_pad), float("inf"), device=dev)
    lid = torch.zeros(1, S_pad, dtype=torch.int32, device=dev)
    for s in range(0, S_pad, _STAGE_CH):
        sm = slot_map[s : s + _STAGE_CH]
        w = len(sm)
        valid = sm >= 0
        safe = sm.clamp_min(0)
        codesT[:, s : s + w] = torch.where(valid[:, None], codes[safe], 0).T
        n2s[0, s : s + w] = torch.where(valid, n2[safe], float("inf"))
        lid[0, s : s + w] = torch.where(valid, local_of[listnos[safe]], 0)
    return codesT, n2s, lid


def _stage_recon_device(codes, listnos, cent, codebooks, slot_map, d_pad):
    """Decoded-reconstruction store for K1 and K2 (faiss_tpu :787): y =
    c_list + pq_decode(code) in float32, rounded to bf16, TRANSPOSED [d_pad,
    S_pad], dims zero-padded, laid out by gathering through ``slot_map``.
    The decode gathers ``codebook[m, code]`` directly; faiss_tpu decodes
    through a one-hot GEMM that is float32-faithful to ~16 bits, so the two
    stores agree to 1 bf16 ulp. Decoded window by window, so the unpacked
    [n, d] reconstruction is never built."""
    S_pad = slot_map.shape[0]
    d = cent.shape[1]
    yT = torch.zeros(d_pad, S_pad, dtype=torch.bfloat16, device=codes.device)
    for s in range(0, S_pad, _STAGE_CH):
        sm = slot_map[s : s + _STAGE_CH]
        safe = sm.clamp_min(0)
        dec = pq_ops.pq_decode(codes[safe], codebooks) + cent[listnos[safe]]
        dec = torch.where((sm >= 0)[:, None], dec, torch.zeros_like(dec))
        yT[:d, s : s + len(sm)] = dec.to(torch.bfloat16).T
    return yT


def _probe_mask(like, cols):
    """[nq, G * 128] bool, True at each row's probed columns ``cols``."""
    return torch.zeros_like(like, dtype=torch.bool).scatter_(1, cols, True)


def _probed(xq, cent_g, cn2g, nprobe):
    """(cm2 = -2 q.c [nq, G * 128], probed [nq, G * 128] bool): True on each
    row's nprobe nearest list columns (search_preassigned semantics,
    IndexIVF.cpp:401); unused columns (cn2g +inf) are never probed."""
    cm2 = -2.0 * (xq @ cent_g.T)
    cols = topk(cn2g[None, :] + cm2, nprobe, largest=False)[1]
    return cm2, _probe_mask(cm2, cols)


def _masked_coarse_bias(xq, cent_g, cn2g, nprobe):
    """K4's coarse term (faiss_tpu :395): -2 q.c per grouped list column,
    1e9 off each query's nprobe nearest lists; ``nprobe == 0`` is
    exhaustive."""
    if not nprobe:
        return -2.0 * (xq @ cent_g.T)
    cm2, probed = _probed(xq, cent_g, cn2g, nprobe)
    return torch.where(probed, cm2, 1e9)


def _dyn_probe_bitmap(xq, cent_g, cn2g, chunk_first, chunk_last, nprobe, qt,
                      nchunks):
    """Probe, home-group sort and per-tile chunk bitmap of the dynamic-chunk
    searches (faiss_tpu :414). Returns (perm, pcols_s [nq, nprobe] probed
    columns of the sorted queries, cm2 = -2 q.c [nq, G * 128] of the
    unsorted queries, bitmap [T, nchunks + 1] of the sorted tiles); the
    trailing bitmap column is the PAD chunk (cleared). The probe is exact:
    an iterative argmin for nprobe <= 4 (first minimum on ties, like
    jnp.argmin), else ``torch.topk``."""
    nq = xq.shape[0]
    cm2 = -2.0 * (xq @ cent_g.T)
    key = cn2g[None, :] + cm2
    if nprobe <= 4:
        kw = key.clone()
        cols = []
        for _ in range(nprobe):
            c = kw.argmin(dim=1)
            cols.append(c)
            kw.scatter_(1, c[:, None], float("inf"))
        pcols = torch.stack(cols, dim=1)
    else:
        pcols = topk(key, nprobe, largest=False)[1]
    perm = torch.argsort(pcols[:, 0] // 128, stable=True)
    pcols_s = pcols[perm]
    cf = chunk_first[pcols_s]  # [nq, nprobe]
    cl = chunk_last[pcols_s]
    # a list's chunks are the contiguous range [chunk_first, chunk_last]
    ciota = torch.arange(nchunks + 1, device=xq.device)
    q2c = torch.zeros(nq, nchunks + 1, dtype=torch.bool, device=xq.device)
    for j in range(nprobe):
        q2c |= (ciota[None, :] >= cf[:, j, None]) & (ciota[None, :] <= cl[:, j, None])
    bitmap = q2c.reshape(nq // qt, qt, nchunks + 1).any(dim=1)
    bitmap[:, nchunks] = False
    return perm, pcols_s, cm2, bitmap


def _dyn_inputs(xq, br, nprobe, qt, msteps):
    """The worklists of the dynamic-chunk searches for one padded sub-batch:
    queries sorted by home group so a qt-query tile's probed lists share
    chunks, and each tile's probed-chunk union, ascending and cut at
    ``msteps``, as its worklist (the PAD chunk fills unused steps). Returns
    (perm, pcols_s, cm2, cmap [nq // qt, msteps] int32, ndropped) with the
    first three as :func:`_dyn_probe_bitmap` gives them; ndropped counts
    probed chunks cut off by ``msteps``."""
    nchunks = br["nchunks"]
    perm, pcols_s, cm2, bitmap = _dyn_probe_bitmap(
        xq, br["centroids_g"], br["cn2g"], br["chunk_first"],
        br["chunk_last"], nprobe, qt, nchunks,
    )
    cnt = bitmap.sum(dim=1)
    # stable argsort of int32 keys: probed chunk ids ascending
    order = torch.argsort((~bitmap).to(torch.int32), dim=1, stable=True)
    step_i = torch.arange(msteps, device=xq.device)
    cmap = torch.where(
        step_i[None, :] < cnt[:, None], order[:, :msteps], nchunks
    ).to(torch.int32).contiguous()
    ndropped = (cnt - msteps).clamp_min(0).sum()
    return perm, pcols_s, cm2, cmap, ndropped


def _pad_dims(xq, br):
    """Queries with their dims zero-padded to the decoded store's d_pad."""
    return torch.nn.functional.pad(
        xq, (0, br["d_pad"] - xq.shape[1])
    ).contiguous()


def _adc_luts(xq, cbt):
    """The flattened ADC tables -2 q . codeword [nq, M * ksub] as one
    float32 product with the block-diagonal codebook, rounded to bf16 as
    faiss_tpu hands them to its kernel (:303, :311, :1644)."""
    return (-2.0 * (xq @ cbt)).to(torch.bfloat16)


def _slots_of(slots_raw, br, kc):
    """The first ``kc`` packed positions mapped to input slots (-1 stays)."""
    return torch.where(
        slots_raw >= 0, br["slot_map_dev"][slots_raw.clamp_min(0).long()], -1
    )[:, :kc]


def _sq_kw(sq):
    """rerank_exact's SQ8 arguments from ``sq`` = (scale, off) or None."""
    return {} if sq is None else dict(sq_scale=sq[0], sq_off=sq[1])


def _fused_search_rerank(xq, br, xb, k, kc, qt, ct, nprobe, sq=None):
    """Code-streaming ADC scan + exact re-rank for one padded sub-batch
    (faiss_tpu :281): the bf16 LUTs, the masked coarse term, K4 over every
    chunk, its top ``kc`` mapped to input slots and re-ranked exactly
    against the refine store (SQ8 codes with ``sq`` = (scale, off)).
    Returns (D [nq, k] f32, slots int64, ndropped 0), on the device."""
    cm2 = _masked_coarse_bias(xq, br["centroids_g"], br["cn2g"], nprobe)
    _, slots_raw, _ = ivfpq_fused(
        cm2, _adc_luts(xq, br["cbt"]), br["codesT"], br["n2s"], br["lid"],
        qt=qt, ct=ct,
    )
    D, I = rerank_exact(xq, xb, _slots_of(slots_raw, br, kc), k, **_sq_kw(sq))
    return D, I, 0


def _fused_search_rerank_dyn(xq, br, xb, k, kc, qt, ct, nprobe, msteps,
                             sq=None):
    """nprobe-sparse ADC scan + exact re-rank for one padded sub-batch
    (faiss_tpu :497): worklists of the home-group-sorted queries, the
    coarse term masked to 1e9 off each query's probed columns, K5 over the
    worklists, the re-rank, rows returned in the original order. Returns
    (D, slots, ndropped), on the device."""
    perm, pcols_s, cm2, cmap, ndropped = _dyn_inputs(xq, br, nprobe, qt, msteps)
    xq_s = xq[perm]
    cm2_s = torch.where(_probe_mask(cm2, pcols_s), cm2[perm], 1e9)
    _, slots_raw, _ = ivfpq_fused_dyn(
        cm2_s, _adc_luts(xq_s, br["cbt"]), br["codesT"], br["n2s"], br["lid"],
        cmap, br["cgroup"], qt=qt, ct=ct,
    )
    D, I = rerank_exact(xq_s, xb, _slots_of(slots_raw, br, kc), k,
                        **_sq_kw(sq))
    inv = torch.argsort(perm, stable=True)
    return D[inv], I[inv], ndropped


def _fused_search_rerank_recon(xq, br, xb, xb_n2, k, kc, qt, ct, nprobe,
                               sq=None):
    """Exhaustive recon scan + exact re-rank for one padded sub-batch
    (faiss_tpu :572): K2 over the store (IVF-PQ's decoded store, or
    IVF-Flat's vectors as the hi/lo planes ``yT``, ``yT_lo``), masked by the
    strict {0, 1e9} penalty (faiss_tpu :641) when ``nprobe > 0``, then the
    re-rank. Returns (D, slots, ndropped 0), on the device."""
    mask = {}
    if nprobe:
        probed = _probed(xq, br["centroids_g"], br["cn2g"], nprobe)[1]
        mask = dict(biasg=torch.where(probed, 0.0, 1e9), lid=br["lid"])
    _, slots_raw, _ = ivf_recon_fused(
        _pad_dims(xq, br), br["yT"], br["n2s"], br.get("yT_lo"), qt=qt, ct=ct,
        **mask
    )
    D, I = rerank_exact(xq, xb, _slots_of(slots_raw, br, kc), k, xb_n2=xb_n2,
                        **_sq_kw(sq))
    return D, I, 0


def _fused_search_rerank_recon_dyn(xq, br, xb, xb_n2, k, kc, qt, ct, nprobe,
                                   msteps, strict_probe, sq=None):
    """nprobe-sparse recon scan + exact re-rank for one padded sub-batch
    (faiss_tpu :662): K1 over the tile worklists of the store (one plane, or
    hi/lo where ``br`` holds ``yT_lo``), penalized by {0, 1e9} off
    each query's probed lists when ``strict_probe``, soft otherwise; its
    candidates mapped through ``slot_map`` to input slots, the top ``kc``
    re-ranked exactly against the refine store, rows returned in the
    original order. Returns (D, slots, ndropped), on the device."""
    with tracing.span("sbbr.worklists"):
        perm, pcols_s, cm2, cmap, ndropped = _dyn_inputs(xq, br, nprobe, qt, msteps)
        xq_s = xq[perm]
        pen = {}
        if strict_probe:
            pen = dict(
                biasg=torch.where(_probe_mask(cm2, pcols_s), 0.0, 1e9),
                lid=br["lid"], cgroup=br["cgroup"],
            )
    with tracing.span("sbbr.scan"):
        _, slots_raw, _ = ivf_recon_fused_dyn(
            _pad_dims(xq_s, br), br["yT"], br["n2s"], cmap, qt, ct,
            yT_lo=br.get("yT_lo"), d=xq_s.shape[1], **pen
        )
    with tracing.span("sbbr.rerank"):
        D, I = rerank_exact(xq_s, xb, _slots_of(slots_raw, br, kc), k,
                            xb_n2=xb_n2, **_sq_kw(sq))
        inv = torch.argsort(perm, stable=True)
        return D[inv], I[inv], ndropped


def grouped_layout(listnos, centroids, nlist, ct, device):
    """The group-packed layout that IVF-PQ and IVF-Flat build alike
    (faiss_tpu ivf_pq.py:1069, ivf.py:655): ``pack_invlists_grouped`` with
    one trailing all-+inf PAD chunk that backs the worklists' unused steps,
    the grouped coarse centroids and their norms (+inf on unused columns),
    each grouped column's chunk span (empty and unused columns point at the
    PAD chunk) and each chunk's group. Returns (the part of ``_brute`` both
    hold, ``local_of`` [nlist] int32 on the device: each list's column
    within its group)."""
    g = pack_invlists_grouped(listnos, nlist, ct, centroids=centroids)
    nchunks, G = g["S"] // ct, g["ngroups"]
    lp = g["list_perm"]
    used = lp >= 0
    local_of = np.zeros(nlist, np.int32)
    local_of[lp[used]] = np.arange(len(lp), dtype=np.int32)[used] % 128
    slot_map = np.concatenate([g["slot_map"], np.full(ct, -1, np.int64)])
    cent_g = np.zeros((len(lp), centroids.shape[1]), np.float32)
    cent_g[used] = centroids[lp[used]]
    cn2g = np.full(len(lp), np.inf, np.float32)
    cn2g[used] = (cent_g[used] ** 2).sum(1)
    cs, cl = g["col_start"], g["col_len"]
    chunk_first = np.where(cl > 0, cs // ct, nchunks)
    chunk_last = np.where(cl > 0, (cs + np.maximum(cl, 1) - 1) // ct, nchunks)
    cgroup = np.concatenate(
        [np.repeat(np.arange(G), g["cpg"]), np.zeros(1, np.int64)]
    ).astype(np.int32)
    # K2 and K4 group a chunk statically (fused_knn._static_groups over the
    # nchunks + 1 chunks of the store): that map must be this one
    static = np.minimum(np.arange(nchunks) // max(1, (nchunks + 1) // G), G - 1)
    assert np.array_equal(cgroup[:nchunks], static), "static chunk groups differ"

    def dev(a):
        return torch.from_numpy(a).to(device)

    return {
        "slot_map": slot_map,
        "slot_map_dev": dev(slot_map),
        "centroids_g": dev(cent_g),
        "cn2g": dev(cn2g),
        "chunk_first": dev(chunk_first),
        "chunk_last": dev(chunk_last),
        "cgroup": dev(cgroup),
        "nchunks": nchunks,
        "cpg": g["cpg"],
    }, dev(local_of)


def dyn_bucket_for(index, xq_dev, br, nprobe, qt):
    """Worklist length of the dynamic-chunk scans of ``index`` (IndexIVFPQ
    or IndexIVFFlat; faiss_tpu ivf_pq.py:1245, ivf.py:777): its
    ``dyn_msteps`` where set, else the largest per-tile probed-chunk union
    of the first batch of this nprobe, rounded up to a multiple of 64 and
    cached per nprobe (``index._dyn_bucket``; _sbbr_collect and
    _sbbf_collect widen it when a batch drops probed chunks)."""
    if index.dyn_msteps:
        return min(index.dyn_msteps, br["nchunks"])
    if index._dyn_bucket is None:
        index._dyn_bucket = {}
    if nprobe not in index._dyn_bucket:
        bitmap = _dyn_probe_bitmap(
            xq_dev, br["centroids_g"], br["cn2g"], br["chunk_first"],
            br["chunk_last"], nprobe, qt, br["nchunks"],
        )[3]
        with tracing.wait("sbbr.bucket", 8):  # one host sync per nprobe
            m = int(bitmap.sum(dim=1).max())
        index._dyn_bucket[nprobe] = min(br["nchunks"], -(-m // 64) * 64)
    return index._dyn_bucket[nprobe]


def collect_sub_batches(index, st):
    """Read phase of the big-batch searches of ``index`` (IndexIVFPQ's
    refined search, faiss_tpu ivf_pq.py:1497, and IndexIVFFlat's, ivf.py:
    942): copy each sub-batch home, map slots to ids, and widen the adaptive
    worklist bucket when a dynamic-chunk batch dropped probed chunks (its
    recall impact is bounded to that batch). The port's selects are exact,
    so no row needs faiss_tpu's lossy-row replay. Each read is a
    ``tracing.wait`` of its own."""
    nq, k, nprobe = st["nq"], st["k"], st["nprobe"]
    D = np.full((nq, k), np.inf, np.float32)
    I = np.full((nq, k), -1, np.int64)
    for start, real, (d, slots, ndropped), was_dyn in st["pending"]:
        with tracing.span("collect.sub_batch"):
            if was_dyn:
                with tracing.wait("collect.ndropped", ndropped.nbytes):
                    ndropped = int(ndropped)
                if ndropped > 0 and not index.dyn_msteps:
                    index._dyn_bucket[nprobe] = min(
                        st["nchunks"], index._dyn_bucket[nprobe] + 64
                    )
            d, slots = d[:real], slots[:real]
            with tracing.wait("collect.d2h_dist", d.nbytes):
                d = d.cpu().numpy()
            with tracing.wait("collect.d2h_slots", slots.nbytes):
                slots = slots.cpu().numpy()
            with tracing.span("collect.id_map"):
                D[start : start + real, : d.shape[1]] = d
                I[start : start + real, : d.shape[1]] = np.where(
                    slots >= 0, index._ids_host[np.maximum(slots, 0)], -1
                )
    return D, I


class IVFFastScanStats:
    """Counters of the big-batch scans (faiss_tpu :212, after
    IndexIVFFastScan.h:409): ``nq`` queries of the refined IVF-PQ and the
    IVF-Flat big batches; of the refined IVF-PQ's, ``ndis`` keys that
    entered selection (every query of a tile scores every slot of every
    chunk the tile scans), ``chunks_scanned`` and ``chunks_skipped`` per
    sub-batch. faiss_tpu's ``lossy_rows`` (rows its approximate selects may
    have lost) has no counterpart: the port's selects are exact. Its
    ``t_scan`` neither: the collects' waits are ``tracing`` spans."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.nq = 0
        self.ndis = 0
        self.chunks_scanned = 0
        self.chunks_skipped = 0

    def __repr__(self):
        return (
            f"IVFFastScanStats(nq={self.nq}, ndis={self.ndis}, "
            f"chunks_scanned={self.chunks_scanned}, "
            f"chunks_skipped={self.chunks_skipped})"
        )


ivf_fast_scan_stats = IVFFastScanStats()


class IndexIVFPQ(IndexIVF):
    """reference: faiss/IndexIVFPQ.h:31 (L2 or inner product).

    ``search`` runs the big-batch ADC scan for nq >= big_batch_threshold by
    residual, L2, without ``max_codes`` or a selector (K4 for k <= 128 at
    ksub <= 16, else the XLA ADC scan) and the per-probe ADC scan for every
    other search;
    IndexRefineFlat runs the refined big-batch paths (_sbbr_submit /
    _sbbr_collect). ``by_residual = False`` encodes the vectors themselves
    and always scans by probe, as faiss_tpu does (:1688-1697)."""

    # slots per kernel chunk (group-packed, multi-list)
    FUSED_CT = 2048
    # budget for the bf16 decoded store of the recon kernels (2 * d_pad bytes
    # per slot): faiss_tpu's value (:1067), sized for a 16 GB TPU. Within it
    # the refined paths scan the store (K1, K2); beyond it they stream the
    # codes (K4, K5).
    recon_scan_max_bytes = 4 << 30
    # dynamic-chunk worklist cap (0 = adapt: the first batch measures the
    # max per-tile probed-chunk union, rounded up to a 64 bucket per nprobe;
    # a batch that drops chunks widens the bucket for the next call)
    dyn_msteps = 0
    _dyn_bucket = None
    # engage the dynamic-chunk scans only up to this probed-chunk fraction:
    # dyn_engage_frac with strict probing, soft_engage_frac without
    dyn_engage_frac = 0.08
    soft_engage_frac = 0.7
    # True (faiss_tpu's default): results come from the nprobe nearest lists
    # only (search_preassigned semantics). False = soft probing: every slot
    # in a worklist chunk competes on its true key.
    strict_probe = True
    # refined-path sub-batch size
    pipeline_batch = 4096

    def __init__(self, quantizer, d: int, nlist: int, M: int, nbits: int = 8,
                 metric=MetricType.L2, *, device):
        super().__init__(quantizer, d, nlist, metric, device=device)
        self.pq = ProductQuantizer(d, M, nbits, device=device)
        self.by_residual = True
        # the polysemous filter inside lists (IndexIVFPQ.h:47-60): 0 = off;
        # meaningful after do_polysemous_training
        self.polysemous_ht = 0
        self.do_polysemous_training = False
        self.polysemous_training = None  # a PolysemousTraining
        self._term2 = None  # [nlist, M, ksub] on the device
        # nq at or above this goes to the big-batch path
        self.big_batch_threshold = 128
        self.is_trained = False

    # -- codec -----------------------------------------------------------------
    def train_encoder(self, x: torch.Tensor, assign: torch.Tensor) -> None:
        """PQ training on the residuals (faiss_tpu :962), or on the vectors
        with ``by_residual = False``; then, with
        ``do_polysemous_training``, the codebooks' polysemous permutation
        (codecs/polysemous.py)."""
        if self.by_residual:
            x = x - self._centroids_dev()[assign]
        self.pq.cp.verbose = False
        self.pq.train(x.cpu().numpy())
        if self.do_polysemous_training:
            from ..codecs.polysemous import PolysemousTraining

            pt = self.polysemous_training or PolysemousTraining()
            pt.optimize_pq_for_hamming(self.pq)
        self._term2 = None

    def encode_vectors(self, x: torch.Tensor, listnos: torch.Tensor) -> np.ndarray:
        """PQ codes [n, M] (uint8, uint16 above 8 bits) of the residuals
        (or of the vectors with ``by_residual = False``), computed on the
        device."""
        resid = x.float()
        if self.by_residual:
            resid = resid - self._centroids_dev()[listnos]
        return codes_numpy(pq_ops.pq_encode(resid, self.pq._dev()), self.pq.nbits)

    def _decode_dev(self, codes: torch.Tensor, listnos: torch.Tensor) -> torch.Tensor:
        """Reconstructions [n, d] float32 on the device."""
        out = pq_ops.pq_decode(codes, self.pq._dev())
        if self.by_residual:
            out = out + self._centroids_dev()[listnos.long()]
        return out

    def decode_vectors(self, codes: np.ndarray, listnos: np.ndarray) -> np.ndarray:
        dev = self.device
        return self._decode_dev(
            codes_tensor(codes, dev),
            torch.from_numpy(np.asarray(listnos, np.int64)).to(dev),
        ).cpu().numpy()

    # -- precomputed tables (faiss_tpu :1014-1041) -------------------------------
    def precompute_table(self) -> None:
        """term2[c, m, k] = ||y_mk||^2 + 2 c_m . y_mk (IndexIVFPQ.cpp:407),
        in float32 on the host as faiss_tpu computes it, kept on the
        device."""
        pq = self.pq
        cmk = self._centroids_host().reshape(self.nlist, pq.M, pq.dsub)
        cb = pq.centroids
        y_norms = np.sum(cb**2, axis=-1)  # [M, ksub]
        cdoty = 2.0 * np.einsum("cmd,mkd->cmk", cmk, cb)
        self._term2 = torch.from_numpy(
            (y_norms[None] + cdoty).astype(np.float32)
        ).to(self.device)

    def _maybe_term2(self):
        """The tables of the by-residual L2 scan (None without residuals).
        An IMI quantizer whose blocks hold whole PQ sub-vectors gets the
        factored tables of :class:`IMITerm2` (faiss's use_precomputed_table
        = 2, which faiss_tpu lacks), with the full table's entries; any
        other quantizer the full table, which raises beyond
        ``precomputed_table_max_bytes``, as faiss_tpu does."""
        if not self.by_residual:
            return None
        if self._term2 is None:
            self._term2 = IMITerm2.build(self.quantizer, self.pq)
        if self._term2 is None:
            nbytes = self.nlist * self.pq.M * self.pq.ksub * 4
            if nbytes > precomputed_table_max_bytes:
                raise MemoryError(
                    f"precomputed table of {nbytes} bytes exceeds cap; "
                    "raise precomputed_table_max_bytes")
            self.precompute_table()
        return self._term2

    # -- search by probe (faiss_tpu :1044, :1726) -------------------------------
    def _stage_codes(self, order, offsets, lengths, max_len):
        """The per-probe lists as one CSR (ops/ivf_ops.RaggedLists): the
        codes (uint8; int32 above 8 bits) and slots in list order. A probe
        step gathers each query's list padded only to the longest list of
        that step: an IMI's 2^20 skewed lists would not fit padded to the
        longest of all."""
        dev = self.device
        lists = RaggedLists(
            codes_tensor(self._codes_host[order] if self.ntotal else
                         np.zeros((0, self.pq.M), np.uint8), dev),
            torch.from_numpy(order.astype(np.int32)).to(dev),
            torch.from_numpy(offsets).to(dev),
            torch.from_numpy(lengths).to(dev), max_len)
        return {"lists": lists, "lengths": lists.lengths}

    def _adc_tables(self, xq, coarse_dis):
        """(luts [nq, M, ksub], bias [nq, nprobe], term2 or None, largest) of
        the per-probe ADC (faiss_tpu :1735-1775). L2 by residual: the bias
        is the coarse distance ||q - c||^2, the tables -2 q . y plus term2
        of the list; L2 without residuals: the full distance tables and no
        bias. Inner product: the tables q . y and, by residual, the bias
        q . c (the coarse inner product), largest first."""
        cb = self.pq._dev()
        if self.metric_type == MetricType.INNER_PRODUCT:
            bias = coarse_dis if self.by_residual else torch.zeros_like(coarse_dis)
            return pq_ops.pq_ip_tables(xq, cb), bias, None, True
        if self.by_residual:
            return (-2.0 * pq_ops.pq_ip_tables(xq, cb), coarse_dis,
                    self._maybe_term2(), False)
        return (pq_ops.pq_distance_tables(xq, cb), torch.zeros_like(coarse_dis),
                None, False)

    def _query_residual_codes(self, xq, probes):
        """PQ codes [nq, nprobe, M] of the query's residual to each probed
        list, for the polysemous filter (faiss_tpu :1715)."""
        nq, nprobe = probes.shape
        cents = self._centroids_dev()[probes.clamp_min(0).long()]
        resid = (xq[:, None, :] - cents).reshape(nq * nprobe, self.d)
        return pq_ops.pq_encode(resid, self.pq._dev()).reshape(nq, nprobe, self.pq.M)

    def _scan(self, xq, probes, coarse_dis, k, dev, sel):
        """The per-probe ADC scan of :meth:`_adc_tables`' tables, with the
        selector's slot mask ``sel`` and, by residual in L2 with
        ``polysemous_ht`` set, the polysemous filter (faiss_tpu :1727)."""
        luts, bias, term2, largest = self._adc_tables(xq, coarse_dis)
        ht = int(self.polysemous_ht)
        qcodes = None
        if ht and self.by_residual and self.metric_type == MetricType.L2:
            qcodes = self._query_residual_codes(xq, probes)
        return ivf_pq_scan(luts, probes, bias, dev["lists"], k, term2=term2,
                           sel_mask=sel, largest=largest, qcodes=qcodes,
                           ht=ht if qcodes is not None else 0)

    def _probe_step(self, xq, dev, sel):
        """range_search's probe step over the CSR: the ADC values as the
        scan computes them (the coarse distance is the bias by residual
        only)."""
        luts, _, term2, _ = self._adc_tables(xq, xq.new_zeros(len(xq), 1))
        res = self.by_residual

        def step(ln, cd):
            cl, valid, sl = dev["lists"].step(ln, sel)
            bias = cd if res else torch.zeros_like(cd)
            return pq_probe_dists(luts, ln, bias, cl, term2), valid, sl

        return step

    def _probe_row_bytes(self, dev) -> int:
        return dev["lists"].shape[1] * dev["lists"].shape[2] * 8

    def search(self, x, k: int, *, params=None):
        """faiss_tpu :1683: the big-batch scan for nq >= big_batch_threshold
        by residual, L2, without ``max_codes``, a selector or the polysemous
        filter; every other search by probe."""
        x = self._check_input(x)
        self._check_trained()
        nprobe, max_codes = self._search_params(params)
        if (self.big_batch_threshold and len(x) >= self.big_batch_threshold
                and self.by_residual and not max_codes and self.ntotal > 0
                and not self.polysemous_ht
                and self.metric_type == MetricType.L2
                and (params is None or params.sel is None)):
            return self._search_big_batch(x, k, min(nprobe, self.nlist))
        return super().search(x, k, params=params)

    def _search_big_batch(self, x, k, nprobe):
        """Big-batch ADC over the group-packed layout (faiss_tpu :1609): per
        query bucket the bf16 LUTs, the coarse term masked by nprobe (0 =
        exhaustive) and K4; then + ||q||^2, slots to ids, keys of masked
        lists (>= 5e8) dropped, distances clamped at 0. For k > 128 or
        ksub > 16 (8-bit PQ) the XLA ADC scan instead."""
        if k > LANES or self.pq.ksub > 16:
            D, slots = self._big_batch_xla(x, k, nprobe)
            return D, self._ids_of(slots)
        br = self._build_brute()
        if nprobe >= self.nlist:
            nprobe = 0
        nq = len(x)
        D = np.full((nq, k), np.inf, np.float32)
        I = np.full((nq, k), -1, np.int64)
        for start, padded, real in query_buckets(nq):
            xq = torch.zeros(padded, self.d, device=self.device)
            xq[:real] = torch.from_numpy(x[start : start + real]).to(self.device)
            cm2 = _masked_coarse_bias(xq, br["centroids_g"], br["cn2g"], nprobe)
            # the select is exact: no lossy rows for faiss_tpu's
            # _big_batch_xla repair
            keys, slots_raw, _ = ivfpq_fused(
                cm2, _adc_luts(xq, br["cbt"]), br["codesT"], br["n2s"],
                br["lid"], qt=min(padded, 256), ct=self.FUSED_CT,
            )
            d = keys[:real, :k] + xq[:real].square().sum(dim=1)[:, None]
            slots = _slots_of(slots_raw[:real], br, k)
            if nprobe:  # masked-list sentinels are not results
                keep = d < _MASKED_KEY
                slots = torch.where(keep, slots, -1)
                d = torch.where(keep, d, float("inf"))
            D[start : start + real] = d.clamp_min(0.0).cpu().numpy()
            I[start : start + real] = self._ids_of(slots.cpu().numpy())
        return D, I

    def _big_batch_xla(self, x, k, nprobe):
        """The XLA ADC scan of faiss_tpu (:1559) over every code in input
        order: per query bucket the float32 LUTs -2 q . y, the coarse
        products q . c (pushed to -5e8 off each query's nprobe nearest
        lists, so their keys exceed 5e8 and are dropped) and
        ops/pq_ops.ivfpq_brute_adc_knn. Its select is exact, so no row
        needs repair. Returns (D [nq, k] float32, input slots int64)."""
        br = self._build_brute()
        cb = self.pq._dev()
        if nprobe >= self.nlist:
            nprobe = 0
        nq = len(x)
        D = np.full((nq, k), np.inf, np.float32)
        S = np.full((nq, k), -1, np.int64)
        cent = br["centroids"]
        for start, padded, real in query_buckets(nq):
            with tracing.span("xla.sub_batch"):
                xq = torch.zeros(padded, self.d, device=self.device)
                xs = x[start : start + real]
                with tracing.wait("xla.h2d", xs.nbytes):
                    xq[:real] = torch.from_numpy(xs).to(self.device)
                luts = -2.0 * pq_ops.pq_ip_tables(xq, cb)
                coarse_ip = xq @ cent.T
                if nprobe:
                    key = cent.square().sum(-1)[None, :] - 2.0 * coarse_ip
                    cols = topk(key, nprobe, largest=False)[1]
                    coarse_ip = torch.where(_probe_mask(coarse_ip, cols),
                                            coarse_ip, -5e8)
                dd, ii = pq_ops.ivfpq_brute_adc_knn(
                    luts, coarse_ip, xq.square().sum(1), br["codes"],
                    br["listnos"], br["n2"], k,
                )
                dd, ii = dd[:real], ii[:real]
                if nprobe:  # candidates from masked lists are not results
                    keep = dd < _MASKED_KEY
                    ii = torch.where(keep, ii, -1)
                    dd = torch.where(keep, dd, float("inf"))
                with tracing.wait("xla.d2h_dist", dd.nbytes):
                    dd = dd.cpu().numpy()
                with tracing.wait("xla.d2h_ids", ii.nbytes):
                    ii = ii.cpu().numpy()
                D[start : start + real] = dd
                S[start : start + real] = ii
        return D, S

    def _build_brute(self):
        """Group-packed search layout (faiss_tpu :1069): the codes, norms
        and list ids of every packed slot, the grouped coarse centroids and
        the chunk metadata of the worklists, and, within
        ``recon_scan_max_bytes``, the bf16 decoded store (else ``yT`` is
        None); plus the codes, lists and norms in input order and the coarse
        centroids, which the XLA ADC scan reads."""
        if self._brute is not None:
            return self._brute
        if not self.ntotal:
            raise RuntimeError("the index is empty")
        if not self.by_residual:
            raise NotImplementedError(
                "the group-packed layout holds residual codes; with "
                "by_residual=False every search scans by probe"
            )
        # the first search stages the layout: one wait for its copies
        with tracing.wait("layout.stage", self._codes_host.nbytes
                          + self._listnos_host.nbytes):
            self._dyn_bucket = None  # worklist size is layout-dependent
            pq, ct, dev = self.pq, self.FUSED_CT, self.device
            centroids = self._centroids_host()
            listnos = self._listnos_host
            lay, local_of = grouped_layout(listnos, centroids, self.nlist, ct, dev)
            sm_d = lay["slot_map_dev"]
            codes_d = codes_tensor(self._codes_host, dev)
            ln_d = torch.from_numpy(listnos.astype(np.int64)).to(dev)
            cent_d = torch.from_numpy(centroids).to(dev)
            cn2 = torch.from_numpy((centroids**2).sum(1).astype(np.float32)).to(dev)
            n2 = _slot_norms(codes_d, ln_d, self._maybe_term2(), cn2)
            codesT, n2s, lid = _stage_brute_device(codes_d, ln_d, n2, sm_d, local_of)
            d_pad = -(-self.d // 128) * 128
            yT = None
            if len(lay["slot_map"]) * d_pad * 2 <= self.recon_scan_max_bytes:
                yT = _stage_recon_device(codes_d, ln_d, cent_d, pq._dev(), sm_d, d_pad)
            self._brute = dict(
                lay, yT=yT, d_pad=d_pad, codesT=codesT, n2s=n2s, lid=lid,
                cbt=pq_ops.pq_blockdiag_codebook(pq._dev()), codes=codes_d,
                listnos=ln_d, n2=n2, centroids=cent_d,
            )
        return self._brute

    _dyn_bucket_for = dyn_bucket_for

    def _search_big_batch_refined(self, x, k, kc, refine_xb, nprobe,
                                  refine_n2, refine_sq=None):
        return self._sbbr_collect(
            self._sbbr_submit(x, k, kc, refine_xb, nprobe, refine_n2,
                              refine_sq=refine_sq)
        )

    def _sbbr_submit(self, x, k, kc, refine_xb, nprobe, refine_n2,
                     refine_sq=None):
        """Dispatch phase of the refined big-batch search (faiss_tpu :1275):
        every sub-batch is enqueued on the device and nothing waits for
        results, except the one-off worklist sizing of a new nprobe. Per
        sub-batch the branch is faiss_tpu's: with a selective nprobe whose
        worklists stay within the engage fraction, the dynamic-chunk scan
        (K1 over the decoded store, K5 over the codes); otherwise the
        exhaustive scan (K2 over the decoded store, K4 over the codes),
        masked to the probed lists when nprobe > 0. ``refine_sq`` = (scale,
        off) where the refine store holds SQ8 codes (Refine(SQ8)): the
        re-rank dequantizes the gathered rows (faiss_tpu :1261-1326).
        Returns the state for :meth:`_sbbr_collect`."""
        br = self._build_brute()
        use_recon = br["yT"] is not None
        kc = min(kc, LANES)
        if nprobe >= self.nlist:
            nprobe = 0
        frac = self.dyn_engage_frac if self.strict_probe else self.soft_engage_frac
        ct, nch = self.FUSED_CT, br["nchunks"]
        nq = len(x)
        pending = []
        for start, padded, real in query_buckets(nq, self.pipeline_batch):
            with tracing.span("sbbr.sub_batch"):
                qt = min(padded, 256)
                xq = torch.zeros(padded, self.d, device=self.device)
                xs = x[start : start + real]
                with tracing.wait("sbbr.h2d", xs.nbytes):
                    xq[:real] = torch.from_numpy(xs).to(self.device)
                use_dyn = bool(nprobe)
                if use_dyn:
                    msteps = self._dyn_bucket_for(xq, br, nprobe, qt)
                    use_dyn = msteps <= int(frac * nch)
                if use_dyn and use_recon:
                    out = _fused_search_rerank_recon_dyn(
                        xq, br, refine_xb, refine_n2, k, kc, qt, ct, nprobe,
                        msteps, self.strict_probe, sq=refine_sq,
                    )
                elif use_dyn:
                    out = _fused_search_rerank_dyn(
                        xq, br, refine_xb, k, kc, qt, ct, nprobe, msteps,
                        sq=refine_sq,
                    )
                elif use_recon:
                    out = _fused_search_rerank_recon(
                        xq, br, refine_xb, refine_n2, k, kc, qt, ct, nprobe,
                        sq=refine_sq,
                    )
                else:
                    out = _fused_search_rerank(
                        xq, br, refine_xb, k, kc, qt, ct, nprobe, sq=refine_sq,
                    )
            nscan = msteps if use_dyn else nch
            ivf_fast_scan_stats.nq += real
            ivf_fast_scan_stats.ndis += padded * nscan * ct
            ivf_fast_scan_stats.chunks_scanned += nscan
            ivf_fast_scan_stats.chunks_skipped += nch - nscan
            pending.append((start, real, out, use_dyn))
        return {"pending": pending, "nq": nq, "k": k, "nprobe": nprobe,
                "nchunks": nch}

    _sbbr_collect = collect_sub_batches


class IndexIVFPQFastScan(IndexIVFPQ):
    """4-bit IVFPQ (reference: faiss/IndexIVFPQFastScan.h:25). ``bbs``, the
    reference's code block size, is kept for the factory string and the
    index file; the port's layouts do not depend on it."""

    def __init__(self, quantizer, d, nlist, M, nbits=4, metric=MetricType.L2,
                 bbs=32, *, device):
        if nbits != 4:
            raise ValueError("FastScan requires nbits=4")
        super().__init__(quantizer, d, nlist, M, nbits, metric, device=device)
        self.bbs = int(bbs)


class IndexIVFPQR(IndexIVFPQ):
    """IVF-PQ with residual refinement (reference: faiss/IndexIVFPQR.h:21;
    faiss_tpu :1786). A second PQ encodes the residual left after IVF-PQ
    reconstruction; ``search`` takes k * k_factor IVF-PQ candidates and
    re-ranks them, on the device, by their exact float32 distance to the
    refined reconstruction."""

    def __init__(self, quantizer, d, nlist, M, nbits, M_refine, nbits_refine,
                 metric=MetricType.L2, *, device):
        super().__init__(quantizer, d, nlist, M, nbits, metric, device=device)
        self.refine_pq = ProductQuantizer(d, M_refine, nbits_refine, device=device)
        self.k_factor = 4
        self._refine_codes = None  # [ntotal, M_refine] uint8/uint16, add order

    def train_encoder(self, x, assign):
        """The IVF-PQ, then the refine PQ on what the IVF-PQ leaves of the
        residual to the coarse centroid (faiss_tpu :1802)."""
        super().train_encoder(x, assign)
        res = x - self._centroids_dev()[assign]
        cb = self.pq._dev()
        left = res - pq_ops.pq_decode(pq_ops.pq_encode(res, cb), cb)
        self.refine_pq.cp.verbose = False
        self.refine_pq.train(left.cpu().numpy())

    def add_core(self, x, ids, listnos) -> None:
        """Encode with the IVF-PQ, then the residual of its reconstruction
        with the refine PQ (faiss_tpu :1812), on the device."""
        x = torch.as_tensor(x, device=self.device).float()
        listnos = torch.as_tensor(listnos, device=self.device).long().ravel()
        codes = self.encode_vectors(x, listnos)
        left = x - self._decode_dev(codes_tensor(codes, self.device), listnos)
        rcodes = pq_ops.pq_encode(left, self.refine_pq._dev())
        self.add_encoded(codes, listnos.to(torch.int32).cpu().numpy(), ids,
                         refine_codes=codes_numpy(rcodes, self.refine_pq.nbits))

    def add_encoded(self, codes, listnos, ids=None, *, refine_codes=None) -> None:
        """Append encoded entries with their refine codes [n, M_refine]."""
        if refine_codes is None or len(refine_codes) != len(codes):
            raise ValueError("IndexIVFPQR entries need one refine code each")
        rc = np.ascontiguousarray(
            refine_codes, np.uint8 if self.refine_pq.nbits <= 8 else np.uint16)
        super().add_encoded(codes, listnos, ids)
        self._refine_codes = (
            rc.copy() if self._refine_codes is None
            else np.concatenate([self._refine_codes, rc])
        )

    def reset(self) -> None:
        super().reset()
        self._refine_codes = None

    def _keep_entries(self, keep) -> None:
        super()._keep_entries(keep)
        self._refine_codes = self._refine_codes[keep]

    def _merge_entries(self, other, add_id: int) -> None:
        self.add_encoded(other._codes_host.copy(), other._listnos_host,
                         other._ids_host + add_id,
                         refine_codes=other._refine_codes)

    def _write_entries(self, slots, x, listnos) -> None:
        """The IVF-PQ codes, then the refine codes of what they leave."""
        super()._write_entries(slots, x, listnos)
        dev = self.device
        codes = codes_tensor(self._codes_host[slots], dev)
        left = x.float() - self._decode_dev(codes, listnos.long())
        self._refine_codes[slots] = codes_numpy(
            pq_ops.pq_encode(left, self.refine_pq._dev()), self.refine_pq.nbits)

    def search(self, x, k: int, *, params=None):
        """IVF-PQ candidates (k * k_factor of them), re-ranked on the device
        by ||x - (decode + refine decode)||^2 in float32 (faiss_tpu :1832)."""
        x = self._check_input(x)
        kc = max(k, int(k * self.k_factor))
        _, Ic = super().search(x, kc, params=params)
        nq = len(x)
        D = np.full((nq, k), np.inf, np.float32)
        I = np.full((nq, k), -1, np.int64)
        if not nq:
            return D, I
        valid = Ic >= 0
        slots = np.zeros(Ic.shape, np.int64)
        slots[valid] = self._slots_of_ids(Ic[valid])
        dev, rcb = self.device, self.refine_pq._dev()
        for start, _, real in query_buckets(nq):
            sl = slice(start, start + real)
            flat = slots[sl].ravel()
            refined = self._decode_dev(
                codes_tensor(self._codes_host[flat], dev),
                torch.from_numpy(self._listnos_host[flat].astype(np.int64)).to(dev),
            ) + pq_ops.pq_decode(codes_tensor(self._refine_codes[flat], dev), rcb)
            xq = torch.from_numpy(x[sl]).to(dev)
            d2 = (refined.view(real, kc, self.d) - xq[:, None, :]).square().sum(-1)
            ok = torch.from_numpy(valid[sl]).to(dev)
            d2 = torch.where(ok, d2, float("inf"))
            dd, pos = topk(d2, k, largest=False)
            ii = torch.gather(torch.from_numpy(Ic[sl]).to(dev), 1, pos)
            ii = torch.where(torch.isinf(dd), -1, ii)
            D[sl, : dd.shape[1]] = dd.cpu().numpy()
            I[sl, : dd.shape[1]] = ii.cpu().numpy()
        return D, I
