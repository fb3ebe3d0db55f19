"""IVF-PQ serving slice (counterpart of faiss_tpu/models/ivf_pq.py).

The path ported here is IndexRefineFlat over IndexIVFPQFastScan at a
selective nprobe with soft probing: queries are sorted by home group, each
256-query tile scans only the chunks of its probed lists (the implem_12
semantics of IndexIVFFastScan.cpp:1166) through kernel K1 against a bf16
decoded-reconstruction store, and the top candidates are re-ranked exactly
against the refine store. Results come back as float32 D and int64 I.

Left out on purpose: the int8/fp16 query staging, the single-read ``carry``
chain, the packed f16 readback and ``rt_econ`` of faiss_tpu exist because
its TPU sat behind a remote link (ROADMAP: port them only if the H100 shows
they help).
"""

from __future__ import annotations

import numpy as np
import torch

from ..base import query_buckets
from ..codecs.pq import ProductQuantizer
from ..metric import MetricType
from ..ops import pq_ops
from ..ops.distances import rerank_exact
from ..ops.fused_knn import ivf_recon_fused_dyn
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


# packed slots decoded per staging step (a [CH, d] float32 transient)
_STAGE_CH = 1 << 18

# Budget for the bf16 decoded store backing K1 (2 * d_pad bytes per slot).
# This is faiss_tpu's value (models/ivf_pq.py:1067), sized for a 16 GB TPU;
# re-deriving it for 80 GB and the code-streaming ADC path beyond it are
# ROADMAP queue 1 item 5.
RECON_SCAN_MAX_BYTES = 4 << 30


def _stage_recon_device(codes, listnos, cent, codebooks, slot_map, d_pad):
    """Decoded-reconstruction store for K1 (faiss_tpu :787): y = c_list +
    pq_decode(code) in float32, rounded to bf16, TRANSPOSED [d_pad, S_pad],
    dims zero-padded, laid out by gathering through ``slot_map`` (packed
    position -> input slot, -1 = pad). The decode gathers ``codebook[m,
    code]`` directly; faiss_tpu decodes through a one-hot GEMM that is
    float32-faithful to ~16 bits, so the two stores agree to 1 bf16 ulp.
    Decoded window by window, so the unpacked [n, d] reconstruction is never
    built."""
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


def _dyn_probe_bitmap(xq, cent_g, cn2g, chunk_first, chunk_last, nprobe, qt,
                      nchunks):
    """Probe, home-group sort and per-tile chunk bitmap of the dynamic-chunk
    search (faiss_tpu :414, soft-probe form). Returns (perm, bitmap
    [T, nchunks + 1]) for home-group-sorted queries; the trailing bitmap
    column is the PAD chunk (cleared)."""
    nq = xq.shape[0]
    key = cn2g[None, :] - 2.0 * (xq @ cent_g.T)
    if nprobe <= 4:
        # iterative argmin (first minimum on ties, like jnp.argmin)
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
    return perm, bitmap


def _k1_inputs(xq, br, nprobe, qt, msteps):
    """K1's inputs for one padded sub-batch: queries sorted by home group so
    a qt-query tile's probed lists share chunks, and each tile's probed-chunk
    union, ascending and cut at ``msteps``, as its worklist (the PAD chunk
    fills unused steps). Returns (perm, xq_p [nq, d_pad] sorted and
    zero-padded, cmap [nq // qt, msteps] int32, ndropped), where ndropped
    counts probed chunks cut off by ``msteps``."""
    nchunks = br["nchunks"]
    perm, bitmap = _dyn_probe_bitmap(
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
    d_pad = br["yT"].shape[0]
    xq_p = torch.nn.functional.pad(xq[perm], (0, d_pad - xq.shape[1]))
    return perm, xq_p.contiguous(), cmap, ndropped


def _fused_search_rerank_recon_dyn(xq, br, xb, xb_n2, k, kc, qt, ct, nprobe,
                                   msteps):
    """nprobe-sparse recon scan + exact re-rank for one padded sub-batch
    (faiss_tpu :662 with strict_probe=False): K1 over the tile worklists,
    its candidates mapped through ``slot_map`` to input slots, the top
    ``kc`` re-ranked exactly against the refine store, rows returned in the
    original order. Returns (D [nq, k] f32, slots [nq, k] int64, ndropped),
    on the device."""
    perm, xq_p, cmap, ndropped = _k1_inputs(xq, br, nprobe, qt, msteps)
    _, slots_raw, _ = ivf_recon_fused_dyn(
        xq_p, br["yT"], br["n2s"], cmap, qt, ct
    )
    slots = torch.where(
        slots_raw >= 0, br["slot_map_dev"][slots_raw.clamp_min(0).long()], -1
    )[:, :kc]
    D, I = rerank_exact(xq[perm], xb, slots, k, xb_n2=xb_n2)
    inv = torch.argsort(perm, stable=True)
    return D[inv], I[inv], ndropped


class IndexIVFPQ(IndexIVF):
    """reference: faiss/IndexIVFPQ.h:31. By-residual L2 only.

    Search runs through IndexRefineFlat on the refined big-batch path
    (_sbbr_submit / _sbbr_collect); IVF-PQ's own search paths are ROADMAP
    queue 1 item 5."""

    # slots per K1 chunk (group-packed, multi-list)
    FUSED_CT = 2048
    # dynamic-chunk worklist cap (0 = adapt: the first batch measures the
    # max per-tile probed-chunk union, rounded up to a 64 bucket per nprobe;
    # a batch that drops chunks widens the bucket for the next call)
    dyn_msteps = 0
    _dyn_bucket = None
    # engage the dyn scan only below this probed-chunk fraction (soft mode)
    soft_engage_frac = 0.7
    # False = soft probing: every slot in a worklist chunk competes on its
    # true key. True (the faiss_tpu default, exact "nprobe lists only") needs
    # K1's penalized mode, which is ROADMAP queue 2.
    strict_probe = True
    # refined-path sub-batch size
    pipeline_batch = 4096

    def __init__(self, quantizer, d: int, nlist: int, M: int, nbits: int = 8,
                 metric=MetricType.L2, *, device):
        super().__init__(quantizer, d, nlist, metric, device=device)
        self.pq = ProductQuantizer(d, M, nbits, device=device)
        # nq at or above this goes to the fused big-batch path
        self.big_batch_threshold = 128
        self._brute = None
        self.is_trained = False

    def train_encoder(self, x: torch.Tensor, assign: torch.Tensor) -> None:
        resid = x - self.quantizer._consolidate()[assign]
        self.pq.cp.verbose = False
        self.pq.train(resid.cpu().numpy())

    def encode_vectors(self, x: torch.Tensor, listnos: torch.Tensor) -> np.ndarray:
        """Residual PQ codes [n, M] uint8, computed on the device."""
        resid = x.float() - self.quantizer._consolidate()[listnos]
        codes = pq_ops.pq_encode(resid, self.pq._dev())
        return codes.to(torch.uint8).cpu().numpy()

    def add_encoded(self, codes, listnos, ids=None) -> None:
        super().add_encoded(codes, listnos, ids)
        self._brute = None

    def reset(self) -> None:
        super().reset()
        self._brute = None

    def search(self, x, k: int, *, params=None):
        raise NotImplementedError(
            "IndexIVFPQ.search (per-probe scan, exhaustive and one-hot ADC "
            "paths) is ROADMAP queue 1 item 5; search through IndexRefineFlat"
        )

    def _build_brute(self):
        """Group-packed search layout and decoded store (faiss_tpu :1069,
        recon branch)."""
        if self._brute is not None:
            return self._brute
        if not self.ntotal:
            raise RuntimeError("the index is empty")
        self._dyn_bucket = None  # worklist size is layout-dependent
        pq, ct, dev = self.pq, self.FUSED_CT, self.device
        centroids = self.quantizer.vectors()
        codes = self._codes_host.astype(np.uint8)
        listnos = self._listnos_host
        # term2[l, m, k] = ||y_mk||^2 + 2 c_lm . y_mk (IndexIVFPQ.cpp:407)
        cb = pq.centroids
        y_norms = np.sum(cb**2, axis=-1)  # [M, ksub]
        cmk = centroids.reshape(self.nlist, pq.M, pq.dsub)
        cdoty = 2.0 * np.einsum("cmd,mkd->cmk", cmk, cb)
        term2 = (y_norms[None] + cdoty).astype(np.float32)
        g = pack_invlists_grouped(listnos, self.nlist, ct, centroids=centroids)
        S = g["S"]
        nchunks = S // ct
        d_pad = -(-self.d // 128) * 128
        if (S + ct) * d_pad * 2 > RECON_SCAN_MAX_BYTES:
            raise NotImplementedError(
                "the decoded store exceeds RECON_SCAN_MAX_BYTES; the "
                "code-streaming ADC scan (K4/K5) is ROADMAP queue 1 item 5"
            )
        # one trailing all-+inf PAD chunk backs the worklists' unused steps
        slot_map = np.concatenate([g["slot_map"], np.full(ct, -1, np.int64)])
        codes_d = torch.from_numpy(codes).to(dev)
        ln_d = torch.from_numpy(listnos.astype(np.int64)).to(dev)
        sm_d = torch.from_numpy(slot_map).to(dev)
        # per-slot norms from term2 (faiss_tpu _stage_brute_device, :892):
        # ||c + y||^2 of the float32 reconstruction, not of the bf16 store
        t2 = torch.from_numpy(term2).to(dev)
        t2sum = t2[
            ln_d[:, None], torch.arange(pq.M, device=dev)[None, :], codes_d.long()
        ].sum(dim=1)
        cn2 = torch.from_numpy((centroids**2).sum(1).astype(np.float32)).to(dev)
        n2 = cn2[ln_d] + t2sum
        n2s = torch.where(
            sm_d >= 0, n2[sm_d.clamp_min(0)], torch.full_like(n2[:1], float("inf"))
        )[None].contiguous()
        lp = g["list_perm"]
        cent_g = np.zeros((len(lp), centroids.shape[1]), np.float32)
        cent_g[lp >= 0] = centroids[lp[lp >= 0]]
        cn2g = np.full(len(lp), np.inf, np.float32)
        cn2g[lp >= 0] = (cent_g[lp >= 0] ** 2).sum(1)
        # chunk span of each grouped column (+ chunk -> group map); empty
        # and unused columns point at the PAD chunk
        cs, cl = g["col_start"], g["col_len"]
        chunk_first = np.where(cl > 0, cs // ct, nchunks)
        chunk_last = np.where(cl > 0, (cs + np.maximum(cl, 1) - 1) // ct, nchunks)
        cgroup = np.concatenate(
            [np.repeat(np.arange(g["ngroups"]), g["cpg"]), np.zeros(1, np.int64)]
        )
        cent_d = torch.from_numpy(centroids).to(dev)
        yT = _stage_recon_device(codes_d, ln_d, cent_d, pq._dev(), sm_d, d_pad)
        self._brute = {
            "yT": yT,
            "n2s": n2s,
            "centroids_g": torch.from_numpy(cent_g).to(dev),
            "cn2g": torch.from_numpy(cn2g).to(dev),
            "slot_map": slot_map,
            "slot_map_dev": sm_d,
            "chunk_first": torch.from_numpy(chunk_first).to(dev),
            "chunk_last": torch.from_numpy(chunk_last).to(dev),
            "cgroup": torch.from_numpy(cgroup).to(dev),
            "nchunks": nchunks,
        }
        return self._brute

    def _dyn_bucket_for(self, xq_dev, br, nprobe, qt):
        """Worklist length for this nprobe (faiss_tpu :1245)."""
        if self.dyn_msteps:
            return min(self.dyn_msteps, br["nchunks"])
        if self._dyn_bucket is None:
            self._dyn_bucket = {}
        if nprobe not in self._dyn_bucket:
            _, bitmap = _dyn_probe_bitmap(
                xq_dev, br["centroids_g"], br["cn2g"], br["chunk_first"],
                br["chunk_last"], nprobe, qt, br["nchunks"],
            )
            m = int(bitmap.sum(dim=1).max())  # one host sync per nprobe
            self._dyn_bucket[nprobe] = min(br["nchunks"], -(-m // 64) * 64)
        return self._dyn_bucket[nprobe]

    def _search_big_batch_refined(self, x, k, kc, refine_xb, nprobe,
                                  refine_n2):
        return self._sbbr_collect(
            self._sbbr_submit(x, k, kc, refine_xb, nprobe, refine_n2)
        )

    def _sbbr_submit(self, x, k, kc, refine_xb, nprobe, refine_n2):
        """Dispatch phase of the refined big-batch search (faiss_tpu :1275,
        dyn + recon branch): every sub-batch is enqueued on the device and
        nothing waits for results, except the one-off worklist sizing of a
        new nprobe. Returns the state for :meth:`_sbbr_collect`."""
        if self.strict_probe:
            raise NotImplementedError(
                "strict probing needs K1's penalized mode (ROADMAP queue 2); "
                "set strict_probe = False"
            )
        if nprobe >= self.nlist:
            nprobe = 0
        if not nprobe:
            raise NotImplementedError(
                "the exhaustive recon scan (K2) is ROADMAP queue 1 item 5"
            )
        br = self._build_brute()
        kc = min(kc, 128)
        nq = len(x)
        pending = []
        for start, padded, real in query_buckets(nq, self.pipeline_batch):
            qt = min(padded, 256)
            xq = torch.zeros(padded, self.d, device=self.device)
            xq[:real] = torch.from_numpy(x[start : start + real]).to(self.device)
            msteps = self._dyn_bucket_for(xq, br, nprobe, qt)
            if msteps > int(self.soft_engage_frac * br["nchunks"]):
                raise NotImplementedError(
                    f"worklists of {msteps} of {br['nchunks']} chunks exceed "
                    "soft_engage_frac: the sequential recon scan (K2) is "
                    "ROADMAP queue 1 item 5"
                )
            out = _fused_search_rerank_recon_dyn(
                xq, br, refine_xb, refine_n2, k, kc, qt, self.FUSED_CT,
                nprobe, msteps,
            )
            pending.append((start, real, out))
        return {"pending": pending, "nq": nq, "k": k, "nprobe": nprobe,
                "nchunks": br["nchunks"]}

    def _sbbr_collect(self, st):
        """Read phase (faiss_tpu :1497): copy each sub-batch home, map slots
        to ids, and widen the adaptive worklist bucket when a batch dropped
        probed chunks (its recall impact is bounded to that batch)."""
        nq, k, nprobe = st["nq"], st["k"], st["nprobe"]
        D = np.full((nq, k), np.inf, np.float32)
        I = np.full((nq, k), -1, np.int64)
        for start, real, (d, slots, ndropped) in st["pending"]:
            if int(ndropped) > 0 and not self.dyn_msteps:
                self._dyn_bucket[nprobe] = min(
                    st["nchunks"], self._dyn_bucket[nprobe] + 64
                )
            d = d[:real].cpu().numpy()
            slots = slots[:real].cpu().numpy()
            D[start : start + real, : d.shape[1]] = d
            I[start : start + real, : d.shape[1]] = np.where(
                slots >= 0, self._ids_host[np.maximum(slots, 0)], -1
            )
        return D, I


class IndexIVFPQFastScan(IndexIVFPQ):
    """4-bit IVFPQ (reference: faiss/IndexIVFPQFastScan.h:25)."""

    def __init__(self, quantizer, d, nlist, M, nbits=4, metric=MetricType.L2,
                 *, device):
        if nbits != 4:
            raise ValueError("FastScan requires nbits=4")
        super().__init__(quantizer, d, nlist, M, nbits, metric, device=device)
