"""Sharded indexes over a mesh of devices (counterpart of
faiss_tpu/parallel/sharded.py; the reference's IndexShards / IndexShardsIVF
composition and gpu/GpuCloner.cpp's multi-GPU sharding).

faiss_tpu runs one controller over a ``Mesh`` of devices in one process:
the database (or the inverted lists) is sharded over the mesh axis, queries
and coarse centroids are replicated, every device runs the single-device
scan, and ``all_gather`` + k-select (``psum`` for k-means) merge inside one
jit. Here the mesh is an ordered list of ``torch.device``\\ s in one process,
and shard ``s`` lives on ``devices[s]``. Each shard runs the same local work
as the unsharded index (``ops.distances.knn``, ``ops.ivf_ops.ivf_flat_scan``,
``ops.ivf_ops.ivf_pq_scan``, ``ops.kmeans_ops.kmeans_assign_update``); the
``all_gather`` becomes moving each shard's ``[nq, k]`` result to
``devices[0]`` and stacking it, the k-select ``ops.topk.merge_topk_many``
there, and ``psum`` a sum there. The host issues the shards one after
another; on CUDA their launches are asynchronous, so shards on distinct
cards overlap. A device may hold several shards (four shards on one card is
the chip smoke test's layout). There is no multi-process launcher: faiss_tpu
has none either. Like faiss_tpu's, this is plain tensor code, no kernel:
its local work goes through XLA there, not a Pallas kernel.

Sharded == unsharded up to the order of ties (tests/test_torch_sharded.py
on ``make_mesh(devices=["cpu"] * 4)``)."""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..clustering import Clustering
from ..codecs.pq import ProductQuantizer, codes_tensor
from ..metric import MetricType, is_similarity_metric
from ..ops import distances as dops
from ..ops import pq_ops
from ..ops.ivf_ops import RaggedLists, ivf_flat_scan, ivf_pq_scan
from ..ops.kmeans_ops import kmeans_assign_update
from ..ops.topk import merge_topk_many, topk


class Mesh:
    """An ordered list of devices (the counterpart of faiss_tpu's one-axis
    ``jax.sharding.Mesh``): shard ``s`` lives on ``devices[s]``; a device
    may appear more than once."""

    def __init__(self, devices: Sequence):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self):
        return f"Mesh({[str(d) for d in self.devices]})"


def make_mesh(n_devices: Optional[int] = None, *, devices=None) -> Mesh:
    """A mesh over ``devices`` (any torch devices, repeats allowed), or over
    the visible CUDA devices when none are named; its first ``n_devices``
    when given (faiss_tpu/parallel/sharded.py:33). Raises where no device is
    named and there is no CUDA device: there is no CPU fallback."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device; name the mesh's devices, e.g. "
                "make_mesh(devices=['cpu'] * 4)"
            )
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = list(devices)
    return Mesh(devices[:n_devices] if n_devices else devices)


def _shard_pad(x: np.ndarray, n_shards: int, fill=0) -> Tuple[np.ndarray, int]:
    """Pad axis 0 to a multiple of n_shards; returns (padded, per_shard)."""
    n = len(x)
    per = -(-n // n_shards)
    pad = per * n_shards - n
    if pad:
        pad_block = np.full((pad,) + x.shape[1:], fill, x.dtype)
        x = np.concatenate([x, pad_block])
    return x, per


def _replicate(t: torch.Tensor, mesh: Mesh) -> List[torch.Tensor]:
    """``t`` on every device of the mesh, one copy per distinct device."""
    on = {}
    for dev in mesh.devices:
        if dev not in on:
            on[dev] = t.to(dev)
    return [on[dev] for dev in mesh.devices]


def _split_rows(x, mesh: Mesh) -> List[torch.Tensor]:
    """Points as one shard per device: a sequence of ``mesh.size`` tensors
    (each moved to its device), or one [n, d] array or tensor with n a
    multiple of the shard count, split into equal row ranges."""
    if isinstance(x, (list, tuple)):
        if len(x) != mesh.size:
            raise ValueError("one row block per shard")
        return [torch.as_tensor(p).to(dev) for p, dev in zip(x, mesh.devices)]
    x = torch.as_tensor(np.ascontiguousarray(x) if isinstance(x, np.ndarray) else x)
    if len(x) % mesh.size:
        raise ValueError("rows must be a multiple of the shard count (_shard_pad)")
    per = len(x) // mesh.size
    return [x[s * per : (s + 1) * per].to(dev) for s, dev in enumerate(mesh.devices)]


def _gather_merge(mesh: Mesh, parts, k: int, largest: bool):
    """The all_gather + k-select: each shard's (dists, ids) [nq, k'] moved
    to ``devices[0]``, stacked to [nq, S, k'] and merged to the best k."""
    d0 = mesh.devices[0]
    dd = torch.stack([d.to(d0) for d, _ in parts], dim=1)
    ii = torch.stack([i.to(d0) for _, i in parts], dim=1)
    return merge_topk_many(dd, ii, k, largest=largest)


def _local_probes(probes: torch.Tensor, shard: int, lps: int) -> torch.Tensor:
    """The probes that shard ``shard`` owns (lists [shard * lps, (shard + 1)
    * lps)) renumbered to its local lists, -1 elsewhere."""
    local = probes - shard * lps
    return torch.where((local >= 0) & (local < lps), local, -1)


def _host_results(D: torch.Tensor, slots: torch.Tensor, ids_host: np.ndarray):
    """(D float32, I int64) on the host, the slots mapped to ids."""
    slots = slots.cpu().numpy()
    return (D.cpu().numpy(),
            np.where(slots >= 0, ids_host[np.maximum(slots, 0)], -1))


class ShardedFlat:
    """Brute-force index sharded across the mesh: each device owns a
    disjoint row range (IndexShards' vector split), merged by k-select
    (faiss_tpu sharded.py:49)."""

    def __init__(self, d: int, mesh: Mesh, metric=MetricType.L2):
        self.d = int(d)
        self.mesh = mesh
        self.metric_type = MetricType(metric)
        self.ntotal = 0
        self._xb = None  # one [per_shard, d] tensor per device
        self._host_parts = []

    @property
    def n_shards(self) -> int:
        return self.mesh.size

    def add(self, x) -> None:
        x = np.ascontiguousarray(x, np.float32)
        self._host_parts.append(x)
        self.ntotal += len(x)
        self._xb = None

    def _consolidate(self):
        """The rows padded to a multiple of the shard count, one row range
        on each device."""
        if self._xb is None:
            host = (np.concatenate(self._host_parts)
                    if len(self._host_parts) > 1 else self._host_parts[0])
            padded, self._per_shard = _shard_pad(host, self.n_shards)
            self._xb = _split_rows(padded, self.mesh)
        return self._xb

    def search(self, x, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """(faiss_tpu sharded.py:106) Each shard's exact k-NN over its rows,
        its local ids made global and the pad rows (gid >= ntotal) masked,
        then the merge."""
        x = torch.from_numpy(np.ascontiguousarray(x, np.float32))
        xb = self._consolidate()
        largest = is_similarity_metric(self.metric_type)
        sentinel = float("-inf") if largest else float("inf")
        parts = []
        for s, (xq, xb_s) in enumerate(zip(_replicate(x, self.mesh), xb)):
            d, i = dops.knn(xq, xb_s, k, metric=self.metric_type)
            gid = torch.where(i >= 0, i + s * self._per_shard, -1)
            valid = (gid >= 0) & (gid < self.ntotal)
            parts.append((torch.where(valid, d, sentinel),
                          torch.where(valid, gid, -1)))
        D, I = _gather_merge(self.mesh, parts, k, largest)
        return D.cpu().numpy(), I.cpu().numpy().astype(np.int64)


class ShardedIVF:
    """IVF index with its inverted lists sharded by list range across the
    mesh, one coarse quantizer replicated (IndexShardsIVF.h:19; faiss_tpu
    sharded.py:133). Built from a trained IndexIVF whose per-probe layout
    holds float32 rows ``[nlist, max_len, d]`` (IVF-Flat, IVF-SQ, IVF-AQ);
    PQ codes go to :class:`ShardedIVFPQ`."""

    def __init__(self, index, mesh: Mesh):
        from ..models.ivf import IndexIVF

        if not isinstance(index, IndexIVF):
            raise TypeError("ShardedIVF wraps a trained IndexIVF")
        self.mesh = mesh
        self.index = index
        self.metric_type = index.metric_type
        self.metric_arg = index.metric_arg
        self.nprobe = index.nprobe
        if index.nlist % mesh.size:
            raise ValueError("nlist must be divisible by the shard count")
        lps = self.lists_per_shard = index.nlist // mesh.size

        dev = index._build_device()
        codes = dev.get("codes")
        if (not isinstance(codes, torch.Tensor) or codes.dim() != 3
                or codes.dtype != torch.float32):
            raise TypeError(
                "ShardedIVF requires a float-staged codec (IVFFlat / IVF-SQ /"
                " IVF-AQ decode to [nlist, max_len, d] floats); use"
                " ShardedIVFPQ for PQ codes"
            )

        def split(t):
            return None if t is None else [
                t[s * lps : (s + 1) * lps].to(d)
                for s, d in enumerate(mesh.devices)
            ]

        self.codes = split(codes)
        self.slot_ids = split(dev["slot_ids"])
        self.lengths = split(dev["lengths"])
        self.code_norms = split(dev["code_norms"])  # None but for L2
        self.centroids = _replicate(
            torch.from_numpy(index._centroids_host()), mesh)
        self._ids_host = index._ids_host

    def search(self, x, k: int, nprobe: Optional[int] = None):
        """(faiss_tpu sharded.py:215) The coarse quantization replicated on
        every shard, each shard's scan of its own probed lists, the
        merge."""
        x = torch.from_numpy(np.ascontiguousarray(x, np.float32))
        nprobe = int(nprobe or self.nprobe)
        largest = is_similarity_metric(self.metric_type)
        lps = self.lists_per_shard
        parts = []
        for s, xq in enumerate(_replicate(x, self.mesh)):
            _, probes = dops.knn(xq, self.centroids[s], nprobe,
                                 metric=self.metric_type,
                                 metric_arg=self.metric_arg)
            parts.append(ivf_flat_scan(
                xq, _local_probes(probes, s, lps), self.codes[s],
                self.slot_ids[s], self.lengths[s], k, metric=self.metric_type,
                code_norms=None if self.code_norms is None else self.code_norms[s],
                metric_arg=self.metric_arg,
            ))
        D, slots = _gather_merge(self.mesh, parts, k, largest)
        return _host_results(D, slots, self._ids_host)


# ---------------------------------------------------------------------------
# data-parallel k-means (the distributed_kmeans recipe,
# benchs/distributed_ondisk/distributed_kmeans.py)
# ---------------------------------------------------------------------------


def sharded_kmeans_iter(mesh: Mesh, x, centroids):
    """One Lloyd iteration with the points sharded over the mesh
    (faiss_tpu sharded.py:271): each shard's ``kmeans_assign_update`` of
    its rows, then the partial sums, counts and objectives summed on
    ``devices[0]`` (faiss_tpu's ``psum``). ``x`` is one row block per
    device, or one array whose rows split evenly (see ``_split_rows``).
    Returns (sums [k, d], counts [k], obj) on ``devices[0]``."""
    c = torch.as_tensor(np.ascontiguousarray(centroids, np.float32)
                        if isinstance(centroids, np.ndarray) else centroids)
    d0 = mesh.devices[0]
    sums = counts = obj = None
    for xs, cs in zip(_split_rows(x, mesh), _replicate(c, mesh)):
        su, co, ob, _ = kmeans_assign_update(xs, cs)
        if sums is None:
            sums, counts, obj = su.to(d0), co.to(d0), ob.to(d0)
        else:
            sums, counts, obj = sums + su.to(d0), counts + co.to(d0), obj + ob.to(d0)
    return sums, counts, obj


def _adc_inputs(xq, cb, coarse_dis, metric, by_residual):
    """(luts [nq, M, ksub], bias [nq, nprobe]) of the four metric x
    residual branches (faiss_tpu sharded.py:378): L2 by residual, -2 q.y
    and the coarse distance (term2 per list); L2 without, the full
    distance tables and no bias; inner product, q.y and q.c by residual
    (else 0)."""
    if metric == MetricType.L2 and by_residual:
        return -2.0 * pq_ops.pq_ip_tables(xq, cb), coarse_dis
    if metric == MetricType.L2:
        return pq_ops.pq_distance_tables(xq, cb), torch.zeros_like(coarse_dis)
    bias = coarse_dis if by_residual else torch.zeros_like(coarse_dis)
    return pq_ops.pq_ip_tables(xq, cb), bias


def _pad128(n: int) -> int:
    return max(128, -(-n // 128) * 128)


def _csr_range(lists: RaggedLists, l0: int, l1: int, device) -> RaggedLists:
    """The lists [l0, l1) of a CSR as a CSR of their own on ``device``:
    their rows are one contiguous range, so this is a slice."""
    lengths = lists.lengths[l0:l1]
    r0 = int(lists.offsets[l0]) if l1 > l0 else 0
    r1 = r0 + int(lengths.sum())
    return RaggedLists(
        lists.codes[r0:r1].to(device), lists.slot_ids[r0:r1].to(device),
        (lists.offsets[l0:l1] - r0).to(device), lengths.to(device),
        _pad128(int(lengths.max()) if l1 > l0 else 0),
    )


class ShardedIVFPQ:
    """IVF-PQ with its inverted lists sharded by list range across the mesh
    (faiss_tpu sharded.py:299): coarse centroids and the query's tables
    replicated, each shard's CSR of codes (and term2 tables) on its device,
    each shard's ADC scan of its own probed lists, the merge. Codes keep
    the port's width (uint8; int32 above 8 bits)."""

    def __init__(self, index, mesh: Mesh):
        from ..models.ivf_pq import IndexIVFPQ

        if not isinstance(index, IndexIVFPQ):
            raise TypeError("ShardedIVFPQ wraps a trained IndexIVFPQ")
        self.mesh = mesh
        self.index = index
        self.nprobe = index.nprobe
        self.metric_type = index.metric_type
        self.by_residual = bool(index.by_residual)
        if index.nlist % mesh.size:
            raise ValueError("nlist must be divisible by the shard count")
        lps = self.lists_per_shard = index.nlist // mesh.size
        lists = index._build_device()["lists"]
        self.lists = [_csr_range(lists, s * lps, (s + 1) * lps, d)
                      for s, d in enumerate(mesh.devices)]
        term2 = (index._maybe_term2()
                 if self.by_residual and self.metric_type == MetricType.L2
                 else None)
        # an IMI's factored tables gather the full table's rows by list
        self.term2 = None if term2 is None else [
            term2[torch.arange(s * lps, (s + 1) * lps, device=index.device)].to(d)
            for s, d in enumerate(mesh.devices)
        ]
        self.centroids = _replicate(torch.from_numpy(index._centroids_host()), mesh)
        self.pq_codebooks = _replicate(torch.from_numpy(index.pq.centroids), mesh)
        self._ids_host = index._ids_host

    def _scan_shard(self, s, xq, k, nprobe, lists):
        """Shard ``s``'s replicated coarse quantization and its ADC scan of
        ``lists`` (its CSR) over the probes it owns: (dists, slots)."""
        coarse_dis, probes = dops.knn(xq, self.centroids[s], nprobe,
                                      metric=self.metric_type)
        luts, bias = _adc_inputs(xq, self.pq_codebooks[s], coarse_dis,
                                 self.metric_type, self.by_residual)
        return ivf_pq_scan(
            luts, _local_probes(probes, s, self.lists_per_shard), bias, lists,
            k, term2=None if self.term2 is None else self.term2[s],
            largest=is_similarity_metric(self.metric_type),
        )

    def search(self, x, k: int, nprobe: Optional[int] = None):
        """faiss_tpu sharded.py:374."""
        x = torch.from_numpy(np.ascontiguousarray(x, np.float32))
        nprobe = int(nprobe or self.nprobe)
        parts = [self._scan_shard(s, xq, k, nprobe, self.lists[s])
                 for s, xq in enumerate(_replicate(x, self.mesh))]
        D, slots = _gather_merge(self.mesh, parts, k,
                                 is_similarity_metric(self.metric_type))
        return _host_results(D, slots, self._ids_host)


# ---------------------------------------------------------------------------
# sharded build: trains and fills a ShardedIVFPQ without building the whole
# index in one place (gpu/GpuCloner.h:45-66, IVFlib.h:171)
# ---------------------------------------------------------------------------


class ShardedIVFPQBuilder:
    """Build an IVF-PQ index directly into sharded storage (faiss_tpu
    sharded.py:438).

    - ``train``: the coarse k-means runs data-parallel over the mesh
      (:func:`sharded_kmeans_iter`), the empty clusters split on the host;
      the PQ codebooks train on a residual sample.
    - ``add``: each chunk is coarse-assigned and PQ-encoded on
      ``devices[0]``, then its rows go to the owning shard's host bucket
      (list range [s * lists_per_shard, (s + 1) * lists_per_shard)).
    - ``finalize``: each shard's bucket becomes its CSR on its device, with
      its term2 tables, as a :class:`ShardedIVFPQ`.

    Codes keep the PQ's width: uint16 on the host above 8 bits (faiss_tpu
    casts them to uint8 at :554, so its codes above 8 bits wrap; ROADMAP
    queue 3)."""

    def __init__(self, d, nlist, M, nbits, mesh: Mesh,
                 metric=MetricType.L2, by_residual=True):
        self.d, self.nlist, self.mesh = int(d), int(nlist), mesh
        self.metric_type = MetricType(metric)
        self.by_residual = bool(by_residual)
        n_shards = mesh.size
        if nlist % n_shards:
            raise ValueError("nlist must be divisible by the shard count")
        self.lists_per_shard = nlist // n_shards
        self.n_shards = n_shards
        self.pq = ProductQuantizer(d, M, nbits, device=mesh.devices[0])
        self.centroids: Optional[np.ndarray] = None
        self.ntotal = 0
        self._codes = [[] for _ in range(n_shards)]
        self._listnos = [[] for _ in range(n_shards)]
        self._gids = [[] for _ in range(n_shards)]
        self._ids_parts = []
        self.is_trained = False

    # -- training ------------------------------------------------------------
    def train(self, xt, niter=20, seed=1234, pq_sample=65536):
        """faiss_tpu sharded.py:479: the same ``RandomState(seed)`` draws
        (the initial centroids, the splits, the PQ sample). The rows are
        zero-padded to a multiple of the shard count, and the pad rows take
        part in the k-means as in faiss_tpu."""
        xt = np.ascontiguousarray(xt, np.float32)
        rs = np.random.RandomState(seed)
        centroids = xt[rs.permutation(len(xt))[: self.nlist]].copy()
        xp, _ = _shard_pad(xt, self.n_shards)
        x_sh = _split_rows(xp, self.mesh)
        for _ in range(niter):
            sums, counts, _ = sharded_kmeans_iter(self.mesh, x_sh, centroids)
            sums, counts = sums.cpu().numpy(), counts.cpu().numpy()
            nz = counts > 0
            new_c = centroids.copy()
            new_c[nz] = sums[nz] / counts[nz, None]
            Clustering._split_clusters(new_c, counts.astype(np.int64), rs)
            centroids = new_c
        self.centroids = centroids
        sub = xt[rs.permutation(len(xt))[:pq_sample]]
        if self.by_residual:
            d0 = self.mesh.devices[0]
            _, a = dops.assign_flat(torch.from_numpy(sub).to(d0),
                                    torch.from_numpy(centroids).to(d0),
                                    metric=self.metric_type)
            sub = sub - centroids[a.cpu().numpy()]
        self.pq.train(sub)
        self.is_trained = True

    # -- population ----------------------------------------------------------
    def add(self, x, ids=None, chunk=1 << 20):
        if not self.is_trained:
            raise RuntimeError("train before add")
        x = np.ascontiguousarray(x, np.float32)
        n = len(x)
        ids = (np.arange(self.ntotal, self.ntotal + n, dtype=np.int64)
               if ids is None else np.asarray(ids, np.int64).ravel())
        d0 = self.mesh.devices[0]
        cdev = torch.from_numpy(self.centroids).to(d0)
        for c0 in range(0, n, chunk):
            xc = x[c0 : c0 + chunk]
            _, a = dops.assign_flat(torch.from_numpy(xc).to(d0), cdev,
                                    metric=self.metric_type)
            self.add_preassigned(xc, a.cpu().numpy(), ids[c0 : c0 + chunk])

    def add_preassigned(self, x, assign, ids=None):
        """Add with a precomputed coarse assignment (faiss_tpu sharded.py:534;
        contrib/ivf_tools.py add_preassigned): the rows are PQ-encoded and
        routed to their owning shard's bucket."""
        if not self.is_trained:
            raise RuntimeError("train before add")
        x = np.ascontiguousarray(x, np.float32)
        n = len(x)
        a = np.asarray(assign, np.int64).ravel()
        if len(a) != n:
            raise ValueError("assign length mismatch")
        ids = (np.arange(self.ntotal, self.ntotal + n, dtype=np.int64)
               if ids is None else np.asarray(ids, np.int64).ravel())
        gid0 = sum(len(p) for p in self._ids_parts)
        self._ids_parts.append(ids)
        resid = x - self.centroids[a] if self.by_residual else x
        codes = self.pq.compute_codes_int(resid)
        gids = np.arange(gid0, gid0 + n, dtype=np.int64)
        owner = a // self.lists_per_shard
        for s in range(self.n_shards):
            m = owner == s
            if m.any():
                self._codes[s].append(codes[m])
                self._listnos[s].append(a[m].astype(np.int32))
                self._gids[s].append(gids[m])
        self.ntotal += n

    # -- assembly ------------------------------------------------------------
    def finalize(self) -> ShardedIVFPQ:
        """faiss_tpu sharded.py:566, with each shard's lists as a CSR in
        list order (add order within a list) on its device."""
        M, dsub = self.pq.M, self.pq.dsub
        lps = self.lists_per_shard
        cb = self.pq.centroids  # [M, ksub, dsub]
        y_norms = np.sum(cb**2, axis=-1)  # [M, ksub]
        code_dt = np.uint8 if self.pq.nbits <= 8 else np.uint16
        lists, t2 = [], []
        for s, dev in enumerate(self.mesh.devices):
            if self._listnos[s]:
                ln = np.concatenate(self._listnos[s]) - s * lps
                cd = np.concatenate(self._codes[s])
                gd = np.concatenate(self._gids[s])
            else:
                ln = np.empty(0, np.int32)
                cd = np.empty((0, M), code_dt)
                gd = np.empty(0, np.int64)
            order = np.argsort(ln, kind="stable")
            lengths = np.bincount(ln, minlength=lps).astype(np.int64)
            offsets = np.zeros(lps, np.int64)
            np.cumsum(lengths[:-1], out=offsets[1:])
            lists.append(RaggedLists(
                codes_tensor(cd[order], dev),
                torch.from_numpy(gd[order].astype(np.int32)).to(dev),
                torch.from_numpy(offsets).to(dev),
                torch.from_numpy(lengths).to(dev),
                _pad128(int(lengths.max()) if len(ln) else 0),
            ))
            if self.by_residual and self.metric_type == MetricType.L2:
                cent_s = self.centroids[s * lps : (s + 1) * lps].reshape(lps, M, dsub)
                t2.append(torch.from_numpy((
                    y_norms[None] + 2.0 * np.einsum("cmd,mkd->cmk", cent_s, cb)
                ).astype(np.float32)).to(dev))

        out = ShardedIVFPQ.__new__(ShardedIVFPQ)
        out.mesh = self.mesh
        out.index = None
        out.nprobe = 1
        out.metric_type = self.metric_type
        out.by_residual = self.by_residual
        out.lists_per_shard = lps
        out.lists = lists
        out.term2 = t2 or None
        out.centroids = _replicate(torch.from_numpy(self.centroids), self.mesh)
        out.pq_codebooks = _replicate(torch.from_numpy(cb), self.mesh)
        out._ids_host = (np.concatenate(self._ids_parts) if self._ids_parts
                         else np.empty(0, np.int64))
        return out


class ShardedRefinedIVFPQ:
    """The serving composite, sharded (faiss_tpu sharded.py:658): an
    optional query transform (``vt``, replicated) -> each shard's IVF-PQ
    candidate scan (top-``kc``) -> an exact re-rank against the shard's own
    refine store -> the merge.

    Each shard's refine store holds the transformed vectors ``xb_t`` (in add
    order, as ``index._ids_host``) float16 or float32, row for row in the
    order of the shard's CSR of codes: the scan carries each candidate's
    local row, so the re-rank gathers from the shard's own store without a
    collective, and only [nq, k] per shard is merged."""

    def __init__(self, index, mesh: Mesh, xb_t, vt=None,
                 store_float16=True, k_factor=4):
        self.sharded = ShardedIVFPQ(index, mesh)
        self.mesh = mesh
        self.vt = vt
        self.k_factor = k_factor
        xb_t = np.ascontiguousarray(xb_t, np.float32)
        if len(xb_t) != index.ntotal:
            raise ValueError("xb_t must hold every stored vector")
        dt = torch.float16 if store_float16 else torch.float32
        self.refine, self.pos_lists = [], []
        for lists, dev in zip(self.sharded.lists, mesh.devices):
            sl = lists.slot_ids.cpu().numpy()
            self.refine.append(torch.from_numpy(xb_t[sl]).to(dev).to(dt))
            # the same CSR whose slots are the local rows of the store
            self.pos_lists.append(RaggedLists(
                lists.codes,
                torch.arange(len(sl), dtype=torch.int32, device=dev),
                lists.offsets, lists.lengths, lists.shape[1]))
        # the candidate cap of faiss_tpu (:727): 8 x the longest list,
        # padded to 128
        self.max_len = index._build_device()["lists"].shape[1]

    def search(self, x, k: int, nprobe: Optional[int] = None):
        """faiss_tpu sharded.py:747: per shard, the ADC top-kc, the exact
        float32 re-rank from the local store (|q - y|^2 elementwise, or
        q . y) to the top k, its rows mapped to slots; then the merge."""
        x = np.ascontiguousarray(x, np.float32)
        if self.vt is not None:
            x = self.vt.apply(x)
        x = torch.from_numpy(np.ascontiguousarray(x, np.float32))
        s_ = self.sharded
        nprobe = int(nprobe or s_.nprobe)
        kc = min(int(round(k * self.k_factor)), self.max_len * 8)
        largest = is_similarity_metric(s_.metric_type)
        sentinel = float("-inf") if largest else float("inf")
        parts = []
        for s, xq in enumerate(_replicate(x, self.mesh)):
            _, pos = s_._scan_shard(s, xq, kc, nprobe, self.pos_lists[s])
            valid = pos >= 0
            cand = self.refine[s][pos.clamp_min(0).long()].float()  # [nq, kc, d]
            if largest:
                dd = (xq[:, None, :] * cand).sum(-1)
            else:
                diff = xq[:, None, :] - cand
                dd = (diff * diff).sum(-1)
            dloc, sel = topk(torch.where(valid, dd, sentinel), k, largest=largest)
            pos_k = torch.gather(pos, 1, sel)
            slots_k = torch.where(
                pos_k >= 0, s_.lists[s].slot_ids[pos_k.clamp_min(0).long()], -1)
            parts.append((torch.where(pos_k >= 0, dloc, sentinel), slots_k))
        D, slots = _gather_merge(self.mesh, parts, k, largest)
        return _host_results(D, slots, s_._ids_host)
