"""IndexFlatPanorama and IndexIVFFlatPanorama: exact L2 search with a
level-1 lower-bound screen (counterpart of faiss_tpu/models/panorama.py;
reference: faiss/impl/Panorama.h:237, faiss/IndexFlat.h:103-183,
faiss/IndexIVFFlatPanorama.h:39).

With d1 = d / levels the first-level dimensions and the norm of the rest,

    LB = ||q_1 - x_1||^2 + (||q_rest|| - ||x_rest||)^2  <=  ||q - x||^2

(Cauchy-Schwarz). Phase 1 keeps the C + 1 smallest bounds of each query
(C = prune_factor * k): for the flat index chunked float32 products of the
d1 dimensions with an exact top-k merge, for the IVF index the IVF-Flat scan
by probe over augmented rows [x_1, ||x_rest||] (whose L2 distance is LB).
Phase 2 re-ranks the C best exactly (ops/distances.rerank_exact). A query is
certified exact when its k-th exact distance is <= its (C + 1)-th bound: no
row left out can beat it. The rows that fail are searched again by the
port's IndexFlat / IndexIVFFlat search (the screen kernel K2 or K3 on a large
flat store; the big-batch or by-probe IVF-Flat search), exactly as
faiss_tpu repairs them; ``last_repaired`` counts them."""

from __future__ import annotations

import numpy as np
import torch

from ..base import query_buckets
from ..metric import MetricType
from ..ops import distances as dops
from ..ops.ivf_ops import ivf_flat_scan
from ..ops.topk import merge_topk, topk
from .flat import IndexFlat
from .ivf_flat import IndexIVFFlat

# queries and rows of one phase-1 score tile ([2048, 65536] float32: 512 MiB)
SCREEN_QUERIES = 2048
SCREEN_ROWS = 1 << 16


def _check_l2(metric):
    if MetricType(metric) != MetricType.L2:
        raise ValueError("Panorama pruning is defined for L2")


def panorama_screen(xq1, q_suf, xb1, b_suf, c: int):
    """The c (<= the store's rows) smallest level-1 lower bounds of each
    query and their rows: (lb [nq, c], rows [nq, c] int64) (faiss_tpu
    panorama.py:38)."""
    nq = xq1.shape[0]
    qn = xq1.square().sum(1)
    bn = xb1.square().sum(1)
    vals = torch.full((nq, c), float("inf"), device=xq1.device)
    ids = torch.full((nq, c), -1, dtype=torch.int64, device=xq1.device)
    for s in range(0, xb1.shape[0], SCREEN_ROWS):
        xt = xb1[s : s + SCREEN_ROWS]
        part = (qn[:, None] + bn[None, s : s + SCREEN_ROWS] - 2.0 * (xq1 @ xt.T))
        gap = q_suf[:, None] - b_suf[None, s : s + SCREEN_ROWS]
        lb = part.clamp_min(0.0) + gap * gap
        cv, cp = topk(lb, c, largest=False)
        vals, ids = merge_topk(vals, ids, cv, cp + s, c, largest=False)
    return vals, ids


def _split_levels(x: torch.Tensor, d1: int):
    """(x_1 [n, d1], ||x_rest|| [n]) of float32 rows."""
    return x[:, :d1].contiguous(), torch.linalg.vector_norm(x[:, d1:], dim=1)


class IndexFlatPanorama(IndexFlat):
    """reference: IndexFlat.h:103 IndexFlatPanorama (levels and pruning)."""

    def __init__(self, d: int, num_levels: int = 4, metric=MetricType.L2, *,
                 device="cuda"):
        _check_l2(metric)
        super().__init__(d, metric, device=device)
        self.num_levels = int(num_levels)  # level-1 width = d / num_levels
        self.prune_factor = 32  # candidates kept = prune_factor * k
        self._pan = None
        self.last_repaired = 0

    def _drop_staged(self) -> None:
        super()._drop_staged()
        self._pan = None

    def _pan_dev(self):
        """(d1, x_1 [n, d1], ||x_rest|| [n]) of the stored rows."""
        if self._pan is None:
            d1 = max(1, self.d // self.num_levels)
            self._pan = (d1,) + _split_levels(self._consolidate().float(), d1)
        return self._pan

    def search(self, x, k: int, *, params=None):
        x = self._check_input(x)
        if ((params is not None and params.sel is not None)
                or self.ntotal <= self.prune_factor * k):
            return super().search(x, k, params=params)
        xb = self._consolidate()
        d1, xb1, b_suf = self._pan_dev()
        c = min(self.prune_factor * k, self.ntotal - 1)
        D, I = self._empty_result(len(x), k)
        x_dev = self._to_device(x)
        uncert = []
        for q0 in range(0, len(x), SCREEN_QUERIES):
            xq = x_dev[q0 : q0 + SCREEN_QUERIES]
            xq1, q_suf = _split_levels(xq, d1)
            # c + 1 bounds: every row left out has LB >= lbv[:, c]
            lbv, cand = panorama_screen(xq1, q_suf, xb1, b_suf, c + 1)
            dd, ii = dops.rerank_exact(xq, xb, cand[:, :c], k)
            D[q0 : q0 + len(xq)] = dd.cpu().numpy()
            I[q0 : q0 + len(xq)] = ii.cpu().numpy()
            bad = (dd[:, k - 1] > lbv[:, c]).cpu().numpy()
            uncert.append(np.nonzero(bad)[0] + q0)
        rows = np.concatenate(uncert)
        self.last_repaired = len(rows)
        if len(rows):
            D[rows], I[rows] = super().search(x[rows], k, params=params)
        return D, I


class IndexIVFFlatPanorama(IndexIVFFlat):
    """IVF-Flat whose by-probe scan screens by the level-1 bound
    (reference: IndexIVFFlatPanorama.h:39, arXiv:2510.00566); see the module
    docstring."""

    def __init__(self, quantizer, d: int, nlist: int, n_levels: int = 4,
                 metric=MetricType.L2, *, device="cuda"):
        _check_l2(metric)
        super().__init__(quantizer, d, nlist, metric, device=device)
        self.n_levels = int(n_levels)
        self.prune_factor = 32
        self.last_repaired = 0

    def _stage_codes(self, order, offsets, lengths, max_len):
        """IVF-Flat's padded layout plus the augmented rows ``aug`` [nlist,
        max_len, d1 + 1], their norms, and the rows in slot order ``xb``
        (the re-rank store)."""
        dev = super()._stage_codes(order, offsets, lengths, max_len)
        d1 = max(1, self.d // self.n_levels)
        xb = torch.from_numpy(np.ascontiguousarray(
            self._codes_host if self.ntotal else np.zeros((0, self.d)),
            np.float32)).to(self.device)
        x1, suf = _split_levels(xb, d1)
        aug = self._padded(dev["slot_ids"], torch.cat([x1, suf[:, None]], 1), 0.0)
        return dict(dev, aug=aug, aug_norms=aug.square().sum(-1), d1=d1, xb=xb)

    def search(self, x, k: int, *, params=None):
        x = self._check_input(x)
        self._check_trained()
        nprobe, _ = self._search_params(params)
        nprobe = min(max(1, nprobe), self.nlist)
        c = self.prune_factor * k
        if ((params is not None and params.sel is not None)
                or self.ntotal == 0 or self.ntotal <= c):
            return super().search(x, k, params=params)
        dev = self._build_device()
        d1 = dev["d1"]
        nq = len(x)
        D, I = self._results(nq, k)
        x_dev = torch.from_numpy(x).to(self.device)
        uncert = []
        for start, padded, real in query_buckets(nq):
            xq = torch.zeros(padded, self.d, device=self.device)
            xq[:real] = x_dev[start : start + real]
            _, probes = self._coarse_search(xq, nprobe)
            xq1, q_suf = _split_levels(xq, d1)
            # phase 1 in d1 + 1 dimensions; c + 1 kept for the certificate
            lbv, slots = ivf_flat_scan(
                torch.cat([xq1, q_suf[:, None]], 1), probes, dev["aug"],
                dev["slot_ids"], dev["lengths"], c + 1, code_norms=dev["aug_norms"])
            dd, ss = dops.rerank_exact(xq, dev["xb"], slots[:, :c], k)
            thresh = lbv[:real, c]
            bad = torch.isfinite(thresh) & (dd[:real, k - 1] > thresh)
            D[start : start + real] = dd[:real].cpu().numpy()
            I[start : start + real] = self._ids_of(ss[:real].cpu().numpy())
            uncert.append(np.nonzero(bad.cpu().numpy())[0] + start)
        rows = np.concatenate(uncert)
        self.last_repaired = len(rows)
        if len(rows):
            D[rows], I[rows] = super().search(x[rows], k, params=params)
        return D, I
