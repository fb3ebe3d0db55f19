"""The inverted multi-index coarse quantizers (counterpart of
faiss_tpu/models/imi.py; reference: faiss/IndexPQ.h:150 MultiIndexQuantizer
and :170 MultiIndexQuantizer2; Babenko & Lempitsky).

The centroids are the cartesian product of M sub-codebooks: ksub^M virtual
cells. A query's k nearest cells are the k smallest sums of one entry per
sub-space. Both stages run on the device as torch ops: the distance tables
and a per-side top-t, then the exact merge of top-k sums, one side at a
time (if a tuple is in the global top-k, each of its prefixes is in the
top-k of the prefix sums, so keeping k per step is exact). The sorts are
stable, as faiss_tpu's argsorts are, so ties resolve to the same cells.
Cell numbering puts sub 0 at the least significant digit (IndexPQ.cpp:872),
as faiss_tpu does."""

from __future__ import annotations

import numpy as np
import torch

from ..base import Index, require_device
from ..codecs.pq import ProductQuantizer
from ..metric import MetricType
from ..ops import pq_ops

# the largest product table ``vectors()`` materializes (faiss_tpu imi.py:104)
MAX_MATERIALIZED_CELLS = 1 << 20


def _merge_topk_sums(cd, ci, d_next, i_next, k, mult):
    """Exact top-k over the sums of candidate partials and one more side
    (faiss_tpu imi.py:25). ``cd``/``ci`` [nq, c]: partial sums and their
    composite ids; ``d_next``/``i_next`` [nq, t]: the next side's top-t.
    Returns ([nq, k'] sums ascending, ids ci * mult + i_next), k' = min(k,
    c * t); equal sums keep the order of (candidate, next entry)."""
    nq, c = cd.shape
    t = d_next.shape[1]
    sums = (cd[:, :, None] + d_next[:, None, :]).reshape(nq, c * t)
    kk = min(k, c * t)
    D, order = torch.sort(sums, dim=1, stable=True)
    D, order = D[:, :kk], order[:, :kk]
    a = torch.gather(ci, 1, order // t)
    b = torch.gather(i_next, 1, order % t)
    return D, a * mult + b


class MultiIndexQuantizer(Index):
    """reference: IndexPQ.h:150 MultiIndexQuantizer (any M)."""

    def __init__(self, d: int, M: int = 2, nbits: int = 12, *, device="cuda"):
        super().__init__(d, MetricType.L2, device=require_device(device))
        self.pq = ProductQuantizer(d, M, nbits, device=self.device)
        self.is_trained = False
        self.ntotal = 0  # ksub^M virtual cells once trained

    def train(self, x) -> None:
        x = self._check_input(x)
        self.pq.train(x)
        self.is_trained = True
        self.ntotal = self.pq.ksub ** self.pq.M

    def add(self, x) -> None:
        raise RuntimeError("MultiIndexQuantizer has virtual centroids; "
                           "add() is not supported (reference behavior)")

    def _side_topk(self, xq: torch.Tensor, t: int):
        """Per sub-space the t nearest sub-centroids (distances, ids),
        from the exhaustive distance tables, by a stable sort."""
        tabs = pq_ops.pq_distance_tables(xq, self.pq._dev())  # [nq, M, ksub]
        ds, is_ = [], []
        for m in range(self.pq.M):
            dm, im = torch.sort(tabs[:, m, :], dim=1, stable=True)
            ds.append(dm[:, :t])
            is_.append(im[:, :t])
        return ds, is_

    def _search_dev(self, xq: torch.Tensor, k: int, params=None):
        """The k nearest cells of device queries ``xq``: (distances float32
        [nq, k], cell ids int64 [nq, k]) on the device, +inf and -1 beyond
        the ksub^M cells."""
        del params
        self._check_trained()
        xq = xq.to(self.device, torch.float32)
        ksub, M = self.pq.ksub, self.pq.M
        ds, is_ = self._side_topk(xq, min(k, ksub))
        # sub 0 is the least significant digit: merge from the last side down
        cd, ci = ds[M - 1], is_[M - 1].long()
        for m in range(M - 2, -1, -1):
            cd, ci = _merge_topk_sums(cd, ci, ds[m], is_[m].long(), k, ksub)
        D, I = cd.float(), ci
        if k > I.shape[1]:  # k exceeds the ksub^M reachable cells
            pad = k - I.shape[1]
            D = torch.nn.functional.pad(D, (0, pad), value=float("inf"))
            I = torch.nn.functional.pad(I, (0, pad), value=-1)
        return D, I

    def search(self, x, k: int, *, params=None):
        x = self._check_input(x)
        D, I = self._search_dev(torch.from_numpy(x).to(self.device), k)
        return D.cpu().numpy(), I.cpu().numpy()

    def reconstruct(self, key: int) -> np.ndarray:
        ksub, M = self.pq.ksub, self.pq.M
        code = []
        for _ in range(M):  # sub 0 = least significant digit
            code.append(key % ksub)
            key //= ksub
        return self.pq.decode_int(np.array([code], np.uint16))[0]

    def reconstruct_n(self, n0: int, ni: int) -> np.ndarray:
        return self.vectors()[n0 : n0 + ni]

    def vectors(self) -> np.ndarray:
        """The materialized product table [ksub^M, d] (at most 2^20 cells,
        as in faiss_tpu): digit m has weight ksub^m."""
        ksub, M = self.pq.ksub, self.pq.M
        n = ksub ** M
        if n > MAX_MATERIALIZED_CELLS:
            raise MemoryError("IMI centroid table too large to materialize")
        out = np.zeros((n, self.d), np.float32)
        dsub = self.d // M
        for m in range(M):
            block = np.tile(np.repeat(self.pq.centroids[m], ksub ** m, axis=0),
                            (ksub ** (M - 1 - m), 1))
            out[:, m * dsub : (m + 1) * dsub] = block
        return out

    def reset(self) -> None:
        pass


class MultiIndexQuantizer2(MultiIndexQuantizer):
    """reference: IndexPQ.h:170 MultiIndexQuantizer2: the same product
    cells, with each side's top-t taken from a sub-index of the port (an
    IndexFlat, an IndexHNSWFlat, ...) filled with that side's codebook; the
    merge is unchanged, so the result is exact relative to what the
    sub-indexes return. As in faiss_tpu, the sides' distances are merged in
    float64."""

    def __init__(self, d: int, nbits: int, *assign_indexes, device=None):
        M = len(assign_indexes)
        if M < 2:
            raise ValueError("MultiIndexQuantizer2 needs >=2 assign indexes")
        super().__init__(d, M, nbits,
                         device=device or assign_indexes[0].device)
        dsub = d // M
        for sub in assign_indexes:
            if sub.d != dsub:
                raise ValueError(f"assign index d={sub.d} != dsub={dsub}")
        self.assign_indexes = list(assign_indexes)
        self.own_fields = True

    def train(self, x) -> None:
        super().train(x)
        dsub = self.d // self.pq.M
        for m, sub in enumerate(self.assign_indexes):
            sub.reset()
            cents = self.pq.centroids[m].reshape(-1, dsub)
            if not sub.is_trained:
                sub.train(cents)
            sub.add(cents)

    def _side_topk(self, xq: torch.Tensor, t: int):
        dsub = self.d // self.pq.M
        xh = xq.cpu().numpy()
        ds, is_ = [], []
        for m, sub in enumerate(self.assign_indexes):
            dm, im = sub.search(
                np.ascontiguousarray(xh[:, m * dsub : (m + 1) * dsub]), t)
            # a missing entry (-1) never wins the merge
            dm = np.where(im < 0, np.inf, dm.astype(np.float64))
            ds.append(torch.from_numpy(dm).to(self.device))
            is_.append(torch.from_numpy(np.maximum(im, 0)).to(self.device))
        return ds, is_
