"""The smaller index variants (counterpart of
faiss_tpu/models/extra_indexes.py):

  - Index2Layer (faiss/Index2Layer.{h,cpp}): IVF-structured codes stored
    flat;
  - IndexIVFFlatDedup (faiss/IndexIVFFlat.h:69): identical vectors stored
    once, the other ids in ``instances``;
  - IndexRowwiseMinMax / IndexRowwiseMinMaxFP16
    (faiss/IndexRowwiseMinMax.h:21-33): a per-row [0, 1] normalization
    around any index's codes, a storage codec without a search;
  - IndexIVFIndependentQuantizer (faiss/IndexIVFIndependentQuantizer.h:24):
    the coarse quantizer on the vectors, the IVF index's codes on
    transformed vectors;
  - IndexIVFSpectralHash (faiss/IndexIVFSpectralHash.h): the residuals'
    random projections thresholded at their medians, the probed lists scanned
    by Hamming distance on the device."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..base import Index, sel_mask
from ..codecs.pq import ProductQuantizer
from ..metric import MetricType, is_similarity_metric
from ..ops.hamming import popcount32
from ..ops.ivf_ops import SCAN_GATHER_BYTES, probe_slots
from ..transforms import RandomRotationMatrix
from .flat import IndexFlat
from .ivf import IndexIVF
from .ivf_flat import IndexIVFFlat


class Index2Layer(Index):
    """Per vector its coarse id and the PQ code of its residual, without
    inverted lists (reference: Index2Layer.h:22): the storage of
    IndexHNSW2Level. The coarse quantizer is the port's (flat, or an IMI
    that trains itself); the PQ trains and encodes on its device. Search
    decodes every row and scans them exactly."""

    def __init__(self, quantizer, nlist: int, M: int, nbits: int = 8,
                 metric=MetricType.L2):
        super().__init__(quantizer.d, metric, device=quantizer.device)
        self.q1_quantizer = quantizer
        self.nlist = int(nlist)
        self.pq = ProductQuantizer(self.d, M, nbits, device=self.device)
        self.is_trained = False
        self._listnos: Optional[np.ndarray] = None
        self._codes: Optional[np.ndarray] = None
        self.code_size = self.pq.code_size + 4  # coarse id stored as int32

    def _centroids(self) -> np.ndarray:
        return self.q1_quantizer.vectors()

    def train(self, x) -> None:
        """The coarse quantizer (k-means of nlist centroids, or the IMI's own
        training), then the PQ on the residuals (faiss_tpu :40)."""
        x = self._check_input(x)
        if self.q1_quantizer.ntotal != self.nlist:
            from .imi import MultiIndexQuantizer

            if isinstance(self.q1_quantizer, MultiIndexQuantizer):
                self.q1_quantizer.train(x)
            else:
                from ..clustering import Clustering

                clus = Clustering(self.d, self.nlist, device=self.device)
                clus.train(x)
                self.q1_quantizer.reset()
                self.q1_quantizer.add(clus.centroids)
        _, assign = self.q1_quantizer.search(x, 1)
        self.pq.train(x - self._centroids()[assign.ravel()])
        self.is_trained = True

    def add(self, x) -> None:
        x = self._check_input(x)
        _, assign = self.q1_quantizer.search(x, 1)
        assign = assign.ravel().astype(np.int32)
        codes = self.pq.compute_codes_int(x - self._centroids()[assign])
        self._listnos = (assign if self._listnos is None
                         else np.concatenate([self._listnos, assign]))
        self._codes = (codes if self._codes is None
                       else np.concatenate([self._codes, codes]))
        self.ntotal += len(x)

    def reconstruct_n(self, n0: int, ni: int) -> np.ndarray:
        recon = self.pq.decode_int(self._codes[n0 : n0 + ni])
        return recon + self._centroids()[self._listnos[n0 : n0 + ni]]

    def search(self, x, k: int, *, params=None):
        """Exact search over the decoded rows (the reference mainly uses the
        class as HNSW storage)."""
        flat = IndexFlat(self.d, self.metric_type, device=self.device)
        flat.add(self.reconstruct_n(0, self.ntotal))
        return flat.search(x, k, params=params)

    def reset(self) -> None:
        self._listnos = None
        self._codes = None
        self.ntotal = 0

    def _truncate(self, n: int) -> None:
        """Drop rows n.. (the interrupt rollback of IndexHNSW2Level)."""
        if n <= 0:
            self.reset()
            return
        self._listnos = self._listnos[:n]
        self._codes = self._codes[:n]
        self.ntotal = n


class IndexIVFFlatDedup(IndexIVFFlat):
    """IVF-Flat that stores identical vectors once (reference:
    IndexIVFFlat.h:69): the first id of a vector is its representative,
    the later ids go to ``instances[representative]`` in add order. Search
    returns representatives, as faiss_tpu's does; with ``expand_instances``
    each representative is followed by its duplicates at the same distance,
    up to k (faiss's IndexIVFFlatDedup::search_preassigned)."""

    expand_instances = False

    def __init__(self, quantizer, d: int, nlist: int, metric=MetricType.L2, *,
                 device="cuda"):
        super().__init__(quantizer, d, nlist, metric, device=device)
        self.instances = {}  # representative id -> [duplicate ids]

    def add_with_ids(self, x, ids) -> None:
        """Rows equal, byte for byte, to a stored row or to an earlier row of
        the batch become instances of its id (faiss_tpu
        extra_indexes.py:117), found by one sort of the rows' bytes."""
        x = self._check_input(x)
        if ids is None:
            ids = np.arange(self.ntotal, self.ntotal + len(x), dtype=np.int64)
        ids = np.asarray(ids, np.int64)
        n0 = self.ntotal
        stored = (np.ascontiguousarray(self._codes_host, np.float32) if n0
                  else np.zeros((0, self.d), np.float32))
        rows = np.concatenate([stored, x]).view(np.dtype((np.void, 4 * self.d)))
        _, first, inverse = np.unique(rows.ravel(), return_index=True,
                                      return_inverse=True)
        rep = first[inverse.ravel()][n0:]  # each new row's first equal row
        own = rep == np.arange(n0, n0 + len(x))
        rep_ids = np.concatenate([self._ids_host, ids])[rep]
        for i in np.nonzero(~own)[0]:
            self.instances.setdefault(int(rep_ids[i]), []).append(int(ids[i]))
        if own.any():
            super().add_with_ids(x[own], ids[own])

    def remove_ids(self, sel) -> int:
        removed = 0
        for rep in list(self.instances):
            dups = self.instances[rep]
            keep = [i for i in dups if not sel.is_member(i)]
            removed += len(dups) - len(keep)
            if keep:
                self.instances[rep] = keep
            else:
                del self.instances[rep]
        return removed + super().remove_ids(sel)

    def search(self, x, k: int, *, params=None):
        D, I = super().search(x, k, params=params)
        if not self.expand_instances or not self.instances:
            return D, I
        D2 = np.full_like(D, -np.inf if is_similarity_metric(self.metric_type)
                          else np.inf)
        I2 = np.full_like(I, -1)
        for q in range(len(I)):
            out = 0
            for dist, i in zip(D[q], I[q]):
                if out >= k or i < 0:
                    break
                for j in [int(i)] + self.instances.get(int(i), []):
                    if out >= k:
                        break
                    D2[q, out], I2[q, out] = dist, j
                    out += 1
        return D2, I2


class IndexRowwiseMinMax(Index):
    """Per-row min/max normalization around a sub-index's codes, float32
    scale and bias (reference: IndexRowwiseMinMax.h:33): rows go to the
    sub-index as (x - min) / (max - min); a code is the scale and bias, then
    the sub-index's code. A storage codec: search raises, as in the
    reference (IndexRowwiseMinMax.cpp:362) and faiss_tpu."""

    _HEAD = np.float32

    def __init__(self, index: Index):
        super().__init__(index.d, index.metric_type, device=index.device)
        self.index = index
        self.is_trained = index.is_trained
        self._scale_bias = []

    def train(self, x) -> None:
        self.index.train(self._normalize(self._check_input(x))[0])
        self.is_trained = True

    @staticmethod
    def _normalize(x):
        lo = x.min(axis=1, keepdims=True)
        hi = x.max(axis=1, keepdims=True)
        scale = np.maximum(hi - lo, 1e-20)
        return ((x - lo) / scale).astype(np.float32), scale.ravel(), lo.ravel()

    def add(self, x) -> None:
        xn, scale, bias = self._normalize(self._check_input(x))
        self.index.add(xn)
        self._scale_bias.extend(zip(scale, bias))
        self.ntotal = self.index.ntotal

    def search(self, x, k: int, *, params=None):
        raise NotImplementedError(
            "search not implemented for IndexRowwiseMinMax (a codec-only "
            "wrapper, as in the reference); use sa_encode/sa_decode")

    def reconstruct(self, key: int) -> np.ndarray:
        scale, bias = self._scale_bias[key]
        return self.index.reconstruct(key) * scale + bias

    def sa_code_size(self) -> int:
        return self.index.sa_code_size() + 2 * np.dtype(self._HEAD).itemsize

    def sa_encode(self, x) -> np.ndarray:
        xn, scale, bias = self._normalize(self._check_input(x))
        head = np.stack([scale, bias], 1).astype(self._HEAD).view(np.uint8)
        return np.concatenate([head, self.index.sa_encode(xn)], axis=1)

    def sa_decode(self, codes) -> np.ndarray:
        codes = np.ascontiguousarray(codes, np.uint8)
        hb = 2 * np.dtype(self._HEAD).itemsize
        head = codes[:, :hb].copy().view(self._HEAD).astype(np.float32)
        return self.index.sa_decode(codes[:, hb:]) * head[:, 0:1] + head[:, 1:2]

    def reset(self) -> None:
        self.index.reset()
        self._scale_bias = []
        self.ntotal = 0


class IndexRowwiseMinMaxFP16(IndexRowwiseMinMax):
    """The fp16 scale and bias variant (IndexRowwiseMinMax.h:21)."""

    _HEAD = np.float16


class IndexIVFIndependentQuantizer(Index):
    """IVF whose coarse quantizer sees the vectors as they are while the IVF
    index encodes them transformed by ``vt`` (reference:
    IndexIVFIndependentQuantizer.h:24). The IVF index's own quantizer holds
    the transformed centroids, for its residuals."""

    def __init__(self, quantizer: Index, index_ivf: IndexIVF, vt=None):
        super().__init__(quantizer.d, index_ivf.metric_type, device=index_ivf.device)
        self.quantizer = quantizer
        self.index_ivf = index_ivf
        self.vt = vt
        self.is_trained = False

    def _apply(self, x: np.ndarray) -> np.ndarray:
        return self.vt.apply(x) if self.vt is not None else x

    def train(self, x) -> None:
        x = self._check_input(x)
        if not self.quantizer.is_trained or self.quantizer.ntotal == 0:
            from ..clustering import Clustering

            clus = Clustering(self.d, self.index_ivf.nlist, device=self.device)
            clus.train(x)
            self.quantizer.reset()
            self.quantizer.add(clus.centroids)
        if self.vt is not None and not self.vt.is_trained:
            self.vt.train(x)
        xt = self._apply(x)
        _, assign = self.quantizer.search(x, 1)
        self.index_ivf.quantizer.reset()
        self.index_ivf.quantizer.add(self._apply(self.quantizer.vectors()))
        dev = self.index_ivf.device
        self.index_ivf.train_encoder(torch.from_numpy(np.ascontiguousarray(xt)).to(dev),
                                     torch.from_numpy(assign.ravel()).to(dev))
        self.index_ivf.is_trained = True
        self.is_trained = True

    def add(self, x) -> None:
        x = self._check_input(x)
        _, assign = self.quantizer.search(x, 1)
        self.index_ivf.add_core(self._apply(x), None, assign.ravel())
        self.ntotal = self.index_ivf.ntotal

    def search(self, x, k: int, *, params=None):
        x = self._check_input(x)
        cd, probes = self.quantizer.search(x, self.index_ivf.nprobe)
        return self.index_ivf.search_preassigned(self._apply(x), k, probes, cd,
                                                 params=params)

    def reset(self) -> None:
        self.index_ivf.reset()
        self.ntotal = 0


class IndexIVFSpectralHash(IndexIVF):
    """IVF of binarized spectral-hash codes (reference:
    IndexIVFSpectralHash.{h,cpp}): residuals through a random rotation to
    ``nbit`` dimensions (seed 1234, as faiss_tpu), thresholded at the
    training residuals' medians (Thresh_global). The search scans each
    query's probed lists by probe on the device: the query's code against
    each list's centroid, Hamming distances by byte popcount, and a top-k on
    (distance, slot), the slot order breaking ties as faiss_tpu's stable
    host sort does."""

    def __init__(self, quantizer, d: int, nlist: int, nbit: int,
                 period: float = 1.0, *, device="cuda"):
        super().__init__(quantizer, d, nlist, MetricType.L2, device=device)
        self.nbit = int(nbit)
        self.period = period
        self.threshold_type = 0  # Thresh_global
        self.vt = RandomRotationMatrix(d, nbit, device=self.device)
        self.vt.init()
        self.trained_thresholds = np.zeros(nbit, np.float32)
        self.code_size = (nbit + 7) // 8

    def _bits(self, x: torch.Tensor, listnos: torch.Tensor) -> torch.Tensor:
        """[n, nbit] bool: the projected residuals above the thresholds."""
        proj = self.vt.apply_tensor(x.float() - self._centroids_dev()[listnos.long()])
        return proj > torch.from_numpy(self.trained_thresholds).to(self.device)

    def train_encoder(self, x, assign) -> None:
        res = x.float() - self._centroids_dev()[assign.long()]
        proj = self.vt.apply_tensor(res).cpu().numpy()
        self.trained_thresholds = np.median(proj, axis=0).astype(np.float32)

    def encode_vectors(self, x, listnos) -> np.ndarray:
        bits = self._bits(x, listnos).cpu().numpy()
        return np.packbits(bits, axis=1, bitorder="little")

    def decode_vectors(self, codes, listnos):
        raise NotImplementedError("spectral hash codes are not invertible")

    def reconstruct(self, key):
        raise NotImplementedError("spectral hash codes are not invertible")

    def _stage_codes(self, order, offsets, lengths, max_len):
        sid = self._slot_ids(order, offsets, max_len)
        codes = torch.from_numpy(np.ascontiguousarray(
            self._codes_host if self.ntotal else np.zeros((0, self.code_size)),
            np.uint8)).to(self.device)
        return {"codes": self._padded(sid, codes, 0), "slot_ids": sid,
                "lengths": torch.from_numpy(lengths).to(self.device)}

    def _pack(self, bits: torch.Tensor) -> torch.Tensor:
        """[n, nbit] bool -> [n, code_size] uint8, little-endian bits."""
        pad = self.code_size * 8 - self.nbit
        b = torch.nn.functional.pad(bits.to(torch.uint8), (0, pad))
        w = (1 << torch.arange(8, device=b.device)).to(torch.uint8)
        return (b.view(len(b), self.code_size, 8) * w).sum(-1).to(torch.uint8)

    def search(self, x, k: int, *, params=None):
        """(D float32 Hamming distances, I) best-first, +inf / -1 past the
        candidates."""
        x = self._check_input(x)
        self._check_trained()
        nprobe, _ = self._search_params(params)
        nprobe = min(max(1, nprobe), self.nlist)
        D, I = self._results(len(x), k)
        if self.ntotal == 0 or not len(x):
            return D, I
        dev = self._build_device()
        sel = sel_mask(params, self._ids_host, self.device)
        codes = dev["codes"]
        x_dev = torch.from_numpy(x).to(self.device)
        rows = max(1, SCAN_GATHER_BYTES // max(1, codes.shape[1] * 32))
        none = torch.iinfo(torch.int64).max
        for r in range(0, len(x), rows):
            xq = x_dev[r : r + rows]
            _, probes = self._coarse_search(xq, nprobe)
            keys = torch.full((len(xq), k), none, dtype=torch.int64, device=self.device)
            for p in range(nprobe):
                ln = probes[:, p]
                qc = self._pack(self._bits(xq, ln.clamp_min(0)))
                cl = codes[ln.clamp_min(0)]  # [rows, max_len, code_size]
                ham = popcount32((cl ^ qc[:, None, :]).to(torch.int32)).sum(-1)
                valid, sl = probe_slots(ln, dev["slot_ids"], dev["lengths"], sel)
                key = torch.where(valid, (ham.long() << 32) | sl.long(), none)
                keys = torch.topk(torch.cat([keys, key], 1), k, largest=False).values
            found = keys != none
            D[r : r + len(xq)] = torch.where(found, (keys >> 32).float(),
                                             float("inf")).cpu().numpy()
            I[r : r + len(xq)] = self._ids_of(
                torch.where(found, keys & 0xFFFFFFFF, -1).cpu().numpy())
        return D, I
