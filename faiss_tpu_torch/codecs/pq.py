"""ProductQuantizer (counterpart of faiss_tpu/codecs/pq.py).

d dims split into M subspaces of dsub dims, each with a k-means codebook of
ksub = 2^nbits codewords (ProductQuantizer.h:76-135), for any nbits from 1
to 16. Training runs all M subspace k-means on the device at once
(ops/kmeans_ops.batched_kmeans), or one k-means over every subspace's rows
with ``Train_shared``, subsampled and initialised with the same RandomState
calls as faiss_tpu. Unpacked codes are uint8 up to 8 bits and uint16 above;
packed codes are faiss's PQEncoder8 / PQEncoder16 (little-endian u2) /
4-bit nibbles / PQEncoderGeneric bit strings."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..clustering import Clustering, ClusteringParameters
from ..metric import MetricType
from ..ops import pq_ops
from ..ops.kmeans_ops import batched_kmeans


def codes_tensor(codes, device) -> torch.Tensor:
    """Unpacked host codes [n, M] on ``device``: uint8 stays uint8, wider
    codes (uint16, which torch barely supports) become int32."""
    codes = np.ascontiguousarray(codes)
    if codes.dtype != np.uint8:
        codes = codes.astype(np.int32)
    return torch.from_numpy(codes).to(device)


def codes_numpy(codes: torch.Tensor, nbits: int) -> np.ndarray:
    """Device codes [n, M] -> host codes uint8 (nbits <= 8) or uint16."""
    if nbits <= 8:
        return codes.to(torch.uint8).cpu().numpy()
    return codes.to(torch.int32).cpu().numpy().astype(np.uint16)


class ProductQuantizer:
    """reference: impl/ProductQuantizer.h:24."""

    # train_type values (ProductQuantizer.h:150)
    Train_default = 0
    Train_hot_start = 1
    Train_shared = 2
    Train_hypercube = 3
    Train_hypercube_pca = 4

    def __init__(self, d: int, M: int, nbits: int = 8, *, device):
        if d % M != 0:
            raise ValueError(f"d={d} not a multiple of M={M}")
        if not 1 <= nbits <= 16:
            raise ValueError(f"nbits={nbits} outside 1..16")
        self.d = int(d)
        self.M = int(M)
        self.nbits = int(nbits)
        self.ksub = 1 << self.nbits
        self.dsub = self.d // self.M
        self.code_size = (self.M * self.nbits + 7) // 8
        self.device = torch.device(device)
        self.cp = ClusteringParameters(niter=25)
        self.train_type = self.Train_default
        self.verbose = False
        self.centroids: Optional[np.ndarray] = None  # [M, ksub, dsub]
        self._dev_centroids = None

    @property
    def is_trained(self) -> bool:
        return self.centroids is not None

    def train(self, x) -> None:
        """ProductQuantizer::train (faiss_tpu/codecs/pq.py:66)."""
        x = np.ascontiguousarray(x, np.float32)
        n = len(x)
        max_n = self.ksub * self.cp.max_points_per_centroid
        if n > max_n:
            rs = np.random.RandomState(self.cp.seed)
            x = x[rs.permutation(n)[:max_n]]
            n = max_n
        xs = x.reshape(n, self.M, self.dsub)
        if self.train_type == self.Train_shared:
            # one codebook for every subspace (ProductQuantizer.h:155)
            clus = Clustering(self.dsub, self.ksub, self.cp, device=self.device)
            clus.train(np.ascontiguousarray(xs.transpose(1, 0, 2)).reshape(-1, self.dsub))
            self.set_centroids(np.broadcast_to(
                clus.centroids[None], (self.M, self.ksub, self.dsub)))
            return
        if n < self.ksub:
            raise ValueError(
                f"not enough training points ({n}) for ksub={self.ksub}"
            )
        xms = np.ascontiguousarray(xs.transpose(1, 0, 2))  # [M, n, dsub]
        rs = np.random.RandomState(self.cp.seed)
        init = xms[:, rs.permutation(n)[: self.ksub], :]
        out = batched_kmeans(
            torch.from_numpy(xms).to(self.device),
            torch.from_numpy(np.ascontiguousarray(init)).to(self.device),
            self.cp.niter,
        )
        self.set_centroids(out.cpu().numpy())

    def set_centroids(self, centroids: np.ndarray) -> None:
        c = np.array(centroids, np.float32)  # a copy: training permutes it in place
        if c.shape != (self.M, self.ksub, self.dsub):
            raise ValueError(f"codebook shape {c.shape} does not match the PQ")
        self.centroids = c
        self._dev_centroids = None

    def _dev(self) -> torch.Tensor:
        if self._dev_centroids is None:
            if self.centroids is None:
                raise RuntimeError("ProductQuantizer is not trained")
            self._dev_centroids = torch.from_numpy(self.centroids).to(
                self.device
            )
        return self._dev_centroids

    # -- codec ------------------------------------------------------------------
    def compute_codes_dev(self, x) -> torch.Tensor:
        """Unpacked codes [n, M] int64 on the device."""
        xd = torch.as_tensor(np.ascontiguousarray(x, np.float32)).to(self.device)
        return pq_ops.pq_encode(xd, self._dev())

    def compute_codes_int(self, x) -> np.ndarray:
        """Unpacked codes [n, M] (uint8 for nbits <= 8, uint16 above)."""
        return codes_numpy(self.compute_codes_dev(x), self.nbits)

    def decode_int(self, codes_int) -> np.ndarray:
        cd = codes_tensor(codes_int, self.device)
        return pq_ops.pq_decode(cd, self._dev()).cpu().numpy()

    def compute_codes(self, x) -> np.ndarray:
        """Packed byte codes [n, code_size]."""
        return self.pack_codes(self.compute_codes_int(x))

    def decode(self, codes) -> np.ndarray:
        return self.decode_int(self.unpack_codes(codes))

    # -- bit packing (ProductQuantizer.h:195-238, faiss_tpu :131-177) ---------
    def pack_codes(self, codes_int: np.ndarray) -> np.ndarray:
        c = np.asarray(codes_int)
        n = len(c)
        if self.nbits == 8:
            return c.astype(np.uint8)
        if self.nbits == 16:
            return c.astype("<u2").view(np.uint8).reshape(n, self.code_size)
        if self.nbits == 4:
            c = c.astype(np.uint8)
            if self.M % 2:
                c = np.concatenate([c, np.zeros((n, 1), np.uint8)], axis=1)
            return c[:, 0::2] | (c[:, 1::2] << 4)
        # PQEncoderGeneric: code m's bit b is bit m * nbits + b of the row,
        # least significant first
        bits = (c.astype(np.uint32)[:, :, None]
                >> np.arange(self.nbits, dtype=np.uint32)) & 1
        return np.packbits(bits.reshape(n, -1).astype(np.uint8), axis=1,
                           bitorder="little")[:, : self.code_size]

    def unpack_codes(self, codes: np.ndarray) -> np.ndarray:
        codes = np.ascontiguousarray(codes, np.uint8)
        n = len(codes)
        if self.nbits == 8:
            return codes
        if self.nbits == 16:
            return codes.view("<u2").reshape(n, self.M).astype(np.uint16)
        if self.nbits == 4:
            out = np.empty((n, self.M), np.uint8)
            out[:, 0::2] = codes[:, : (self.M + 1) // 2] & 0xF
            out[:, 1::2] = codes[:, : self.M // 2] >> 4
            return out
        bits = np.unpackbits(codes, axis=1, bitorder="little")
        bits = bits[:, : self.M * self.nbits].reshape(n, self.M, self.nbits)
        vals = (bits.astype(np.uint32) << np.arange(self.nbits, dtype=np.uint32)).sum(-1)
        return vals.astype(np.uint8 if self.nbits <= 8 else np.uint16)

    # -- tables ---------------------------------------------------------------
    def compute_distance_tables(self, xq) -> np.ndarray:
        """[nq, M, ksub] squared-L2 ADC tables (ProductQuantizer.h:126)."""
        xd = torch.from_numpy(np.ascontiguousarray(xq, np.float32)).to(self.device)
        return pq_ops.pq_distance_tables(xd, self._dev()).cpu().numpy()

    def compute_inner_prod_tables(self, xq) -> np.ndarray:
        xd = torch.from_numpy(np.ascontiguousarray(xq, np.float32)).to(self.device)
        return pq_ops.pq_ip_tables(xd, self._dev()).cpu().numpy()

    def compute_sdc_table(self) -> np.ndarray:
        """Symmetric table [M, ksub, ksub] (ProductQuantizer::
        compute_sdc_table), on the host in float32 as faiss_tpu computes
        it."""
        c = self.centroids
        d2 = (
            np.sum(c**2, -1)[:, :, None]
            + np.sum(c**2, -1)[:, None, :]
            - 2 * np.einsum("mkd,mjd->mkj", c, c)
        )
        return np.maximum(d2, 0).astype(np.float32)

    def search(self, xq, codes_int, k: int, metric=MetricType.L2):
        """ADC k-NN of ``xq`` over the unpacked codes (ProductQuantizer::
        search): (D float32 [nq, k], I int64)."""
        xd = torch.from_numpy(np.ascontiguousarray(xq, np.float32)).to(self.device)
        largest = MetricType(metric) != MetricType.L2
        luts = (pq_ops.pq_ip_tables(xd, self._dev()) if largest
                else pq_ops.pq_distance_tables(xd, self._dev()))
        D, I = pq_ops.pq_adc_knn(luts, codes_tensor(codes_int, self.device), k,
                                 largest=largest)
        return D.cpu().numpy(), I.cpu().numpy()
