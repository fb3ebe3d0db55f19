"""ProductQuantizer (counterpart of faiss_tpu/codecs/pq.py).

d dims split into M subspaces of dsub dims, each with a k-means codebook of
ksub = 2^nbits codewords (ProductQuantizer.h:76-135). Training runs all M
subspace k-means on the device at once (ops/kmeans_ops.batched_kmeans),
subsampled and initialised with the same RandomState calls as faiss_tpu."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..clustering import ClusteringParameters
from ..ops import pq_ops
from ..ops.kmeans_ops import batched_kmeans


class ProductQuantizer:
    """reference: impl/ProductQuantizer.h:24."""

    def __init__(self, d: int, M: int, nbits: int = 8, *, device):
        if d % M != 0:
            raise ValueError(f"d={d} not a multiple of M={M}")
        if nbits not in (4, 8):
            raise NotImplementedError("only nbits 4 and 8 are ported")
        self.d = int(d)
        self.M = int(M)
        self.nbits = int(nbits)
        self.ksub = 1 << self.nbits
        self.dsub = self.d // self.M
        self.code_size = (self.M * self.nbits + 7) // 8
        self.device = torch.device(device)
        self.cp = ClusteringParameters(niter=25)
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
        if n < self.ksub:
            raise ValueError(
                f"not enough training points ({n}) for ksub={self.ksub}"
            )
        xms = np.ascontiguousarray(
            x.reshape(n, self.M, self.dsub).transpose(1, 0, 2)
        )  # [M, n, dsub]
        rs = np.random.RandomState(self.cp.seed)
        init = xms[:, rs.permutation(n)[: self.ksub], :]
        out = batched_kmeans(
            torch.from_numpy(xms).to(self.device),
            torch.from_numpy(np.ascontiguousarray(init)).to(self.device),
            self.cp.niter,
        )
        self.set_centroids(out.cpu().numpy())

    def set_centroids(self, centroids: np.ndarray) -> None:
        c = np.ascontiguousarray(centroids, np.float32)
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

    def compute_codes_int(self, x) -> np.ndarray:
        """Unpacked codes [n, M] uint8."""
        xd = torch.as_tensor(np.ascontiguousarray(x, np.float32)).to(self.device)
        return pq_ops.pq_encode(xd, self._dev()).to(torch.uint8).cpu().numpy()

    def decode_int(self, codes_int) -> np.ndarray:
        cd = torch.as_tensor(np.asarray(codes_int)).to(self.device)
        return pq_ops.pq_decode(cd, self._dev()).cpu().numpy()

    def compute_codes(self, x) -> np.ndarray:
        """Packed byte codes [n, code_size] (PQEncoder8 / 4-bit packing)."""
        return self.pack_codes(self.compute_codes_int(x))

    def decode(self, codes) -> np.ndarray:
        return self.decode_int(self.unpack_codes(codes))

    def pack_codes(self, codes_int: np.ndarray) -> np.ndarray:
        c = np.asarray(codes_int, np.uint8)
        if self.nbits == 8:
            return c.copy()
        if self.M % 2:
            c = np.concatenate([c, np.zeros((len(c), 1), np.uint8)], axis=1)
        return c[:, 0::2] | (c[:, 1::2] << 4)

    def unpack_codes(self, codes: np.ndarray) -> np.ndarray:
        codes = np.ascontiguousarray(codes, np.uint8)
        if self.nbits == 8:
            return codes
        out = np.empty((len(codes), self.M), np.uint8)
        out[:, 0::2] = codes[:, : (self.M + 1) // 2] & 0xF
        out[:, 1::2] = codes[:, : self.M // 2] >> 4
        return out
