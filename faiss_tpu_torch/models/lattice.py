"""IndexLattice (counterpart of faiss_tpu/models/lattice.py; reference:
faiss/IndexLattice.{h,cpp}).

Each of the nsq subvectors of d / nsq dimensions is stored as a
``scale_nbit``-bit quantized norm and the id of its direction's nearest
vertex on the Zn sphere of squared radius r2. The norms and their scalar
codes are host numpy, as in faiss_tpu (bit for bit); the vertex search and
the ids run on the device in batches of subvectors (codecs/lattice.py), in
place of faiss_tpu's one Python call per vertex. ``sa_encode`` packs, per
subvector, the norm bits then the id bits, little-endian (faiss_tpu's
bytes). Search decodes the codes once into the port's IndexFlat and runs its
exact search (the screen kernel K2 or K3 on large stores)."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..base import Index
from ..codecs.lattice import BATCH, ZnSphereCodecAlt
from ..metric import MetricType
from .flat import IndexFlat


class IndexLattice(Index):
    """reference: IndexLattice.h:19."""

    def __init__(self, d: int, nsq: int, scale_nbit: int, r2: int,
                 metric=MetricType.L2, *, device="cuda"):
        super().__init__(d, metric, device=device)
        if d % nsq:
            raise ValueError("d must be a multiple of nsq")
        self.nsq = int(nsq)
        self.dsq = d // nsq
        self.scale_nbit = int(scale_nbit)
        self.zn_sphere_codec = ZnSphereCodecAlt(self.dsq, r2, device=self.device)
        # bits of a subvector's id (IndexLattice.cpp constructor)
        self.lattice_nbit = max(0, int(self.zn_sphere_codec.nv - 1).bit_length())
        self.trained: Optional[np.ndarray] = None  # [2, nsq] min / max norms
        self.is_trained = False
        self._codes: Optional[np.ndarray] = None  # [n, nsq, 2] int64 fields
        self._flat = IndexFlat(d, metric, device=self.device)  # decoded rows

    @property
    def code_size(self) -> int:
        return (self.nsq * (self.scale_nbit + self.lattice_nbit) + 7) // 8

    def sa_code_size(self) -> int:
        return self.code_size

    def train(self, x) -> None:
        x = self._check_input(x)
        norms = np.linalg.norm(x.reshape(len(x), self.nsq, self.dsq), axis=2)
        self.trained = np.stack([norms.min(0), norms.max(0)])
        self.is_trained = True

    # -- codec ----------------------------------------------------------------
    def _encode_fields(self, x: np.ndarray) -> np.ndarray:
        """[n, nsq, 2] int64: (norm code, lattice id) of every subvector."""
        n = len(x)
        sub = x.reshape(n, self.nsq, self.dsq)
        mins, maxs = self.trained
        sc = 1 << self.scale_nbit
        norms = np.linalg.norm(sub, axis=2)
        nj = (norms - mins) * sc / np.maximum(maxs - mins, 1e-20)
        nj = np.clip(nj, 0, sc - 1).astype(np.int64)
        flat = sub.reshape(n * self.nsq, self.dsq)
        codec = self.zn_sphere_codec
        ids = np.empty(n * self.nsq, np.int64)
        for s in range(0, len(flat), BATCH):
            xs = torch.from_numpy(np.ascontiguousarray(flat[s : s + BATCH])).to(self.device)
            c, atoms, _ = codec.search_dev(xs)
            ids[s : s + BATCH] = codec.encode_vertices(c, atoms).cpu().numpy()
        return np.stack([nj, ids.reshape(n, self.nsq)], axis=2)

    def _decode_fields(self, fields: np.ndarray) -> np.ndarray:
        """Reconstructions [n, d] float32: each vertex scaled to its decoded
        norm, in float64 then rounded, as faiss_tpu computes it."""
        n = len(fields)
        mins, maxs = self.trained
        sc = 1 << self.scale_nbit
        r = np.sqrt(self.zn_sphere_codec.r2)
        norm = (fields[:, :, 0] + 0.5) * (maxs - mins) / sc + mins  # float64
        ids = fields[:, :, 1].reshape(-1)
        out = np.empty((n * self.nsq, self.dsq), np.float32)
        for s in range(0, len(ids), BATCH):
            v = self.zn_sphere_codec.decode_ids(
                torch.from_numpy(ids[s : s + BATCH]).to(self.device))
            out[s : s + BATCH] = v.cpu().numpy()
        out = out.reshape(n, self.nsq, self.dsq) * (norm / r)[:, :, None]
        return out.astype(np.float32).reshape(n, self.d)

    def _bit_widths(self):
        return np.tile(np.array([self.scale_nbit, self.lattice_nbit]), self.nsq)

    def sa_encode(self, x) -> np.ndarray:
        """Packed codes (IndexLattice.cpp:80): per subvector the norm's
        ``scale_nbit`` bits then the id's ``lattice_nbit`` bits,
        little-endian."""
        fields = self._encode_fields(self._check_input(x)).reshape(len(x), -1)
        widths = self._bit_widths()
        bits = np.concatenate(
            [(fields[:, f, None] >> np.arange(w)) & 1 for f, w in enumerate(widths)],
            axis=1).astype(np.uint8)
        return np.packbits(bits, axis=1, bitorder="little")[:, : self.code_size]

    def sa_decode(self, codes) -> np.ndarray:
        codes = np.ascontiguousarray(codes, np.uint8)
        n = len(codes)
        widths = self._bit_widths()
        bits = np.unpackbits(codes, axis=1, bitorder="little")[:, : widths.sum()]
        starts = np.concatenate([[0], np.cumsum(widths)])
        fields = np.stack(
            [(bits[:, a : a + w].astype(np.int64) << np.arange(w)).sum(1)
             for a, w in zip(starts, widths)], axis=1)
        return self._decode_fields(fields.reshape(n, self.nsq, 2))

    # -- population and search --------------------------------------------------
    def add(self, x) -> None:
        x = self._check_input(x)
        self._check_trained()
        self.add_fields(self._encode_fields(x))

    def add_fields(self, fields: np.ndarray) -> None:
        """Append encoded fields [n, nsq, 2] int64 (norm code, lattice id)."""
        fields = np.asarray(fields, np.int64)
        self._codes = fields if self._codes is None else np.concatenate(
            [self._codes, fields])
        self._flat.add(self._decode_fields(fields))
        self.ntotal += len(fields)

    def reset(self) -> None:
        self._codes = None
        self._flat.reset()
        self.ntotal = 0

    def search(self, x, k: int, *, params=None):
        return self._flat.search(self._check_input(x), k, params=params)

    def reconstruct_n(self, n0: int, ni: int) -> np.ndarray:
        return self._decode_fields(self._codes[n0 : n0 + ni])
