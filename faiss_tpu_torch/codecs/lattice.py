"""Zn-lattice sphere codec (counterpart of faiss_tpu/codecs/lattice.py;
reference: faiss/impl/lattice_Zn.{h,cpp}).

A direction is quantized to the nearest point of Z^dim on the sphere of
squared radius r2, and the points carry consecutive ids. Every sphere point
is a sign and permutation image of an "atom" (a non-increasing non-negative
integer vector with sum of squares r2), so

  - the nearest point: sort |x| descending, one product against the atom
    matrix, the best atom, the permutation and signs undone (on the
    codec's device, in batches);
  - the id: (the atom's base) + (the rank of the point's multiset
    permutation of |values|, descending lexicographic) * 2^(nonzeros) +
    (the sign bits of the nonzeros in position order), faiss_tpu's
    numbering bit for bit.

faiss_tpu ranks and unranks one vertex at a time in Python; here the ranks
are closed forms over whole batches in int64 tensors: the number of distinct
permutations P_i of the suffix seq[i:] follows from P_{i+1} by one exact
multiply and divide, and position i adds P_i * #{j >= i: seq[j] > seq[i]} /
(dim - i). Unranking walks the positions with a count of each value per
row. The atoms are enumerated on the host, a copy of faiss_tpu's
enumeration."""

from __future__ import annotations

import functools
from math import comb
from typing import List, Tuple

import numpy as np
import torch

# subvectors a batch of the nearest-point search and the id arithmetic holds
BATCH = 1 << 20


@functools.lru_cache(maxsize=None)
def zn_sphere_atoms(dim: int, r2: int) -> np.ndarray:
    """All non-increasing non-negative integer vectors of length ``dim``
    with sum of squares r2, as a [natom, dim] float32 matrix, in faiss_tpu's
    order (codecs/lattice.py:30)."""
    out: List[List[int]] = []

    def rec(prefix, remaining, max_val, slots):
        if remaining == 0:
            out.append(prefix + [0] * slots)
            return
        if slots == 0:
            return
        v = min(max_val, int(np.sqrt(remaining)))
        while v >= 1:
            if v * v <= remaining:
                rec(prefix + [v], remaining - v * v, v, slots - 1)
            v -= 1

    rec([], r2, int(np.sqrt(r2)), dim)
    if not out:
        raise ValueError(f"no Z^{dim} points with squared norm {r2}")
    return np.asarray(out, np.float32)


class ZnSphereSearch:
    """Nearest sphere vertex (reference: lattice_Zn.h:25), on ``device``."""

    def __init__(self, dim: int, r2: int, *, device="cuda"):
        self.dim, self.r2 = int(dim), int(r2)
        self.device = torch.device(device)
        self.voc = zn_sphere_atoms(self.dim, self.r2)  # [natom, dim]
        self.natom = len(self.voc)
        self._voc_dev = torch.from_numpy(self.voc).to(self.device)

    def search_dev(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """x [n, dim] float32 on the device -> (vertices [n, dim] int64, their
        atoms [n] int64, the dot products [n] float32)."""
        x = x.float()
        order = torch.sort(-x.abs(), dim=1, stable=True).indices
        xs = torch.gather(x.abs(), 1, order)
        dots = xs @ self._voc_dev.T  # [n, natom]
        best = torch.argmax(dots, dim=1)
        c = torch.zeros_like(x, dtype=torch.int64)
        c.scatter_(1, order, self._voc_dev[best].long())
        c = torch.where(x < 0, -c, c)
        return c, best, dots.gather(1, best[:, None])[:, 0]

    def search_multi(self, x) -> Tuple[np.ndarray, np.ndarray]:
        """[n, dim] -> (nearest vertices [n, dim] float32, dot products [n])."""
        x = torch.as_tensor(np.ascontiguousarray(x, np.float32), device=self.device)
        c, _, dp = self.search_dev(x)
        return c.float().cpu().numpy(), dp.cpu().numpy()

    def search(self, x) -> Tuple[np.ndarray, float]:
        c, dp = self.search_multi(np.asarray(x, np.float32)[None])
        return c[0], float(dp[0])


class ZnSphereCodec(ZnSphereSearch):
    """Sphere vertices with consecutive ids (reference: lattice_Zn.h:115)."""

    def __init__(self, dim: int, r2: int, *, device="cuda"):
        super().__init__(dim, r2, device=device)
        atoms = np.asarray(self.voc, np.int64)
        perm = [self._multiset_perms(a) for a in atoms]
        signbits = [int((a != 0).sum()) for a in atoms]
        c0 = [0]
        for p, sb in zip(perm, signbits):
            c0.append(c0[-1] + p * (1 << sb))
        if c0[-1] >= 1 << 62:
            raise ValueError(f"Z^{dim} sphere r2={r2} has too many points")
        self.nv = int(c0[-1])
        self.code_size = max(1, (int(self.nv - 1).bit_length() + 7) // 8)
        dev = self.device
        self._perm_dev = torch.tensor(perm, dtype=torch.int64, device=dev)
        self._sb_dev = torch.tensor(signbits, dtype=torch.int64, device=dev)
        self._c0_dev = torch.tensor(c0, dtype=torch.int64, device=dev)
        # atoms by their descending-|value| key in base vmax + 1
        self._base = int(atoms.max()) + 1
        keys = self._keys(torch.from_numpy(atoms).to(dev))
        self._key_sorted, self._key_atom = torch.sort(keys)

    @staticmethod
    def _multiset_perms(atom) -> int:
        total, rem = 1, len(atom)
        for c in np.unique(atom, return_counts=True)[1]:
            total *= comb(rem, int(c))
            rem -= int(c)
        return total

    def _keys(self, sorted_abs: torch.Tensor) -> torch.Tensor:
        w = self._base ** torch.arange(self.dim - 1, -1, -1, device=sorted_abs.device,
                                       dtype=torch.int64)
        return (sorted_abs * w).sum(1)

    def _atoms_of(self, ca: torch.Tensor) -> torch.Tensor:
        """The atom of each row's |vertex| (raises on a non-vertex)."""
        srt = torch.sort(ca, dim=1, descending=True).values
        keys = self._keys(srt.clamp_max(self._base - 1))
        pos = torch.searchsorted(self._key_sorted, keys).clamp_max(
            len(self._key_sorted) - 1)
        if not bool(((self._key_sorted[pos] == keys) & (srt[:, 0] < self._base)).all()):
            raise ValueError("vector is not a sphere vertex")
        return self._key_atom[pos]

    def encode_vertices(self, c: torch.Tensor, atoms=None) -> torch.Tensor:
        """Ids [n] int64 of the vertices ``c`` [n, dim] (integers, any
        dtype) on the device; ``atoms`` [n] when already known."""
        c = c.long()
        ca = c.abs()
        if atoms is None:
            atoms = self._atoms_of(ca)
        n, dim = ca.shape
        ge = torch.triu(torch.ones(dim, dim, dtype=torch.bool, device=c.device))
        # [n, i, j]: j >= i and seq[j] (>, ==) seq[i]
        gt = ((ca[:, None, :] > ca[:, :, None]) & ge).sum(2)
        eq = ((ca[:, None, :] == ca[:, :, None]) & ge).sum(2)
        rank = torch.zeros(n, dtype=torch.int64, device=c.device)
        p = torch.ones(n, dtype=torch.int64, device=c.device)
        for i in range(dim - 1, -1, -1):
            m = dim - i
            p = p * m // eq[:, i]  # distinct permutations of seq[i:]
            rank += p * gt[:, i] // m
        nz = ca != 0
        bit = torch.cumsum(nz.long(), 1) - 1
        signs = (((c < 0) & nz).long() << bit.clamp_min(0)).sum(1)
        return self._c0_dev[atoms] + (rank << self._sb_dev[atoms]) + signs

    def decode_ids(self, codes: torch.Tensor) -> torch.Tensor:
        """Vertices [n, dim] int64 of the ids ``codes`` [n] on the device."""
        codes = codes.long()
        a = torch.searchsorted(self._c0_dev, codes, right=True) - 1
        off = codes - self._c0_dev[a]
        sb = self._sb_dev[a]
        signs = off & ((1 << sb) - 1)
        rank = off >> sb
        atom = self._voc_dev[a].long()  # [n, dim]
        vals = torch.arange(self._base - 1, -1, -1, device=codes.device)  # descending
        counts = (atom[:, None, :] == vals[None, :, None]).sum(2)  # [n, V]
        p = self._perm_dev[a]
        n = len(codes)
        seq = torch.zeros(n, self.dim, dtype=torch.int64, device=codes.device)
        for i in range(self.dim):
            m = self.dim - i
            pv = p[:, None] * counts // m  # permutations after placing each v
            cum = torch.cumsum(pv, 1)
            pick = (rank[:, None] >= cum).sum(1)  # first v with rank < cum
            before = torch.where(pick > 0, cum.gather(1, (pick - 1).clamp_min(0)[:, None])[:, 0], 0)
            rank = rank - before
            p = pv.gather(1, pick[:, None])[:, 0]
            counts = counts - torch.nn.functional.one_hot(pick, len(vals))
            seq[:, i] = vals[pick]
        nz = seq != 0
        bit = torch.cumsum(nz.long(), 1) - 1
        neg = nz & (((signs[:, None] >> bit.clamp_min(0)) & 1) == 1)
        return torch.where(neg, -seq, seq)

    def encode(self, x) -> int:
        """Nearest-vertex id of (possibly unnormalized) x."""
        x = torch.as_tensor(np.asarray(x, np.float32)[None], device=self.device)
        c, a, _ = self.search_dev(x)
        return int(self.encode_vertices(c, a)[0])

    def encode_vertex(self, c) -> int:
        c = torch.as_tensor(np.rint(np.asarray(c)).astype(np.int64)[None],
                            device=self.device)
        return int(self.encode_vertices(c)[0])

    def decode(self, code: int) -> np.ndarray:
        v = self.decode_ids(torch.tensor([int(code)], device=self.device))
        return v[0].float().cpu().numpy()


class ZnSphereCodecAlt(ZnSphereCodec):
    """The reference's power-of-two recursive variant (lattice_Zn.h:175),
    kept for its name: the combinatorial codec covers every dimension."""
