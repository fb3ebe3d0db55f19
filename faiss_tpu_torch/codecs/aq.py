"""Additive quantizers (counterpart of faiss_tpu/codecs/aq.py; reference:
faiss/impl/AdditiveQuantizer.{h,cpp}, ResidualQuantizer.{h,cpp},
LocalSearchQuantizer.{h,cpp}, ProductAdditiveQuantizer.h).

A vector is approximated by the SUM of M codewords, one from each of M
codebooks of K = 2^nbits codewords (AdditiveQuantizer.h:26):

  - ResidualQuantizer trains greedily, level by level, with k-means of the
    residuals on the device (ops/kmeans_ops.batched_kmeans), subsampled and
    initialised with faiss_tpu's RandomState(123) calls on the host; it
    encodes by beam search, each level one batched float32 product over
    the [rows, beam, K] continuations and one ``torch.topk`` over beam * K,
    the rows in tiles of ``BEAM_TILE`` elements;
  - LocalSearchQuantizer starts from the RQ codes, runs ICM sweeps (each
    level re-picked with the others fixed: a product and an argmin) and
    iterated local search: perturbations drawn on the host from
    RandomState(0x15C) exactly as faiss_tpu draws them, so both packages
    perturb the same levels, then ICM, keeping the rows that improved; the
    codebooks come from faiss_tpu's least-squares update (host numpy
    ``solve``);
  - the product forms train one sub-quantizer per dimension split and embed
    its codebooks, zero elsewhere, in the full-d codebooks.

Search reads per-query tables (``compute_LUT``) plus a stored norm per code,
whose storage ``search_type`` selects (float32, qint8/4, cqint8/4, lsq2x4,
rq2x4; the numeric values are faiss_tpu's). The norm codecs are faiss_tpu's
host numpy, copied. Packed codes are the port's ProductQuantizer bit
strings, the norm bytes appended."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..base import require_device
from ..callbacks import InterruptCallback
from ..ops.kmeans_ops import batched_kmeans
from .pq import ProductQuantizer, codes_numpy, codes_tensor

# elements of one encode tile [rows, beam, max(K, d)] (the continuations'
# errors and the beam's residuals; [rows, K] for ICM): at 1M rows and K = 256
# one untiled [n, 5, 256] float32 level is 5 GB
BEAM_TILE = 1 << 26


def _tile_rows(beam: int, K: int, d: int) -> int:
    return max(1, BEAM_TILE // (min(beam, K) * max(K, d)))


def decode_dev(codes: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """codes [n, M] -> the sum of their codewords [n, d] float32, added in
    order of m (faiss_tpu aq.py:107)."""
    out = codebooks[0][codes[:, 0].long()]
    for m in range(1, codebooks.shape[0]):
        out = out + codebooks[m][codes[:, m].long()]
    return out


def beam_search_encode(x: torch.Tensor, codebooks: torch.Tensor,
                       beam: int) -> torch.Tensor:
    """Residual beam search (faiss_tpu aq.py:32): x [n, d], codebooks
    [M, K, d] -> codes [n, M] int64 of the best beam. Each level scores the
    beam * K continuations |r|^2 + |c|^2 - 2 r.c in one product and keeps
    the ``beam`` smallest."""
    n, d = x.shape
    M, K, _ = codebooks.shape
    b = min(beam, K)
    cn = codebooks.square().sum(-1)  # [M, K]
    rows = _tile_rows(b, K, d)
    out = []
    for s in range(0, n, rows):
        xs = x[s : s + rows]
        nr = xs.shape[0]
        c0 = codebooks[0]
        d2 = xs.square().sum(-1)[:, None] + cn[0][None, :] - 2.0 * (xs @ c0.T)
        _, idx = torch.topk(d2, b, dim=1, largest=False)
        codes = idx[:, :, None]
        res = xs[:, None, :] - c0[idx]
        for m in range(1, M):
            InterruptCallback.check()
            cm = codebooks[m]
            ip = (res.reshape(-1, d) @ cm.T).reshape(nr, b, K)
            e = res.square().sum(-1)[:, :, None] + cn[m][None, None, :] - 2.0 * ip
            _, sel = torch.topk(e.reshape(nr, -1), b, dim=1, largest=False)
            bsel, ksel = sel // K, sel % K
            codes = torch.cat([torch.gather(codes, 1, bsel[:, :, None].expand(-1, -1, m)),
                               ksel[:, :, None]], dim=2)
            res = torch.gather(res, 1, bsel[:, :, None].expand(-1, -1, d)) - cm[ksel]
        out.append(codes[:, 0, :])
    if not out:
        return torch.zeros(0, M, dtype=torch.int64, device=x.device)
    return torch.cat(out)


def icm_sweep(x: torch.Tensor, codebooks: torch.Tensor,
              codes: torch.Tensor) -> torch.Tensor:
    """One ICM sweep (faiss_tpu aq.py:84; LocalSearchQuantizer::icm_encode):
    each level in turn re-picks its code, the argmin over its codebook of
    the distance to x minus the other levels' codewords. Returns new codes
    [n, M] int64."""
    codes = codes.clone()
    cn = codebooks.square().sum(-1)
    for m in range(codebooks.shape[0]):
        cm = codebooks[m]
        recon = decode_dev(codes, codebooks)
        target = x - (recon - cm[codes[:, m]])
        d2 = (target.square().sum(-1)[:, None] + cn[m][None, :]
              - 2.0 * (target @ cm.T))
        codes[:, m] = d2.argmin(dim=1)
    return codes


def _row_err(x, codes, codebooks):
    r = decode_dev(codes, codebooks) - x
    return r.square().sum(-1)


def _packer(M: int, nbits: int) -> ProductQuantizer:
    """A ProductQuantizer shell that packs M codes of nbits (faiss_tpu's
    helper, aq.py:246)."""
    helper = ProductQuantizer.__new__(ProductQuantizer)
    helper.M, helper.nbits = M, nbits
    helper.code_size = (M * nbits + 7) // 8
    return helper


class AdditiveQuantizer:
    """Sum-of-codebooks codec (reference: AdditiveQuantizer.h:26; faiss_tpu
    aq.py:115). ``codebooks`` [M, K, d] float32 on the host, copied to
    ``device`` at first use."""

    # search_type values (AdditiveQuantizer.h:57 Search_type_t; the numbers
    # are faiss_tpu's, which its index files hold)
    ST_decompress = 0
    ST_LUT_nonorm = 1
    ST_norm_from_LUT = 2
    ST_norm_float = 4
    ST_norm_qint8 = 5
    ST_norm_qint4 = 6
    ST_norm_cqint8 = 7
    ST_norm_cqint4 = 8
    ST_norm_lsq2x4 = 9
    ST_norm_rq2x4 = 10

    # bytes appended to the packed code for the stored norm (byte-aligned)
    _NORM_BYTES = {0: 0, 1: 0, 2: 0, 4: 4, 5: 1, 6: 1, 7: 1, 8: 1, 9: 1, 10: 1}
    # the norm modes trained after the codebooks
    _TRAINED_NORMS = (5, 6, 7, 8, 9, 10)

    def __init__(self, d: int, M: int, nbits: int = 8, *, device="cuda"):
        self.d = int(d)
        self.M = int(M)
        self.nbits = int(nbits)
        self.K = 1 << self.nbits
        self.device = require_device(device)
        self.code_size = (self.M * self.nbits + 7) // 8 + 4  # + float32 norm
        self._codebooks: Optional[np.ndarray] = None
        self._cb_dev = None
        self.search_type = self.ST_norm_float
        self.norm_min = self.norm_max = float("nan")
        self.qnorm: Optional[np.ndarray] = None  # cqint / lsq2x4 / rq2x4
        self.norm_tabs: Optional[np.ndarray] = None  # [2, 16] (2x4 modes)
        self.verbose = False

    @property
    def codebooks(self) -> Optional[np.ndarray]:
        return self._codebooks

    @codebooks.setter
    def codebooks(self, cb) -> None:
        self._codebooks = None if cb is None else np.ascontiguousarray(cb, np.float32)
        self._cb_dev = None

    @property
    def is_trained(self) -> bool:
        return self._codebooks is not None

    def _dev(self) -> torch.Tensor:
        if self._cb_dev is None:
            if self._codebooks is None:
                raise RuntimeError(f"{type(self).__name__} is not trained")
            self._cb_dev = torch.from_numpy(self._codebooks).to(self.device)
        return self._cb_dev

    def set_search_type(self, st: int) -> None:
        """Select the norm storage (AdditiveQuantizer.h:72); resizes
        code_size. Call before train()."""
        if st not in self._NORM_BYTES:
            raise ValueError(f"unknown search_type {st}")
        self.search_type = st
        self.code_size = (self.M * self.nbits + 7) // 8 + self._NORM_BYTES[st]

    # -- norm storage (host numpy, faiss_tpu aq.py:161-233) -------------------
    def train_norm(self, norms: np.ndarray) -> None:
        norms = np.ascontiguousarray(norms, np.float32).ravel()
        self.norm_min = float(norms.min())
        self.norm_max = float(norms.max())
        st = self.search_type
        if st in (self.ST_norm_cqint8, self.ST_norm_cqint4):
            # quantile-initialised 1-D Lloyd, as faiss_tpu trains the table
            k = 256 if st == self.ST_norm_cqint8 else 16
            sub = np.sort(norms[: 1 << 16])
            uniq = np.unique(sub)
            if len(uniq) <= k:
                self.qnorm = np.resize(uniq, k).astype(np.float32)
                return
            cents = np.quantile(sub, (np.arange(k) + 0.5) / k)
            for _ in range(25):
                bounds = (cents[1:] + cents[:-1]) / 2
                a = np.searchsorted(bounds, sub)
                sums = np.bincount(a, weights=sub, minlength=k)
                cnts = np.bincount(a, minlength=k)
                nz = cnts > 0
                cents[nz] = sums[nz] / cnts[nz]
            self.qnorm = cents.astype(np.float32)
        elif st in (self.ST_norm_lsq2x4, self.ST_norm_rq2x4):
            sub_cls = (LocalSearchQuantizer if st == self.ST_norm_lsq2x4
                       else ResidualQuantizer)
            sub = sub_cls(1, 2, 4, device=self.device)
            sub.train(norms[: 1 << 16, None])
            c = sub.codebooks[:, :, 0]  # [2, 16]
            self.norm_tabs = c.astype(np.float32)
            # entry i * 16 + j reconstructs c0[j] + c1[i]
            self.qnorm = (c[1][:, None] + c[0][None, :]).ravel().astype(np.float32)

    def encode_norms(self, norms: np.ndarray) -> np.ndarray:
        """uint8 [n, norm bytes] norm payload of the packed codes."""
        norms = np.ascontiguousarray(norms, np.float32).ravel()
        st = self.search_type
        if st == self.ST_norm_float:
            return norms[:, None].view(np.uint8)
        if st in (self.ST_norm_qint8, self.ST_norm_qint4):
            scale = 256 if st == self.ST_norm_qint8 else 16
            span = max(self.norm_max - self.norm_min, 1e-20)
            i = np.floor((norms - self.norm_min) / span * scale)
            return np.clip(i, 0, scale - 1).astype(np.uint8)[:, None]
        if self.qnorm is not None:  # cqint / lsq2x4 / rq2x4: nearest entry
            i = np.abs(norms[:, None] - self.qnorm[None, :]).argmin(1)
            return i.astype(np.uint8)[:, None]
        return np.zeros((len(norms), 0), np.uint8)

    def decode_norms(self, codes: np.ndarray) -> Optional[np.ndarray]:
        """The stored reconstruction norms of packed codes (float32 [n]), or
        None where the search type stores none."""
        st = self.search_type
        nb = self._NORM_BYTES[st]
        if nb == 0:
            return None
        tail = np.ascontiguousarray(codes[:, codes.shape[1] - nb :])
        if st == self.ST_norm_float:
            return tail.view(np.float32).ravel()
        i = tail[:, 0].astype(np.float32)
        if st in (self.ST_norm_qint8, self.ST_norm_qint4):
            scale = 256 if st == self.ST_norm_qint8 else 16
            return (i + 0.5) / scale * (self.norm_max - self.norm_min) + self.norm_min
        return self.qnorm[tail[:, 0]]

    def stored_norms(self, norms: np.ndarray) -> np.ndarray:
        """The norms a search ranks with: the exact ones, or, for a one-byte
        norm code, the decoded value of that code (faiss_tpu models/aq.py:
        107-112, AdditiveQuantizer.h:78)."""
        if self._NORM_BYTES.get(self.search_type, 0) == 1:
            return self.decode_norms(self.encode_norms(norms)).astype(np.float32)
        return np.ascontiguousarray(norms, np.float32)

    # -- codec ------------------------------------------------------------------
    def compute_codes_dev(self, x: torch.Tensor) -> torch.Tensor:
        """Unpacked codes [n, M] int64 of device rows ``x``."""
        raise NotImplementedError

    def _x_dev(self, x) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x.to(self.device, torch.float32)
        return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(self.device)

    def compute_codes_int(self, x) -> np.ndarray:
        """Unpacked codes [n, M] (uint8 up to 8 bits, uint16 above)."""
        return codes_numpy(self.compute_codes_dev(self._x_dev(x)), self.nbits)

    def compute_codes(self, x) -> np.ndarray:
        """Packed codes with the trailing stored norm (per search_type)."""
        codes_int = self.compute_codes_int(x)
        packed = _packer(self.M, self.nbits).pack_codes(codes_int)
        if self._NORM_BYTES[self.search_type] == 0:
            return packed
        recon = self.decode_int(codes_int)
        norms = (recon**2).sum(1).astype(np.float32)
        return np.concatenate([packed, self.encode_norms(norms)], axis=1)

    def unpack_codes(self, codes) -> np.ndarray:
        helper = _packer(self.M, self.nbits)
        return helper.unpack_codes(np.ascontiguousarray(codes, np.uint8)[:, : helper.code_size])

    def decode_dev(self, codes: torch.Tensor) -> torch.Tensor:
        return decode_dev(codes, self._dev())

    def decode_int(self, codes_int) -> np.ndarray:
        return self.decode_dev(codes_tensor(codes_int, self.device)).cpu().numpy()

    def decode(self, codes) -> np.ndarray:
        return self.decode_int(self.unpack_codes(codes))

    def _maybe_train_norm(self, x) -> None:
        """After the codebooks: fit the norm codec on the reconstruction
        norms of the first 8192 training rows (faiss_tpu aq.py:280)."""
        if self.search_type in self._TRAINED_NORMS:
            sub = np.ascontiguousarray(x[:8192], np.float32)
            recon = self.decode_int(self.compute_codes_int(sub))
            self.train_norm((recon**2).sum(1))

    def compute_LUT(self, xq) -> np.ndarray:
        """Per-query inner-product tables [nq, M, K]
        (AdditiveQuantizer::compute_LUT), computed on the device."""
        return self.lut_dev(self._x_dev(xq)).cpu().numpy()

    def lut_dev(self, xq: torch.Tensor) -> torch.Tensor:
        return torch.einsum("qd,mkd->qmk", xq, self._dev())


class ResidualQuantizer(AdditiveQuantizer):
    """reference: impl/ResidualQuantizer.h:22; faiss_tpu aq.py:298."""

    def __init__(self, d: int, M: int, nbits: int = 8, *, device="cuda"):
        super().__init__(d, M, nbits, device=device)
        self.max_beam_size = 5
        self.train_iters = 15  # k-means iterations per level

    def train(self, x) -> None:
        x = np.ascontiguousarray(x, np.float32)
        n = len(x)
        max_n = self.K * 256
        if n > max_n:
            x = x[np.random.RandomState(123).permutation(n)[:max_n]]
            n = max_n
        res = torch.from_numpy(x).to(self.device)
        codebooks = torch.zeros(self.M, self.K, self.d, device=self.device)
        rs = np.random.RandomState(123)
        for m in range(self.M):
            InterruptCallback.check()
            init = res[torch.from_numpy(rs.permutation(n)[: self.K]).to(self.device)]
            cb = batched_kmeans(res[None], init[None], self.train_iters)[0]
            codebooks[m] = cb
            d2 = (res.square().sum(1)[:, None] + cb.square().sum(1)[None, :]
                  - 2.0 * (res @ cb.T))
            res = res - cb[d2.argmin(1)]
        self.codebooks = codebooks.cpu().numpy()
        self._maybe_train_norm(x)

    def compute_codes_dev(self, x: torch.Tensor) -> torch.Tensor:
        return beam_search_encode(x, self._dev(), self.max_beam_size)


class LocalSearchQuantizer(AdditiveQuantizer):
    """reference: impl/LocalSearchQuantizer.h:24; faiss_tpu aq.py:349. RQ
    codes refined by ICM sweeps and iterated local search; the codebooks by
    least squares over the one-hot design matrix."""

    def __init__(self, d: int, M: int, nbits: int = 8, *, device="cuda"):
        super().__init__(d, M, nbits, device=device)
        self.encode_ils_iters = 4  # perturb + ICM rounds at encode time
        self.icm_iters = 2  # ICM sweeps per round
        self.nperts = min(4, M)  # levels perturbed per round (LSQ.h:42)
        self.train_ils_iters = 2
        self._rq = ResidualQuantizer(d, M, nbits, device=device)

    def train(self, x) -> None:
        self._rq.train(x)
        self.codebooks = self._rq.codebooks
        x = np.ascontiguousarray(x, np.float32)[: self.K * 64]
        for _ in range(self.train_ils_iters):
            codes = self.compute_codes_int(x)
            # least squares for every codeword at once (host numpy, as
            # faiss_tpu solves it); the column index in int64: faiss_tpu adds
            # m * K to the uint8 codes, which overflows past M * K = 256
            # (ROADMAP queue 3)
            onehot = np.zeros((len(x), self.M * self.K), np.float32)
            for m in range(self.M):
                onehot[np.arange(len(x)), m * self.K + codes[:, m].astype(np.int64)] = 1
            gram = onehot.T @ onehot + 1e-3 * np.eye(self.M * self.K, dtype=np.float32)
            sol = np.linalg.solve(gram, onehot.T @ x)
            self.codebooks = sol.reshape(self.M, self.K, self.d).astype(np.float32)
        self._maybe_train_norm(x)

    def compute_codes_dev(self, x: torch.Tensor) -> torch.Tensor:
        self._rq.codebooks = self.codebooks
        cb = self._dev()
        n = x.shape[0]
        # every round's perturbations for all rows, drawn as faiss_tpu draws
        # them (levels, then values, per round), before the rows are tiled
        rng = np.random.RandomState(0x15C)
        perts = [(rng.randint(self.M, size=(n, self.nperts)),
                  rng.randint(self.K, size=(n, self.nperts)))
                 for _ in range(max(0, self.encode_ils_iters - 1))]
        rows = _tile_rows(self._rq.max_beam_size, self.K, self.d)
        out = []
        for s in range(0, n, rows):
            xs = x[s : s + rows]
            codes = self._rq.compute_codes_dev(xs)
            for _ in range(self.icm_iters):
                InterruptCallback.check()
                codes = icm_sweep(xs, cb, codes)
            best, best_err = codes, _row_err(xs, codes, cb)
            for levels, vals in perts:
                InterruptCallback.check()
                lv = torch.from_numpy(levels[s : s + rows]).to(self.device)
                vv = torch.from_numpy(vals[s : s + rows]).to(self.device)
                cand = best.clone()
                for j in range(self.nperts):  # in order: a repeated level keeps the last
                    cand.scatter_(1, lv[:, j : j + 1], vv[:, j : j + 1])
                for _ in range(self.icm_iters):
                    cand = icm_sweep(xs, cb, cand)
                err = _row_err(xs, cand, cb)
                win = err < best_err
                best = torch.where(win[:, None], cand, best)
                best_err = torch.minimum(err, best_err)
            out.append(best)
        if not out:
            return torch.zeros(0, self.M, dtype=torch.int64, device=self.device)
        return torch.cat(out)


class ProductAdditiveQuantizer(AdditiveQuantizer):
    """Independent additive quantizers over dimension splits (reference:
    impl/ProductAdditiveQuantizer.h; faiss_tpu aq.py:424)."""

    def __init__(self, d: int, nsplits: int, Msub: int, nbits: int = 8,
                 sub_cls=ResidualQuantizer, *, device="cuda"):
        if d % nsplits:
            raise ValueError("d must be divisible by nsplits")
        super().__init__(d, nsplits * Msub, nbits, device=device)
        self.nsplits = nsplits
        self.dsub = d // nsplits
        self.subs = [sub_cls(self.dsub, Msub, nbits, device=device)
                     for _ in range(nsplits)]

    def set_sub_codebooks(self) -> None:
        """The sub-quantizers' codebooks from the embedded full-d ones (an
        index file holds only the latter)."""
        Msub = self.M // self.nsplits
        for s, sub in enumerate(self.subs):
            sub.codebooks = self.codebooks[s * Msub : (s + 1) * Msub, :,
                                           s * self.dsub : (s + 1) * self.dsub]

    def train(self, x) -> None:
        x = np.ascontiguousarray(x, np.float32)
        Msub = self.M // self.nsplits
        codebooks = np.zeros((self.M, self.K, self.d), np.float32)
        for s, sub in enumerate(self.subs):
            sl = slice(s * self.dsub, (s + 1) * self.dsub)
            sub.train(x[:, sl])
            codebooks[s * Msub : (s + 1) * Msub, :, sl] = sub.codebooks
        self.codebooks = codebooks
        self._maybe_train_norm(x)

    def compute_codes_dev(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([
            sub.compute_codes_dev(x[:, s * self.dsub : (s + 1) * self.dsub].contiguous())
            for s, sub in enumerate(self.subs)], dim=1)


class ProductResidualQuantizer(ProductAdditiveQuantizer):
    def __init__(self, d, nsplits, Msub, nbits=8, *, device="cuda"):
        super().__init__(d, nsplits, Msub, nbits, ResidualQuantizer, device=device)


class ProductLocalSearchQuantizer(ProductAdditiveQuantizer):
    def __init__(self, d, nsplits, Msub, nbits=8, *, device="cuda"):
        super().__init__(d, nsplits, Msub, nbits, LocalSearchQuantizer, device=device)
