"""RaBitQ indexes (counterpart of faiss_tpu/models/rabitq.py; reference:
faiss/IndexRaBitQ.{h,cpp}, IndexRaBitQFastScan.h, IndexIVFRaBitQ.{h,cpp},
IndexIVFRaBitQFastScan.h).

Storage is one bit a dimension plus float32 factors, on the device. The
1-bit flat scan unpacks a chunk's sign rows, takes <q_r, o_bar> for every
query by one float32 ``torch.mm`` (TF32 off), applies the estimator and
keeps an exact running top-k. The multi-bit indexes rank by the implied
vectors (codecs/rabitq.MultiBitRaBitQ.implied_vectors) with f_add as their
norms, through ops/distances.knn. The IVF index stores g = <P c, o_bar> in
each 1-bit code, so its query-side product takes P q once for every probe
(ops/ivf_ops.ivf_rabitq_scan). The FastScan classes are the qb = 8
quantized-query operating point (``bbs`` kept for the factory and files).
ID selectors are applied before the select in every search (faiss_tpu drops
them, ROADMAP queue 3). No kernel: faiss_tpu computes all of this in XLA.
L2 only, as the reference."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..base import Index, query_buckets, require_device, sel_mask
from ..codecs.rabitq import (
    MultiBitRaBitQ,
    RaBitQuantizer,
    quantize_query_sq,
    quantize_query_sq_dev,
)
from ..metric import MetricType
from ..ops import distances as dops
from ..ops.ivf_ops import (
    ivf_rabitq_scan,
    probe_slots,
    rabitq_probe_dists,
    rabitq_sqrt_d,
    unpack_signs,
)
from ..ops.pq_ops import _knn_init, _select_chunk
from .ivf import IndexIVF


def rabitq_knn(qr, qn2, packed, factors, k, d, keep=None, db_chunk=1 << 15):
    """The flat 1-bit scan (faiss_tpu models/rabitq.py:36, _rabitq_knn): per
    chunk of ``db_chunk`` codes the signs unpacked, <q_r, o_bar> as one
    float32 product, est = |x_r| <q_r, o_bar> / f and |q_r|^2 + |x_r|^2 -
    2 est; codes that ``keep`` clears at +inf before the exact select.
    Returns (D [nq, min(k, nb)], ids int64), +inf and -1 past the kept
    codes."""
    nb = packed.shape[0]
    kk = min(k, nb)
    vals, ids = _knn_init(qr.shape[0], kk, False, qr.device)
    sqrt_d = rabitq_sqrt_d(d)
    for c0 in range(0, nb, db_chunk):
        signs = unpack_signs(packed[c0 : c0 + db_chunk], d)
        ip_ob = (qr @ signs.T) / sqrt_d
        fc = factors[c0 : c0 + db_chunk]
        nr, f = fc[:, 0][None, :], fc[:, 1][None, :]
        est = nr * ip_ob / f
        dist = qn2[:, None] + nr * nr - 2.0 * est
        if keep is not None:
            dist = torch.where(keep[None, c0 : c0 + db_chunk], dist, float("inf"))
        vals, ids = _select_chunk(vals, ids, dist, c0, kk, False)
    return vals, ids


class IndexRaBitQ(Index):
    """Flat RaBitQ index (reference: IndexRaBitQ.h:20; faiss_tpu :80);
    ``nb_bits > 1`` is the multi-bit variant (IndexRaBitQ.h:40)."""

    def __init__(self, d: int, metric=MetricType.L2, nb_bits: int = 1, *,
                 device="cuda"):
        if MetricType(metric) != MetricType.L2:
            raise ValueError("RaBitQ supports L2 only (like the reference)")
        super().__init__(d, metric, device=require_device(device))
        self.nb_bits = int(nb_bits)
        self.rabitq = (MultiBitRaBitQ(d, self.nb_bits, device=self.device)
                       if self.nb_bits > 1 else RaBitQuantizer(d))
        self.is_trained = False
        self.qb = 0  # query quantization bits; 0 = the float query
        self.centered = False  # zero-symmetric query range
        self._bits: Optional[np.ndarray] = None  # host codes, as in files
        self._factors: Optional[np.ndarray] = None
        self._dev_state = None

    def train(self, x) -> None:
        self.rabitq.train(self._check_input(x))
        self.is_trained = True

    def add(self, x) -> None:
        x = self._check_input(x)
        self._check_trained()
        self.add_codes(*self.rabitq.encode_parts(x))

    def add_codes(self, bits, factors) -> None:
        """Append encoded rows: 1-bit packed signs [n, d/8] (multi-bit: the
        codes [n, d]) and their factors [n, 2] float32."""
        bits = np.ascontiguousarray(
            bits, self.rabitq._code_dtype if self.nb_bits > 1 else np.uint8)
        factors = np.ascontiguousarray(factors, np.float32)
        self._bits = bits if self._bits is None else np.concatenate([self._bits, bits])
        self._factors = (factors if self._factors is None
                         else np.concatenate([self._factors, factors]))
        self.ntotal = len(self._bits)
        self._dev_state = None

    def _device_state(self):
        """(codes or implied vectors, factors or f_add) on the device, built
        at the first search after a change."""
        if self._dev_state is None:
            if self.nb_bits > 1:
                y = self.rabitq.implied_vectors(self._bits, self._factors)
                first = torch.from_numpy(np.ascontiguousarray(y, np.float32))
                second = torch.from_numpy(np.ascontiguousarray(self._factors[:, 0]))
            else:
                first = torch.from_numpy(self._bits)
                second = torch.from_numpy(self._factors)
            self._dev_state = (first.to(self.device), second.to(self.device))
        return self._dev_state

    def search(self, x, k: int, *, params=None):
        x = self._check_input(x)
        nq = len(x)
        D = np.full((nq, k), np.inf, np.float32)
        I = np.full((nq, k), -1, np.int64)
        if self.ntotal == 0 or nq == 0:
            return D, I
        keep = sel_mask(params, np.arange(self.ntotal, dtype=np.int64), self.device)
        first, second = self._device_state()
        if self.nb_bits > 1:
            xc = torch.from_numpy(x - self.rabitq.center).to(self.device)
            Dt, It = dops.knn(xc, first, k, metric=MetricType.L2, y_norms=second,
                              y_mask=keep)
            return Dt.cpu().numpy(), It.cpu().numpy()
        for start, _, real in query_buckets(nq):
            qr, qn2 = self.rabitq.rotate_queries(x[start : start + real])
            # |q_r|^2 stays exact (the reference's qr_to_c_L2sqr is taken
            # from the unquantized query too)
            qr = quantize_query_sq(qr, self.qb, self.centered)
            d, i = rabitq_knn(torch.from_numpy(qr).to(self.device),
                              torch.from_numpy(qn2).to(self.device), first,
                              second, k, self.d, keep)
            D[start : start + real, : d.shape[1]] = d.cpu().numpy()
            I[start : start + real, : d.shape[1]] = i.cpu().numpy()
        return D, I

    def reconstruct_n(self, n0: int, ni: int) -> np.ndarray:
        bits, fac = self._bits[n0 : n0 + ni], self._factors[n0 : n0 + ni]
        if self.nb_bits > 1:
            return self.rabitq.decode(bits, fac, self.rabitq.center)
        return self.rabitq.decode(np.concatenate([bits, fac.view(np.uint8)], axis=1))

    def sa_code_size(self) -> int:
        return self.rabitq.code_size

    def sa_encode(self, x) -> np.ndarray:
        x = self._check_input(x)
        if self.nb_bits > 1:
            return self.rabitq.pack(*self.rabitq.encode_parts(x))
        return self.rabitq.compute_codes(x)

    def sa_decode(self, codes) -> np.ndarray:
        if self.nb_bits > 1:
            c, f = self.rabitq.unpack(np.asarray(codes, np.uint8))
            return self.rabitq.decode(c, f, self.rabitq.center)
        return self.rabitq.decode(codes)

    def reset(self) -> None:
        self._bits = self._factors = self._dev_state = None
        self.ntotal = 0


class IndexRaBitQFastScan(IndexRaBitQ):
    """FastScan RaBitQ (reference: IndexRaBitQFastScan.h:39; faiss_tpu
    :247): queries quantized to ``qb`` = 8 bits before the scan."""

    def __init__(self, d: int, metric=MetricType.L2, bbs: int = 32,
                 nb_bits: int = 1, *, device="cuda"):
        super().__init__(d, metric, nb_bits, device=device)
        self.bbs = int(bbs)
        self.qb = 8
        self.centered = False

    @classmethod
    def from_rabitq(cls, orig: IndexRaBitQ, bbs: int = 32):
        """IndexRaBitQFastScan(const IndexRaBitQ&) (IndexRaBitQFastScan.cpp):
        the same codec and codes."""
        out = cls(orig.d, orig.metric_type, bbs, orig.nb_bits, device=orig.device)
        out.rabitq = orig.rabitq
        out.is_trained = orig.is_trained
        if orig._bits is not None:
            out.add_codes(orig._bits.copy(), orig._factors.copy())
        return out


class IndexIVFRaBitQ(IndexIVF):
    """IVF over RaBitQ codes of the residuals (reference: IndexIVFRaBitQ.h:19;
    faiss_tpu :276). A 1-bit code is the bits, (|x_r|, f) and g = <P c,
    o_bar> of its list centroid c; a multi-bit code is the codec's packed
    bytes."""

    def __init__(self, quantizer, d, nlist, metric=MetricType.L2,
                 nb_bits: int = 1, *, device="cuda"):
        if MetricType(metric) != MetricType.L2:
            raise ValueError("RaBitQ supports L2 only")
        super().__init__(quantizer, d, nlist, metric, device=require_device(device))
        self.nb_bits = int(nb_bits)
        if self.nb_bits > 1:
            self.rabitq = MultiBitRaBitQ(d, self.nb_bits, device=self.device)
            self.code_size = self.rabitq.code_size
        else:
            self.rabitq = RaBitQuantizer(d)
            self.code_size = self.rabitq.code_size + 4  # + <P c, o_bar>
        self.by_residual = True
        self.qb = 0
        self.centered = False

    def train_encoder(self, x, assign) -> None:
        self.rabitq.center = np.zeros(self.d, np.float32)  # residual mode

    def encode_vectors(self, x: torch.Tensor, listnos: torch.Tensor) -> np.ndarray:
        """Host numpy, as faiss_tpu encodes (models/rabitq.py:300)."""
        x = x.float().cpu().numpy()
        centers = self._centroids_host()[listnos.cpu().numpy()]
        if self.nb_bits > 1:
            return self.rabitq.pack(*self.rabitq.encode_parts(x, centers=centers))
        bits, factors = self.rabitq.encode_parts(x, centers=centers)
        ubits = np.unpackbits(bits, axis=1, bitorder="little")[:, : self.d]
        o_bar = (2.0 * ubits - 1.0) / np.sqrt(self.d)
        g = ((centers @ self.rabitq.P.T) * o_bar).sum(1).astype(np.float32)
        return np.concatenate([bits, factors.view(np.uint8), g[:, None].view(np.uint8)],
                              axis=1)

    def decode_vectors(self, codes, listnos) -> np.ndarray:
        codes = np.ascontiguousarray(codes, np.uint8)
        cents = self._centroids_host()[np.asarray(listnos)]
        if self.nb_bits > 1:
            c, f = self.rabitq.unpack(codes)
            return self.rabitq.decode(c, f, cents)
        nbytes = (self.d + 7) // 8
        return self.rabitq.decode(codes[:, : nbytes + 8]) + cents  # center 0

    def _implied(self):
        """(z = c + y, t = |c|^2 + 2 <c, y> + f_add) of every slot: the
        multi-bit estimator as IVF-Flat's norm expansion (faiss_tpu
        :327-351)."""
        c, f = self.rabitq.unpack(self._codes_host)
        cents = self._centroids_host()[self._listnos_host]
        y = self.rabitq.implied_vectors(c, f)
        z = (cents + y).astype(np.float32)
        t = ((cents * cents).sum(1) + 2.0 * (cents * y).sum(1) + f[:, 0]).astype(np.float32)
        return z, t

    def _stage_codes(self, order, offsets, lengths, max_len):
        sid = self._slot_ids(order, offsets, max_len)
        dev = {"slot_ids": sid, "lengths": torch.from_numpy(lengths).to(self.device)}
        if self.nb_bits > 1:
            z, t = self._implied() if self.ntotal else (
                np.zeros((0, self.d), np.float32), np.zeros(0, np.float32))
            dev["codes"] = self._padded(sid, torch.from_numpy(z).to(self.device), 0.0)
            dev["code_norms"] = self._padded(sid, torch.from_numpy(t).to(self.device),
                                             float("inf"))
            return dev
        nbytes = (self.d + 7) // 8
        codes = (self._codes_host if self.ntotal
                 else np.zeros((0, self.code_size), np.uint8))
        fac = np.ascontiguousarray(codes[:, nbytes:]).view(np.float32)  # |x_r|, f, g
        dev["codes"] = self._padded(
            sid, torch.from_numpy(np.ascontiguousarray(codes[:, :nbytes])).to(self.device),
            0)
        dev["factors"] = self._padded(  # f = 1 on pads: no division by zero
            sid, torch.from_numpy(fac).to(self.device),
            torch.tensor([0.0, 1.0, 0.0], device=self.device))
        dev["code_norms"] = None
        return dev

    def _rotated_queries(self, xq: torch.Tensor) -> torch.Tensor:
        """P q on the device, quantized to ``qb`` bits once for every probe
        (faiss_tpu :378-398: the per-probe shift rides in g exactly, so
        only the grid differs from the reference's per-probe P (q - c))."""
        qP = xq @ torch.from_numpy(self.rabitq.P.T.copy()).to(self.device)
        return quantize_query_sq_dev(qP, self.qb, self.centered)

    def _scan(self, xq, probes, coarse_dis, k, dev, sel):
        if self.nb_bits > 1:
            return super()._scan(xq, probes, coarse_dis, k, dev, sel)
        return ivf_rabitq_scan(self._rotated_queries(xq), probes, coarse_dis,
                               dev["codes"], dev["factors"], dev["slot_ids"],
                               dev["lengths"], k, sel)

    def _probe_step(self, xq, dev, sel):
        if self.nb_bits > 1:
            return super()._probe_step(xq, dev, sel)
        qP = self._rotated_queries(xq)

        def step(ln, cd):
            dist = rabitq_probe_dists(qP, ln, cd, dev["codes"], dev["factors"], self.d)
            return (dist,) + probe_slots(ln, dev["slot_ids"], dev["lengths"], sel)

        return step

    def _probe_row_bytes(self, dev) -> int:
        return dev["codes"].shape[1] * self.d * 4  # the unpacked signs


class IndexIVFRaBitQFastScan(IndexIVFRaBitQ):
    """FastScan IVF RaBitQ (reference: IndexIVFRaBitQFastScan.h:49;
    faiss_tpu :412): qb = 8."""

    def __init__(self, quantizer, d, nlist, metric=MetricType.L2, bbs: int = 32,
                 nb_bits: int = 1, *, device="cuda"):
        super().__init__(quantizer, d, nlist, metric, nb_bits, device=device)
        self.bbs = int(bbs)
        self.qb = 8

    @classmethod
    def from_ivf_rabitq(cls, orig: IndexIVFRaBitQ, bbs: int = 32):
        """IndexIVFRaBitQFastScan(const IndexIVFRaBitQ&, int bbs): the same
        quantizer, codec and lists."""
        out = cls(orig.quantizer, orig.d, orig.nlist, orig.metric_type, bbs,
                  orig.nb_bits, device=orig.device)
        out.rabitq = orig.rabitq
        out.is_trained = orig.is_trained
        out.nprobe = orig.nprobe
        if orig.ntotal:
            out.add_encoded(orig._codes_host.copy(), orig._listnos_host,
                            orig._ids_host)
        return out
