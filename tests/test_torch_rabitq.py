"""Port parity for RaBitQ (faiss_tpu_torch/codecs/rabitq.py and
models/rabitq.py against faiss_tpu's): the same seeded numpy inputs go
through both packages, with the port on the CPU.

The codecs encode bit for bit: the 1-bit signs and factors, the queries'
rotation and qb-bit quantization, and the multi-bit codes, whose grid search
runs on the port's device with numpy's float64 summation order. The flat,
FastScan and IVF searches equal faiss_tpu's from its state
(convert.rabitq_from_arrays / ivf_rabitq_from_arrays), 1-bit and multi-bit,
at qb 0 and 8: distances within 1e-5 of the scale of the estimator's terms,
ids tie-aware. ID selectors, which faiss_tpu drops, are checked on the
port's side against float64 of the estimator over the selected rows. Files
go both ways."""

import functools

import numpy as np
import pytest
import torch

import faiss_tpu as ftj
from faiss_tpu.codecs import rabitq as rbj
from faiss_tpu.models import rabitq as ref_rabitq
import faiss_tpu_torch as ftt
from faiss_tpu_torch import convert
from faiss_tpu_torch.codecs import rabitq as rbt
from faiss_tpu_torch.ops import ivf_ops
from faiss_tpu_torch.utils.evaluation import ids_agree_tie_aware
from torch_threads import one_torch_thread  # noqa: F401

D, NB, NQ, K, NLIST = 32, 2000, 32, 10, 8


def mixture(seed, n, d=D, ncent=24):
    rs = np.random.RandomState(seed)
    cent = np.random.RandomState(98).randn(ncent, d).astype(np.float32)
    return (cent[rs.randint(ncent, size=n)] + 0.4 * rs.randn(n, d)).astype(np.float32)


@pytest.fixture(scope="module")
def data():
    return mixture(1, NB), mixture(2, NQ)


@pytest.fixture(autouse=True)
def small_reference_chunks(monkeypatch):
    """faiss_tpu's flat 1-bit scan pads the codes to its 32,768-code chunk;
    a 2048-code chunk gives the same results in a fraction of the CPU
    time."""
    monkeypatch.setattr(ref_rabitq, "_rabitq_knn",
                        functools.partial(ref_rabitq._rabitq_knn, db_chunk=2048))


def test_pairwise_sum_is_numpys():
    """The grid search's float64 sums in numpy's pairwise order, bit for
    bit, at every length up to 300 (the 8-way unrolled block, the halving
    above 128, the tail)."""
    rs = np.random.RandomState(5)
    for n in list(range(1, 40)) + [63, 64, 127, 128, 129, 136, 200, 255, 256, 300]:
        a = rs.rand(6, 3, n) * np.exp(rs.randn(6, 3, n) * 6)
        got = rbt._np_pairwise_sum(torch.from_numpy(a)).numpy()
        assert np.array_equal(got, a.sum(-1)), n


@pytest.mark.parametrize("d", [32, 20, 136])
def test_one_bit_codec_bit_identical(d):
    rs = np.random.RandomState(d)
    x = rs.randn(500, d).astype(np.float32) * 2 + 1
    a, b = rbj.RaBitQuantizer(d), rbt.RaBitQuantizer(d)
    assert np.array_equal(a.P, b.P) and a.code_size == b.code_size
    a.train(x)
    b.train(x)
    assert np.array_equal(a.center, b.center)
    for u, v in zip(a.encode_parts(x), b.encode_parts(x)):
        assert u.dtype == v.dtype and np.array_equal(u, v)
    ca, cb = a.compute_codes(x), b.compute_codes(x)
    assert np.array_equal(ca, cb) and np.array_equal(a.decode(ca), b.decode(cb))
    for u, v in zip(a.rotate_queries(x[:40]), b.rotate_queries(x[:40])):
        assert np.array_equal(u, v)
    qr = a.rotate_queries(x[:40])[0]
    for qb in (0, 1, 4, 8):
        for centered in (False, True):
            ref = rbj.quantize_query_sq(qr, qb, centered)
            assert np.array_equal(rbt.quantize_query_sq(qr, qb, centered), ref)
            dev = rbt.quantize_query_sq_dev(torch.from_numpy(qr), qb, centered).numpy()
            np.testing.assert_allclose(dev, ref, rtol=1e-6, atol=1e-6 * np.abs(qr).max())


@pytest.mark.parametrize("nb,d", [(2, 32), (3, 20), (4, 32), (5, 136), (8, 32)])
def test_multibit_codec_bit_identical(nb, d):
    """Codes and factors bit for bit (the grid search on the device equals
    numpy's), L2 and inner product, pack / unpack, implied vectors and
    decode."""
    rs = np.random.RandomState(nb * 100 + d)
    x = rs.randn(700, d).astype(np.float32)
    a, b = rbj.MultiBitRaBitQ(d, nb), rbt.MultiBitRaBitQ(d, nb, device="cpu")
    assert np.array_equal(a.P, b.P) and a.code_size == b.code_size
    a.train(x)
    b.train(x)
    b.T_TILE = 128 * d * 37  # tiles of 37 rows: the result does not depend on them
    for metric in ("L2", "IP"):
        ca, fa = a.encode_parts(x, metric=metric)
        cb, fb = b.encode_parts(x, metric=metric)
        assert np.array_equal(ca, cb) and np.array_equal(fa, fb)
    packed = b.pack(cb, fb)
    assert np.array_equal(packed, a.pack(ca, fa))
    for u, v in zip(b.unpack(packed), a.unpack(packed)):
        assert np.array_equal(u, v)
    assert np.array_equal(b.implied_vectors(cb, fb), a.implied_vectors(ca, fa))
    assert np.array_equal(b.decode(cb, fb), a.decode(ca, fa))


def test_nine_bit_codes_do_not_wrap(data):
    """At nb_bits 9 the codes take 9 bits (faiss_tpu's uint8 codes wrap
    there): uint16 codes on the ladder, pack / unpack round trip, and the
    flat search equals float64 of the estimator."""
    xb, xq = data
    index = ftt.IndexRaBitQ(D, nb_bits=9, device="cpu")
    index.train(xb)
    index.add(xb)
    codes = index._bits
    assert codes.dtype == np.uint16 and codes.max() > 255 and codes.max() < 512
    packed = index.sa_encode(xb[:300])
    assert packed.shape == (300, index.rabitq.code_size)
    c, f = index.rabitq.unpack(packed)
    assert np.array_equal(c, codes[:300]) and np.array_equal(f, index._factors[:300])
    d64, scale = flat64(index, xq)
    assert_vs64(*index.search(xq, K), d64, scale)


def flat64(index, xq, keep=None):
    """float64 of the flat estimator on the search's float32 inputs, with
    the per-row scale of its terms (|q_r|^2 + max |x_r|^2 + 2 max |est|);
    +inf on rows ``keep`` clears."""
    fac = index._factors.astype(np.float64)
    if index.nb_bits > 1:
        rb = index.rabitq
        qc = (xq - rb.center).astype(np.float64)
        u = rb.u_values(index._bits).astype(np.float64)
        est = fac[None, :, 1] * ((qc @ rb.P.T.astype(np.float64)) @ u.T)
        qn = (qc**2).sum(1)
        d64 = np.maximum(qn[:, None] + fac[None, :, 0] + est, 0.0)
        scale = qn + fac[:, 0].max() + np.abs(est).max(1)
    else:
        qr, qn2 = index.rabitq.rotate_queries(xq)
        qr = rbt.quantize_query_sq(qr, index.qb, index.centered).astype(np.float64)
        bits = np.unpackbits(index._bits, axis=1, bitorder="little")[:, : index.d]
        signs = 2.0 * bits - 1.0
        est = fac[None, :, 0] * (qr @ signs.T) / np.sqrt(np.float32(index.d)) / fac[None, :, 1]
        d64 = qn2[:, None] + fac[None, :, 0] ** 2 - 2.0 * est
        scale = qn2 + (fac[:, 0] ** 2).max() + 2.0 * np.abs(est).max(1)
    if keep is not None:
        d64 = np.where(keep[None], d64, np.inf)
    return d64, scale


def assert_vs64(D_, I_, d64, scale, ids=None, k=K):
    o = np.argsort(d64, 1, kind="stable")[:, :k]
    ref = np.take_along_axis(d64, o, 1)
    ids = o if ids is None else ids[o]
    fin = np.isfinite(ref)
    tol = 1e-5 * scale
    assert (np.isfinite(D_) == fin).all() and (I_[~fin] == -1).all()
    assert (np.abs(np.where(fin, D_ - ref, 0.0)) <= tol[:, None]).all()
    big = 1e30
    assert ids_agree_tie_aware(np.where(fin, ref, big), np.where(fin, ids, -1),
                               np.where(fin, D_, big), I_, tol).all()


def assert_agree(ref, port, xq, scale, k=K, params=None):
    Dr, Ir = ref.search(xq, k)
    Dp, Ip = port.search(xq, k, params=params)
    tol = 1e-5 * scale
    assert Dp.dtype == np.float32 and Ip.dtype == np.int64
    assert (np.abs(Dp - Dr) <= tol[:, None]).all()
    assert ids_agree_tie_aware(Dr, Ir, Dp, Ip, tol).all()


FLAT = [(1, 0, False, False), (1, 8, False, True), (1, 4, True, False),
        (2, 0, False, False), (4, 0, False, True), (8, 0, False, False)]


@pytest.mark.parametrize("nb,qb,centered,fastscan", FLAT,
                         ids=[f"nb{f[0]}-qb{f[1]}{'c' if f[2] else ''}{'-fs' if f[3] else ''}"
                              for f in FLAT])
def test_flat_search_matches_reference(data, nb, qb, centered, fastscan):
    """faiss_tpu's flat index and the port's from its arrays: the same
    estimator distances and ids; both against float64 of the estimator;
    reconstruct_n and sa_* equal."""
    xb, xq = data
    ref = (ftj.IndexRaBitQFastScan(D, nb_bits=nb) if fastscan
           else ftj.IndexRaBitQ(D, nb_bits=nb))
    ref.qb, ref.centered = qb, centered
    ref.train(xb)
    ref.add(xb)
    port = convert.rabitq_from_arrays(D, nb, ref.rabitq.P, ref.rabitq.center, ref._bits,
                                      ref._factors, fastscan=fastscan, qb=qb, device="cpu")
    port.centered = centered
    assert type(port).__name__ == type(ref).__name__ and port.ntotal == NB
    d64, scale = flat64(port, xq)
    assert_agree(ref, port, xq, scale)
    assert_vs64(*port.search(xq, K), d64, scale)
    assert np.array_equal(port.reconstruct_n(5, 50), ref.reconstruct_n(5, 50))
    codes = ref.sa_encode(xq)
    assert np.array_equal(port.sa_encode(xq), codes)
    assert np.array_equal(port.sa_decode(codes), ref.sa_decode(codes))
    own = ftt.IndexRaBitQ(D, nb_bits=nb, device="cpu")
    own.train(xb)
    own.add(xb)  # the port's own encode: faiss_tpu's codes bit for bit
    assert np.array_equal(own._bits, ref._bits) and np.array_equal(own._factors, ref._factors)


@pytest.mark.parametrize("nb", [1, 3])
def test_flat_selector_before_select(data, nb):
    """An ID selector keeps its rows before the select (faiss_tpu's flat
    RaBitQ ignores ``params``): only selected ids, each row against
    float64 of the estimator over the selected rows; none selected, none
    returned."""
    xb, xq = data
    index = ftt.IndexRaBitQ(D, nb_bits=nb, device="cpu")
    index.train(xb)
    index.add(xb)
    keep = np.arange(NB) % 5 == 1
    params = ftt.SearchParameters(sel=ftt.IDSelectorBitmap(np.packbits(keep, bitorder="little")))
    Dp, Ip = index.search(xq, K, params=params)
    assert np.isin(Ip, np.nonzero(keep)[0]).all()
    d64, scale = flat64(index, xq, keep)
    assert_vs64(Dp, Ip, d64, scale)
    Dn, In = index.search(xq, K, params=ftt.SearchParameters(sel=ftt.IDSelectorRange(0, 0)))
    assert (In == -1).all() and np.isinf(Dn).all()


def test_fastscan_from_rabitq(data):
    xb, xq = data
    base = ftt.IndexRaBitQ(D, device="cpu")
    base.train(xb)
    base.add(xb)
    fs = ftt.IndexRaBitQFastScan.from_rabitq(base, bbs=64)
    assert fs.qb == 8 and fs.bbs == 64 and fs.ntotal == NB
    base.qb = 8
    Db, Ib = base.search(xq, K)
    Df, If = fs.search(xq, K)
    assert np.array_equal(Db, Df) and np.array_equal(Ib, If)
    ref = ftj.IndexRaBitQFastScan.from_rabitq(
        convert_to_ref(base), bbs=64)
    assert_agree(ref, fs, xq, flat64(fs, xq)[1])


def convert_to_ref(port):
    """A faiss_tpu IndexRaBitQ holding the port's state, through a file."""
    return ftj.deserialize_index(ftt.serialize_index(port))


def ivf_pair(xb, nb, fastscan=False, qb=None):
    cls = ftj.IndexIVFRaBitQFastScan if fastscan else ftj.IndexIVFRaBitQ
    ref = cls(None, D, NLIST, nb_bits=nb)
    ref.cp.niter = 4
    ref.cp.min_points_per_centroid = 1
    if qb is not None:
        ref.qb = qb
    ref.train(xb)
    ref.add(xb)
    ref.nprobe = 3
    port = convert.ivf_rabitq_from_arrays(
        ref.quantizer.vectors(), nb, ref._codes_host, ref._listnos_host, ref._ids_host,
        fastscan=fastscan, qb=ref.qb, device="cpu")
    port.nprobe = ref.nprobe
    return ref, port


def ivf64(index, xq, keep=None):
    """float64 of the IVF estimator over each row's probed lists, on the
    search's inputs (the port's coarse distances and P q as it rotates and
    quantizes it): (distances [nq, ntotal] in slot order, +inf off the
    probed lists and where ``keep`` [slots] clears, their scale)."""
    cd, probes = index.quantizer.search(xq, index.nprobe)
    cents = index._centroids_host().astype(np.float64)
    codes, ln = index._codes_host, index._listnos_host
    out = np.full((len(xq), index.ntotal), np.inf)
    scale = np.zeros(len(xq))
    if index.nb_bits > 1:
        c, f = index.rabitq.unpack(codes)
        u, f = index.rabitq.u_values(c).astype(np.float64), f.astype(np.float64)
        P = index.rabitq.P.astype(np.float64)
    else:
        nbytes = (index.d + 7) // 8
        qP = index._rotated_queries(torch.from_numpy(xq)).double().numpy()
        fac = np.ascontiguousarray(codes[:, nbytes:]).view(np.float32).astype(np.float64)
        signs = 2.0 * np.unpackbits(codes[:, :nbytes], axis=1,
                                    bitorder="little")[:, : index.d] - 1.0
    for r in range(len(xq)):
        for p, l in enumerate(probes[r]):
            s = np.nonzero(ln == l)[0]
            if keep is not None:
                s = s[keep[s]]
            if index.nb_bits > 1:
                qc = xq[r].astype(np.float64) - cents[l]
                est = f[s, 1] * (u[s] @ (P @ qc))
                out[r, s] = np.maximum((qc**2).sum() + f[s, 0] + est, 0.0)
                mag = 2 * ((xq[r].astype(np.float64) ** 2).sum() + (cents**2).sum(1).max()) \
                    + f[s, 0] + np.abs(est)
            else:
                nr, fs, g = fac[s, 0], fac[s, 1], fac[s, 2]
                est = nr * (signs[s] @ qP[r] / np.sqrt(np.float32(index.d)) - g) / fs
                out[r, s] = float(cd[r, p]) + nr * nr - 2.0 * est
                mag = abs(float(cd[r, p])) + nr * nr + 2.0 * np.abs(est)
            scale[r] = max(scale[r], mag.max(initial=0.0))
    return out, scale


IVF = [(1, False, None), (1, True, None), (1, False, 6), (2, False, None), (4, True, None)]


@pytest.mark.parametrize("nb,fastscan,qb", IVF,
                         ids=[f"nb{n}{'-fs' if f else ''}-qb{q}" for n, f, q in IVF])
def test_ivf_search_matches_reference(data, nb, fastscan, qb):
    """The IVF forms from faiss_tpu's lists search as faiss_tpu's by probe
    (the 1-bit scan with g = <P c, o_bar> and the once-quantized P q, the
    multi-bit one through the flat scan with overridden norms), both
    against float64 of the estimator; the port's own encode of faiss_tpu's
    assignment gives its codes bit for bit; reconstruction equal."""
    xb, xq = data
    ref, port = ivf_pair(xb, nb, fastscan, qb)
    d64, scale = ivf64(port, xq)
    assert_agree(ref, port, xq, scale)
    Dp, Ip = port.search(xq, K)
    assert_vs64(Dp, Ip, d64, scale, port._ids_host)
    own = port.encode_vectors(torch.from_numpy(xb), torch.from_numpy(ref._listnos_host))
    assert np.array_equal(own, ref._codes_host)
    keys = np.array([0, 7, 1999])
    np.testing.assert_allclose(port.reconstruct_batch(keys), ref.reconstruct_batch(keys),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("nb", [1, 4])
def test_ivf_selector_is_honoured(data, nb):
    """faiss_tpu's 1-bit IVF scan deletes the selector mask; the port keeps
    only selected ids, against float64 of the estimator over the selected
    probed slots."""
    xb, xq = data
    _, port = ivf_pair(xb, nb)
    lo, hi = 500, 1400
    params = ftt.SearchParametersIVF(sel=ftt.IDSelectorRange(lo, hi))
    Dp, Ip = port.search(xq, K, params=params)
    assert ((Ip == -1) | ((Ip >= lo) & (Ip < hi))).all() and (Ip >= 0).any()
    keep = (port._ids_host >= lo) & (port._ids_host < hi)
    d64, scale = ivf64(port, xq, keep)
    assert_vs64(Dp, Ip, d64, scale, port._ids_host)


def test_ivf_scan_chunks_and_range_search(data, monkeypatch):
    """The 1-bit scan's query chunks change only the float32 rounding of its
    products; range search by probe returns the estimator's hits below the
    radius."""
    xb, xq = data
    _, port = ivf_pair(xb, 1)
    d64, scale = ivf64(port, xq)
    D0, I0 = port.search(xq, K)
    monkeypatch.setattr(ivf_ops, "SCAN_GATHER_BYTES", 3 * 128 * D * 4)
    D1, I1 = port.search(xq, K)
    tol = 1e-5 * scale
    assert (np.abs(D0 - D1) <= tol[:, None]).all()
    assert ids_agree_tie_aware(D0, I0, D1, I1, tol).all()
    radius = float(np.median(D0[:, 4]))
    res = port.range_search(xq, radius)
    for r in range(NQ):
        got = set(res.labels[res.lims[r] : res.lims[r + 1]].tolist())
        tol = 1e-5 * scale[r]
        sure = set(port._ids_host[d64[r] < radius - tol].tolist())
        maybe = set(port._ids_host[d64[r] < radius + tol].tolist())
        assert sure <= got <= maybe


def test_ivf_fastscan_from_ivf_rabitq(data):
    xb, xq = data
    ref, port = ivf_pair(xb, 1)
    fs = ftt.IndexIVFRaBitQFastScan.from_ivf_rabitq(port, bbs=64)
    assert fs.qb == 8 and fs.bbs == 64 and fs.ntotal == NB and fs.nprobe == port.nprobe
    ref_fs = ftj.IndexIVFRaBitQFastScan.from_ivf_rabitq(ref, bbs=64)
    assert_agree(ref_fs, fs, xq, ivf64(fs, xq)[1])


FILES = ["RaBitQ", "RaBitQfs4", "IVF8,RaBitQ", "IVF8,RaBitQfs", "IVF8,RaBitQ3"]


@pytest.mark.parametrize("desc", FILES)
def test_files_both_ways(data, desc, tmp_path):
    """faiss_tpu writes, the port reads, and back: the same searches."""
    xb, xq = data
    ref = ftj.index_factory(D, desc)
    if desc.startswith("IVF"):
        ref.cp.niter, ref.cp.min_points_per_centroid = 4, 1
    ref.train(xb)
    ref.add(xb)
    if desc.startswith("IVF"):
        ref.nprobe = 3
    ftj.write_index(ref, str(tmp_path / "j.npz"))
    port = ftt.read_index(str(tmp_path / "j.npz"), device="cpu")
    assert type(port).__name__ == type(ref).__name__
    assert (port.nb_bits, port.qb) == (ref.nb_bits, ref.qb)
    scale = (ivf64(port, xq) if desc.startswith("IVF") else flat64(port, xq))[1]
    assert_agree(ref, port, xq, scale)
    ftt.write_index(port, str(tmp_path / "t.npz"))
    back = ftj.read_index(str(tmp_path / "t.npz"))
    assert type(back) is type(ref) and back.ntotal == NB
    assert_agree(back, port, xq, scale)


def test_l2_only_and_default_device(monkeypatch):
    with pytest.raises(ValueError, match="L2"):
        ftt.IndexRaBitQ(D, ftt.METRIC_INNER_PRODUCT, device="cpu")
    with pytest.raises(ValueError, match="L2"):
        ftt.index_factory(D, "IVF8,RaBitQ", ftt.METRIC_INNER_PRODUCT, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: ftt.IndexRaBitQ(D), lambda: ftt.IndexIVFRaBitQ(None, D, 4),
                 lambda: ftt.IndexResidualQuantizer(D, 2, 4)):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            make()
