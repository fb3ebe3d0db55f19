"""Port parity for the PQ family (faiss_tpu_torch/codecs/pq.py,
codecs/polysemous.py, ops/pq_ops.py's flat scans, models/pq.py, and IVF-PQ's
polysemous filter and other widths) against faiss_tpu on the CPU.

Every port index is built from a faiss_tpu index's arrays
(faiss_tpu_torch.convert), so search parity does not depend on k-means.
Tolerances: the flat ADC scans sum the same float32 table entries in the
same order (distances rtol 1e-5 / atol 1e-4, ids up to ties at that); the
FastScan branch rounds the LUTs to bf16 on both sides (rtol 1e-5, and a
float64 sum of the bf16 values); IVF-PQ as tests/test_torch_ivfpq_probe.py
(2e-6 of |q|^2 + max |x|^2, the float32 norm expansion's error).

Reference faults met here (ROADMAP queue 3), asserted on the port's side
only: faiss_tpu's IndexPQ applies an ID selector after its top-k, so the
selector test compares with a faiss_tpu IndexPQ holding only the selected
rows; faiss_tpu would run ST_polysemous on inner-product tables, which the
port refuses as it refuses ST_SDC; faiss_tpu's IVF-PQ stages its codes as
uint8, so above 8 bits the port is held to float64."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import faiss_tpu as ftj
from faiss_tpu.ops import pq_ops as ref_pq
import faiss_tpu_torch as ftt
from faiss_tpu.codecs.polysemous import PolysemousTraining as PolyJ
from faiss_tpu.codecs.pq import ProductQuantizer as PQJ
from faiss_tpu_torch import convert
from faiss_tpu_torch.codecs.pq import ProductQuantizer as PQT
from faiss_tpu_torch.ops import pq_ops as port_pq
from faiss_tpu_torch.utils.evaluation import ids_agree_tie_aware
from test_torch_ivfpq_probe import exact_agree
from torch_threads import one_torch_thread  # noqa: F401

D, NB, NQ, K, M = 32, 3000, 64, 10, 8


@pytest.fixture(scope="module")
def data():
    rs = np.random.RandomState(5)
    cent = rs.randn(40, D).astype(np.float32)
    xb = (cent[rs.randint(40, size=NB)] + 0.5 * rs.randn(NB, D)).astype(np.float32)
    xq = (cent[rs.randint(40, size=NQ)] + 0.5 * rs.randn(NQ, D)).astype(np.float32)
    return xb, xq


@pytest.fixture(autouse=True)
def small_reference_chunks(monkeypatch):
    """faiss_tpu's flat scans pad the 3000 codes to their 65,536-code chunk;
    a 4096-code chunk gives the same results in a fraction of the CPU time."""
    for name in ("pq_adc_knn", "pq_polysemous_knn"):
        monkeypatch.setattr(ref_pq, name,
                            functools.partial(getattr(ref_pq, name), db_chunk=4096))


_TRAINED = {}


def _trained(xb, nbits, M_):
    """(codebooks, codes) of faiss_tpu's IndexPQ trained on and holding xb,
    once per width; above NB codewords the codebooks are rows of xb plus
    noise (too few points to train) and the codes faiss_tpu's pq_encode in
    chunks of 512 rows (its default chunk would pad 3000 rows to 32768)."""
    if (nbits, M_) not in _TRAINED:
        if (1 << nbits) <= NB:
            index = ftj.IndexPQ(D, M_, nbits)
            index.pq.cp.niter = 6
            index.train(xb)
            index.add(xb)
            _TRAINED[nbits, M_] = index.pq.centroids, index._codes_host
        else:
            rs = np.random.RandomState(nbits)
            rows = xb[rs.randint(NB, size=1 << nbits)] + 0.1 * rs.randn(1 << nbits, D)
            cb = np.ascontiguousarray(
                rows.reshape(-1, M_, D // M_).transpose(1, 0, 2), np.float32)
            codes = np.asarray(ref_pq.pq_encode(jnp.asarray(xb), jnp.asarray(cb),
                                                chunk=512)).astype(np.uint16)
            _TRAINED[nbits, M_] = cb, codes
    return _TRAINED[nbits, M_]


def ref_pq_index(xb, nbits, metric=ftj.METRIC_L2, cls=None, M_=M):
    """A faiss_tpu IndexPQ (or ``cls``) of ``metric`` with the trained
    codebooks and codes of :func:`_trained` (training ignores the
    metric)."""
    cb, codes = _trained(xb, nbits, M_)
    index = (cls or ftj.IndexPQ)(D, M_, nbits, metric)
    index.pq.centroids = cb.copy()
    index.is_trained = True
    index._codes_host = codes.copy()
    index.ntotal = len(codes)
    return index


def port_of(ref, fastscan=False):
    return convert.pq_from_arrays(
        ref.d, ref.pq.M, ref.pq.nbits, ref.pq.centroids, ref._codes_host,
        ref.metric_type, fastscan=fastscan, device="cpu")


def adc_agree(Dj, Ij, Dt, It, largest=False):
    assert Dt.dtype == np.float32 and It.dtype == np.int64
    np.testing.assert_array_equal(Ij == -1, It == -1)
    fin = np.isfinite(Dj)
    np.testing.assert_array_equal(fin, np.isfinite(Dt))
    np.testing.assert_allclose(np.where(fin, Dt, 0), np.where(fin, Dj, 0),
                               rtol=1e-5, atol=1e-4)
    sign = -1.0 if largest else 1.0
    tol = 1e-5 * np.abs(np.where(fin, Dj, 0)).max(1) + 1e-4
    assert ids_agree_tie_aware(np.where(fin, sign * Dj, 1e30), Ij,
                               np.where(fin, sign * Dt, 1e30), It, tol).all()


@pytest.mark.parametrize("nbits", range(1, 17))
def test_pack_unpack_bit_for_bit(nbits):
    """PQEncoder8/16/4-bit/Generic packing equal to faiss_tpu's at every
    width, an odd M included, and the unpacked codes back."""
    for M_ in (5, 8):
        rs = np.random.RandomState(nbits * 10 + M_)
        codes = rs.randint(1 << nbits, size=(37, M_)).astype(
            np.uint8 if nbits <= 8 else np.uint16)
        pj, pt = PQJ(M_ * 2, M_, nbits), PQT(M_ * 2, M_, nbits, device="cpu")
        assert pj.code_size == pt.code_size
        packed = pt.pack_codes(codes)
        assert packed.dtype == np.uint8 and packed.shape == (37, pt.code_size)
        np.testing.assert_array_equal(packed, pj.pack_codes(codes))
        np.testing.assert_array_equal(pt.unpack_codes(packed), codes)
        np.testing.assert_array_equal(pt.unpack_codes(packed), pj.unpack_codes(packed))


@pytest.mark.parametrize("nbits", [4, 6, 8, 12])
def test_codes_equal_but_near_ties(data, nbits):
    """The port's codes equal faiss_tpu's except on rows whose two nearest
    codewords tie within 1e-5 relative (float32 GEMMs of two libraries);
    decode, the ADC tables and the SDC table agree."""
    xb, xq = data
    ref = ref_pq_index(xb, nbits)
    pt = PQT(D, M, nbits, device="cpu")
    pt.set_centroids(ref.pq.centroids)
    cj, ct = ref._codes_host, pt.compute_codes_int(xb)
    assert ct.dtype == cj.dtype == (np.uint8 if nbits <= 8 else np.uint16)
    xs = xb[:500].reshape(500, M, -1).astype(np.float64)
    c64 = ref.pq.centroids.astype(np.float64)
    d2 = ((xs**2).sum(-1)[:, :, None] + (c64**2).sum(-1)[None]
          - 2 * np.einsum("nmd,mkd->nmk", xs, c64))
    two = np.sort(d2, axis=-1)[:, :, :2]
    cj, ct = cj[:500], ct[:500]
    tie = (two[..., 1] - two[..., 0]) <= 1e-5 * two[..., 1]
    assert ((cj == ct) | tie).all() and (cj == ct).mean() > 0.99
    np.testing.assert_allclose(pt.decode_int(cj), ref.pq.decode_int(cj), rtol=0, atol=0)
    np.testing.assert_allclose(pt.compute_distance_tables(xq),
                               ref.pq.compute_distance_tables(xq), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(pt.compute_inner_prod_tables(xq),
                               ref.pq.compute_inner_prod_tables(xq), rtol=1e-5, atol=1e-4)
    if nbits <= 8:
        np.testing.assert_allclose(pt.compute_sdc_table(), ref.pq.compute_sdc_table(),
                                   rtol=1e-6, atol=1e-6)
    Dj, Ij = ref.pq.search(xq, ref._codes_host, K)
    Dt, It = pt.search(xq, ref._codes_host, K)
    adc_agree(Dj, Ij, Dt, It)


def test_train_shared_and_sdc(data):
    """Train_shared: one codebook for every subspace, as good as
    faiss_tpu's by the quantization error (1e-4 relative); the SDC table of
    the same codebooks within 1e-6."""
    xb, _ = data
    pj, pt = PQJ(D, M, 4), PQT(D, M, 4, device="cpu")
    for pq in (pj, pt):
        pq.train_type = pq.Train_shared
        pq.cp.niter = 8
        pq.train(xb)
    assert all(np.array_equal(pt.centroids[m], pt.centroids[0]) for m in range(M))
    err = [float(((pq.decode_int(pq.compute_codes_int(xb)) - xb) ** 2).sum())
           for pq in (pj, pt)]
    assert abs(err[1] - err[0]) <= 1e-4 * err[0]
    pt.set_centroids(pj.centroids)
    np.testing.assert_allclose(pt.compute_sdc_table(), pj.compute_sdc_table(),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("nbits", [4, 6, 8, 12])
def test_index_pq_adc(data, nbits, metric):
    """IndexPQ's ADC search (ST_PQ) equal to faiss_tpu's: the one-hot bf16
    branch at 4 bits, float32 gathers above."""
    xb, xq = data
    mj = ftj.METRIC_L2 if metric == "l2" else ftj.METRIC_INNER_PRODUCT
    ref = ref_pq_index(xb, nbits, mj)
    port = port_of(ref)
    assert port.ntotal == NB and np.array_equal(port.codes_host, ref._codes_host)
    adc_agree(*ref.search(xq, K), *port.search(xq, K), largest=metric == "ip")


def test_fastscan_bf16_branch(data):
    """IndexPQFastScan: faiss_tpu's distances, and each equal to the float64
    sum of the bf16-rounded tables at the returned codes (rtol 1e-5)."""
    xb, xq = data
    ref = ref_pq_index(xb, 4, cls=ftj.IndexPQFastScan)
    port = port_of(ref, fastscan=True)
    assert isinstance(port, ftt.IndexPQFastScan) and port.bbs == 32
    Dt, It = port.search(xq, K)
    adc_agree(*ref.search(xq, K), Dt, It)
    luts = port.pq.compute_distance_tables(xq)
    lb = torch.from_numpy(luts).to(torch.bfloat16).double().numpy()
    codes = ref._codes_host[It].astype(np.int64)  # [nq, K, M]
    want = lb[np.arange(NQ)[:, None, None], np.arange(M)[None, None], codes].sum(-1)
    np.testing.assert_allclose(Dt, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("nbits", [4, 8])
def test_sdc(data, nbits):
    xb, xq = data
    ref = ref_pq_index(xb, nbits)
    port = port_of(ref)
    ref.search_type = port.search_type = ftt.IndexPQ.ST_SDC
    adc_agree(*ref.search(xq, K), *port.search(xq, K))


@pytest.mark.parametrize("ht", ["full", 24, 16])
def test_polysemous_search(data, ht):
    """ST_polysemous equal to faiss_tpu's at a Hamming threshold that keeps
    every code (then equal to ADC too), a middle one and a small one (where
    rows run out of codes: -1 and +inf)."""
    xb, xq = data
    ref = ref_pq_index(xb, 8)
    port = port_of(ref)
    ref.search_type = port.search_type = ftt.IndexPQ.ST_polysemous
    ref.polysemous_ht = port.polysemous_ht = M * 8 + 1 if ht == "full" else ht
    Dj, Ij = ref.search(xq, K)
    Dt, It = port.search(xq, K)
    adc_agree(Dj, Ij, Dt, It)
    if ht == "full":
        port.search_type = ftt.IndexPQ.ST_PQ
        adc_agree(*port.search(xq, K), Dt, It)
    elif ht == 16:
        assert (It == -1).any()
    # the sparse and dense scoring give the same values
    old = port_pq.POLY_SPARSE_PAIRS
    port_pq.POLY_SPARSE_PAIRS = 0 if old else 1 << 40
    try:
        Ds, Is = port.search(xq, K)
    finally:
        port_pq.POLY_SPARSE_PAIRS = old
    np.testing.assert_array_equal(Ds, Dt)
    np.testing.assert_array_equal(Is == -1, It == -1)


def test_polysemous_inner_product_refused(data):
    xb, xq = data
    port = port_of(ref_pq_index(xb, 4, ftj.METRIC_INNER_PRODUCT))
    for st in (ftt.IndexPQ.ST_SDC, ftt.IndexPQ.ST_polysemous):
        port.search_type = st
        with pytest.raises(ValueError, match="L2"):
            port.search(xq, K)


@pytest.mark.parametrize("nbits,M_", [(4, 8), (8, 2)])
def test_polysemous_training_permutation(data, nbits, M_):
    """PolysemousTraining permutes the codebooks exactly as faiss_tpu's, from
    the same codebooks (the same RandomState draws, the same float64
    cost)."""
    xb, _ = data
    ref = ref_pq_index(xb, nbits, M_=M_)
    pj = PQJ(D, M_, nbits)
    pj.centroids = ref.pq.centroids.copy()
    pt = PQT(D, M_, nbits, device="cpu")
    pt.set_centroids(ref.pq.centroids)
    PolyJ().optimize_pq_for_hamming(pj)
    ftt.PolysemousTraining().optimize_pq_for_hamming(pt)
    assert not np.array_equal(pj.centroids, ref.pq.centroids)
    np.testing.assert_array_equal(pt.centroids, pj.centroids)
    assert ftt.SimulatedAnnealingParameters().n_iter == 50000


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_range_search(data, metric):
    """Strict < (L2) / > (IP) over the decoded rows: faiss_tpu's sets, but
    for rows within 1e-5 (|q|^2 + max |y|^2) of the radius."""
    xb, xq = data
    mj = ftj.METRIC_L2 if metric == "l2" else ftj.METRIC_INNER_PRODUCT
    ref = ref_pq_index(xb, 6, mj)
    port = port_of(ref)
    recon = ref.reconstruct_n(0, NB).astype(np.float64)
    q64 = xq[:16].astype(np.float64)
    d64 = (((q64[:, None] - recon[None]) ** 2).sum(-1) if metric == "l2"
           else q64 @ recon.T)
    radius = float(np.median(d64))
    rj, rt = ref.range_search(xq[:16], radius), port.range_search(xq[:16], radius)
    tol = 1e-5 * ((q64**2).sum(1) + (recon**2).sum(1).max())
    for q in range(16):
        sj = set(rj.labels[rj.lims[q]: rj.lims[q + 1]])
        st = rt.labels[rt.lims[q]: rt.lims[q + 1]]
        assert len(set(st)) == len(st)
        for i in sj.symmetric_difference(st):
            assert abs(d64[q, i] - radius) <= tol[q]
        np.testing.assert_allclose(rt.distances[rt.lims[q]: rt.lims[q + 1]],
                                   d64[q, st], rtol=1e-5, atol=tol[q])


def test_selector_before_select(data):
    """An ID selector keeps its rows before the select: the port equals a
    faiss_tpu IndexPQ holding only the selected rows, ids remapped (faiss_tpu
    filters after its top-k and loses selected rows, ROADMAP queue 3)."""
    xb, xq = data
    ref = ref_pq_index(xb, 8)
    port = port_of(ref)
    sel = ftt.IDSelectorRange(NB // 3, NB // 2)
    Dt, It = port.search(xq, K, params=ftt.SearchParameters(sel=sel))
    sub = ftj.IndexPQ(D, M, 8)
    sub.pq.centroids = ref.pq.centroids
    sub.is_trained = True
    sub._codes_host = ref._codes_host[NB // 3 : NB // 2]
    sub.ntotal = len(sub._codes_host)
    Dj, Ij = sub.search(xq, K)
    adc_agree(Dj, np.where(Ij >= 0, Ij + NB // 3, -1), Dt, It)


def test_merge_from_reconstruct_and_sa(data):
    xb, xq = data
    ref = ref_pq_index(xb, 6)
    a = convert.pq_from_arrays(D, M, 6, ref.pq.centroids, ref._codes_host[:1000],
                               device="cpu")
    b = convert.pq_from_arrays(D, M, 6, ref.pq.centroids, ref._codes_host[1000:],
                               device="cpu")
    a.merge_from(b)
    assert a.ntotal == NB and b.ntotal == 0
    np.testing.assert_array_equal(a.codes_host, ref._codes_host)
    adc_agree(*ref.search(xq, K), *a.search(xq, K))
    np.testing.assert_array_equal(a.reconstruct_n(5, 20), ref.reconstruct_n(5, 20))
    np.testing.assert_array_equal(a.reconstruct_batch([7, 3]), ref.reconstruct_n(0, 8)[[7, 3]])
    assert a.sa_code_size() == ref.sa_code_size() == 6
    codes = a.sa_encode(xq)
    np.testing.assert_array_equal(codes, ref.sa_encode(xq))
    np.testing.assert_array_equal(a.sa_decode(codes), ref.sa_decode(codes))


# -- IVF-PQ: the polysemous filter and other widths --------------------------
NLIST = 16


def ref_ivfpq(xb, nbits, polysemous=False, cls=None, extra=()):
    index = (cls or ftj.IndexIVFPQ)(None, D, NLIST, 4, nbits, *extra)
    index.cp.niter = 4
    index.do_polysemous_training = polysemous
    index.train(xb)
    index.add(xb)
    return index


def ivf_port(ref):
    return convert.ivfpq_from_arrays(
        ref.quantizer.vectors(), ref.pq.centroids, ref._codes_host,
        ref._listnos_host, ref._ids_host, device="cpu")


@pytest.fixture(scope="module")
def poly_ivf(data):
    return ref_ivfpq(data[0], 6, polysemous=True)


@pytest.mark.parametrize("ht", [10, 7])
def test_ivfpq_polysemous_by_probe(data, poly_ivf, ht):
    """polysemous_ht on the per-probe scan, with faiss_tpu's permuted
    codebooks (6 bits): equal to faiss_tpu's; the filter drops codes."""
    xb, xq = data
    ref = poly_ivf
    port = ivf_port(ref)
    ref.nprobe = port.nprobe = 4
    ref.polysemous_ht = port.polysemous_ht = ht
    Dj, Ij = ref.search(xq, K)
    Dt, It = port.search(xq, K)
    exact_agree(Dj, Ij, Dt, It, xq, xb)
    port.polysemous_ht = 0
    Iu = port.search(xq, K)[1]
    assert (Iu >= 0).sum() > (It >= 0).sum() or not np.array_equal(Iu, It)


def test_ivfpq_do_polysemous_training(data):
    """The port's train_encoder with do_polysemous_training gives the
    codebooks of its own training permuted by PolysemousTraining."""
    xb, _ = data
    out = []
    for poly in (False, True):
        index = ftt.IndexIVFPQ(None, D, NLIST, 4, 6, device="cpu")
        index.cp.niter = 4
        index.do_polysemous_training = poly
        index.train(xb)
        out.append(index.pq)
    ftt.PolysemousTraining().optimize_pq_for_hamming(out[0])
    np.testing.assert_array_equal(out[1].centroids, out[0].centroids)


def f64_in_lists(port, xq, Dt, It, k, luts_bf16=False):
    """Rows of a port IVF-PQ search against float64 over the probed lists:
    the exact squared distance to each reconstruction (by probe), or the
    ADC sum of the port's bf16-rounded tables plus the coarse and norm
    terms (the XLA scan)."""
    q = torch.from_numpy(xq)
    probes = port._coarse_search(q, port.nprobe)[1].numpy()
    rows = port.decode_vectors(port._codes_host, port._listnos_host).astype(np.float64)
    cent = port.quantizer.vectors().astype(np.float64)
    luts = (-2 * port_pq.pq_ip_tables(q, port.pq._dev())).to(torch.bfloat16).double().numpy()
    codes = port._codes_host.astype(np.int64)
    x64 = xq.astype(np.float64)
    for r in range(len(xq)):
        sel = np.nonzero(np.isin(port._listnos_host, probes[r]))[0]
        if luts_bf16:
            c = cent[port._listnos_host[sel]]
            d = ((x64[r] ** 2).sum() + (rows[sel] ** 2).sum(1) - 2 * c @ x64[r]
                 + luts[r][np.arange(4)[None], codes[sel]].sum(1))
        else:
            d = ((x64[r] - rows[sel]) ** 2).sum(1)
        o = np.argsort(d, kind="stable")[:k]
        tol = 1e-5 * ((x64[r] ** 2).sum() + (rows**2).sum(1).max())
        np.testing.assert_allclose(Dt[r, : len(o)], d[o], rtol=0, atol=tol)
        assert ids_agree_tie_aware(d[o][None], port._ids_host[sel][o][None],
                                   Dt[r : r + 1, : len(o)], It[r : r + 1, : len(o)],
                                   tol).all()


@pytest.mark.parametrize("branch", ["probe", "big_batch"])
@pytest.mark.parametrize("nbits", [3, 6, 10])
def test_ivfpq_other_nbits(data, nbits, branch):
    """IVF-PQ at 3, 6 and 10 bits on each branch: by probe (small batches)
    and the big batch (K4's plain version at 3 bits, the XLA ADC scan at 6
    and 10). faiss_tpu's equal at 3 and 6 bits; at 10 bits faiss_tpu stages
    its codes as uint8 (ROADMAP queue 3), so the port is held to float64."""
    xb, xq = data
    rs = np.random.RandomState(7)
    x = xb if nbits <= 8 else np.concatenate(
        [xb, (xb[rs.randint(NB, size=NB)] + 0.3 * rs.randn(NB, D)).astype(np.float32)])
    ref = ref_ivfpq(x, nbits)
    port = ivf_port(ref)
    assert port._codes_host.dtype == (np.uint8 if nbits <= 8 else np.uint16)
    ref.nprobe = port.nprobe = 4
    xs = xq if branch == "probe" else np.concatenate([xq, xq + 0.01])
    assert (len(xs) >= port.big_batch_threshold) == (branch == "big_batch")
    Dt, It = port.search(xs, K)
    if nbits <= 8:
        exact_agree(*ref.search(xs, K), Dt, It, xs, x)
    else:
        f64_in_lists(port, xs, Dt, It, K, luts_bf16=branch == "big_batch")


def test_ivfpqr_other_nbits(data):
    """IndexIVFPQR with a 10-bit refine PQ: the refine codes kept uint16,
    the search equal to faiss_tpu's (an 8-bit PQ, whose ADC candidates do
    not tie at the k * k_factor cut, as 6-bit codes within a list do)."""
    xb, xq = data
    ref = ref_ivfpq(xb, 8, cls=ftj.IndexIVFPQR, extra=(4, 10))
    port = convert.ivfpqr_from_arrays(
        ref.quantizer.vectors(), ref.pq.centroids, ref._codes_host,
        ref._listnos_host, ref._ids_host, ref.refine_pq.centroids,
        ref._refine_codes, device="cpu")
    assert port._refine_codes.dtype == np.uint16
    ref.nprobe = port.nprobe = 4
    exact_agree(*ref.search(xq, K), *port.search(xq, K), xq, xb)


def test_factory_and_files(data, tmp_path):
    """PQm / PQmxn / PQmx4fs / PQ4,RFlat through index_factory, and IndexPQ
    files written by each package read by the other."""
    xb, xq = data
    for desc, cls in (("PQ8", ftt.IndexPQ), ("PQ8x6", ftt.IndexPQ),
                      ("PQ8x4fs_64", ftt.IndexPQFastScan)):
        index = ftt.index_factory(D, desc, device="cpu")
        assert type(index) is cls and index.pq.M == 8
    assert ftt.index_factory(D, "PQ8x4fs_64", device="cpu").bbs == 64
    ref = ref_pq_index(xb, 6)
    port = port_of(ref)
    fj, fp = tmp_path / "j.npz", tmp_path / "p.npz"
    ftj.write_index(ref, str(fj))
    ftt.write_index(port, str(fp))
    back_t = ftt.read_index(str(fj), device="cpu")
    back_j = ftj.read_index(str(fp))
    assert type(back_t) is ftt.IndexPQ and type(back_j) is ftj.IndexPQ
    np.testing.assert_array_equal(back_j._codes_host, ref._codes_host)
    np.testing.assert_array_equal(back_j.pq.centroids, ref.pq.centroids)
    adc_agree(*ref.search(xq, K), *back_t.search(xq, K))
    fs = port_of(ref_pq_index(xb, 4, cls=ftj.IndexPQFastScan), fastscan=True)
    back = ftj.deserialize_index(ftt.serialize_index(fs))
    assert type(back) is ftj.IndexPQFastScan and back.bbs == 32
