"""Port parity for the non-flat coarse quantizers (faiss_tpu_torch/models/
imi.py and the IVF base's quantizer paths against faiss_tpu's).

MultiIndexQuantizer at M = 2 and 4 and MultiIndexQuantizer2 over port
IndexFlat / IndexHNSWFlat sub-indexes, holding faiss_tpu's codebooks: the
cells of each query (ids tie-aware: faiss_tpu's and the port's sorts are
both stable, and the tables differ in their last bits), the product table.
IVF indexes over them, each from faiss_tpu's trained state: IMI2x4,Flat and
IMI2x5,PQ8 with and without max_codes; IVF32_HNSW16,Flat and
IVF32_HNSW16,PQ8x4fs,RFlat at nq 64 (by probe, the HNSW graph's coarse
search) and nq 256 at nprobe 32 and 2 (the big-batch path, exact coarse
distances over the quantizer's rows; faiss_tpu's Pallas kernels in
interpret mode at the shapes of tests/test_pq.py:529); IVF16(PQ4),Flat. Adds through the port's
quantizer land in faiss_tpu's lists. IVF-PQ's CSR per-probe layout against
faiss_tpu's padded one; the IMI's factored term2 tables against the full
table.

Tolerances: distances within 1e-5 * (|q|^2 + max |y|^2), 1e-4 of that
scale where an IVF-PQ returns float32 ADC sums; ids tie-aware within
them."""

import numpy as np
import pytest

import faiss_tpu as ftj
import faiss_tpu_torch as ftt
from faiss_tpu.models import ivf_pq as ref_pq
from faiss_tpu_torch.convert import (
    flat_from_arrays,
    hnsw_from_state,
    imi_from_arrays,
    ivfflat_from_arrays,
    refine_flat_from_arrays,
)
from faiss_tpu_torch.models import ivf_pq as port_pq
from faiss_tpu_torch.utils.evaluation import ids_agree_tie_aware
from torch_threads import one_torch_thread  # noqa: F401

D, NB, NQ, K = 16, 3000, 64, 10


def mixture(rs, n, ncent=64, d=D):
    cent = np.random.RandomState(99).rand(ncent, d).astype(np.float32)
    scales = (1.0 / (np.arange(d) + 1.0)).astype(np.float32) * 0.4
    a = rs.randint(ncent, size=n)
    return (cent[a] + rs.randn(n, d).astype(np.float32) * scales).astype(np.float32)


@pytest.fixture(scope="module")
def data():
    rs = np.random.RandomState(31)
    return mixture(rs, NB), mixture(rs, 256)


def scale_tol(xq, xb, rel=1e-5):
    return rel * ((xq.astype(np.float64) ** 2).sum(1)
                  + (xb.astype(np.float64) ** 2).sum(1).max())


def agree(Dj, Ij, Dt, It, tol, rows=None):
    assert Dt.dtype == np.float32 and It.dtype == np.int64
    assert Dt.shape == Dj.shape
    if rows is not None:
        assert rows.mean() > 0.5, rows.mean()
        Dj, Ij, Dt, It, tol = Dj[rows], Ij[rows], Dt[rows], It[rows], tol[rows]
    np.testing.assert_array_equal(Ij == -1, It == -1)
    fin = np.isfinite(Dj)
    assert (np.abs(np.where(fin, Dt - Dj, 0)) <= tol[:, None]).all()
    ok = ids_agree_tie_aware(np.where(fin, Dj, 1e30), Ij,
                             np.where(fin, Dt, 1e30), It, tol)
    assert ok.all(), np.where(~ok)


@pytest.mark.parametrize("M,nbits", [(2, 5), (4, 3)])
def test_imi_matches_reference(data, M, nbits):
    xb, xq = data
    ref = ftj.MultiIndexQuantizer(D, M, nbits)
    ref.pq.cp.niter = 4
    ref.train(xb)
    port = imi_from_arrays(D, ref.pq.centroids, nbits=nbits, device="cpu")
    assert port.ntotal == ref.ntotal == (1 << nbits) ** M
    tol = scale_tol(xq, xb)
    for k in (1, 8, 40):
        Dj, Ij = ref.search(xq, k)
        Dt, It = port.search(xq, k)
        agree(Dj, Ij, Dt, It, tol)
    np.testing.assert_array_equal(port.vectors(), ref.vectors())
    for key in (0, 5, port.ntotal - 1):
        np.testing.assert_array_equal(port.reconstruct(key), ref.reconstruct(key))
    with pytest.raises(RuntimeError, match="virtual"):
        port.add(xb[:2])


def test_imi_cells_are_exact_against_brute_force(data):
    """The merge is exact: the k best cells of the port equal a brute force
    over the whole product table (float64 sums of the float32 tables)."""
    xb, xq = data
    port = ftt.MultiIndexQuantizer(D, 2, 4, device="cpu")
    port.pq.cp.niter = 4
    port.train(xb)
    tabs = port.pq.compute_distance_tables(xq).astype(np.float64)
    full = (tabs[:, 0, None, :] + tabs[:, 1, :, None]).reshape(len(xq), -1)
    Dc, Ic = port.search(xq, 20)
    want = np.sort(full, 1)[:, :20]
    np.testing.assert_allclose(Dc, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(np.take_along_axis(full, Ic, 1), Dc, rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("sub", ["flat", "hnsw"])
def test_imi2_matches_reference(data, sub):
    xb, xq = data
    if sub == "flat":
        subs_j = [ftj.IndexFlatL2(D // 2) for _ in range(2)]
        subs_t = [ftt.IndexFlatL2(D // 2, device="cpu") for _ in range(2)]
    else:
        subs_j = [ftj.IndexHNSWFlat(D // 2, 8) for _ in range(2)]
        subs_t = [ftt.IndexHNSWFlat(D // 2, 8, device="cpu") for _ in range(2)]
    ref = ftj.MultiIndexQuantizer2(D, 5, *subs_j)
    ref.pq.cp.niter = 4
    ref.train(xb)
    port = ftt.MultiIndexQuantizer2(D, 5, *subs_t)
    port.pq.set_centroids(ref.pq.centroids)
    # the sub-indexes filled as train() fills them (faiss_tpu imi.py:141)
    for m, s in enumerate(port.assign_indexes):
        s.add(ref.pq.centroids[m])
    port.is_trained, port.ntotal = True, ref.ntotal
    if sub == "hnsw":
        for a, b in zip(subs_j, subs_t):
            assert (a.graph_state()["neighbors"] == b.graph_state()["neighbors"]).all()
    tol = scale_tol(xq, xb)
    for k in (1, 16):
        Dj, Ij = ref.search(xq, k)
        Dt, It = port.search(xq, k)
        agree(Dj, Ij, Dt, It, tol)


def imi_ivf_pair(desc, xb):
    """faiss_tpu's IVF over an IMI from index_factory, trained and filled,
    and the port's from the same string holding faiss_tpu's codebooks and
    adding the rows itself through its IMI."""
    ref = ftj.index_factory(D, desc)
    ref.quantizer.pq.cp.niter = 4
    if hasattr(ref, "pq"):
        ref.pq.cp.niter = 4
    ref.train(xb)
    ref.add(xb)
    port = ftt.index_factory(D, desc, device="cpu")
    assert port.quantizer_trains_alone == 1
    q = port.quantizer
    q.pq.set_centroids(ref.quantizer.pq.centroids)
    q.is_trained, q.ntotal = True, ref.quantizer.ntotal
    if hasattr(port, "pq"):
        port.pq.set_centroids(ref.pq.centroids)
    port.is_trained = True
    port.add(xb)
    np.testing.assert_array_equal(port._listnos_host, ref._listnos_host)
    if hasattr(port, "pq"):
        assert (port._codes_host == ref._codes_host).all(1).mean() > 0.99
    return ref, port


@pytest.mark.parametrize("desc", ["IMI2x4,Flat", "IMI2x5,PQ8"])
@pytest.mark.parametrize("max_codes", [0, 200])
def test_imi_ivf_matches_reference(data, desc, max_codes):
    xb, xq = data
    xq = xq[:NQ]
    ref, port = imi_ivf_pair(desc, xb)
    tol = scale_tol(xq, xb, 1e-4 if "PQ" in desc else 1e-5)
    for nprobe in (4, 16):
        pj = ftj.SearchParametersIVF(nprobe=nprobe, max_codes=max_codes)
        pt = ftt.SearchParametersIVF(nprobe=nprobe, max_codes=max_codes)
        Dj, Ij = ref.search(xq, K, params=pj)
        Dt, It = port.search(xq, K, params=pt)
        agree(Dj, Ij, Dt, It, tol)


def hnsw_quantizer(ref_q):
    """The port's copy of faiss_tpu's HNSW coarse quantizer: same rows,
    same graph."""
    return hnsw_from_state(flat_from_arrays(ref_q.storage.vectors(), device="cpu"),
                           ref_q.graph_state())


@pytest.fixture(scope="module")
def ivf_hnsw_flat(data):
    xb, _ = data
    ref = ftj.index_factory(D, "IVF32_HNSW16,Flat")
    ref.FUSED_CT = 256
    ref.cp.niter = 4
    ref.cp.min_points_per_centroid = 1
    ref.fused_interpret = True
    ref.train(xb)
    ref.add(xb)
    q = hnsw_quantizer(ref.quantizer)
    port = ftt.IndexIVFFlat(q, D, 32, device="cpu")
    port.FUSED_CT = 256
    assert port.is_trained
    port.add(xb)  # assigned through the port's graph
    np.testing.assert_array_equal(port._listnos_host, ref._listnos_host)
    np.testing.assert_array_equal(port._codes_host, ref._codes_host)
    return ref, port


def flags_of(monkeypatch):
    """faiss_tpu's lossy-row flags, read where its collect unpacks them."""
    flags = []
    unpack_results = ref_pq._unpack_results

    def unpack(packed, k):
        out = unpack_results(packed, k)
        flags.append(out[2])
        return out

    monkeypatch.setattr(ref_pq, "_unpack_results", unpack)
    return flags


@pytest.mark.parametrize("nq", [64, 256])
def test_ivf_hnsw_flat_matches_reference(data, ivf_hnsw_flat, nq, monkeypatch):
    xb, xq = data
    xq = xq[:nq]
    ref, port = ivf_hnsw_flat
    flags = flags_of(monkeypatch)
    for index in (ref, port):
        monkeypatch.setattr(index, "nprobe", 4)
    Dj, Ij = ref.search(xq, K)
    Dt, It = port.search(xq, K)
    rows = None
    if nq >= 128:
        rows = ~np.concatenate(flags)[:nq]
    agree(Dj, Ij, Dt, It, scale_tol(xq, xb), rows)


@pytest.fixture(scope="module")
def ivf_hnsw_pq_refine(data):
    xb, _ = data
    ref = ftj.index_factory(D, "IVF32_HNSW16,PQ8x4fs,RFlat")
    base = ref.base_index
    base.FUSED_CT = 256
    base.fused_interpret = True
    base.query_h2d_dtype = None
    base.pack_d2h = None
    base.cp.niter = 4
    base.cp.min_points_per_centroid = 1
    ref.train(xb)
    ref.add(xb)
    port = refine_flat_from_arrays(
        base.quantizer.vectors(), base.pq.centroids, base._codes_host,
        base._listnos_host, base._ids_host, ref.refine_index.vectors(),
        device="cpu",
        store_float16=np.dtype(ref.refine_index.storage_dtype) == np.float16)
    pb = port.base_index
    pb.quantizer = hnsw_quantizer(base.quantizer)
    pb.FUSED_CT = 256
    port.k_factor = ref.k_factor
    return ref, port


@pytest.mark.parametrize("nq,nprobe,kf", [(64, 4, 100), (256, 32, 4),
                                           (256, 2, 4)])
def test_ivf_hnsw_pq_refine_matches_reference(data, ivf_hnsw_pq_refine, nq,
                                              nprobe, kf, monkeypatch):
    """By probe at nq 64 (the graph's coarse search, the ADC scan, the
    re-rank), the big-batch path at nq 256 (exact coarse distances over the
    graph's rows; K1/K2's plain versions against faiss_tpu's Pallas kernels
    in interpret mode, on the rows they did not flag as lossy: at kc = 40,
    over 80% of them here), over every list and over the 2 nearest. 4-bit
    ADC keys tie (rows with equal codes), so by probe the candidates cover
    every entry of the 4 probed lists (k_factor 100)."""
    xb, xq = data
    xq = xq[:nq]
    ref, port = ivf_hnsw_pq_refine
    flags = flags_of(monkeypatch)
    for index in (ref, port):
        monkeypatch.setattr(index.base_index, "nprobe", nprobe)
        monkeypatch.setattr(index, "k_factor", kf)
    Dj, Ij = ref.search(xq, K)
    Dt, It = port.search(xq, K)
    rows = ~np.concatenate(flags)[:nq] if nq >= 128 else None
    agree(Dj, Ij, Dt, It, scale_tol(xq, xb), rows)


def test_ivf_hnsw_pq_adds_through_the_graph(data, ivf_hnsw_pq_refine):
    """A port IVF-PQ over the port's graph assigns and encodes as faiss_tpu
    did (the residual to a centroid read through the device copy of the
    graph's rows)."""
    xb, _ = data
    ref, port = ivf_hnsw_pq_refine
    fresh = ftt.IndexIVFPQFastScan(port.base_index.quantizer, D, 32, 8, 4,
                                   device="cpu")
    fresh.pq.set_centroids(ref.base_index.pq.centroids)
    fresh.is_trained = True
    fresh.add(xb)
    np.testing.assert_array_equal(fresh._listnos_host, ref.base_index._listnos_host)
    same = (fresh._codes_host == ref.base_index._codes_host).all(1).mean()
    assert same > 0.99, same


def test_ivf_pq_quantizer_matches_reference(data):
    """IVF16(PQ4),Flat: an IndexPQ as the coarse quantizer (trained first:
    faiss_tpu fills it with the k-means centroids, which an untrained PQ
    cannot encode), the lists assigned by its ADC search."""
    xb, xq = data
    xq = xq[:NQ]
    ref = ftj.index_factory(D, "IVF16(PQ4),Flat")
    ref.quantizer.pq.cp.niter = 4
    ref.quantizer.train(xb)
    ref.cp.niter = 4
    ref.train(xb)
    ref.add(xb)
    port = ftt.index_factory(D, "IVF16(PQ4),Flat", device="cpu")
    assert isinstance(port.quantizer, ftt.IndexPQ)
    port.quantizer.pq.set_centroids(ref.quantizer.pq.centroids)
    port.quantizer.is_trained = True
    port.quantizer.add_codes_int(ref.quantizer._codes_host)
    port.is_trained = True
    cent = ref.quantizer.reconstruct_n(0, 16)
    np.testing.assert_array_equal(port.quantizer.reconstruct_n(0, 16), cent)
    port.add(xb)
    assert (port._listnos_host == ref._listnos_host).mean() > 0.99
    port = ivfflat_from_arrays(cent, ref._codes_host,
                               ref._listnos_host, ref._ids_host, device="cpu")
    port.quantizer = pq_q = ftt.IndexPQ(D, 4, device="cpu")
    pq_q.pq.set_centroids(ref.quantizer.pq.centroids)
    pq_q.is_trained = True
    pq_q.add_codes_int(ref.quantizer._codes_host)
    ref.nprobe = port.nprobe = 4
    Dj, Ij = ref.search(xq, K)
    Dt, It = port.search(xq, K)
    agree(Dj, Ij, Dt, It, scale_tol(xq, xb))


def test_ragged_layout_equals_padded(data):
    """IVF-PQ's per-probe layout, one CSR, gives the results of faiss_tpu's
    padded layout over the same codes: every probe search (plain,
    max_codes, a selector, the polysemous filter) and range_search."""
    xb, xq = data
    xq = xq[:NQ]
    ref, port = imi_ivf_pair("IMI2x5,PQ8", xb)
    port._codes_host = ref._codes_host.copy()
    port._drop_caches()
    ref.nprobe = port.nprobe = 16
    tol = scale_tol(xq, xb, 1e-4)
    for kw in (dict(), dict(max_codes=150), dict(sel=(100, 2500))):
        pj, pt = (pkg.SearchParametersIVF(
            nprobe=16, max_codes=kw.get("max_codes", 0),
            sel=pkg.IDSelectorRange(*kw["sel"]) if "sel" in kw else None)
            for pkg in (ftj, ftt))
        agree(*ref.search(xq, K, params=pj), *port.search(xq, K, params=pt), tol)
    assert type(port._device["lists"]).__name__ == "RaggedLists"
    ref.polysemous_ht = port.polysemous_ht = 40
    agree(*ref.search(xq, K), *port.search(xq, K), tol)
    ref.polysemous_ht = port.polysemous_ht = 0
    radius = float(np.median(port.search(xq[:8], K)[0][:, K - 1]))
    rj, rt = ref.range_search(xq[:8], radius), port.range_search(xq[:8], radius)
    n = 0
    for q in range(8):
        sj = slice(int(rj.lims[q]), int(rj.lims[q + 1]))
        st = slice(int(rt.lims[q]), int(rt.lims[q + 1]))
        dj = dict(zip(rj.labels[sj].tolist(), rj.distances[sj].tolist()))
        dt = dict(zip(rt.labels[st].tolist(), rt.distances[st].tolist()))
        for u, v in ((dj, dt), (dt, dj)):
            for i in set(u) - set(v):
                assert abs(u[i] - radius) <= tol[q], (q, i, u[i], radius)
        for i in set(dj) & set(dt):
            assert abs(dj[i] - dt[i]) <= tol[q]
            n += 1
    assert n >= 8 * K // 2, n


def test_imi_factored_term2_equals_full_table(data, monkeypatch):
    """An IVF-PQ over an IMI reads the factored IMITerm2 tables: every entry
    equal to the full table's (precompute_table), and the searches equal;
    beyond precomputed_table_max_bytes any other quantizer raises
    MemoryError."""
    import torch

    xb, xq = data
    xq = xq[:NQ]
    _, port = imi_ivf_pair("IMI2x5,PQ8", xb)
    port.nprobe = 8
    t2 = port._maybe_term2()
    assert isinstance(t2, port_pq.IMITerm2)
    got = port.search(xq, K)
    port.precompute_table()
    full = port._term2
    assert isinstance(full, torch.Tensor)
    lists = torch.arange(port.nlist)
    np.testing.assert_array_equal(t2[lists].numpy(), full.numpy())
    cw = torch.randint(0, 256, (50, port.pq.M))
    ln = torch.randint(0, port.nlist, (50,))
    mi = torch.arange(port.pq.M)[None, :]
    np.testing.assert_array_equal(t2[ln[:, None], mi, cw].numpy(),
                                  full[ln[:, None], mi, cw].numpy())
    want = port.search(xq, K)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])
    monkeypatch.setattr(port_pq, "precomputed_table_max_bytes", 1)
    flat = ftt.IndexIVFPQ(None, D, 8, 4, device="cpu")
    flat.quantizer.add(xb[:8])
    flat.pq.set_centroids(np.random.RandomState(0).randn(4, 256, 4).astype(np.float32))
    with pytest.raises(MemoryError):
        flat._maybe_term2()
