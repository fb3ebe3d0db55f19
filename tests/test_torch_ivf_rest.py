"""Port parity for the rest of IVF: the inner-product metric of IVF-Flat
and IVF-PQ (from converted state; spherical k-means when the port trains),
IVF range_search, spherical k-means, and remove_ids, merge_from and
update_vectors followed by the big-batch searches.

The mutation tests hold the port's big batch after the mutation to a
faiss_tpu index built from the kept rows, never to the mutated faiss_tpu
index: faiss_tpu's IndexIVF.remove_ids and merge_from clear the per-probe
layout but not the big-batch one (``_brute``), so its next big batch reads
stale slots (ROADMAP queue 3). IVF-Flat's strict big batch is exact within
the probed lists, so it is held to faiss_tpu's search by probe of the fresh
index, on the rows whose probed lists hold the kc candidates it re-ranks;
IVF-PQ's (8-bit, the ADC scan over the codes) to the fresh index's own big
batch.

Tolerances: distances within 1e-5 * (|q|^2 + max |y|^2), ids up to ties at
it; range results as per-query sets, an entry on one side only lying within
that tolerance of the radius. Spherical k-means objectives within 1e-4
relative (faiss_tpu assigns through three bf16 products)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import faiss_tpu as ftj
import faiss_tpu_torch as ftt
from faiss_tpu.ops import kmeans_ops as kj
from faiss_tpu_torch.convert import ivfflat_from_arrays, ivfpq_from_arrays
from faiss_tpu_torch.models import ivf_pq as port_pq
from faiss_tpu_torch.ops import kmeans_ops as kt
from faiss_tpu_torch.utils.evaluation import ids_agree_tie_aware
from torch_threads import one_torch_thread  # noqa: F401

D, NLIST, NB, NQ, M, K = 16, 64, 3000, 128, 4, 10
KC = max(2 * K, K + 32)


def mixture(rs, n, ncent=64, d=D):
    """Small Gaussian mixture in the shape of bench.py's generator."""
    cent = np.random.RandomState(99).rand(ncent, d).astype(np.float32)
    scales = (1.0 / (np.arange(d) + 1.0)).astype(np.float32) * 0.4
    a = rs.randint(ncent, size=n)
    return (cent[a] + rs.randn(n, d).astype(np.float32) * scales).astype(np.float32)


def tol_of(xq, xb):
    return 1e-5 * ((xq.astype(np.float64) ** 2).sum(1)
                   + (xb.astype(np.float64) ** 2).sum(1).max())


def agree(Dj, Ij, Dt, It, tol, largest=False, rows=None):
    if rows is not None:
        Dj, Ij, Dt, It, tol = Dj[rows], Ij[rows], Dt[rows], It[rows], tol[rows]
    assert Dt.dtype == np.float32 and It.dtype == np.int64
    np.testing.assert_array_equal(Ij == -1, It == -1)
    fin = np.isfinite(Dj)
    np.testing.assert_array_equal(fin, np.isfinite(Dt))
    assert (np.abs(np.where(fin, Dt - Dj, 0)) <= tol[:, None]).all()
    s = -1.0 if largest else 1.0
    ok = ids_agree_tie_aware(np.where(fin, s * Dj, 1e30), Ij,
                             np.where(fin, s * Dt, 1e30), It, tol)
    assert ok.all(), np.where(~ok)


@pytest.fixture(scope="module")
def data():
    rs = np.random.RandomState(61)
    return mixture(rs, NB), mixture(rs, NQ)


# -- inner product ------------------------------------------------------------
@pytest.fixture(scope="module")
def ip_built(data):
    xb, _ = data
    ivf = ftj.IndexIVFFlat(None, D, NLIST, ftj.METRIC_INNER_PRODUCT)
    ivf.cp.niter = 4
    ivf.cp.min_points_per_centroid = 1
    ivf.train(xb)
    ivf.add(xb)
    assert ivf.cp.spherical
    pqs = {}
    for nbits in (8, 4):
        pq = ftj.IndexIVFPQ(ivf.quantizer, D, NLIST, M, nbits,
                            ftj.METRIC_INNER_PRODUCT)
        pq.train(xb)
        pq.add(xb)
        pqs[nbits] = pq
    cent = ivf.quantizer.vectors()
    ports = {"flat": ivfflat_from_arrays(cent, ivf._codes_host, ivf._listnos_host,
                                         ivf._ids_host, device="cpu",
                                         metric=ftt.METRIC_INNER_PRODUCT)}
    for nbits, pq in pqs.items():
        ports[f"pq{nbits}"] = ivfpq_from_arrays(
            cent, pq.pq.centroids, pq._codes_host, pq._listnos_host,
            pq._ids_host, device="cpu", metric=ftt.METRIC_INNER_PRODUCT)
    refs = {"flat": ivf, "pq8": pqs[8], "pq4": pqs[4]}
    return refs, ports


@pytest.mark.parametrize("which", ["flat", "pq8", "pq4"])
@pytest.mark.parametrize("nprobe", [1, 6])
def test_inner_product_search_matches_reference(data, ip_built, which, nprobe):
    """By probe at nq = 128 (the big-batch gates close to inner product),
    largest first, against faiss_tpu's; and search_preassigned."""
    xb, xq = data
    refs, ports = ip_built
    ref, port = refs[which], ports[which]
    assert port.metric_type == ftt.METRIC_INNER_PRODUCT
    ref.nprobe = port.nprobe = nprobe
    Dj, Ij = ref.search(xq, K)
    Dt, It = port.search(xq, K)
    fin = np.isfinite(Dt)
    assert (np.diff(np.where(fin, Dt, -1e30), axis=1) <= 0).all()
    assert (fin | (It == -1)).all() and port._brute is None
    tol = tol_of(xq, xb)
    agree(Dj, Ij, Dt, It, tol, largest=True)
    dis, assign = port._coarse_search(torch.from_numpy(xq), nprobe)
    Dj, Ij = ref.search_preassigned(xq, K, assign.numpy(), dis.numpy())
    Dt, It = port.search_preassigned(xq, K, assign.numpy(), dis.numpy())
    agree(Dj, Ij, Dt, It, tol, largest=True)


def test_inner_product_coarse_assignment_matches_reference(data, ip_built):
    """The coarse search and the add assignment by inner product."""
    xb, xq = data
    refs, ports = ip_built
    ref, port = refs["flat"], ports["flat"]
    dj, ij = ref._coarse_search(xq, 3)
    dt, it = port._coarse_search(torch.from_numpy(xq), 3)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-5, atol=1e-5)
    a = port._assign(torch.from_numpy(xb)).numpy()
    np.testing.assert_array_equal(a, ref._listnos_host)


def test_inner_product_train_on_the_port(data):
    """The port's own IP training: spherical k-means gives unit-norm
    centroids; search by probe returns inner products of the stored
    vectors, largest first."""
    xb, xq = data
    index = ftt.IndexIVFFlat(None, D, NLIST, ftt.METRIC_INNER_PRODUCT, device="cpu")
    index.cp.niter = 4
    index.cp.min_points_per_centroid = 1
    index.train(xb)
    assert index.cp.spherical
    np.testing.assert_allclose(
        np.linalg.norm(index.quantizer.vectors(), axis=1), 1.0, rtol=1e-5)
    index.add(xb)
    index.nprobe = NLIST
    Dt, It = index.search(xq, K)
    ip = xq.astype(np.float64) @ xb.T.astype(np.float64)
    want = -np.sort(-ip, axis=1)[:, :K]
    assert (np.abs(Dt - want) <= tol_of(xq, xb)[:, None]).all()
    # another metric builds its flat quantizer under that metric and scans
    # by probe (tests/test_torch_metrics.py checks it against float64)
    l1 = ftt.IndexIVFFlat(None, D, NLIST, ftt.MetricType.L1, device="cpu")
    assert l1.quantizer.metric_type == ftt.MetricType.L1
    l1.cp.niter = 2
    l1.cp.min_points_per_centroid = 1
    l1.train(xb)
    l1.add(xb)
    assert l1.ntotal and not l1._big_batch_gate(np.tile(xq, (8, 1)), K, None)[1]


# -- spherical k-means -----------------------------------------------------
def test_spherical_kmeans_matches_reference():
    rs = np.random.RandomState(9)
    x = mixture(rs, 3000, ncent=12)
    init = x[rs.permutation(len(x))[:16]]
    init = init / np.linalg.norm(init, axis=1, keepdims=True)
    _, objs_j, _, _, ns_j, _ = kj.kmeans_fused_loop(
        jnp.asarray(x), jnp.asarray(init), jax.random.PRNGKey(0), niter=6,
        spherical=True)
    c, objs_t, _, _, ns_t, _ = kt.kmeans_fused_loop(
        torch.from_numpy(x), torch.from_numpy(init), torch.Generator(),
        niter=6, chunk=1024, spherical=True)
    assert int(np.asarray(ns_j).sum()) == 0 and int(ns_t.sum()) == 0
    np.testing.assert_allclose(c.norm(dim=1).numpy(), 1.0, rtol=1e-5)
    np.testing.assert_allclose(objs_t.numpy(), np.asarray(objs_j), rtol=1e-4)
    for niter in (0, 3):
        cpj = ftj.ClusteringParameters(niter=niter, seed=5, spherical=True)
        cpt = ftt.ClusteringParameters(niter=niter, seed=5, spherical=True)
        cj, ct = ftj.Clustering(D, 16, cpj), ftt.Clustering(D, 16, cpt, device="cpu")
        oj, ot = cj.train(x), ct.train(x)
        np.testing.assert_allclose(np.linalg.norm(ct.centroids, axis=1), 1.0,
                                   rtol=1e-5)
        if niter == 0:
            np.testing.assert_array_equal(ct.centroids, cj.centroids)
        else:
            np.testing.assert_allclose(ot, oj, rtol=1e-4)


# -- range search ------------------------------------------------------------
def range_agree(rj, rt, radius, tol):
    assert rt.lims.dtype == np.uint64 and len(rt.lims) == len(rj.lims)
    n = 0
    for q in range(len(rj.lims) - 1):
        sj = slice(int(rj.lims[q]), int(rj.lims[q + 1]))
        st = slice(int(rt.lims[q]), int(rt.lims[q + 1]))
        dj = dict(zip(rj.labels[sj].tolist(), rj.distances[sj].tolist()))
        dt = dict(zip(rt.labels[st].tolist(), rt.distances[st].tolist()))
        assert len(dt) == st.stop - st.start
        for a, b in ((dj, dt), (dt, dj)):
            for i in set(a) - set(b):
                assert abs(a[i] - radius) <= tol[q], (q, i, a[i], radius)
        for i in set(dj) & set(dt):
            assert abs(dj[i] - dt[i]) <= tol[q]
            n += 1
    return n


@pytest.fixture(scope="module")
def l2_built(data):
    xb, _ = data
    ivf = ftj.IndexIVFFlat(None, D, NLIST)
    ivf.cp.niter = 4
    ivf.cp.min_points_per_centroid = 1
    ivf.train(xb)
    ivf.add(xb)
    pq = ftj.IndexIVFPQ(ivf.quantizer, D, NLIST, M, 8)
    pq.train(xb)
    pq.add(xb)
    return ivf, pq


def port_flat(ivf, **kw):
    return ivfflat_from_arrays(ivf.quantizer.vectors(), ivf._codes_host,
                               ivf._listnos_host, ivf._ids_host, device="cpu", **kw)


def port_pq8(pq):
    return ivfpq_from_arrays(pq.quantizer.vectors(), pq.pq.centroids,
                             pq._codes_host, pq._listnos_host, pq._ids_host,
                             device="cpu")


@pytest.mark.parametrize("which", ["flat_l2", "flat_ip", "pq8", "flat_sel"])
def test_ivf_range_search_matches_reference(data, l2_built, ip_built, which,
                                            monkeypatch):
    """By probe over the padded lists at nprobe 4, the radius at the median
    10th-neighbour distance, against faiss_tpu's range_search (which
    decodes and scores each candidate on the host); small gather chunks
    split the queries."""
    xb, xq = data
    if which == "flat_ip":
        ref, port = ip_built[0]["flat"], ip_built[1]["flat"]
    elif which == "pq8":  # faiss_tpu decodes per query on the host: fewer
        ref, port = l2_built[1], port_pq8(l2_built[1])
        xq = xq[:48]
    else:
        ref, port = l2_built[0], port_flat(l2_built[0])
    ref.nprobe = port.nprobe = 4
    monkeypatch.setattr(port, "_probe_row_bytes", lambda dev: 1 << 25)
    Dk, _ = port.search(xq, K)
    radius = float(np.median(Dk[:, K - 1]))
    pj = pt = None
    if which == "flat_sel":
        pj = ftj.SearchParametersIVF(sel=ftj.IDSelectorRange(0, NB // 2))
        pt = ftt.SearchParametersIVF(sel=ftt.IDSelectorRange(0, NB // 2))
    rj = ref.range_search(xq, radius, params=pj)
    rt = port.range_search(xq, radius, params=pt)
    assert range_agree(rj, rt, radius, tol_of(xq, xb)) > 3 * len(xq)
    if which == "flat_sel":
        assert (rt.labels < NB // 2).all()
    r8 = port.range_search(xq, radius, params=ftt.SearchParametersIVF(nprobe=8))
    assert r8.lims[-1] >= rt.lims[-1]


# -- mutation ---------------------------------------------------------------
def fresh_flat(ivf, keep, xrows=None, listnos=None):
    """A faiss_tpu IVF-Flat sharing ``ivf``'s quantizer, holding the kept
    entries (with replaced rows and lists where given)."""
    index = ftj.IndexIVFFlat(ivf.quantizer, D, NLIST)
    x = ivf._codes_host if xrows is None else xrows
    ln = ivf._listnos_host if listnos is None else listnos
    index.add_core(x[keep], ivf._ids_host[keep], ln[keep])
    return index


def full_rows(port, xq, nprobe):
    """Rows whose nprobe nearest lists hold at least KC entries."""
    sizes = np.bincount(port._listnos_host, minlength=NLIST)
    near = port._coarse_search(torch.from_numpy(xq), nprobe)[1].numpy()
    return sizes[near].sum(1) >= KC


def big_batch(port, xq, mode, nprobe, monkeypatch):
    """The port's big-batch search, through K2 masked ("k2": the default
    engage fraction over few chunks) or K1 penalized ("k1": small chunks,
    worklists as long as the store's chunks, so none is dropped); asserts
    the branch and that no probed chunk was dropped."""
    port.nprobe = nprobe
    taken = []
    for name in ("_fused_search_rerank_recon", "_fused_search_rerank_recon_dyn"):
        real = getattr(port_pq, name)

        def spy(*a, _real=real, _name=name, **kw):
            out = _real(*a, **kw)
            taken.append((_name, int(out[2])))
            return out

        monkeypatch.setattr(f"faiss_tpu_torch.models.ivf_flat.{name}", spy)
    if mode == "k1":
        port.FUSED_CT = 32
        port.dyn_engage_frac = 1.0
        port.dyn_msteps = port._build_brute()["nchunks"]
    D_, I_ = port.search(xq, K)
    want = "_fused_search_rerank_recon" + ("_dyn" if mode == "k1" else "")
    assert taken and all(t == (want, 0) for t in taken), taken
    return D_, I_


@pytest.mark.parametrize("mode", ["k2", "k1"])
def test_ivfflat_remove_then_big_batch(data, l2_built, mode, monkeypatch):
    """remove_ids of a tenth of the ids (after a big batch built the
    layout): no removed id comes back, and the strict big batch equals
    faiss_tpu's search by probe of a fresh index of the kept rows on full
    rows."""
    xb, xq = data
    ivf = l2_built[0]
    port = port_flat(ivf)
    big_batch(port, xq, mode, 2, monkeypatch)  # stage the layout first
    gone = np.random.RandomState(3).choice(NB, NB // 10, replace=False)
    assert port.remove_ids(ftt.IDSelectorBatch(gone)) == len(gone)
    assert port._brute is None and port._device is None
    assert port.remove_ids(ftt.IDSelectorBatch(gone)) == 0
    Dt, It = big_batch(port, xq, mode, 2, monkeypatch)
    assert not np.isin(It, gone).any()
    keep = ~np.isin(ivf._ids_host, gone)
    ref = fresh_flat(ivf, keep)
    ref.nprobe = 2
    rows = full_rows(port, xq, 2)
    assert rows.mean() > 0.8
    agree(*ref.search(xq, K), Dt, It, tol_of(xq, xb), rows=rows)
    assert port.ntotal == NB - len(gone) and port.get_list_size(0) == ref.get_list_size(0)


def test_ivfflat_merge_and_update_then_big_batch(data, l2_built, monkeypatch):
    """merge_from an index sharing the quantizer that holds the removed
    rows gives back the whole index; update_vectors moves rows between
    lists and reconstruct returns the new vectors; after each, the strict
    big batch equals faiss_tpu's search by probe of a fresh index built
    from the same entries."""
    xb, xq = data
    ivf = l2_built[0]
    tol = tol_of(xq, xb)
    port = port_flat(ivf)
    gone = np.random.RandomState(4).choice(NB, NB // 10, replace=False)
    port.remove_ids(ftt.IDSelectorBatch(gone))
    big_batch(port, xq, "k2", 1, monkeypatch)
    other = port_flat(ivf)
    other.remove_ids(ftt.IDSelectorNot(ftt.IDSelectorBatch(gone)))
    assert other.ntotal == len(gone)
    port.merge_from(other)
    assert other.ntotal == 0 and port.ntotal == NB and port._brute is None
    with pytest.raises(ValueError, match="incompatible"):
        port.merge_from(port_pq8(l2_built[1]))
    Dt, It = big_batch(port, xq, "k2", 1, monkeypatch)
    ref = fresh_flat(ivf, np.ones(NB, bool))
    ref.nprobe = 1
    rows = full_rows(port, xq, 1)
    agree(*ref.search(xq, K), Dt, It, tol, rows=rows)
    # update: 100 ids get vectors of other components
    rs = np.random.RandomState(5)
    ids = rs.choice(NB, 100, replace=False)
    new = mixture(rs, 100)
    port.update_vectors(ids, new)
    assert port._brute is None
    np.testing.assert_array_equal(port.reconstruct_batch(ids), new)
    np.testing.assert_array_equal(port.reconstruct(int(ids[3])), new[3])
    with pytest.raises(ValueError, match="did not find"):
        port.update_vectors([NB + 5], new[:1])
    Dt, It = big_batch(port, xq, "k2", 1, monkeypatch)
    slots = port._slots_of_ids(ivf._ids_host)  # ref entries in port order
    ref = ftj.IndexIVFFlat(ivf.quantizer, D, NLIST)
    ref.add_core(port._codes_host[slots], ivf._ids_host,
                 port._listnos_host[slots])
    ref.nprobe = 1
    moved = (port._listnos_host[port._slots_of_ids(ids)]
             != ivf._listnos_host[ids]).sum()
    assert moved > 50
    rows = full_rows(port, xq, 1)
    agree(*ref.search(xq, K), Dt, It, tol_of(xq, np.concatenate([xb, new])),
          rows=rows)


@pytest.mark.parametrize("op", ["remove", "merge", "update"])
def test_ivfpq_mutation_then_big_batch(data, l2_built, op):
    """8-bit IVF-PQ: the big batch (the ADC scan over the codes, k <= 32)
    after each mutation against a fresh faiss_tpu index of the resulting
    entries; 4-bit IVF-PQ (K4) after the same mutation equals a fresh port
    index of those entries bitwise; IndexIVFPQR keeps its refine codes
    aligned."""
    xb, xq = data
    pq = l2_built[1]
    port = port_pq8(pq)
    port.nprobe = pq.nprobe = 4
    port.search(xq, K)  # stage the big-batch layout first
    rs = np.random.RandomState(6)
    gone = rs.choice(NB, NB // 10, replace=False)
    if op == "remove":
        port.remove_ids(ftt.IDSelectorBatch(gone))
    elif op == "merge":
        port.remove_ids(ftt.IDSelectorBatch(gone))
        other = port_pq8(pq)
        other.remove_ids(ftt.IDSelectorNot(ftt.IDSelectorBatch(gone)))
        port.merge_from(other, add_id=10 * NB)
    else:
        port.update_vectors(gone, mixture(rs, len(gone)))
    assert port._brute is None
    ref = ftj.IndexIVFPQ(pq.quantizer, D, NLIST, M, 8)
    ref.pq = pq.pq
    ref.is_trained = True
    ref._codes_host = port._codes_host.copy()
    ref._listnos_host = port._listnos_host.copy()
    ref._ids_host = port._ids_host.copy()
    ref.ntotal = port.ntotal
    ref.nprobe = 4
    Dj, Ij = ref.search(xq, K)  # its XLA ADC scan on the CPU
    Dt, It = port.search(xq, K)
    assert port._brute is not None  # the big batch ran
    if op != "update":
        assert not np.isin(It, gone).any()
    if op == "merge":
        assert np.isin(gone + 10 * NB, port._ids_host).all()
    agree(Dj, Ij, Dt, It, tol_of(xq, xb))
    # 4-bit (K4) and IndexIVFPQR over the same entries
    rs4 = np.random.RandomState(7)
    codes4 = rs4.randint(16, size=(NB, M)).astype(np.uint8)
    cb4 = rs4.rand(M, 16, D // M).astype(np.float32)
    fs = ivfpq_from_arrays(pq.quantizer.vectors(), cb4, codes4, pq._listnos_host,
                           pq._ids_host, device="cpu")
    fs.nprobe = 4
    fs.search(xq, K)
    if op == "update":
        fs.update_vectors(gone, mixture(rs4, len(gone)))
    else:
        fs.remove_ids(ftt.IDSelectorBatch(gone))
    fresh = ivfpq_from_arrays(pq.quantizer.vectors(), cb4, fs._codes_host,
                              fs._listnos_host, fs._ids_host, device="cpu")
    fresh.nprobe = 4
    for a, b in zip(fs.search(xq, K), fresh.search(xq, K)):
        np.testing.assert_array_equal(a, b)


def test_ivfpqr_mutation_keeps_refine_codes(data, l2_built):
    xb, xq = data
    pq = l2_built[1]
    pqr = ftt.IndexIVFPQR(None, D, NLIST, M, 8, M, 8, device="cpu")
    pqr.quantizer.add(pq.quantizer.vectors())
    pqr.is_trained = True
    pqr.pq.set_centroids(pq.pq.centroids)
    pqr.refine_pq.set_centroids(pq.pq.centroids)
    pqr.add(xb)
    gone = np.arange(0, NB, 7)
    pqr.remove_ids(ftt.IDSelectorBatch(gone))
    other = ftt.IndexIVFPQR(pqr.quantizer, D, NLIST, M, 8, M, 8, device="cpu")
    other.pq.set_centroids(pq.pq.centroids)
    other.refine_pq.set_centroids(pq.pq.centroids)
    other.is_trained = True
    other.add_with_ids(xb[gone], gone)
    pqr.merge_from(other)
    pqr.update_vectors(gone[:20], xb[gone[:20]])
    whole = ftt.IndexIVFPQR(pqr.quantizer, D, NLIST, M, 8, M, 8, device="cpu")
    whole.pq.set_centroids(pq.pq.centroids)
    whole.refine_pq.set_centroids(pq.pq.centroids)
    whole.is_trained = True
    whole.add(xb)
    slots = pqr._slots_of_ids(whole._ids_host)
    np.testing.assert_array_equal(pqr._codes_host[slots], whole._codes_host)
    np.testing.assert_array_equal(pqr._refine_codes[slots], whole._refine_codes)
    pqr.nprobe = whole.nprobe = 4
    Dp, Ip = pqr.search(xq[:40], K)
    Dw, Iw = whole.search(xq[:40], K)
    agree(Dw, Iw, Dp, Ip, tol_of(xq[:40], xb))
