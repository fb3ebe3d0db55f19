"""Port parity for the rest of IVF-PQ search: the per-probe ADC scan
(ops/ivf_ops.ivf_pq_scan; small batches, ``max_codes``, ``by_residual =
False``, ``search_preassigned``), the XLA ADC scan (ops/pq_ops.
ivfpq_brute_adc_knn; unrefined k > 128 and 8-bit PQ), IndexRefineFlat over
8-bit PQ (without a decoded store, small batches, k * k_factor > 128: the
base's own search, then the re-rank), and IndexIVFPQR. Each port index is built from the arrays
of a trained faiss_tpu index (faiss_tpu_torch.convert), so the comparison
does not depend on k-means RNG; 8-bit PQ (IndexIVFPQ), 4-bit PQ
(IndexIVFPQFastScan), a non-residual 8-bit PQ and IndexIVFPQR share one
coarse quantizer.

Tolerances. The per-probe scans sum the same float32 table entries in the
same order, but their coarse distances ||q||^2 + ||c||^2 - 2 q.c come from
two float32 expansions whose rounding scales with the norms: distances
within 2e-6 * (|q|^2 + max ||x||^2) and ids up to ties at it (4-bit codes
tie exactly within a list). faiss_tpu's XLA scan selects with
``approx_min_k`` capped at 32 candidates per chunk, so the port (exact) is
held to it only for k <= 32, and above that to a float64 ADC of the same
bf16 LUTs and inputs over the probed lists: distances within
1e-5 * (|q|^2 + max n2), the size of float32's error on the norm expansion,
and ids up to ties at it. Re-ranked distances are exact float32 on both
sides, checked at the same tolerance."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import faiss_tpu as ftj
import faiss_tpu_torch as ftt
from faiss_tpu.ops import ivf_ops as ref_ivf
from faiss_tpu.ops import pq_ops as ref_pq
from faiss_tpu_torch.convert import (
    ivfflat_from_arrays,
    ivfpq_from_arrays,
    ivfpqr_from_arrays,
)
from faiss_tpu_torch.ops import ivf_ops as port_ivf
from faiss_tpu_torch.ops import pq_ops as port_pq
from faiss_tpu_torch.utils.evaluation import ids_agree_tie_aware
from torch_threads import one_torch_thread  # noqa: F401

D, NLIST, NB, NQ, M = 16, 64, 3000, 128, 4


def mixture(rs, n, ncent=64, d=D):
    """Small Gaussian mixture in the shape of bench.py's generator."""
    cent = np.random.RandomState(99).rand(ncent, d).astype(np.float32)
    scales = (1.0 / (np.arange(d) + 1.0)).astype(np.float32) * 0.4
    a = rs.randint(ncent, size=n)
    return (cent[a] + rs.randn(n, d).astype(np.float32) * scales).astype(np.float32)


def port_of(ref, **kw):
    return ivfpq_from_arrays(
        ref.quantizer.vectors(), ref.pq.centroids, ref._codes_host,
        ref._listnos_host, ref._ids_host, device="cpu", **kw,
    )


@pytest.fixture(scope="module")
def built():
    rs = np.random.RandomState(31)
    xb, xq = mixture(rs, NB), mixture(rs, NQ)
    refs = {"pq8": ftj.IndexIVFPQ(None, D, NLIST, M, 8)}
    refs["pq8"].cp.niter = 4
    refs["pq8"].cp.min_points_per_centroid = 1
    refs["pq8"].train(xb)
    quantizer = refs["pq8"].quantizer
    refs["fs4"] = ftj.IndexIVFPQFastScan(quantizer, D, NLIST, M, 4)
    refs["nores"] = ftj.IndexIVFPQ(quantizer, D, NLIST, M, 8)
    refs["nores"].by_residual = False
    refs["pqr"] = ftj.IndexIVFPQR(quantizer, D, NLIST, M, 8, 8, 8)
    for name in ("fs4", "nores", "pqr"):
        refs[name].train(xb)
    for ref in refs.values():
        ref.add(xb)
    ports = {name: port_of(refs[name]) for name in ("pq8", "fs4")}
    ports["nores"] = port_of(refs["nores"], by_residual=False)
    r = refs["pqr"]
    ports["pqr"] = ivfpqr_from_arrays(
        r.quantizer.vectors(), r.pq.centroids, r._codes_host, r._listnos_host,
        r._ids_host, r.refine_pq.centroids, r._refine_codes, device="cpu",
    )
    return refs, ports, xb, xq


def set_both(monkeypatch, a, b, **attrs):
    for index in (a, b):
        for name, value in attrs.items():
            monkeypatch.setattr(index, name, value)


def exact_agree(Dj, Ij, Dt, It, xq, xb):
    """Two results of the same float32 arithmetic on the queries ``xq``
    (see the docstring)."""
    assert Dt.dtype == np.float32 and It.dtype == np.int64
    np.testing.assert_array_equal(Ij == -1, It == -1)
    fin = np.isfinite(Dj)
    tol = 2e-6 * ((xq.astype(np.float64) ** 2).sum(1)
                  + (xb.astype(np.float64) ** 2).sum(1).max())
    assert ids_agree_tie_aware(np.where(fin, Dj, 1e30), Ij,
                               np.where(fin, Dt, 1e30), It, tol).all()
    assert (np.abs(np.where(fin, Dt - Dj, 0)) <= tol[:, None]).all()


def test_adc_tables_and_gather_match_reference(built):
    refs, _, _, xq = built
    cb = refs["pq8"].pq.centroids
    got = port_pq.pq_distance_tables(torch.from_numpy(xq), torch.from_numpy(cb))
    want = np.asarray(ref_pq.pq_distance_tables(xq, cb))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    codes = np.random.RandomState(2).randint(256, size=(50, M)).astype(np.uint8)
    np.testing.assert_allclose(
        port_pq.adc_scores_gather(got, torch.from_numpy(codes)).numpy(),
        np.asarray(ref_pq.adc_scores_gather(jnp.asarray(want), jnp.asarray(codes))),
        rtol=1e-5, atol=1e-4,
    )
    oh = port_pq.codes_onehot(torch.from_numpy(codes), 256)
    np.testing.assert_array_equal(
        oh.float().numpy(),
        np.asarray(ref_pq.codes_onehot(codes, 256)).astype(np.float32),
    )


def test_ivf_pq_scan_matches_reference(built):
    """ivf_pq_scan over the port's CSR layout (each list's codes and slots
    equal to the valid part of faiss_tpu's padded layout), with the
    precomputed tables and -1 probes, against faiss_tpu's scan over its
    padded layout on the same inputs."""
    refs, ports, xb, xq = built
    ref, port = refs["pq8"], ports["pq8"]
    dj, dt = ref._build_device(), port._build_device()
    lists = dt["lists"]
    lengths = np.asarray(dj["lengths"])
    np.testing.assert_array_equal(lists.lengths.numpy(), lengths)
    codes_j, slots_j = np.asarray(dj["codes"]), np.asarray(dj["slot_ids"])
    for c in range(port.nlist):
        o, n = int(lists.offsets[c]), int(lengths[c])
        np.testing.assert_array_equal(lists.codes[o : o + n].numpy(),
                                      codes_j[c, :n])
        np.testing.assert_array_equal(lists.slot_ids[o : o + n].numpy(),
                                      slots_j[c, :n])
    dis, probes = port._coarse_search(torch.from_numpy(xq), 6)
    probes[::3, 4:] = -1
    term2 = port._maybe_term2()
    np.testing.assert_allclose(term2.numpy(), np.asarray(ref._maybe_term2()),
                               rtol=1e-6, atol=1e-6)
    luts = -2.0 * port_pq.pq_ip_tables(torch.from_numpy(xq), port.pq._dev())
    Dj, Sj = map(np.asarray, ref_ivf.ivf_pq_scan(
        luts.numpy(), probes.numpy().astype(np.int32), dis.numpy(),
        dj["codes"], dj["slot_ids"], dj["lengths"], 20, term2=term2.numpy(),
    ))
    Dt, St = port_ivf.ivf_pq_scan(luts, probes, dis, lists, 20, term2=term2)
    exact_agree(Dj, Sj.astype(np.int64), Dt.numpy(), St.numpy().astype(np.int64),
                xq, xb)


@pytest.mark.parametrize("which", ["pq8", "fs4", "nores"])
def test_small_batch_scans_by_probe_like_reference(built, which, monkeypatch):
    """Fewer than big_batch_threshold queries: the per-probe ADC scan in both
    packages (by residual with the precomputed tables, or, for the
    non-residual index, with the full distance tables)."""
    refs, ports, xb, xq = built
    ref, port = refs[which], ports[which]
    set_both(monkeypatch, ref, port, nprobe=5)
    monkeypatch.setattr(port, "_search_big_batch", None)  # must not be taken
    Dj, Ij = ref.search(xq[:100], 10)
    Dt, It = port.search(xq[:100], 10)
    exact_agree(Dj, Ij, Dt, It, xq[:100], xb)


def test_non_residual_big_batch_scans_by_probe(built, monkeypatch):
    """by_residual=False sends even a big batch to the per-probe scan, as
    faiss_tpu's use_big does (ivf_pq.py:1688-1697)."""
    refs, ports, xb, xq = built
    ref, port = refs["nores"], ports["nores"]
    set_both(monkeypatch, ref, port, nprobe=3)
    monkeypatch.setattr(port, "_search_big_batch", None)
    Dj, Ij = ref.search(xq, 10)
    Dt, It = port.search(xq, 10)
    exact_agree(Dj, Ij, Dt, It, xq, xb)
    with pytest.raises(NotImplementedError, match="by probe"):
        port._build_brute()


@pytest.mark.parametrize("how", ["attribute", "params"])
def test_max_codes_matches_reference(built, how, monkeypatch):
    """max_codes stops probing once the lists probed so far hold that many
    codes; a big batch then scans by probe too."""
    refs, ports, xb, xq = built
    ref, port = refs["fs4"], ports["fs4"]
    set_both(monkeypatch, ref, port, nprobe=8)
    params = None
    if how == "attribute":
        set_both(monkeypatch, ref, port, max_codes=100)
        Dj, Ij = ref.search(xq, 10)
    else:
        Dj, Ij = ref.search(xq, 10, params=ftj.SearchParametersIVF(max_codes=100))
        params = ftt.SearchParametersIVF(max_codes=100)
    monkeypatch.setattr(port, "_search_big_batch", None)
    Dt, It = port.search(xq, 10, params=params)
    exact_agree(Dj, Ij, Dt, It, xq, xb)


def test_search_preassigned_matches_reference(built):
    """The coarse distances handed in are the per-probe scan's bias."""
    refs, ports, xb, xq = built
    ref, port = refs["pq8"], ports["pq8"]
    dis, assign = ref.quantizer.search(xq, 4)
    assign[:10, 2:] = -1
    Dj, Ij = ref.search_preassigned(xq, 10, assign, dis)
    Dt, It = port.search_preassigned(xq, 10, assign, dis)
    exact_agree(Dj, Ij, Dt, It, xq, xb)
    # the bias moves every distance of a probe by its coarse distance
    Dz, _ = port.search_preassigned(xq, 10, assign[:, :1], np.zeros_like(dis[:, :1]))
    Dd, _ = port.search_preassigned(xq, 10, assign[:, :1], dis[:, :1])
    fin = np.isfinite(Dz)
    np.testing.assert_allclose(Dd[fin] - Dz[fin],
                               np.broadcast_to(dis[:, :1], Dz.shape)[fin],
                               rtol=1e-4, atol=1e-4)


def float64_adc(port, xq, nprobe, k):
    """float64 ADC of the XLA scan's inputs (bf16-rounded LUTs, coarse
    products, per-slot norms) over each query's nprobe nearest lists: the
    k best (distances, slots) per query, and the key of every slot."""
    br = port._build_brute()
    x = torch.from_numpy(xq).double()
    cent = br["centroids"].double()
    luts = (-2.0 * port_pq.pq_ip_tables(torch.from_numpy(xq), port.pq._dev()))
    luts = luts.to(torch.bfloat16).double()
    codes = br["codes"].long()
    ip = sum(luts[:, m, :][:, codes[:, m]] for m in range(codes.shape[1]))
    coarse = x @ cent.T
    keys = (x.square().sum(1)[:, None] + br["n2"].double()[None]
            - 2.0 * coarse[:, br["listnos"]] + ip)
    probed = torch.topk(cent.square().sum(1)[None] - 2.0 * coarse, nprobe,
                        largest=False).indices
    inl = (br["listnos"][None, None, :] == probed[:, :, None]).any(1)
    masked = torch.where(inl, keys, torch.inf)
    d, s = torch.sort(masked, dim=1, stable=True)
    d, s = d[:, :k].numpy(), s[:, :k].numpy()
    return d, np.where(np.isinf(d), -1, s), keys.numpy(), br


@pytest.mark.parametrize("which, k", [("fs4", 150), ("pq8", 40)])
def test_xla_path_matches_float64(built, which, k, monkeypatch):
    """Unrefined k > 128 (4-bit: the one-hot product) and 8-bit PQ above
    k = 32 (table gathers) run the XLA ADC scan; held to float64 (see the
    docstring)."""
    _, ports, _, xq = built
    port = ports[which]
    nprobe = 8
    monkeypatch.setattr(port, "nprobe", nprobe)
    calls = []
    xla = port._big_batch_xla
    monkeypatch.setattr(port, "_big_batch_xla",
                        lambda *a: calls.append(a[1]) or xla(*a))
    Dt, It = port.search(xq, k)
    assert calls == [k]
    d64, s64, keys, br = float64_adc(port, xq, nprobe, k)
    qn2 = (xq.astype(np.float64) ** 2).sum(1)
    tol = 1e-5 * (qn2 + float(br["n2"].max()))
    np.testing.assert_array_equal(It == -1, s64 == -1)
    fin = It >= 0
    slots = port._slots_of_ids(It[fin])
    err = np.abs(Dt[fin] - keys[np.where(fin)[0], slots])
    assert (err <= np.broadcast_to(tol[:, None], It.shape)[fin]).all()
    assert ids_agree_tie_aware(np.where(fin, d64, 1e30), port._ids_host[np.maximum(s64, 0)],
                               np.where(fin, Dt, 1e30), It, tol).all()


def test_8bit_unrefined_matches_reference(built, monkeypatch):
    """8-bit PQ at k <= 32: both take their XLA ADC scan, exact here."""
    refs, ports, _, xq = built
    ref, port = refs["pq8"], ports["pq8"]
    set_both(monkeypatch, ref, port, nprobe=4)
    Dj, Ij = ref.search(xq, 10)
    Dt, It = port.search(xq, 10)
    n2max = float(port._build_brute()["n2"].max())
    tol = 1e-5 * ((xq.astype(np.float64) ** 2).sum(1) + n2max)
    np.testing.assert_array_equal(Ij == -1, It == -1)
    fin = np.isfinite(Dj)
    assert ids_agree_tie_aware(np.where(fin, Dj, 1e30), Ij, np.where(fin, Dt, 1e30),
                               It, tol).all()
    assert (np.abs(np.where(fin, Dt - Dj, 0)) <= tol[:, None]).all()


@pytest.mark.parametrize("case", ["no_store_8bit", "small_batch", "many_candidates"])
def test_refined_8bit_matches_reference(built, case, monkeypatch):
    """IndexRefineFlat over 8-bit PQ: without a decoded store (no kernel
    reads 8-bit codes), with a small batch and with k * k_factor > 128 the
    base's own search gives the candidates (the XLA ADC scan at 128 queries,
    k * k_factor = 32, where faiss_tpu's capped select is exact) and
    IndexRefine re-ranks them at submit."""
    refs, ports, xb, xq = built
    kf = 20 if case == "many_candidates" else 4
    k = 10 if case == "many_candidates" else 8
    nq = 100 if case == "small_batch" else NQ
    refb = refs["pq8"]
    ref = ftj.IndexRefineFlat(refb, xb)
    port = ftt.IndexRefineFlat(ports["pq8"], xb)
    set_both(monkeypatch, refb, port.base_index, nprobe=4,
             recon_scan_max_bytes=0, _brute=None)
    monkeypatch.setattr(refb, "fused_interpret", True)
    for index in (ref, port):
        index.k_factor = kf
    Dj, Ij = ref.search(xq[:nq], k)
    handle = port.search_submit(xq[:nq], k)
    assert handle[0] == "eager"  # answered at submit
    Dt, It = port.search_collect(handle)
    exact_agree(Dj, Ij, Dt, It, xq[:nq], xb)


@pytest.mark.parametrize("nq", [100, NQ])
def test_ivfpqr_matches_reference(built, nq, monkeypatch):
    """IndexIVFPQR: by probe (100 queries) and through the 8-bit XLA scan
    (128), with k * k_factor = 32 candidates re-ranked against the refined
    reconstruction."""
    refs, ports, xb, xq = built
    ref, port = refs["pqr"], ports["pqr"]
    set_both(monkeypatch, ref, port, nprobe=4)
    Dj, Ij = ref.search(xq[:nq], 8)
    Dt, It = port.search(xq[:nq], 8)
    exact_agree(Dj, Ij, Dt, It, xq[:nq], xb)
    # the distances are those to the refined reconstruction, in float64
    fin = It >= 0
    slots = port._slots_of_ids(It[fin])
    rec = (port.decode_vectors(port._codes_host[slots], port._listnos_host[slots])
           .astype(np.float64)
           + port.refine_pq.decode_int(port._refine_codes[slots]))
    q = np.broadcast_to(xq[:nq, None, :], It.shape + (D,))[fin]
    np.testing.assert_allclose(Dt[fin], ((rec - q) ** 2).sum(1), rtol=1e-5, atol=1e-5)


def test_ivfpqr_train_add_search_on_its_own():
    """The port's own IndexIVFPQR: the refine PQ trains on what the IVF-PQ
    leaves, so the refined reconstruction is closer than the IVF-PQ one, and
    searches return valid results."""
    rs = np.random.RandomState(41)
    xb, xq = mixture(rs, 2000), mixture(rs, 40)
    index = ftt.IndexIVFPQR(None, D, 32, M, 8, 8, 8, device="cpu")
    index.cp.niter = 4
    index.cp.min_points_per_centroid = 1
    index.train(xb)
    index.add(xb[:1200])
    index.add(xb[1200:])
    assert index.ntotal == 2000 and index._refine_codes.shape == (2000, 8)
    base = index.decode_vectors(index._codes_host, index._listnos_host)
    refined = base + index.refine_pq.decode_int(index._refine_codes)
    assert ((refined - xb) ** 2).sum(1).mean() < 0.5 * ((base - xb) ** 2).sum(1).mean()
    index.nprobe = 4
    Dq, Iq = index.search(xq, 5)
    assert (Iq >= 0).all() and (np.diff(Dq, axis=1) >= 0).all()
    with pytest.raises(ValueError, match="refine code"):
        index.add_encoded(index._codes_host[:3], index._listnos_host[:3])
    index.reset()
    assert index.ntotal == 0 and index._refine_codes is None


def test_ivfflat_per_probe_scan_ignores_coarse_distances(built):
    """IndexIVF passes each probe's coarse distance to the codec's scan;
    IVF-Flat's exact scan does not use it, so its results do not change."""
    refs, _, xb, xq = built
    ref = refs["pq8"]
    flat = ivfflat_from_arrays(ref.quantizer.vectors(), xb, ref._listnos_host,
                               ref._ids_host, device="cpu")
    flat.nprobe = 4
    D0, I0 = flat.search(xq[:64], 10)
    dis, assign = flat._coarse_search(torch.from_numpy(xq[:64]), 4)
    for cd in (dis.numpy(), np.zeros_like(dis.numpy())):
        Dp, Ip = flat.search_preassigned(xq[:64], 10, assign.numpy(), cd)
        np.testing.assert_array_equal(Ip, I0)
        np.testing.assert_array_equal(Dp, D0)
    exact_agree(*ftj.IndexIVFFlat.search(_ref_flat(ref, xb), xq[:64], 10), D0, I0,
                xq[:64], xb)


def _ref_flat(ref, xb):
    index = ftj.IndexIVFFlat(ref.quantizer, D, NLIST)
    index.nprobe = 4
    index.add_core(xb, None, ref._listnos_host)
    return index


@pytest.mark.parametrize("what", ["polysemous_ht", "polysemous_training", "selector"])
def test_still_unported_options_raise(built, what, monkeypatch):
    """The options that once raised now run. The polysemous filter of the
    per-probe scan equals faiss_tpu's (and drops candidates);
    do_polysemous_training permutes the port's trained codebooks exactly as
    faiss_tpu's PolysemousTraining permutes the same codebooks; ID
    selectors: search_preassigned with a selector equals faiss_tpu's, and
    returns only selected ids."""
    refs, _, xb, xq = built
    port = port_of(refs["pq8"])
    if what == "selector":
        assign = np.random.RandomState(3).randint(NLIST, size=(10, 2))
        cdis = np.random.RandomState(4).rand(10, 2).astype(np.float32)
        Dj, Ij = refs["pq8"].search_preassigned(
            xq[:10], 5, assign, cdis,
            params=ftj.SearchParametersIVF(sel=ftj.IDSelectorRange(0, NB // 2)))
        Dt, It = port.search_preassigned(
            xq[:10], 5, assign, cdis,
            params=ftt.SearchParametersIVF(sel=ftt.IDSelectorRange(0, NB // 2)))
        assert ((It >= -1) & (It < NB // 2)).all()
        exact_agree(Dj, Ij, Dt, It, xq[:10], xb)
        return
    if what == "polysemous_ht":
        set_both(monkeypatch, refs["pq8"], port, nprobe=4, polysemous_ht=13)
        Dj, Ij = refs["pq8"].search(xq[:10], 5)
        Dt, It = port.search(xq[:10], 5)
        exact_agree(Dj, Ij, Dt, It, xq[:10], xb)
        port.polysemous_ht = 0
        assert not np.array_equal(port.search(xq[:10], 5)[1], It)
        return
    from faiss_tpu.codecs.polysemous import PolysemousTraining as PolyJ
    from faiss_tpu.codecs.pq import ProductQuantizer as PQJ

    trained = []
    for poly in (False, True):
        index = port_of(refs["pq8"])
        index.do_polysemous_training = poly
        index.polysemous_training = ftt.PolysemousTraining()
        index.polysemous_training.n_iter = 300
        index.train(xb)
        trained.append(index.pq.centroids)
    pj = PQJ(D, M, 8)
    pj.centroids = trained[0].copy()
    pt = PolyJ()
    pt.n_iter = 300
    pt.optimize_pq_for_hamming(pj)
    assert not np.array_equal(trained[1], trained[0])
    np.testing.assert_array_equal(trained[1], pj.centroids)
