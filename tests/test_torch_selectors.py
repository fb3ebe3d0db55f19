"""Port parity for ID selectors: every selector's mask against faiss_tpu's,
selectors in the searches of the flat, IVF-Flat and IVF-PQ indexes (the
masked k-NN; by probe and preassigned), IndexIDMap and IndexIDMap2 over
flat and IVF-Flat with the selector translated to their ids, and
IndexIVFStats. Port indexes serve the state of trained faiss_tpu indexes
(faiss_tpu_torch.convert), so the comparison does not depend on k-means
RNG.

Tolerances: distances within 1e-5 * (|q|^2 + max |y|^2), the size of
float32's error on the norm expansion; ids agree up to ties at it (the
IVF-PQ scans sum the same float32 table entries in the same order and are
held to the same bound)."""

import numpy as np
import pytest
import torch

import faiss_tpu as ftj
import faiss_tpu_torch as ftt
from faiss_tpu_torch.convert import (
    flat_from_arrays,
    idmap_from_arrays,
    ivfflat_from_arrays,
    ivfpq_from_arrays,
)
from faiss_tpu_torch.utils.evaluation import ids_agree_tie_aware
from torch_threads import one_torch_thread  # noqa: F401

D, NLIST, NB, NQ, M, K = 16, 32, 3000, 128, 4, 10


def mixture(rs, n, ncent=64, d=D):
    """Small Gaussian mixture in the shape of bench.py's generator."""
    cent = np.random.RandomState(99).rand(ncent, d).astype(np.float32)
    scales = (1.0 / (np.arange(d) + 1.0)).astype(np.float32) * 0.4
    a = rs.randint(ncent, size=n)
    return (cent[a] + rs.randn(n, d).astype(np.float32) * scales).astype(np.float32)


def selector_pairs():
    """(name, faiss_tpu selector, port selector) of every selector kind."""
    rs = np.random.RandomState(3)
    arr = rs.choice(NB, 700, replace=False)
    bitmap = (rs.rand((NB + 7) // 8 - 10) * 256).astype(np.uint8)
    pairs = []
    for lib, name in ((ftj, "ftj"), (ftt, "ftt")):
        rng = lib.IDSelectorRange(200, 1900)
        arr_s = lib.IDSelectorArray(arr)
        pairs.append({
            "range": rng,
            "array": arr_s,
            "batch": lib.IDSelectorBatch(arr[::2]),
            "empty_array": lib.IDSelectorArray([]),
            "bitmap": lib.IDSelectorBitmap(bitmap),
            "not": lib.IDSelectorNot(rng),
            "and": lib.IDSelectorAnd(rng, arr_s),
            "or": lib.IDSelectorOr(lib.IDSelectorRange(0, 100), arr_s),
            "xor": lib.IDSelectorXOr(rng, arr_s),
            "all": lib.IDSelectorAll(),
        })
    return [(k, pairs[0][k], pairs[1][k]) for k in pairs[0]]


SELECTORS = selector_pairs()
SEL_IDS = [s[0] for s in SELECTORS]


@pytest.mark.parametrize("i", range(len(SELECTORS)), ids=SEL_IDS)
def test_selector_masks_match_reference(i):
    """mask_for_ids equals faiss_tpu's bitwise, ids below 0 and past the
    bitmap included; is_member agrees."""
    _, sj, st = SELECTORS[i]
    ids = np.concatenate([np.arange(-5, NB + 40), [2**40, -2**40]]).astype(np.int64)
    mj, mt = sj.mask_for_ids(ids), st.mask_for_ids(ids)
    assert mt.dtype == bool and mt.shape == ids.shape
    np.testing.assert_array_equal(mt, mj)
    for j in (0, 150, 250, NB - 1):
        assert st.is_member(j) == sj.is_member(j)


@pytest.fixture(scope="module")
def built():
    rs = np.random.RandomState(41)
    xb, xq = mixture(rs, NB), mixture(rs, NQ)
    ivf = ftj.IndexIVFFlat(None, D, NLIST)
    ivf.cp.niter = 4
    ivf.cp.min_points_per_centroid = 1
    ivf.train(xb)
    ivf.add(xb)
    pq = ftj.IndexIVFPQ(ivf.quantizer, D, NLIST, M, 8)
    pq.train(xb)
    pq.add(xb)
    ports = {
        "flat": flat_from_arrays(xb, device="cpu"),
        "ivfflat": ivfflat_from_arrays(ivf.quantizer.vectors(), ivf._codes_host,
                                       ivf._listnos_host, ivf._ids_host,
                                       device="cpu"),
        "ivfpq": ivfpq_from_arrays(ivf.quantizer.vectors(), pq.pq.centroids,
                                   pq._codes_host, pq._listnos_host,
                                   pq._ids_host, device="cpu"),
    }
    flat = ftj.IndexFlatL2(D)
    flat.add(xb)
    refs = {"flat": flat, "ivfflat": ivf, "ivfpq": pq}
    for name in ("ivfflat", "ivfpq"):
        refs[name].nprobe = ports[name].nprobe = 4
    return refs, ports, xb, xq


def tol_of(xq, xb):
    return 1e-5 * ((xq.astype(np.float64) ** 2).sum(1)
                   + (xb.astype(np.float64) ** 2).sum(1).max())


def agree(Dj, Ij, Dt, It, tol):
    assert Dt.dtype == np.float32 and It.dtype == np.int64
    np.testing.assert_array_equal(Ij == -1, It == -1)
    fin = np.isfinite(Dj)
    np.testing.assert_array_equal(fin, np.isfinite(Dt))
    assert (np.abs(np.where(fin, Dt - Dj, 0)) <= tol[:, None]).all()
    ok = ids_agree_tie_aware(np.where(fin, Dj, 1e30), Ij,
                             np.where(fin, Dt, 1e30), It, tol)
    assert ok.all(), np.where(~ok)


def selected(sel_t, I):
    ids = I[I >= 0]
    return bool(sel_t.mask_for_ids(ids).all())


@pytest.mark.parametrize("which", ["flat", "ivfflat", "ivfpq"])
@pytest.mark.parametrize("sel", ["range", "batch", "not", "bitmap"])
def test_search_with_selector_matches_reference(built, which, sel):
    """A selector in params: the masked plain k-NN for flat, the scan by
    probe for IVF (its big-batch gate closes to selectors), each against
    faiss_tpu's with the same selector; every returned id is selected."""
    refs, ports, xb, xq = built
    _, sj, st = SELECTORS[SEL_IDS.index(sel)]
    cls_j = ftj.SearchParameters if which == "flat" else ftj.SearchParametersIVF
    cls_t = ftt.SearchParameters if which == "flat" else ftt.SearchParametersIVF
    Dj, Ij = refs[which].search(xq, K, params=cls_j(sel=sj))
    Dt, It = ports[which].search(xq, K, params=cls_t(sel=st))
    assert selected(st, It)
    agree(Dj, Ij, Dt, It, tol_of(xq, xb))


def test_flat_selector_avoids_kernel_paths(built, monkeypatch):
    """With a selector the flat search never takes the screen, stripes or
    K3, even where its store is large enough for them."""
    _, ports, xb, xq = built
    port = ports["flat"]
    monkeypatch.setattr(port, "PALLAS_MIN_NB", 1024)

    def refuse(*a, **kw):
        raise AssertionError("a kernel path ran with a selector")

    monkeypatch.setattr(port, "_search_fused", refuse)
    st = ftt.IDSelectorRange(0, 500)
    Dt, It = port.search(xq, K, params=ftt.SearchParameters(sel=st))
    assert selected(st, It) and (It >= 0).all()
    d64 = ((xq[:, None, :].astype(np.float64) - xb[None, :500]) ** 2).sum(-1)
    want = np.sort(d64, 1)[:, :K]
    assert (np.abs(Dt - want) <= tol_of(xq, xb)[:, None]).all()


def test_selector_keeping_fewer_than_k(built):
    """A selector that keeps fewer than k rows: the rest is -1 and +inf."""
    refs, ports, _, xq = built
    ids = [5, 17, 2900]
    for which in ("flat", "ivfflat"):
        cls = ftt.SearchParameters if which == "flat" else ftt.SearchParametersIVF
        p = cls(sel=ftt.IDSelectorArray(ids))
        if which == "ivfflat":
            p.nprobe = NLIST
        Dt, It = ports[which].search(xq[:8], K, params=p)
        assert (It[:, :3] >= 0).all() and (It[:, 3:] == -1).all()
        assert np.isinf(Dt[:, 3:]).all()
        assert np.isin(It[:, :3], ids).all()


@pytest.mark.parametrize("which", ["ivfflat", "ivfpq"])
def test_search_preassigned_with_selector_matches_reference(built, which):
    refs, ports, xb, xq = built
    _, sj, st = SELECTORS[SEL_IDS.index("xor")]
    dis, assign = ports[which]._coarse_search(torch.from_numpy(xq), 6)
    assign, dis = assign.numpy(), dis.numpy()
    assign[::4, 3:] = -1
    Dj, Ij = refs[which].search_preassigned(
        xq, K, assign, dis, params=ftj.SearchParametersIVF(sel=sj))
    Dt, It = ports[which].search_preassigned(
        xq, K, assign, dis, params=ftt.SearchParametersIVF(sel=st))
    assert selected(st, It)
    agree(Dj, Ij, Dt, It, tol_of(xq, xb))


@pytest.mark.parametrize("inner", ["flat", "ivfflat"])
@pytest.mark.parametrize("two", [False, True], ids=["IDMap", "IDMap2"])
def test_idmap_matches_reference(built, inner, two):
    """IndexIDMap(2) over flat and IVF-Flat with non-sequential 64-bit ids:
    searches translate through id_map; a selector over the external ids is
    translated; IndexIDMap2 reconstructs by id; remove_ids by external id
    leaves the rest findable."""
    refs, _, xb, xq = built
    rs = np.random.RandomState(7)
    ext = rs.permutation(NB).astype(np.int64) * 3 + (1 << 40)
    if inner == "flat":
        ij = ftj.IndexFlatL2(D)
        it = ftt.IndexFlatL2(D, device="cpu")
    else:
        ij = ftj.IndexIVFFlat(refs["ivfflat"].quantizer, D, NLIST)
        it = ivfflat_from_arrays(refs["ivfflat"].quantizer.vectors(),
                                 xb[:0], [], [], device="cpu")
        ij.nprobe = it.nprobe = 4
    mj = (ftj.IndexIDMap2 if two else ftj.IndexIDMap)(ij)
    mt = (ftt.IndexIDMap2 if two else ftt.IndexIDMap)(it)
    mj.add_with_ids(xb, ext)
    mt.add_with_ids(xb, ext)
    with pytest.raises(RuntimeError, match="add_with_ids"):
        mt.add(xb[:2])
    tol = tol_of(xq, xb)
    Dj, Ij = mj.search(xq, K)
    Dt, It = mt.search(xq, K)
    assert np.isin(It, ext).all()
    agree(Dj, Ij, Dt, It, tol)
    half = np.sort(ext)[NB // 2]
    cls_j = ftj.SearchParameters if inner == "flat" else ftj.SearchParametersIVF
    cls_t = ftt.SearchParameters if inner == "flat" else ftt.SearchParametersIVF
    Dj, Ij = mj.search(xq, K, params=cls_j(sel=ftj.IDSelectorRange(0, half)))
    Dt, It = mt.search(xq, K, params=cls_t(sel=ftt.IDSelectorRange(0, half)))
    assert ((It < half) | (It == -1)).all()
    agree(Dj, Ij, Dt, It, tol)
    if two:
        keys = ext[[0, 5, 2999]]
        want = xb[[0, 5, 2999]]
        np.testing.assert_array_equal(mt.reconstruct_batch(keys), want)
        np.testing.assert_array_equal(mt.reconstruct(int(keys[1])), want[1])
        with pytest.raises(KeyError):
            mt.reconstruct(12345)
    # remove a tenth of the ids by external id
    gone = ext[rs.choice(NB, NB // 10, replace=False)]
    assert mt.remove_ids(ftt.IDSelectorBatch(gone)) == len(gone)
    assert mt.ntotal == NB - len(gone) == len(mt.id_map)
    kept = ~np.isin(ext, gone)
    Dt, It = mt.search(xq, K)
    assert not np.isin(It, gone).any()
    fresh = (ftj.IndexIDMap2 if two else ftj.IndexIDMap)(
        ftj.IndexFlatL2(D) if inner == "flat"
        else ftj.IndexIVFFlat(refs["ivfflat"].quantizer, D, NLIST))
    if inner != "flat":
        fresh.index.nprobe = 4
    fresh.add_with_ids(xb[kept], ext[kept])
    agree(*fresh.search(xq, K), Dt, It, tol)
    if two:
        j = np.nonzero(kept)[0][-1]
        np.testing.assert_array_equal(mt.reconstruct(int(ext[j])), xb[j])


def test_idmap_from_arrays(built):
    refs, _, xb, xq = built
    ext = np.arange(NB, dtype=np.int64)[::-1] * 7
    mt = idmap_from_arrays(flat_from_arrays(xb, device="cpu"), ext, two=True)
    assert isinstance(mt, ftt.IndexIDMap2) and mt.ntotal == NB
    _, It = mt.search(xq[:5], 3)
    _, Ir = refs["flat"].search(xq[:5], 3)
    np.testing.assert_array_equal(It, ext[Ir])
    with pytest.raises(ValueError):
        idmap_from_arrays(flat_from_arrays(xb, device="cpu"), ext[:5])


def test_ivf_stats_count_the_search_by_probe(built):
    """IndexIVFStats counts nq in the search by probe, as faiss_tpu's
    does; reset clears it."""
    refs, ports, _, xq = built
    ftj.indexIVF_stats.reset()
    ftt.indexIVF_stats.reset()
    for lib, index in ((ftj, refs["ivfflat"]), (ftt, ports["ivfflat"])):
        index.search(xq[:50], K)
        index.search(xq[:7], K, params=lib.SearchParametersIVF(nprobe=2))
    ports["ivfpq"].search(xq[:20], K)
    refs["ivfpq"].search(xq[:20], K)
    assert ftt.indexIVF_stats.nq == ftj.indexIVF_stats.nq == 77
    ftt.indexIVF_stats.reset()
    assert ftt.indexIVF_stats.nq == 0 and ftt.indexIVF_stats.ndis == 0
    assert isinstance(ftt.indexIVF_stats, ftt.IndexIVFStats)
