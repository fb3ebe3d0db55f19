"""Port parity for the host shard compositions (IndexShards, IndexReplicas,
IndexShardsIVF in faiss_tpu_torch/models/meta.py), the IVF list tooling
(faiss_tpu_torch/ivflib.py) and the inverted lists
(faiss_tpu_torch/invlists.py) against faiss_tpu's, at small sizes. The port's
IVF indexes are built from the arrays of faiss_tpu's trained ones
(faiss_tpu_torch.convert), so both hold the same lists; one IVF-Flat is
trained per module and the IVF-PQ shares its coarse quantizer.

Tolerances: distances within 1e-5 of |q|^2 + max |x|^2 (the float32
rounding of the norm expansions, which the packages order differently);
ids equal up to ties at it. Entry stores, list contents and on-disk layouts
are compared exactly."""

import os

import numpy as np
import pytest

import faiss_tpu as ftj
import faiss_tpu.invlists as ref_il
import faiss_tpu.ivflib as ref_lib
import faiss_tpu_torch as ftt
from faiss_tpu.utils.datasets import SyntheticDataset
from faiss_tpu_torch import convert
from faiss_tpu_torch.utils.evaluation import ids_agree_tie_aware
from torch_threads import one_torch_thread  # noqa: F401

D_, NLIST, K, NPROBE = 32, 16, 10, 4


@pytest.fixture(scope="module")
def ds():
    d = SyntheticDataset(D_, 2000, 4000, 48)
    return d.get_train(), d.get_database(), d.get_queries()


@pytest.fixture(scope="module")
def refs(ds):
    """faiss_tpu IVF-Flat and IVF-PQ (M 4, 8 bits) over one quantizer."""
    xt, xb, _ = ds
    ivf = ftj.IndexIVFFlat(None, D_, NLIST)
    ivf.cp.niter = 4
    ivf.train(xt)
    ivf.add(xb)
    ivf.nprobe = NPROBE
    pq = ftj.IndexIVFPQ(ivf.quantizer, D_, NLIST, 4, 8)
    pq.pq.cp.niter = 4
    pq.train(xt)
    pq.add(xb)
    pq.nprobe = NPROBE
    return {"flat": ivf, "pq": pq}


def port_of(ref):
    if isinstance(ref, ftj.IndexIVFPQ):
        out = convert.ivfpq_from_arrays(
            ref.quantizer.vectors(), ref.pq.centroids, ref._codes_host,
            ref._listnos_host, ref._ids_host, device="cpu")
    else:
        out = convert.ivfflat_from_arrays(
            ref.quantizer.vectors(), ref._codes_host, ref._listnos_host,
            ref._ids_host, device="cpu")
    out.nprobe = ref.nprobe
    return out


def assert_same(res, ref, xq, xb):
    (D, I), (Dr, Ir) = res, ref
    tol = 1e-5 * ((xq.astype(np.float64) ** 2).sum(1)
                  + (xb.astype(np.float64) ** 2).sum(1).max())
    fin = np.isfinite(Dr)
    assert (np.isfinite(D) == fin).all()
    assert (np.abs(np.where(fin, D - Dr, 0)) <= tol[:, None]).all()
    assert ids_agree_tie_aware(np.where(fin, D, 0), I, np.where(fin, Dr, 0),
                               Ir, tol).all()


def assert_store_equal(port, ref):
    np.testing.assert_array_equal(port._ids_host, ref._ids_host)
    np.testing.assert_array_equal(port._listnos_host, ref._listnos_host)
    np.testing.assert_array_equal(port._codes_host, ref._codes_host)
    assert port.ntotal == ref.ntotal


# -- IndexShards / IndexReplicas / IndexShardsIVF ------------------------------


@pytest.mark.parametrize("largest", [False, True])
@pytest.mark.parametrize("as_tensor", [False, True])
def test_merge_result_tables(largest, as_tensor):
    """The shard merge on numpy tables and on torch tensors against
    faiss_tpu's (ties broken by shard order in both)."""
    import torch

    from faiss_tpu.models.meta import _merge_result_tables as ref_merge
    from faiss_tpu_torch.models.meta import _merge_result_tables

    rs = np.random.RandomState(1)
    Ds = [np.round(rs.randn(20, 7), 1).astype(np.float32) for _ in range(3)]
    Is = [rs.randint(0, 1000, size=(20, 7)).astype(np.int64) for _ in range(3)]
    Dr, Ir = ref_merge(Ds, Is, 10, largest)
    wrap = torch.from_numpy if as_tensor else np.asarray
    D, I = _merge_result_tables([wrap(d) for d in Ds], [wrap(i) for i in Is],
                                10, largest)
    D, I = np.asarray(D), np.asarray(I)
    np.testing.assert_array_equal(D, Dr)
    key = -Dr if largest else Dr
    assert (np.diff(key, axis=1) >= 0).all()
    # the ids of each distinct distance agree as sets (argpartition may
    # keep another of several ids tied at the k-th distance)
    for r in range(len(D)):
        for v in np.unique(Dr[r][Dr[r] != Dr[r, -1]]):
            assert set(I[r][D[r] == v]) == set(Ir[r][Dr[r] == v])


@pytest.mark.parametrize("successive_ids", [True, False])
@pytest.mark.parametrize("threaded", [False, True])
def test_index_shards_flat(ds, successive_ids, threaded):
    _, xb, xq = ds
    ref = ftj.IndexShards(D_, threaded=threaded, successive_ids=successive_ids)
    port = ftt.IndexShards(D_, threaded=threaded, successive_ids=successive_ids)
    for _ in range(3):
        ref.add_shard(ftj.IndexFlatL2(D_))
        port.add_shard(ftt.IndexFlatL2(D_, device="cpu"))
    ref.add(xb[:3001])  # uneven: 1001, 1000, 1000
    port.add(xb[:3001])
    assert port.ntotal == ref.ntotal == 3001 and port.count() == 3
    assert [s.ntotal for s in port.shards] == [1001, 1000, 1000]
    assert_same(port.search(xq, K), ref.search(xq, K), xq, xb)
    port.reset()
    assert port.ntotal == 0 and port.at(0).ntotal == 0


def test_index_shards_ivf_params(ds, refs):
    """Shards of IVF-Flat halves, nprobe through the search parameters."""
    _, xb, xq = ds
    ivf = refs["flat"]
    ref = ftj.IndexShards(D_)
    port = ftt.IndexShards(D_)
    for lo, hi in ((0, 2000), (2000, 4000)):
        r = ftj.IndexIVFFlat(ivf.quantizer, D_, NLIST)
        r.add(xb[lo:hi])
        ref.add_shard(r)
        port.add_shard(convert.ivfflat_from_arrays(
            ivf.quantizer.vectors(), xb[lo:hi], r._listnos_host,
            r._ids_host, device="cpu"))
    Dr, Ir = ref.search(xq, K, params=ftj.SearchParametersIVF(nprobe=NPROBE))
    D, I = port.search(xq, K, params=ftt.SearchParametersIVF(nprobe=NPROBE))
    assert_same((D, I), (Dr, Ir), xq, xb)
    # the unsharded index holds the same rows under the same ids
    assert_same((D, I), port_of(ivf).search(xq, K), xq, xb)


def test_index_replicas(ds):
    _, xb, xq = ds
    ref, port = ftj.IndexReplicas(D_), ftt.IndexReplicas(D_)
    for _ in range(3):
        ref.add_replica(ftj.IndexFlatL2(D_))
        port.add_replica(ftt.IndexFlatL2(D_, device="cpu"))
    ref.add(xb)
    port.add(xb)
    assert port.ntotal == len(xb) and port.count() == 3
    assert all(r.ntotal == len(xb) for r in port.replicas)
    D, I = port.search(xq[:47], K)  # 16, 16, 15 queries
    assert_same((D, I), ref.search(xq[:47], K), xq[:47], xb)
    single = ftt.IndexFlatL2(D_, device="cpu")
    single.add(xb)
    Ds, Is = single.search(xq[:47], K)
    np.testing.assert_array_equal(I, Is)
    np.testing.assert_array_equal(D, Ds)


@pytest.mark.parametrize("n_shards", [2, 3])
def test_index_shards_ivf(ds, refs, n_shards):
    _, xb, xq = ds
    ivf = refs["flat"]
    port_ivf = port_of(ivf)
    rsh = ref_lib.shard_ivf_index_centroids(ivf, n_shards)
    psh = ftt.shard_ivf_index_centroids(port_ivf, n_shards)
    for p, r in zip(psh, rsh):
        assert_store_equal(p, r)
        assert p._device is None and p.quantizer is port_ivf.quantizer
    ref = ftj.IndexShardsIVF(ivf.quantizer, D_, NLIST, nprobe=NPROBE)
    port = ftt.IndexShardsIVF(port_ivf.quantizer, D_, NLIST, nprobe=NPROBE)
    for p, r in zip(psh, rsh):
        ref.add_shard(r)
        port.add_shard(p)
    D, I = port.search(xq, K)
    assert_same((D, I), ref.search(xq, K), xq, xb)
    assert_same((D, I), port_ivf.search(xq, K), xq, xb)
    with pytest.raises(TypeError):
        port.add_shard(ftt.IndexFlatL2(D_, device="cpu"))


# -- ivflib ---------------------------------------------------------------------


def test_extract_index_ivf(refs):
    port_ivf = port_of(refs["flat"])
    wrapped = ftt.IndexIDMap(ftt.IndexPreTransform(port_ivf))
    assert ftt.extract_index_ivf(wrapped) is port_ivf
    assert ftt.try_extract_index_ivf(wrapped) is port_ivf
    flat = ftt.IndexFlatL2(D_, device="cpu")
    assert ftt.try_extract_index_ivf(flat) is None
    with pytest.raises(TypeError):
        ftt.extract_index_ivf(flat)


@pytest.mark.parametrize("shift_ids", [True, False])
def test_merge_into_and_add_preassigned(ds, refs, shift_ids):
    _, xb, xq = ds
    ivf = refs["flat"]
    ln = ivf._listnos_host
    pq_ = port_of(ivf).quantizer
    halves = []
    for lo, hi in ((0, 1500), (1500, 4000)):
        r = ftj.IndexIVFFlat(ivf.quantizer, D_, NLIST)
        p = ftt.IndexIVFFlat(pq_, D_, NLIST, device="cpu")
        ids = None if shift_ids else np.arange(lo, hi)
        ref_lib.add_preassigned(r, xb[lo:hi], ln[lo:hi], ids)
        ftt.add_preassigned(p, xb[lo:hi], ln[lo:hi], ids)
        assert_store_equal(p, r)
        halves.append((r, p))
    (r0, p0), (r1, p1) = halves
    ref_lib.merge_into(r0, r1, shift_ids=shift_ids)
    ftt.merge_into(ftt.IndexPreTransform(p0), p1, shift_ids=shift_ids)
    assert_store_equal(p0, r0)
    assert p1.ntotal == 0
    assert_store_equal(p0, ivf)
    p0.nprobe = NPROBE
    assert_same(p0.search(xq, K), ivf.search(xq, K), xq, xb)


@pytest.mark.parametrize("kind", ["flat", "pq"])
def test_search_preassigned(ds, refs, kind):
    _, xb, xq = ds
    ref = refs[kind]
    port = port_of(ref)
    _, assign = ref.quantizer.search(xq, NPROBE)
    D, I = ftt.search_preassigned(port, xq, K, assign)  # coarse distances 0
    assert_same((D, I), ref_lib.search_preassigned(ref, xq, K, assign), xq, xb)


@pytest.mark.parametrize("kind", ["flat", "pq"])
def test_replace_ivf_quantizer(ds, refs, kind):
    _, xb, xq = ds
    port = port_of(refs[kind])
    before = port.search(xq, K)
    old = port.quantizer
    new = ftt.IndexFlatL2(D_, device="cpu")
    assert ftt.replace_ivf_quantizer(port, new) is old
    assert port.quantizer is new and new.ntotal == NLIST
    assert port._device is None and getattr(port, "_term2", None) is None
    after = port.search(xq, K)
    np.testing.assert_array_equal(after[1], before[1])
    np.testing.assert_array_equal(after[0], before[0])
    with pytest.raises(ValueError):
        small = ftt.IndexFlatL2(D_, device="cpu")
        small.add(xb[:3])
        ftt.replace_ivf_quantizer(port, small)


def test_get_invlist_range(refs):
    ref = refs["pq"]
    port = port_of(ref)
    for got, want in zip(ftt.get_invlist_range(port, 3, 9),
                         ref_lib.get_invlist_range(ref, 3, 9)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["flat", "pq"])
def test_clone_index(ds, refs, kind):
    _, xb, xq = ds
    port = port_of(refs[kind])
    clone = ftt.clone_index(port)
    assert clone is not port and clone.device == port.device
    assert_store_equal(clone, port)
    D, I = clone.search(xq, K)
    D0, I0 = port.search(xq, K)
    np.testing.assert_array_equal(I, I0)
    np.testing.assert_array_equal(D, D0)
    assert_same((D, I), ref_lib.clone_index(refs[kind]).search(xq, K), xq, xb)
    clone.reset()
    assert port.ntotal == len(xb)


def test_sliding_index_window(ds, refs):
    _, xb, xq = ds
    ivf = refs["flat"]
    ln = ivf._listnos_host
    subs = []
    for lo, hi in ((1000, 2000), (2000, 3500)):
        r = ftj.IndexIVFFlat(ivf.quantizer, D_, NLIST)
        ref_lib.add_preassigned(r, xb[lo:hi], ln[lo:hi], np.arange(lo, hi))
        p = convert.ivfflat_from_arrays(ivf.quantizer.vectors(), xb[lo:hi],
                                        ln[lo:hi], np.arange(lo, hi), device="cpu")
        subs.append((r, p))
    rbase = ftj.IndexIVFFlat(ivf.quantizer, D_, NLIST)
    ref_lib.add_preassigned(rbase, xb[:1000], ln[:1000])
    pbase = convert.ivfflat_from_arrays(ivf.quantizer.vectors(), xb[:1000],
                                        ln[:1000], np.arange(1000), device="cpu")
    pbase.nprobe = rbase.nprobe = NPROBE
    rw = ref_lib.SlidingIndexWindow(rbase)
    pw = ftt.SlidingIndexWindow(ftt.IndexPreTransform(pbase))
    pbase.search(xq, K)  # builds the per-probe layout that step drops
    steps = [(subs[0], False), (subs[1], True), ((None, None), True),
             ((None, None), True)]
    for (r, p), remove in steps:
        rw.step(r, remove)
        pw.step(p, remove)
        assert pw.n_slice == rw.n_slice and pw.index.ntotal == pbase.ntotal
        assert_store_equal(pbase, rbase)
        assert pbase._device is None
        if pbase.ntotal:
            assert_same(pbase.search(xq, K), rbase.search(xq, K), xq, xb)


# -- invlists -------------------------------------------------------------------


def list_contents(il):
    return [(il.list_size(l), il.get_ids(l).copy(), il.get_codes(l).copy())
            for l in range(il.nlist)]


def assert_lists_equal(a, b):
    for (na, ia, ca), (nb, ib, cb) in zip(list_contents(a), list_contents(b)):
        assert na == nb
        np.testing.assert_array_equal(ia, ib)
        np.testing.assert_array_equal(ca, cb)


@pytest.mark.parametrize("kind", ["flat", "pq"])
def test_array_slice_stack_lists(refs, kind):
    ref = refs[kind]
    port = port_of(ref)
    ra = ref_il.ArrayInvertedLists.from_index(ref)
    pa = ftt.ArrayInvertedLists.from_index(port)
    assert pa.code_size == ra.code_size and pa.nlist == NLIST
    assert_lists_equal(pa, ra)
    assert pa.compute_ntotal == ref.ntotal and pa.print_stats() == ra.print_stats()
    views = (
        (ftt.SliceInvertedLists(pa, 4, 11), ref_il.SliceInvertedLists(ra, 4, 11)),
        (ftt.HStackInvertedLists([pa, pa]), ref_il.HStackInvertedLists([ra, ra])),
        (ftt.VStackInvertedLists([ftt.SliceInvertedLists(pa, 0, 5),
                                  ftt.SliceInvertedLists(pa, 5, NLIST)]),
         ref_il.VStackInvertedLists([ref_il.SliceInvertedLists(ra, 0, 5),
                                     ref_il.SliceInvertedLists(ra, 5, NLIST)])),
    )
    for pv, rv in views:
        assert pv.nlist == rv.nlist
        assert_lists_equal(pv, rv)
    assert_lists_equal(views[2][0], pa)
    with pytest.raises(RuntimeError):
        views[0][0].add_entries(0, [1], np.zeros((1, pa.code_size), np.uint8))
    with pytest.raises(ValueError):
        ftt.HStackInvertedLists([pa, ftt.SliceInvertedLists(pa, 0, 3)])
    # the writable in-RAM lists
    pw, rw = ftt.ArrayInvertedLists(3, 4), ref_il.ArrayInvertedLists(3, 4)
    for il in (pw, rw):
        il.add_entries(1, [7, 8], np.arange(8, dtype=np.uint8).reshape(2, 4))
        il.add_entries(1, [9], np.full((1, 4), 5, np.uint8))
        il.resize(1, 2)
    assert_lists_equal(pw, rw)


@pytest.mark.parametrize("kind", ["flat", "pq"])
def test_replace_invlists(ds, refs, kind):
    """A VStack of two halves' lists, and an HStack of two shards' lists,
    copied into the index: its store and search equal faiss_tpu's."""
    _, xb, xq = ds
    ref = refs[kind]
    port = port_of(ref)
    pa = ftt.ArrayInvertedLists.from_index(port)
    ra = ref_il.ArrayInvertedLists.from_index(ref)
    before = port.search(xq, K)
    for pv, rv in (
        (ftt.VStackInvertedLists([ftt.SliceInvertedLists(pa, 0, 7),
                                  ftt.SliceInvertedLists(pa, 7, NLIST)]),
         ref_il.VStackInvertedLists([ref_il.SliceInvertedLists(ra, 0, 7),
                                     ref_il.SliceInvertedLists(ra, 7, NLIST)])),
        (ftt.HStackInvertedLists([pa]), ref_il.HStackInvertedLists([ra])),
    ):
        rcopy = ref_lib.clone_index(ref)
        ftt.replace_invlists(port, pv)
        ref_il.replace_invlists(rcopy, rv)
        assert_store_equal(port, rcopy)
        assert port._device is None
        got = port.search(xq, K)
        assert_same(got, rcopy.search(xq, K), xq, xb)
        assert_same(got, before, xq, xb)
    with pytest.raises(ValueError):
        ftt.replace_invlists(port, ftt.SliceInvertedLists(pa, 0, 3))


def test_on_disk_invlists(ds, refs, tmp_path):
    _, xb, xq = ds
    ivf = refs["flat"]
    port = port_of(ivf)
    before = port.search(xq, K)
    pa = ftt.ArrayInvertedLists.from_index(port)
    ra = ref_il.ArrayInvertedLists.from_index(ivf)
    # bulk construction, then the index reads its lists back from the file
    pd = ftt.OnDiskInvertedLists(NLIST, pa.code_size, str(tmp_path / "p.ivfdata"))
    rd = ref_il.OnDiskInvertedLists(NLIST, ra.code_size, str(tmp_path / "r.ivfdata"))
    assert pd.merge_from_multiple([pa]) == rd.merge_from_multiple([ra]) == len(xb)
    assert pd.is_compact and rd.is_compact
    assert_lists_equal(pd, rd)
    with open(tmp_path / "p.ivfdata", "rb") as f, open(tmp_path / "r.ivfdata", "rb") as g:
        assert f.read() == g.read()
    pd.prefetch_lists([0, 3, -1, 7])
    ftt.replace_invlists(port, pd)
    after = port.search(xq, K)
    np.testing.assert_array_equal(after[1], before[1])
    np.testing.assert_array_equal(after[0], before[0])
    # a read-only reopen of the file refuses writes
    ro = ftt.OnDiskInvertedLists(NLIST, pa.code_size, str(tmp_path / "p.ivfdata"),
                                 read_only=True)
    with pytest.raises(RuntimeError):
        ro.add_entries(0, [1], np.zeros((1, pa.code_size), np.uint8))
    pd.close()
    # incremental growth, updates and shrinking: the same layout and bytes
    small = [ftt.OnDiskInvertedLists(4, 3, str(tmp_path / "ps")),
             ref_il.OnDiskInvertedLists(4, 3, str(tmp_path / "rs"))]
    rs = np.random.RandomState(0)
    ops = [(int(rs.randint(4)), int(rs.randint(1, 9))) for _ in range(12)]
    for il in small:
        for i, (l, n) in enumerate(ops):
            il.add_entries(l, np.arange(n) + 100 * i,
                           np.full((n, 3), i, np.uint8))
        il.update_entries(ops[0][0], 0, [-5], np.full((1, 3), 77, np.uint8))
        il.resize(ops[1][0], 1)
        il.resize(ops[2][0], 0)
    ps, rsl = small
    for a in ("sizes", "caps", "offs"):
        np.testing.assert_array_equal(getattr(ps, a), getattr(rsl, a))
    assert sorted(ps.slots) == sorted(rsl.slots) and ps.totsize == rsl.totsize
    assert_lists_equal(ps, rsl)
    assert not ps.is_compact
    ps.crop_invlists(1, 3)
    rsl.crop_invlists(1, 3)
    assert ps.nlist == 2
    assert_lists_equal(ps, rsl)
    ps.close()
    assert os.path.getsize(tmp_path / "ps") == rsl.totsize


def test_invlists_io_hook():
    class Hook(ftt.InvertedListsIOHook):
        classname = "PortTestLists"

    assert ftt.InvertedListsIOHook.lookup_or_none("PortTestLists") is None
    with pytest.raises(KeyError):
        ftt.InvertedListsIOHook.lookup("PortTestLists")
    h = Hook()
    ftt.InvertedListsIOHook.add_callback(h)
    try:
        assert ftt.InvertedListsIOHook.lookup("PortTestLists") is h
        with pytest.raises(NotImplementedError):
            h.write(None, {}, "")
    finally:
        ftt.invlists._io_hooks.pop("PortTestLists")
