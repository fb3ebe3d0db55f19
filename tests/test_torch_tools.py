"""Port parity for faiss_tpu's tools: the public names, the big-batch
counters, extra, stats, utils.datasets, reverse_index_factory, autotune and
bench_fw (faiss_tpu_torch's modules against faiss_tpu's of the same name).

Exact k-NN and distance matrices agree with faiss_tpu's within 1e-5 of the
row's scale (|q|^2 + max |y|^2 for L2 and the inner product, the row's
largest distance for the other metrics), ids tie-aware; the host utilities
(k-selection, merges, sorts, packing, seeded arrays, the diversity filter,
MatrixStats, SyntheticDataset) bit for bit. Autotune and bench_fw compare
their accuracy per operating point on the same index state (times differ),
and OperatingPoints on fixed inputs. Where faiss_tpu is at fault the test
holds the port to the intended behaviour alone (ROADMAP queue 3)."""

import ast
import importlib
import json
from pathlib import Path

import numpy as np
import pytest

import faiss_tpu as ftj
import faiss_tpu_torch as ftt
from faiss_tpu import extra as jx
from faiss_tpu_torch import extra as tx
from faiss_tpu_torch.utils.evaluation import ids_agree_tie_aware
from test_torch_factory import SUPPORTED, tree
from torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
D = 16

# ---------------------------------------------------------------------------
# the public names
# ---------------------------------------------------------------------------

MODULES = ["extra", "stats", "autotune", "bench_fw", "factory_tools", "io_ref",
           "utils/datasets", "contrib/exhaustive_search", "contrib/inspect_tools",
           "contrib/clustering", "contrib/big_batch_search", "contrib/ondisk",
           "contrib/offline_ivf", "contrib/client_server", "contrib/torch_utils"]
# the only names of faiss_tpu the port does not carry: they hand arrays to JAX
JAX_ONLY = {"torch_to_jax", "jax_to_torch"}


def module_names(pkg, mod):
    """Public top-level definitions of a module, read from its source (an
    import of torch_utils would patch every index class)."""
    src = (ROOT / pkg / f"{mod}.py").read_text()
    out = set()
    for node in ast.parse(src).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, ast.Assign):
            out |= {t.id for t in node.targets if isinstance(t, ast.Name)}
    return {n for n in out if not n.startswith("_")}


def test_public_names():
    ref = {n for n in dir(ftj) if not n.startswith("_")}
    port = {n for n in dir(ftt) if not n.startswith("_")}
    assert ref - port == set(), sorted(ref - port)
    qt = [n for n in ref if n.startswith("ScalarQuantizer_QT_")]
    assert len(qt) == len(ftt.QuantizerType) >= 19
    for n in qt:
        assert int(getattr(ftt, n)) == int(getattr(ftj, n)) and getattr(ftt, n).name == n[16:]
    for mod in MODULES:
        missing = module_names("faiss_tpu", mod) - module_names("faiss_tpu_torch", mod)
        assert missing <= JAX_ONLY, (mod, missing)
        if mod == "contrib/torch_utils":
            assert missing == JAX_ONLY


# ---------------------------------------------------------------------------
# the big-batch counters (ivf_fast_scan_stats)
# ---------------------------------------------------------------------------

def mixture(rs, n, ncent=64, d=D):
    cent = np.random.RandomState(99).rand(ncent, d).astype(np.float32)
    scales = (1.0 / (np.arange(d) + 1.0)).astype(np.float32) * 0.4
    a = rs.randint(ncent, size=n)
    return (cent[a] + rs.randn(n, d).astype(np.float32) * scales).astype(np.float32)


@pytest.mark.parametrize("kind", ["ivf_flat", "ivfpq_refined"])
def test_fast_scan_stats_match_reference(kind):
    """The same big-batch searches (128 queries, strict nprobe 4; for the
    refined IVF-PQ, then soft with every worklist engaged) through faiss_tpu
    (Pallas in interpret mode) and the port on a converted index count the
    same queries, and for the refined IVF-PQ the same keys and chunks."""
    from faiss_tpu_torch.convert import ivfflat_from_arrays, refine_flat_from_arrays

    rs = np.random.RandomState(24)
    xb, xq = mixture(rs, 2000), mixture(rs, 128)
    if kind == "ivf_flat":
        ref = ftj.IndexIVFFlat(None, D, 64)
        base_j = ref
    else:
        base_j = ftj.IndexIVFPQFastScan(None, D, 64, 4, 4)
        base_j.query_h2d_dtype = None
        base_j.pack_d2h = None
        ref = ftj.IndexRefineFlat(base_j, store_float16=True)
        ref.k_factor = 4
    base_j.FUSED_CT = 256
    base_j.cp.niter = 4
    base_j.cp.min_points_per_centroid = 1
    base_j.fused_interpret = True
    ref.train(xb)
    ref.add(xb)
    if kind == "ivf_flat":
        port = base_t = ivfflat_from_arrays(
            ref.quantizer.vectors(), ref._codes_host, ref._listnos_host,
            ref._ids_host, device="cpu")
    else:
        port = refine_flat_from_arrays(
            base_j.quantizer.vectors(), base_j.pq.centroids, base_j._codes_host,
            base_j._listnos_host, base_j._ids_host, ref.refine_index.vectors(),
            device="cpu", store_float16=True)
        port.k_factor = 4
        base_t = port.base_index
    base_t.FUSED_CT = 256
    counts = []
    for pkg, index, base in ((ftj, ref, base_j), (ftt, port, base_t)):
        stats = pkg.ivf_fast_scan_stats
        stats.reset()
        base.nprobe = 4
        index.search(xq, 10)
        if kind == "ivfpq_refined":
            base.strict_probe = False
            base.soft_engage_frac = 1.0
            index.search(xq, 10)
        counts.append(stats)
    sj, st = counts
    assert st.nq == sj.nq == len(xq) * (1 if kind == "ivf_flat" else 2)
    if kind == "ivfpq_refined":
        assert (st.ndis, st.chunks_scanned, st.chunks_skipped) == (
            sj.ndis, sj.chunks_scanned, sj.chunks_skipped)


# ---------------------------------------------------------------------------
# extra
# ---------------------------------------------------------------------------

METRICS = ["L2", "INNER_PRODUCT", "L1", "Linf", "Lp", "Canberra", "BrayCurtis",
           "JensenShannon", "NaNEuclidean", "ABS_INNER_PRODUCT", "GOWER"]


@pytest.fixture(scope="module")
def small():
    rs = np.random.RandomState(3)
    xb = np.abs(rs.randn(300, D)).astype(np.float32)
    xq = np.abs(rs.randn(20, D)).astype(np.float32)
    return xb / xb.sum(1, keepdims=True), xq / xq.sum(1, keepdims=True)


def row_scale(metric, xq, xb, Dj):
    if metric in ("L2", "INNER_PRODUCT"):
        return 1e-5 * ((xq.astype(np.float64) ** 2).sum(1)
                       + float((xb.astype(np.float64) ** 2).sum(1).max()))
    return 1e-5 * (np.abs(Dj).max(1) + 1e-6)


@pytest.mark.parametrize("metric", METRICS)
def test_knn_and_pairwise_distances_match_reference(small, metric):
    xb, xq = small
    mt = getattr(ftt.MetricType, metric)
    arg = 3.0 if metric == "Lp" else 0.0
    Dj, Ij = jx.knn(xq, xb, 7, metric=mt, metric_arg=arg)
    Dt, It = tx.knn(xq, xb, 7, metric=mt, metric_arg=arg, device="cpu")
    assert Dt.dtype == np.float32 and It.dtype == np.int64 and Dt.shape == (20, 7)
    Pj = jx.pairwise_distances(xq, xb, mt, arg)
    Pt = tx.pairwise_distances(xq, xb, mt, arg, device="cpu")
    tol = row_scale(metric, xq, xb, Pj)  # the row's scale over every column
    assert (np.abs(Dt.astype(np.float64) - Dj) <= tol[:, None]).all()
    sign = -1.0 if ftt.is_similarity_metric(mt) else 1.0
    assert ids_agree_tie_aware(sign * Dj, Ij, sign * Dt, It, tol).all()
    assert (np.abs(Pt.astype(np.float64) - Pj) <= tol[:, None]).all()
    assert tx.knn_gpu is tx.knn
    np.testing.assert_array_equal(tx.pairwise_distance_gpu(xq, xb, mt, arg, device="cpu"), Pt)


def test_knn_hamming_matches_reference():
    rs = np.random.RandomState(4)
    xb = rs.randint(256, size=(500, 8)).astype(np.uint8)
    xq = rs.randint(256, size=(30, 8)).astype(np.uint8)
    Dj, Ij = jx.knn_hamming(xq, xb, 9)
    Dt, It = tx.knn_hamming(xq, xb, 9, device="cpu")
    np.testing.assert_array_equal(Dt, Dj)
    assert ids_agree_tie_aware(Dj, Ij, Dt, It, 0).all()


def test_host_utilities_match_reference():
    """Values bit for bit; positions too where no two values tie (among
    ties faiss_tpu keeps XLA's top-k order, the port the lower position)."""
    rs = np.random.RandomState(5)
    tied = rs.randint(6, size=(40, 30)).astype(np.float32)
    distinct = rs.rand(40, 30).astype(np.float32)
    for fj, ft_ in ((jx.kmin, tx.kmin), (jx.kmax, tx.kmax)):
        vj, ij = fj(distinct, 7)
        vt, it = ft_(distinct, 7)
        np.testing.assert_array_equal(vt, vj)
        np.testing.assert_array_equal(it, ij)
        vj, _ = fj(tied, 7)
        vt, it = ft_(tied, 7)
        np.testing.assert_array_equal(vt, vj)
        np.testing.assert_array_equal(np.take_along_axis(tied, it, 1), vt)
    Dall = np.sort(rs.rand(3, 25, 6).astype(np.float32), axis=2)
    Iall = rs.randint(1 << 40, size=(3, 25, 6)).astype(np.int64)
    for keep_max in (False, True):
        D_, I_ = (Dall[:, :, ::-1], Iall[:, :, ::-1]) if keep_max else (Dall, Iall)
        for a, b in zip(jx.merge_knn_results(D_, I_, keep_max),
                        tx.merge_knn_results(D_, I_, keep_max)):
            np.testing.assert_array_equal(b, a)
    Dall = np.round(Dall * 4)  # ties across the shards: both heaps sort stably
    heaps = [m.ResultHeap(25, 6, keep_max=False) for m in (jx, tx)]
    for s in range(3):
        for h in heaps:
            h.add_result(Dall[s], Iall[s])
    for h in heaps:
        h.finalize()
    np.testing.assert_array_equal(heaps[1].D, heaps[0].D)
    np.testing.assert_array_equal(heaps[1].I, heaps[0].I)
    keys = rs.randint(11, size=300)
    for a, b in zip(jx.bucket_sort(keys), tx.bucket_sort(keys)):
        np.testing.assert_array_equal(b, a)
    mj, mt = (rs.randint(9, size=(20, 5)).astype(np.int32),) * 2
    mj, mt = mj.copy(), mt.copy()
    np.testing.assert_array_equal(tx.matrix_bucket_sort_inplace(mt),
                                  jx.matrix_bucket_sort_inplace(mj))
    np.testing.assert_array_equal(mt, mj)
    for nbit in (1, 5, 12, 33):
        a = rs.randint(1 << min(nbit, 62), size=(17, 3), dtype=np.int64).astype(np.uint64)
        pj, pt = jx.pack_bitstrings(a, nbit), tx.pack_bitstrings(a, nbit)
        np.testing.assert_array_equal(pt, pj)
        np.testing.assert_array_equal(tx.unpack_bitstrings(pt, 3, nbit),
                                      jx.unpack_bitstrings(pj, 3, nbit))
    for name in ("rand", "randn", "randint"):
        a, b = getattr(jx, name)(50, 7), getattr(tx, name)(50, 7)
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_diversity_select_and_search_match_reference():
    rs = np.random.RandomState(6)
    xb = rs.rand(400, D).astype(np.float32)
    xq = rs.rand(15, D).astype(np.float32)
    groups = rs.randint(12, size=400)
    jflat, tflat = ftj.IndexFlatL2(D), ftt.IndexFlatL2(D, device="cpu")
    jflat.add(xb)
    tflat.add(xb)
    D0, I0 = jflat.search(xq, 40)
    for a, b in zip(jx.diversity_select(D0, I0, groups, 10, 2),
                    tx.diversity_select(D0, I0, groups, 10, 2)):
        np.testing.assert_array_equal(b, a)
    Dj, Ij = jx.diversity_search(jflat, xq, 10, groups, 1, fetch_factor=1)
    Dt, It = tx.diversity_search(tflat, xq, 10, groups, 1, fetch_factor=1)
    fin = np.isfinite(Dj)
    assert (fin == np.isfinite(Dt)).all()
    tol = 1e-5 * ((xq ** 2).sum(1) + float((xb ** 2).sum(1).max()))
    assert ids_agree_tie_aware(np.where(fin, Dj, 1e30), Ij, np.where(fin, Dt, 1e30),
                               It, tol).all()
    for r in range(len(xq)):
        assert np.bincount(groups[It[r][It[r] >= 0]]).max() <= 1


def test_diversity_select_missing_candidates_form_no_group():
    """A missing candidate (-1) counts against no group. faiss_tpu files it
    under group -1 (extra.py:111), so a real group labelled -1 loses a
    slot to it (ROADMAP queue 3); the port keeps the real candidate."""
    D_ = np.array([[0.1, 0.2, 0.3, 0.4]], np.float32)
    I_ = np.array([[0, -1, 1, 2]], np.int64)
    groups = np.array([-1, -1, 5])
    Do, Io, nv = tx.diversity_select(D_, I_, groups, 3, 2)
    np.testing.assert_array_equal(Io, [[0, 1, 2]])
    np.testing.assert_array_equal(Do, np.float32([[0.1, 0.3, 0.4]]))
    assert nv.tolist() == [3]


# ---------------------------------------------------------------------------
# stats
# ---------------------------------------------------------------------------

def test_matrix_stats_match_reference():
    from faiss_tpu.stats import MatrixStats as JStats

    rs = np.random.RandomState(7)
    x = rs.randn(200, D).astype(np.float32)
    x[:, 3] = 1.5  # a constant dimension
    x[:, 5] = 0.0  # an all-zero one
    x[10] = x[11] = x[12]  # duplicates
    x[20, 2], x[21, 7] = np.nan, np.inf
    a, b = JStats(x), ftt.MatrixStats(x)
    assert vars(b) == vars(a)
    assert "WARN" in b.comments


# ---------------------------------------------------------------------------
# utils.datasets
# ---------------------------------------------------------------------------

def test_synthetic_dataset_bit_for_bit():
    from faiss_tpu.utils import datasets as jds
    from faiss_tpu_torch.utils import datasets as tds

    for metric in ("L2", "IP"):
        a = jds.SyntheticDataset(D, 500, 2000, 40, metric=metric, seed=9)
        b = tds.SyntheticDataset(D, 500, 2000, 40, metric=metric, seed=9, device="cpu")
        for get in ("get_train", "get_database", "get_queries"):
            np.testing.assert_array_equal(getattr(b, get)(), getattr(a, get)())
        assert int(b.metric) == int(a.metric)
        gj, gt = a.get_groundtruth(10), b.get_groundtruth(10)
        xq, xb = b.get_queries().astype(np.float64), b.get_database().astype(np.float64)
        d64 = ((xq[:, None] - xb[None]) ** 2).sum(-1) if metric == "L2" else -(xq @ xb.T)
        Dj = np.take_along_axis(d64, gj, 1)
        Dt = np.take_along_axis(d64, gt, 1)
        tol = 1e-5 * ((xq ** 2).sum(1) + (xb ** 2).sum(1).max())
        assert ids_agree_tie_aware(Dj, gj, Dt, gt, tol).all()
        blocks = list(b.database_iterator(bs=300, split=(3, 1)))
        np.testing.assert_array_equal(
            np.vstack(blocks), np.vstack(list(a.database_iterator(bs=300, split=(3, 1)))))
    assert "2000 vectors" in str(b)


def _write_bvecs(path, x):
    with open(path, "wb") as f:
        for row in x:
            np.int32(x.shape[1]).tofile(f)
            row.tofile(f)


def test_loaders_read_the_standard_layouts(tmp_path, monkeypatch):
    from faiss_tpu.utils import datasets as jds
    from faiss_tpu_torch.utils import datasets as tds

    rs = np.random.RandomState(8)
    for sub, d, stem in (("sift1M", 128, "sift"), ("gist1M", 960, "gist")):
        base = tmp_path / sub
        base.mkdir()
        xb = rs.rand(120, d).astype(np.float32)
        xq = rs.rand(6, d).astype(np.float32)
        tds.fvecs_write(str(base / f"{stem}_base.fvecs"), xb)
        tds.fvecs_write(str(base / f"{stem}_query.fvecs"), xq)
        tds.fvecs_write(str(base / f"{stem}_learn.fvecs"), xb[:30])
        gt = np.argsort(((xq[:, None] - xb[None]) ** 2).sum(-1), 1)[:, :100].astype(np.int32)
        tds.ivecs_write(str(base / f"{stem}_groundtruth.ivecs"), gt)
        assert (base / f"{stem}_base.fvecs").read_bytes() == _bytes_of(
            jds.fvecs_write, xb, tmp_path)
        cls = tds.DatasetSIFT1M if sub == "sift1M" else tds.DatasetGIST1M
        tds.set_dataset_basedir(str(tmp_path))  # no trailing slash
        ds_ = cls()
        assert ds_.basedir == str(tmp_path) + f"/{sub}/"
        ds_.nb, ds_.nq, ds_.nt = 120, 6, 30
        ds_.device = "cpu"
        assert ds_.check_sizes()
        np.testing.assert_array_equal(ds_.get_database(), xb)
        np.testing.assert_array_equal(ds_.get_train(maxtrain=10), xb[:10])
        np.testing.assert_array_equal(ds_.get_groundtruth(k=10), gt[:, :10])
        np.testing.assert_array_equal(ds_.get_groundtruth(), gt)
        with pytest.raises(ValueError, match="100 neighbours"):
            ds_.get_groundtruth(k=101)  # faiss_tpu narrows (queue 3)
        np.testing.assert_array_equal(tds.fvecs_mmap(str(base / f"{stem}_base.fvecs")), xb)
        np.testing.assert_array_equal(tds.ivecs_read(str(base / f"{stem}_groundtruth.ivecs")),
                                      jds.ivecs_read(str(base / f"{stem}_groundtruth.ivecs")))
    # BigANN (bvecs) and Deep1B (fvecs) prefixes
    big = tmp_path / "bigann"
    (big / "gnd").mkdir(parents=True)
    xu = rs.randint(0, 256, size=(64, 128), dtype=np.uint8)
    _write_bvecs(big / "bigann_base.bvecs", xu)
    _write_bvecs(big / "bigann_query.bvecs", xu[:4])
    _write_bvecs(big / "bigann_learn.bvecs", xu[:16])
    tds.ivecs_write(str(big / "gnd" / "idx_1M.ivecs"), np.zeros((4, 100), np.int32))
    bg = tds.DatasetBigANN(nb_M=1)
    bg.nb = 64
    np.testing.assert_array_equal(np.vstack(list(bg.database_iterator(bs=17))),
                                  xu.astype(np.float32))
    np.testing.assert_array_equal(bg.get_queries(), xu[:4].astype(np.float32))
    np.testing.assert_array_equal(bg.get_train(maxtrain=5), xu[:5].astype(np.float32))
    assert bg.get_groundtruth(k=10).shape == (4, 10)
    with pytest.raises(AssertionError):
        tds.DatasetBigANN(nb_M=3)
    deep = tmp_path / "deep1b"
    deep.mkdir()
    xd = rs.rand(50, 96).astype(np.float32)
    tds.fvecs_write(str(deep / "base.fvecs"), xd)
    tds.fvecs_write(str(deep / "learn.fvecs"), xd[:20])
    tds.fvecs_write(str(deep / "deep1B_queries.fvecs"), xd[:3])
    tds.ivecs_write(str(deep / "deep100k_groundtruth.ivecs"), np.zeros((3, 100), np.int32))
    dp = tds.DatasetDeep1B(nb=10**5)
    np.testing.assert_array_equal(dp.get_database(), xd)  # the file's 50 rows
    np.testing.assert_array_equal(dp.get_queries(), xd[:3])
    np.testing.assert_array_equal(dp.get_train(maxtrain=7), xd[:7])
    assert dp.get_groundtruth().shape == (3, 100)
    # FAISS_TPU_DATA without its trailing slash (faiss_tpu keeps the value
    # as it is, datasets.py:111; ROADMAP queue 3)
    monkeypatch.setenv("FAISS_TPU_DATA", str(tmp_path))
    try:
        importlib.reload(tds)
        assert tds.dataset_basedir == str(tmp_path) + "/"
        assert tds.DatasetSIFT1M().basedir == str(tmp_path) + "/sift1M/"
    finally:
        monkeypatch.delenv("FAISS_TPU_DATA")
        importlib.reload(tds)


def _bytes_of(write, x, tmp_path):
    p = tmp_path / "ref_written.fvecs"
    write(str(p), x)
    return p.read_bytes()


# ---------------------------------------------------------------------------
# reverse_index_factory
# ---------------------------------------------------------------------------

def _rebuilds(pkg, d, s, metric, index, **kw):
    try:
        return tree(pkg.index_factory(d, s, metric, **kw)) == tree(index)
    except (ValueError, TypeError):
        return False


@pytest.mark.parametrize("d,desc,metric", SUPPORTED,
                         ids=[f"{d}-{s}-{m}" for d, s, m in SUPPORTED])
def test_reverse_index_factory(d, desc, metric):
    """Where faiss_tpu's string rebuilds its index, the port returns the
    same string; every string the port returns rebuilds the port's index;
    where the port raises, faiss_tpu raises too or its string does not
    rebuild the index (ROADMAP queue 3 lists those)."""
    mt = ftj.METRIC_L2 if metric == "l2" else ftj.METRIC_INNER_PRODUCT
    ref = ftj.index_factory(d, desc, mt)
    port = ftt.index_factory(d, desc, mt, device="cpu")
    try:
        sj = ftj.reverse_index_factory(ref)
        ok_j = _rebuilds(ftj, d, sj, mt, ref)
    except TypeError:
        sj, ok_j = None, False
    try:
        st = ftt.reverse_index_factory(port)
    except TypeError:
        assert not ok_j, (desc, sj)
        return
    assert _rebuilds(ftt, d, st, mt, port, device="cpu"), (desc, st)
    if ok_j:
        assert st == sj


def test_reverse_index_factory_ivfpq_not_by_residual():
    index = ftt.index_factory(D, "IVF8,PQ4", device="cpu")
    assert ftt.reverse_index_factory(index) == "IVF8,PQ4x8"
    index.by_residual = False  # faiss_tpu returns the same string (queue 3)
    with pytest.raises(TypeError, match="not by residual"):
        ftt.reverse_index_factory(index)


# ---------------------------------------------------------------------------
# autotune
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ivf_pair():
    """A trained faiss_tpu IVF32,Flat and the port's from its state; 60
    queries (below the big-batch threshold: exact within the probed lists
    in both) and their exact neighbours."""
    from faiss_tpu_torch.convert import ivfflat_from_arrays

    rs = np.random.RandomState(10)
    xb, xq = mixture(rs, 3000), mixture(rs, 60)
    ref = ftj.IndexIVFFlat(None, D, 32)
    ref.cp.niter = 4
    ref.train(xb)
    ref.add(xb)
    port = ivfflat_from_arrays(ref.quantizer.vectors(), ref._codes_host,
                               ref._listnos_host, ref._ids_host, device="cpu")
    gt = np.argsort(((xq[:, None].astype(np.float64) - xb[None]) ** 2).sum(-1), 1)[:, :10]
    return ref, port, xb, xq, gt


def test_explore_matches_reference(ivf_pair):
    ref, port, xb, xq, gt = ivf_pair
    out = []
    for pkg, index in ((ftj, ref), (ftt, port)):
        ps = pkg.ParameterSpace()
        ps.initialize(index)
        assert [(r.name, r.values) for r in ps.parameter_ranges] == [
            ("nprobe", [1, 2, 4, 8, 16, 32])]
        ps.parameter_ranges = [pkg.ParameterRange("nprobe", [1, 2, 4, 8])]
        pts = {}
        for crit in (pkg.OneRecallAtRCriterion(len(xq), 10),
                     pkg.IntersectionCriterion(len(xq), 10)):
            crit.set_groundtruth(None, gt)
            ops = ps.explore(index, xq, crit)
            pts[type(crit).__name__] = [(o.key, o.perf) for o in ops.all_pts]
        out.append(pts)
    assert out[1] == out[0]
    assert out[1]["IntersectionCriterion"][-1][1] > out[1]["IntersectionCriterion"][0][1]


def test_operating_points_on_fixed_inputs():
    pts = [(0.5, 0.010, "a"), (0.7, 0.020, "b"), (0.6, 0.030, "c"),
           (0.9, 0.025, "d"), (0.9, 0.015, "e"), (0.2, 0.001, "f")]
    res = []
    for pkg in (ftj, ftt):
        ops = pkg.OperatingPoints()
        added = [ops.add(*p) for p in pts]
        res.append((added, [o.key for o in ops.optimal_pts],
                    ops.t_for_perf(0.6), ops.t_for_perf(0.95), repr(ops.all_pts[0])))
    assert res[1] == res[0]


def test_set_index_parameter_through_wrappers():
    """On the main path's kind of index (a refinement at the top) nprobe,
    k_factor_rf and quantizer_ names land as in faiss_tpu. Under IDMap and
    a PreTransform the port reaches the same places, where faiss_tpu
    refuses (ROADMAP queue 3), and ``initialize`` gives the IVF's nprobe
    range under a refinement too."""
    params = "nprobe=6,k_factor_rf=12,quantizer_efSearch=40"
    res = []
    for pkg, kw in ((ftj, {}), (ftt, {"device": "cpu"})):
        index = pkg.index_factory(D, "IVF16_HNSW8,PQ4x4fs,RFlat", **kw)
        ps = pkg.ParameterSpace()
        ps.set_index_parameters(index, params)
        ps.set_index_parameter(index, "ht", 20)
        ivf = index.base_index
        res.append((ivf.nprobe, index.k_factor, ivf.quantizer.hnsw.efSearch))
        with pytest.raises(ValueError, match="cannot set parameter"):
            ps.set_index_parameter(index, "efConstruction", 3)
    assert res[1] == res[0] == (6, 12.0, 40)
    index = ftt.index_factory(D, "IDMap,OPQ4,IVF16_HNSW8,PQ4x4fs,RFlat", device="cpu")
    ps = ftt.ParameterSpace()
    ps.set_index_parameters(index, params)
    refine = index.index.index
    ivf = refine.base_index
    assert (ivf.nprobe, refine.k_factor, ivf.quantizer.hnsw.efSearch) == (6, 12.0, 40)
    ps.initialize(index)
    assert [(r.name, r.values) for r in ps.parameter_ranges] == [
        ("nprobe", [1, 2, 4, 8, 16]), ("k_factor_rf", [1, 2, 4, 16, 64])]


def test_ht_sets_the_polysemous_threshold():
    """``ht`` reaches IVF-PQ's and PQ's polysemous filter, off at or above
    the code's bits, as in AutoTune.cpp (faiss_tpu ignores it: ROADMAP queue
    3), so explore over ht sees different operating points; elsewhere it
    is refused."""
    rs = np.random.RandomState(12)
    xb, xq = mixture(rs, 2000), mixture(rs, 40)
    gt = np.argsort(((xq[:, None].astype(np.float64) - xb[None]) ** 2).sum(-1), 1)[:, :10]
    index = ftt.index_factory(D, "IVF16,PQ8x4", device="cpu")
    index.train(xb)
    index.add(xb)
    index.nprobe = 4
    ps = ftt.ParameterSpace()
    ps.parameter_ranges = [ftt.ParameterRange("ht", [0, 10, 32])]
    crit = ftt.IntersectionCriterion(len(xq), 10)
    crit.set_groundtruth(None, gt)
    perf = {o.key: o.perf for o in ps.explore(index, xq, crit).all_pts}
    assert index.polysemous_ht == 0  # 32 >= 8 x 4 bits: filter off
    assert perf["ht=0"] == perf["ht=32"] > perf["ht=10"]
    ps.set_index_parameters(index, "ht=10")
    assert index.polysemous_ht == 10

    pq = ftt.index_factory(D, "PQ8x4", device="cpu")
    ps.set_index_parameter(pq, "ht", 12)
    assert (pq.search_type, pq.polysemous_ht) == (pq.ST_polysemous, 12)
    ps.set_index_parameter(pq, "ht", 32)
    assert pq.search_type == pq.ST_PQ
    with pytest.raises(ValueError, match="cannot set parameter"):
        ps.set_index_parameter(ftt.index_factory(D, "Flat", device="cpu"), "ht", 4)


# ---------------------------------------------------------------------------
# bench_fw
# ---------------------------------------------------------------------------

def test_benchmark_matches_reference(ivf_pair, tmp_path):
    """A Benchmark over one index file (written by faiss_tpu, read by each
    package) and an exact Flat: the same recall at every point; the port's
    BenchmarkIO cache, run_benchmark with the Optimizer and main."""
    from faiss_tpu.bench_fw import Benchmark as JBench
    from faiss_tpu.utils.datasets import SyntheticDataset as JSyn
    from faiss_tpu_torch import bench_fw as tbf
    from faiss_tpu_torch.utils.datasets import SyntheticDataset as TSyn

    ref = ivf_pair[0]
    path = str(tmp_path / "ivf.npz")
    ftj.write_index(ref, path)
    descs = lambda pkg: [pkg.IndexDescriptor(path=path, search_params={"nprobe": [1, 4, 16]}),  # noqa: E731
                         pkg.IndexDescriptor("Flat")]
    res = []
    for pkg, bench, syn, kw in ((ftj, JBench, JSyn, {}), (ftt, tbf.Benchmark, TSyn,
                                                          {"device": "cpu"})):
        data = syn(D, 500, 3000, 60, seed=11, **kw)
        ds_ = pkg.DatasetDescriptor(dataset=data, name="syn")
        out = bench(ds_, descs(pkg), k=10, **kw).run()
        res.append([[(p["params"], p["recall"]) for p in e["points"]]
                    for e in out["indexes"]])
    assert res[1] == res[0]
    assert res[1][1] == [({}, 1.0)]

    io = tbf.BenchmarkIO(str(tmp_path / "cache"))
    cfg = {"dataset": {"d": D, "nb": 2000, "nq": 30, "nt": 1000},
           "indexes": [{"factory": "IVF16,Flat", "search_params": {"nprobe": [1, 16]}}],
           "basedir": io.basedir, "min_accuracy": 0.5, "device": "cpu"}
    first = tbf.run_benchmark(cfg)
    desc = tbf.IndexDescriptor(**cfg["indexes"][0])
    assert Path(io.index_path("syn_16d_2000n_1338", desc)).exists()
    cached = io.load_index("syn_16d_2000n_1338", desc, device="cpu")
    assert type(cached) is ftt.IndexIVFFlat and cached.ntotal == 2000
    again = tbf.run_benchmark(cfg)  # built from the cache: no training
    assert again["all"]["indexes"][0]["train_s"] == 0.0
    assert [p["recall"] for p in again["all"]["indexes"][0]["points"]] == [
        p["recall"] for p in first["all"]["indexes"][0]["points"]]
    assert first["pareto"] and first["filtered_candidates"][0].factory == "IVF16,Flat"
    cfg_path, out_path = tmp_path / "cfg.json", tmp_path / "out.json"
    cfg.pop("min_accuracy")
    cfg_path.write_text(json.dumps(cfg))
    tbf.main([str(cfg_path), str(out_path)])
    assert json.loads(out_path.read_text())["indexes"][0]["factory"] == "IVF16,Flat"


def test_benchmark_skips_the_cache_for_a_family_without_files(tmp_path):
    """IndexHNSW2Level has no file form: the writer raises TypeError, and
    the port's Benchmark goes on without caching it (faiss_tpu catches only
    NotImplementedError there and stops; ROADMAP queue 3)."""
    from faiss_tpu_torch import bench_fw as tbf

    io = tbf.BenchmarkIO(str(tmp_path))
    ds_ = tbf.DatasetDescriptor(d=D, nb=1000, nq=20, nt=1000)
    desc = tbf.IndexDescriptor("HNSW8,16+PQ4")
    with pytest.raises(TypeError):
        ftt.serialize_index(ftt.index_factory(D, desc.factory, device="cpu"))
    out = tbf.Benchmark(ds_, [desc], k=5, io=io, device="cpu").run()
    assert out["indexes"][0]["points"][0]["recall"] > 0
    assert not Path(io.index_path(ds_.label(), desc)).exists()
