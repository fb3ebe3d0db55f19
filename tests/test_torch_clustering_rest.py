"""Port parity for the rest of training (faiss_tpu_torch/clustering.py and
ops/kmeans_ops.py, ops/adsampling.py against faiss_tpu's): weighted,
integer and frozen Lloyd loops, the k-means++ and AFK-MC2 inits, the uint8
loop, Kmeans, kmeans_clustering, kmeans1d, ProgressiveDimClustering,
SuperKMeans and its assign-update step, and the ADSampling helpers, on the
same seeded numpy inputs with the port on the CPU.

Objectives are compared, not centroids, where faiss_tpu's float32
assignment is its 3-pass bf16 product (~2^-16 relative) and the port's is
exact float32: rtol 1e-4. The uint8 loops share their arithmetic (the bf16
hi/lo split of the centroids, exact products), so there the centroids are
compared too, at the bounds of tests/test_clustering.py:172-190. The data
are well separated clusters, so no cluster empties and the two packages'
different donor streams for empty-cluster splits never come into play
(each test asserts it)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import faiss_tpu as ftj
from faiss_tpu import clustering as cj
from faiss_tpu.ops import adsampling as adj
from faiss_tpu.ops import kmeans_ops as kj
import faiss_tpu_torch as ftt
from faiss_tpu_torch import clustering as ct
from faiss_tpu_torch.ops import adsampling as adt
from faiss_tpu_torch.ops import kmeans_ops as kt
from torch_threads import one_torch_thread  # noqa: F401


def blobs(seed, n, d, ncent, scale=4.0, noise=0.3):
    rs = np.random.RandomState(seed)
    cent = rs.rand(ncent, d).astype(np.float32) * scale
    a = rs.randint(ncent, size=n)
    return (cent[a] + noise * rs.randn(n, d)).astype(np.float32)


def pixels(seed, n, d, k):
    """uint8 points around k prototype images (tests/test_clustering.py:177)."""
    rs = np.random.RandomState(seed)
    protos = rs.randint(0, 256, size=(k, d))
    return np.clip(protos[rs.randint(k, size=n)] + rs.randint(-20, 21, size=(n, d)),
                   0, 255).astype(np.uint8)


def no_splits(*clusterings):
    return sum(s.nsplit for c in clusterings for s in c.iteration_stats) == 0


def objs(clus):
    return [s.obj for s in clus.iteration_stats]


OPTIONS = {
    "weighted": (dict(), True),
    "int": (dict(int_centroids=True), False),
    "frozen": (dict(frozen_centroids=True), False),
    "weighted_int": (dict(int_centroids=True), True),
    "weighted_subsampled": (dict(max_points_per_centroid=150), True),
}


@pytest.mark.parametrize("option", list(OPTIONS))
def test_weighted_int_frozen_loops_match_reference(option):
    """Clustering.train with weights, integer or frozen centroids: the
    per-iteration objectives agree (rtol 1e-4); frozen centroids stay the
    init's."""
    kw, weighted = OPTIONS[option]
    x = blobs(0, 3000, 16, 12) * 10
    w = (np.random.RandomState(1).rand(len(x)) + 0.5).astype(np.float32)
    w = w if weighted else None
    a = ftj.Clustering(16, 12, ftj.ClusteringParameters(niter=6, seed=3, **kw))
    b = ct.Clustering(16, 12, ct.ClusteringParameters(niter=6, seed=3, **kw),
                      device="cpu")
    oa, ob = a.train(x, weights=w), b.train(x, weights=w)
    assert no_splits(a, b)
    np.testing.assert_allclose(objs(b), objs(a), rtol=1e-4)
    np.testing.assert_allclose(ob, oa, rtol=1e-4)
    if "int_centroids" in kw:
        assert np.array_equal(b.centroids, np.round(b.centroids))
    if "frozen_centroids" in kw:
        init = ct.Clustering(16, 12, ct.ClusteringParameters(niter=0, seed=3),
                             device="cpu")
        init.train(x)
        assert np.array_equal(b.centroids, init.centroids)
        assert len(set(objs(b))) == 1


@pytest.mark.parametrize("init_method", ["random", "kmeans++", "afkmc2"])
@pytest.mark.parametrize("weighted", [False, True])
def test_inits_bit_identical(init_method, weighted):
    """Subsampling (of the weights too) and every init draw from the same
    RandomState calls: with niter = 0 the centroids are bit-identical."""
    x = blobs(2, 2500, 8, 10)
    w = np.random.RandomState(4).rand(len(x)).astype(np.float32) if weighted else None
    kw = dict(niter=0, seed=11, init_method=init_method, max_points_per_centroid=200)
    a = ftj.Clustering(8, 10, ftj.ClusteringParameters(**kw))
    b = ct.Clustering(8, 10, ct.ClusteringParameters(**kw), device="cpu")
    a.train(x, weights=w)
    b.train(x, weights=w)
    assert np.array_equal(a.centroids, b.centroids)
    rs = np.random.RandomState(5)
    assert np.array_equal(cj._kmeans_pp_init(x, 6, np.random.RandomState(5)),
                          ct._kmeans_pp_init(x, 6, rs))
    assert np.array_equal(cj._afk_mc2_init(x, 6, np.random.RandomState(6), 50),
                          ct._afk_mc2_init(x, 6, np.random.RandomState(6), 50))


def test_split_clusters_and_imbalance_factor_match_reference():
    """The host split of empty clusters and the imbalance factor, equal."""
    rs = np.random.RandomState(7)
    c0 = rs.rand(8, 5).astype(np.float32)
    counts0 = np.array([9, 0, 4, 0, 7, 1, 0, 3])
    ca, na = c0.copy(), counts0.copy()
    cb, nb = c0.copy(), counts0.copy()
    sa = ftj.Clustering._split_clusters(ca, na, np.random.RandomState(3))
    sb = ct.Clustering._split_clusters(cb, nb, np.random.RandomState(3))
    assert sa == sb == 3
    assert np.array_equal(ca, cb) and np.array_equal(na, nb)
    assert cj.imbalance_factor(counts0) == ct.imbalance_factor(counts0)
    assert np.isnan(ct.imbalance_factor(np.zeros(4)))


def test_uint8_loop_matches_reference(monkeypatch):
    """The uint8 loop against faiss_tpu's (objective rtol 1e-4, centroids
    rtol 1e-4 / atol 1e-3); the points reach the loop as uint8."""
    xi = pixels(3, 4000, 24, 8)
    seen = []
    real = ct.kmeans_fused_loop

    def spy(x, *args, **kw):
        seen.append(x.dtype)
        return real(x, *args, **kw)

    monkeypatch.setattr(ct, "kmeans_fused_loop", spy)
    ka = ftj.Kmeans(24, 8, niter=12, seed=5, max_points_per_centroid=10**9)
    kb = ftt.Kmeans(24, 8, niter=12, seed=5, max_points_per_centroid=10**9,
                    device="cpu")
    oa, ob = ka.train(xi), kb.train(xi)
    assert seen == [torch.uint8]
    assert no_splits(ka, kb)
    assert abs(oa - ob) <= 1e-4 * oa
    np.testing.assert_allclose(kb.obj, ka.obj, rtol=1e-4)
    np.testing.assert_allclose(kb.centroids, ka.centroids, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("chunk", [4000, 1024, 999])
def test_uint8_loop_counts_every_row_once(chunk):
    """Chunks that do not divide n (the last one ragged) count each row
    once and give the one-chunk result; the uint8 loop equals faiss_tpu's
    uint8 loop called directly."""
    xi = pixels(8, 4000, 20, 6)
    init = xi[np.random.RandomState(2).permutation(len(xi))[:6]].astype(np.float32)
    out = kt.kmeans_fused_loop(torch.from_numpy(xi), torch.from_numpy(init),
                               torch.Generator(), niter=5, chunk=chunk)
    c, o, _, tots, ns, counts = out
    assert (tots.numpy() == len(xi)).all() and int(counts.sum()) == len(xi)
    ref = kj.kmeans_fused_loop(jnp.asarray(xi), jnp.asarray(init),
                               jax.random.PRNGKey(0), niter=5, chunk=1024)
    assert int(ns.sum()) == 0 and int(np.asarray(ref[4]).sum()) == 0
    np.testing.assert_allclose(o.numpy(), np.asarray(ref[1]), rtol=1e-5)
    np.testing.assert_allclose(c.numpy(), np.asarray(ref[0]), rtol=1e-4, atol=1e-3)
    with pytest.raises(NotImplementedError, match="unweighted"):
        kt.kmeans_fused_loop(torch.from_numpy(xi), torch.from_numpy(init),
                             torch.Generator(), torch.ones(len(xi)), niter=1,
                             chunk=chunk)


def test_uint8_with_weights_or_kmeanspp_takes_float_path(monkeypatch):
    """Weights or a k-means++ init send uint8 points down the float32 path,
    as in faiss_tpu (:198-202); the objectives agree."""
    xi = pixels(4, 1500, 8, 4)
    w = (np.random.RandomState(4).rand(len(xi)) + 0.5).astype(np.float32)
    seen = []
    real = ct.kmeans_fused_loop
    monkeypatch.setattr(ct, "kmeans_fused_loop",
                        lambda x, *a, **k: seen.append(x.dtype) or real(x, *a, **k))
    for kw, weights in ((dict(), w), (dict(init_method="kmeans++"), None)):
        ka = ftj.Kmeans(8, 4, niter=5, seed=5, max_points_per_centroid=10**9, **kw)
        kb = ftt.Kmeans(8, 4, niter=5, seed=5, max_points_per_centroid=10**9,
                        device="cpu", **kw)
        oa, ob = ka.train(xi, weights=weights), kb.train(xi, weights=weights)
        assert no_splits(ka, kb)
        np.testing.assert_allclose(ob, oa, rtol=1e-4)
    assert seen == [torch.float32, torch.float32]


def test_kmeans_train_and_assign_match_reference():
    """Kmeans: objectives per iteration, then assign through IndexFlatL2:
    ids equal up to ties, distances within 1e-5 (|x|^2 + |c|^2); gpu= is
    accepted and ignored, an unknown parameter raises."""
    from faiss_tpu_torch.utils.evaluation import ids_agree_tie_aware

    x = blobs(5, 3000, 16, 10)
    ka = ftj.Kmeans(16, 10, niter=8, seed=9, gpu=True)
    kb = ftt.Kmeans(16, 10, niter=8, seed=9, gpu=True, device="cpu")
    ka.train(x)
    kb.train(x)
    assert no_splits(ka, kb)
    np.testing.assert_allclose(kb.obj, ka.obj, rtol=1e-4)
    Da, Ia = ka.assign(x[:500])
    Db, Ib = kb.assign(x[:500])
    assert Ib.dtype == np.int64 and Ib.min() >= 0
    tol = 1e-5 * ((x[:500] ** 2).sum(1) + (ka.centroids ** 2).sum(1).max())
    assert (np.abs(Da - Db) <= tol).all()
    assert ids_agree_tie_aware(Da[:, None], Ia[:, None], Db[:, None], Ib[:, None],
                               tol).all()
    d2 = ((x[:500, None].astype(np.float64) - kb.centroids[None]) ** 2).sum(-1)
    assert (d2[np.arange(500), Ib] <= d2.min(1) + tol).all()
    # a warm start from given centroids
    ka.train(x, init_centroids=ka.centroids)
    kb.train(x, init_centroids=ka.centroids)
    np.testing.assert_allclose(kb.obj, ka.obj, rtol=1e-4)
    with pytest.raises(TypeError, match="unknown Kmeans parameter"):
        ftt.Kmeans(16, 10, device="cpu", bogus=1)


def test_kmeans_clustering_matches_reference():
    x = blobs(6, 2000, 12, 8)
    a = ftj.kmeans_clustering(12, 8, x, niter=6, seed=4)
    b = ftt.kmeans_clustering(12, 8, x, niter=6, seed=4, device="cpu")
    assert b.shape == (8, 12) and b.dtype == np.float32

    def objective(c):
        return ((x[:, None].astype(np.float64) - c[None]) ** 2).sum(-1).min(1).sum()

    np.testing.assert_allclose(objective(b), objective(a), rtol=1e-4)


@pytest.mark.parametrize("n,k", [(1, 3), (40, 1), (300, 5), (1000, 16)])
def test_kmeans1d_bit_identical(n, k):
    x = np.random.RandomState(n + k).randn(n).astype(np.float32)
    ca, aa = ftj.kmeans1d(x, k)
    cb, ab = ftt.kmeans1d(x, k)
    assert ca.dtype == cb.dtype and np.array_equal(ca, cb)
    assert aa.dtype == ab.dtype and np.array_equal(aa, ab)


def test_progressive_dim_clustering_matches_reference(monkeypatch):
    """ProgressiveDimClustering over the port's PCAMatrix: objective within
    rtol 1e-3 (the PCA applies differ in their float32 products); no step
    of either package splits a cluster."""
    x = blobs(3, 3000, 24, 12)
    steps = []
    for mod in (cj, ct):
        train = mod.Clustering.train

        def spy(self, *args, _train=train, **kw):
            out = _train(self, *args, **kw)
            steps.append(self)
            return out

        monkeypatch.setattr(mod.Clustering, "train", spy)
    a = ftj.ProgressiveDimClustering(24, 8)
    a.cp.niter = 10
    b = ftt.ProgressiveDimClustering(
        24, 8, ftt.ProgressiveDimClusteringParameters(niter=10), device="cpu")
    oa, ob = a.train(x), b.train(x)
    assert len(steps) == 20 and no_splits(*steps)
    np.testing.assert_allclose(ob, oa, rtol=1e-3)
    assert b.centroids.shape == (8, 24)


@pytest.mark.parametrize("weighted", [False, True])
def test_superkmeans_matches_reference(weighted):
    """SuperKMeans: objective <= 1.05 x exact Lloyd (tests/test_clustering.py
    :137) and within rtol 1e-3 of faiss_tpu's; the pruned share is recorded
    per iteration after the first. Weighted training runs the exact loop."""
    x = blobs(0, 4000, 32, 12)
    w = (np.random.RandomState(2).rand(len(x)) + 0.5).astype(np.float32) if weighted else None
    a = cj.SuperKMeans(32, 16, cj.SuperKMeansParameters(niter=8, seed=3))
    b = ftt.SuperKMeans(32, 16, ftt.SuperKMeansParameters(niter=8, seed=3),
                        device="cpu")
    oa, ob = a.train(x, weights=w), b.train(x, weights=w)
    exact = ct.Clustering(32, 16, ct.ClusteringParameters(niter=8, seed=3),
                          device="cpu")
    oe = exact.train(x, weights=w)
    assert no_splits(exact)
    assert ob <= 1.05 * oe + 1e-6
    np.testing.assert_allclose(ob, oa, rtol=1e-3)
    assert b.centroids.shape == (16, 32)
    if weighted:
        assert len(b.iteration_stats) == 8 and not b.pruning_fractions
    else:
        assert len(b.pruning_fractions) == 7
        assert all(0.0 <= f <= 1.0 for f in b.pruning_fractions)
        assert b.pruning_fractions[-1] > 0.5


def test_superkm_assign_update_exactness():
    """With keep == k the iteration is the exact argmin (faiss_tpu's
    test_superkm_assign_update_exactness), on both packages."""
    rs = np.random.RandomState(2)
    x = rs.randn(500, 32).astype(np.float32)
    c = rs.randn(16, 32).astype(np.float32)
    d2 = ((x[:, None].astype(np.float64) - c[None]) ** 2).sum(-1)
    new_c, tau, obj, _, tot, frac = kt.superkm_assign_update(
        torch.from_numpy(x), torch.from_numpy(c), 0.5, torch.Generator(), 16, 16,
        chunk=128)
    np.testing.assert_allclose(tau.numpy(), d2.min(1), rtol=1e-4, atol=1e-4)
    assert abs(float(obj) - d2.min(1).sum()) / d2.min(1).sum() < 1e-4
    assert int(tot) == 500 and 0.0 <= float(frac) <= 1.0
    ref = kj.superkm_assign_update(jnp.asarray(x), jnp.asarray(c), 0.5,
                                   jax.random.PRNGKey(0), 16, 16)
    np.testing.assert_allclose(float(obj), float(ref[2]), rtol=1e-4)
    np.testing.assert_allclose(float(frac), float(ref[5]), atol=1e-3)
    a = d2.argmin(1)
    if (np.bincount(a, minlength=16) > 0).all():  # no split: the means
        means = np.stack([x[a == j].mean(0) for j in range(16)])
        np.testing.assert_allclose(new_c.numpy(), means, rtol=1e-4, atol=1e-5)


def test_adsampling_helpers_equal():
    """Thresholds, the PDX layout and partial norms equal faiss_tpu's; the
    batch assignment agrees (exact distances, ids up to ties)."""
    for p in (0.001, 0.5, 0.975):
        assert adt.normal_quantile(p) == adj.normal_quantile(p)
    for p, alpha in ((16, 0.999), (40, 0.9)):
        assert adt.chi2_quantile_wh(p, alpha) == adj.chi2_quantile_wh(p, alpha)
    for d, eps in ((32, 1e-3), (100, 0.05)):
        a, b = adj.precompute_ad_thresholds(d, eps), adt.precompute_ad_thresholds(d, eps)
        assert a.dtype == b.dtype and np.array_equal(a, b)
    rs = np.random.RandomState(3)
    Y = rs.randn(10, 21).astype(np.float32)
    for bs in (4, 8, 21):
        pa, pb = adj.pdxify(Y, bs), adt.pdxify(Y, bs)
        assert np.array_equal(pa, pb)
        assert np.array_equal(adt.de_pdxify(pb, 10, 21, bs), Y)
    assert np.array_equal(adj.compute_partial_norms(Y, 7), adt.compute_partial_norms(Y, 7))
    x = blobs(1, 600, 48, 12)
    c = blobs(2, 40, 48, 12)
    da, ia = adj.assign_adsampling(x, c, d_prime=16, keep=8)
    db, ib = adt.assign_adsampling(torch.from_numpy(x), torch.from_numpy(c),
                                   d_prime=16, keep=8)
    assert ib.dtype == torch.int32
    np.testing.assert_allclose(db.numpy(), da, rtol=1e-4, atol=1e-4)
    d2 = ((x[:, None].astype(np.float64) - c[None]) ** 2).sum(-1)
    tol = 1e-4 * (1 + d2.min(1))
    assert ((ib.numpy() == ia) | (np.abs(d2[np.arange(600), ib.numpy()]
                                         - d2[np.arange(600), ia]) <= tol)).all()


def test_new_entry_points_need_a_card(monkeypatch):
    """The card is the default device: with none, the new entry points raise
    rather than fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: ftt.Kmeans(8, 4), lambda: ftt.Clustering(8, 4),
                 lambda: ftt.SuperKMeans(8, 4), lambda: ftt.ProgressiveDimClustering(8, 4),
                 lambda: ftt.kmeans_clustering(8, 4, np.zeros((10, 8), np.float32))):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            make()


def test_chip_smoke_row12_data_equals_job_generator(monkeypatch, tmp_path):
    """chip_smoke's BASELINE row 12 set (its copy of
    benchs/jobs/job_kmeans_row12.py's generator, seed 42) bit for bit
    against the job's load_or_gen at a small n (one of its 500k-row
    batches), the job's cache file redirected to a temporary directory."""
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    monkeypatch.syspath_prepend(str(root))
    monkeypatch.syspath_prepend(str(root / "benchs" / "jobs"))
    import chip_smoke as cs
    import job_kmeans_row12 as job

    n = 3000
    monkeypatch.setattr(job, "N", n)
    monkeypatch.setattr(job, "DATA", str(tmp_path / "row12.npy"))
    monkeypatch.setattr(job, "log", lambda m: None)
    ref = np.asarray(job.load_or_gen())
    got = cs.row12_data(n)
    assert got.dtype == ref.dtype == np.uint8 and got.shape == (n, cs.ROW12_D)
    assert np.array_equal(got, ref)
