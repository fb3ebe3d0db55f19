"""Port parity for training: faiss_tpu_torch's k-means loop, batched PQ
k-means and Clustering against faiss_tpu on the same inputs. Objectives are
compared, not centroids; faiss_tpu assigns through a 3-pass bf16 product
(~2^-16 relative), the port in exact float32, hence rtol 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import faiss_tpu as ftj
from faiss_tpu.ops import kmeans_ops as kj
from faiss_tpu_torch import clustering as ct_clustering
from faiss_tpu_torch.ops import kmeans_ops as kt
from torch_threads import one_torch_thread  # noqa: F401


def blobs(seed, n, d, ncent):
    """Well separated clusters, so no cluster empties and the two packages'
    different empty-cluster donor streams never come into play."""
    rs = np.random.RandomState(seed)
    cent = rs.rand(ncent, d).astype(np.float32) * 4
    a = rs.randint(ncent, size=n)
    return (cent[a] + 0.3 * rs.randn(n, d)).astype(np.float32)


def test_kmeans_fused_loop_objectives_match():
    x = blobs(0, 3000, 16, 12)
    init = x[np.random.RandomState(1).permutation(len(x))[:16]]
    _, objs_j, _, _, ns_j, _ = kj.kmeans_fused_loop(
        jnp.asarray(x), jnp.asarray(init), jax.random.PRNGKey(0), niter=6
    )
    c, objs_t, _, tots, ns_t, counts = kt.kmeans_fused_loop(
        torch.from_numpy(x), torch.from_numpy(init), torch.Generator(),
        niter=6, chunk=1024,
    )
    assert int(np.asarray(ns_j).sum()) == 0 and int(ns_t.sum()) == 0
    np.testing.assert_allclose(objs_t.numpy(), np.asarray(objs_j), rtol=1e-4)
    assert (np.diff(objs_t.numpy()) <= 1e-3 * objs_t.numpy()[0]).all()
    assert (tots.numpy() == len(x)).all() and int(counts.sum()) == len(x)


def test_batched_kmeans_objectives_match():
    rs = np.random.RandomState(2)
    M, n, dsub, k = 4, 600, 4, 16
    xs = rs.randn(M, n, dsub).astype(np.float32)
    init = xs[:, rs.permutation(n)[:k], :]

    def objective(c):  # sum over subspaces of squared distance to nearest
        d2 = ((xs[:, :, None, :] - np.asarray(c)[:, None, :, :]) ** 2).sum(-1)
        return float(d2.min(-1).sum())

    for niter in (1, 2, 4):
        cj = kj.batched_kmeans(jnp.asarray(xs), jnp.asarray(init), k, niter)
        cthat = kt.batched_kmeans(
            torch.from_numpy(xs), torch.from_numpy(init), niter
        )
        np.testing.assert_allclose(
            objective(cthat.numpy()), objective(cj), rtol=1e-4
        )


def test_clustering_init_bit_identical_and_objectives_match():
    """Subsampling and init draw from np.random.RandomState(seed) exactly as
    faiss_tpu does: with niter=0 the centroids are bit-identical, and the
    per-iteration objectives of a full run agree."""
    x = blobs(4, 5000, 8, 10)
    for niter in (0, 5):
        cpj = ftj.ClusteringParameters(
            niter=niter, seed=77, max_points_per_centroid=200
        )
        cpt = ct_clustering.ClusteringParameters(
            niter=niter, seed=77, max_points_per_centroid=200
        )
        cj = ftj.Clustering(8, 8, cpj)
        ct = ct_clustering.Clustering(8, 8, cpt, device="cpu")
        obj_j, obj_t = cj.train(x), ct.train(x)
        if niter == 0:
            assert np.array_equal(cj.centroids, ct.centroids)
            assert obj_j == obj_t == np.inf
        else:
            assert sum(s.nsplit for s in cj.iteration_stats + ct.iteration_stats) == 0
            np.testing.assert_allclose(
                [s.obj for s in ct.iteration_stats],
                [s.obj for s in cj.iteration_stats], rtol=1e-4,
            )
            np.testing.assert_allclose(obj_t, obj_j, rtol=1e-4)


def test_split_empty_clusters_reseeds_from_donors():
    """An empty slot takes a non-empty donor scaled by (1 + EPS); each donor
    used shrinks once by (1 - EPS); others are untouched."""
    rs = np.random.RandomState(3)
    c = torch.from_numpy(rs.rand(6, 4).astype(np.float32) + 1)
    counts = torch.tensor([5.0, 0.0, 9.0, 0.0, 3.0, 1.0])
    out, nsplit = kt._split_empty_clusters(
        c, counts, torch.Generator().manual_seed(0)
    )
    assert int(nsplit) == 2
    eps = kt.EPS
    donors = set()
    for e in (1, 3):
        ratio = (out[e] / (1 + eps)).numpy()
        match = [j for j in (0, 2, 4) if np.allclose(ratio, c[j].numpy())]
        assert match, e
        donors.add(match[0])
    for j in (0, 2, 4, 5):
        scale = (1 - eps) if j in donors else 1.0
        np.testing.assert_allclose(out[j].numpy(), c[j].numpy() * scale)
