"""Port parity for the sharded indexes (faiss_tpu_torch/parallel/sharded.py)
against faiss_tpu/parallel/sharded.py: the port's classes on a mesh of four
CPU devices (``make_mesh(devices=["cpu"] * 4)``) against faiss_tpu's on four
devices of the virtual CPU mesh (tests/conftest.py), on the shapes of
tests/test_sharded.py (SyntheticDataset(32, 2000, 6000, 64)). Each port
index is built from the arrays of the trained faiss_tpu index
(faiss_tpu_torch.convert), so the comparison does not depend on k-means RNG;
each faiss_tpu index is trained once per module.

Tolerances: distances within 1e-5 relative (of each row's largest
magnitude), ids equal up to ties at that tolerance
(utils/evaluation.ids_agree_tie_aware). Where faiss_tpu is at fault (codes
above 8 bits wrapping in ShardedIVFPQBuilder.add_preassigned, the extra
metrics scored as inner products in ShardedIVF), the port is held to
float64 instead (ROADMAP queue 3)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import faiss_tpu as ftj
import faiss_tpu_torch as ftt
from faiss_tpu.ops.topk import merge_topk_many as ref_merge
from faiss_tpu.parallel import sharded as ref_sh
from faiss_tpu.utils.datasets import SyntheticDataset
from faiss_tpu_torch import convert
from faiss_tpu_torch.metric import MetricType
from faiss_tpu_torch.ops.topk import merge_topk_many
from faiss_tpu_torch.parallel import sharded as port_sh
from faiss_tpu_torch.utils.evaluation import ids_agree_tie_aware
from torch_threads import one_torch_thread  # noqa: F401

D_, NLIST, K, NPROBE = 32, 16, 10, 4
L2, IP = MetricType.L2, MetricType.INNER_PRODUCT


@pytest.fixture(scope="module")
def ds():
    d = SyntheticDataset(D_, 2000, 6000, 64)
    return d.get_train(), d.get_database(), d.get_queries()


@pytest.fixture(scope="module")
def meshes():
    return ref_sh.make_mesh(4), ftt.make_mesh(devices=["cpu"] * 4)


def assert_same(D, I, Dr, Ir, xq, xb, largest=False):
    """D within 1e-5 of each row's float32 scale, |q|^2 + max |x|^2 (L2) or
    |q| max |x| (inner product): the rounding of the norm expansions and
    products, which the two packages order differently; ids equal up to
    ties at it."""
    D, Dr = np.asarray(D, np.float64), np.asarray(Dr, np.float64)
    fin = np.isfinite(Dr)
    assert (np.isfinite(D) == fin).all()
    qn2 = (xq.astype(np.float64) ** 2).sum(1)
    xn2 = (xb.astype(np.float64) ** 2).sum(1).max()
    scale = np.sqrt(qn2 * xn2) if largest else qn2 + xn2
    err = np.abs(np.where(fin, D - Dr, 0))
    assert (err <= 1e-5 * scale[:, None]).all(), float((err / scale[:, None]).max())
    sign = -1.0 if largest else 1.0
    assert ids_agree_tie_aware(sign * np.where(fin, D, 0), I,
                               sign * np.where(fin, Dr, 0), Ir, 1e-5 * scale).all()


@pytest.mark.parametrize("metric", [L2, IP])
def test_sharded_flat(ds, meshes, metric):
    _, xb, xq = ds
    ref = ref_sh.ShardedFlat(D_, meshes[0], int(metric))
    ref.add(xb[:3000])
    ref.add(xb[3000:5999])  # 5999 rows: the last shard holds a pad row
    port = ftt.ShardedFlat(D_, meshes[1], metric)
    port.add(xb[:3000])
    port.add(xb[3000:5999])
    Dr, Ir = ref.search(xq, K)
    D, I = port.search(xq, K)
    assert I.dtype == np.int64 and (I < 5999).all()
    assert_same(D, I, Dr, Ir, xq, xb, metric == IP)


def filled(cls, metric, cent):
    q = cls(D_)
    q.add(cent)
    return q


@pytest.fixture(scope="module")
def ivfflat(ds):
    """faiss_tpu IndexIVFFlat per metric: L2 trained, inner product over the
    same centroids."""
    xt, xb, _ = ds
    ref = ftj.IndexIVFFlat(None, D_, NLIST)
    ref.cp.niter = 4
    ref.train(xt)
    out = {L2: ref}
    out[IP] = ftj.IndexIVFFlat(filled(ftj.IndexFlatIP, IP, ref.quantizer.vectors()),
                               D_, NLIST, int(IP))
    for r in out.values():
        r.add(xb)
        r.nprobe = NPROBE
    return out


def port_ivfflat(ref, metric=None):
    return convert.ivfflat_from_arrays(
        ref.quantizer.vectors(), ref._codes_host, ref._listnos_host,
        ref._ids_host, device="cpu",
        metric=ref.metric_type if metric is None else metric)


@pytest.mark.parametrize("metric", [L2, IP])
@pytest.mark.parametrize("nprobe", [1, NPROBE])
def test_sharded_ivf(ds, meshes, ivfflat, metric, nprobe):
    _, xb, xq = ds
    ref = ivfflat[metric]
    Dr, Ir = ref_sh.ShardedIVF(ref, meshes[0]).search(xq, K, nprobe=nprobe)
    D, I = ftt.ShardedIVF(port_ivfflat(ref), meshes[1]).search(xq, K, nprobe=nprobe)
    assert_same(D, I, Dr, Ir, xq, xb, metric == IP)


@pytest.fixture(scope="module")
def ivfpq(ds, ivfflat):
    """faiss_tpu IndexIVFPQ (M 4, 8 bits) per (metric, residual) over the
    IVF-Flat's coarse centroids; the PQ is trained once (L2 by residual)
    and its codebooks given to the other three."""
    xt, xb, _ = ds
    cent = ivfflat[L2].quantizer.vectors()
    out = {}
    for metric, by_res in ((L2, True), (L2, False), (IP, True), (IP, False)):
        q = filled(ftj.IndexFlatL2 if metric == L2 else ftj.IndexFlatIP, metric, cent)
        ref = ftj.IndexIVFPQ(q, D_, NLIST, 4, 8, int(metric))
        ref.by_residual = by_res
        if out:
            ref.pq.centroids = out[L2, True].pq.centroids.copy()
            ref.is_trained = True
        else:
            ref.pq.cp.niter = 4
            ref.train(xt)
        ref.add(xb)
        ref.nprobe = NPROBE
        out[metric, by_res] = ref
    return out


def port_ivfpq(ref):
    return convert.ivfpq_from_arrays(
        ref.quantizer.vectors(), ref.pq.centroids, ref._codes_host,
        ref._listnos_host, ref._ids_host, device="cpu",
        by_residual=ref.by_residual, metric=ref.metric_type)


@pytest.mark.parametrize("metric", [L2, IP])
@pytest.mark.parametrize("by_res", [True, False])
def test_sharded_ivfpq(ds, meshes, ivfpq, metric, by_res):
    _, xb, xq = ds
    ref = ivfpq[metric, by_res]
    Dr, Ir = ref_sh.ShardedIVFPQ(ref, meshes[0]).search(xq, K, nprobe=NPROBE)
    port = ftt.ShardedIVFPQ(port_ivfpq(ref), meshes[1])
    assert (port.term2 is not None) == (metric == L2 and by_res)
    D, I = port.search(xq, K, nprobe=NPROBE)
    assert_same(D, I, Dr, Ir, xq, xb, metric == IP)
    # and the unsharded port index's search by probe
    Du, Iu = port.index.search(xq, K, params=ftt.SearchParametersIVF(nprobe=NPROBE))
    assert_same(D, I, Du, Iu, xq, xb, metric == IP)


def cut_ties(refined, xq, D, I, Dr, Ir, kc, nprobe, tol):
    """Rows whose ids differ (beyond ties of the re-ranked distances) may
    differ only in ids that tie with their shard's kc-th ADC key: the two
    packages break ADC ties at the candidate cut differently. Returns the
    number of such rows."""
    sh = refined.sharded
    ok = ids_agree_tie_aware(D, I, Dr, Ir, tol)
    for r in np.nonzero(~ok)[0]:
        x = torch.from_numpy(xq[r : r + 1])
        for i in set(I[r]) ^ set(Ir[r]):
            slot = int(np.nonzero(sh._ids_host == i)[0][0])
            s = int(sh.index._listnos_host[slot]) // sh.lists_per_shard
            keys, slots = sh._scan_shard(s, x, len(sh._ids_host), nprobe,
                                         sh.lists[s])
            key = keys[0][slots[0] == slot]
            assert len(key) == 1 and abs(float(key[0]) - float(keys[0, kc - 1])) <= tol[r]
    return int((~ok).sum())


def test_sharded_refined_ivfpq(ds, meshes, ivfpq):
    _, xb, xq = ds
    ref = ivfpq[L2, True]
    Dr, Ir = ref_sh.ShardedRefinedIVFPQ(ref, meshes[0], xb, k_factor=4).search(
        xq, K, nprobe=NPROBE)
    port = convert.sharded_refined_ivfpq_from_arrays(
        ref.quantizer.vectors(), ref.pq.centroids, ref._codes_host,
        ref._listnos_host, ref._ids_host, xb, meshes[1], k_factor=4)
    D, I = port.search(xq, K, nprobe=NPROBE)
    # exact to the fp16 store in float64
    x16 = xb.astype(np.float16).astype(np.float64)
    d64 = ((xq[:, None, :].astype(np.float64) - x16[I]) ** 2).sum(-1)
    np.testing.assert_allclose(D, d64, rtol=1e-5, atol=1e-5)
    tol = 1e-5 * ((xq.astype(np.float64) ** 2).sum(1)
                  + (xb.astype(np.float64) ** 2).sum(1).max())
    assert cut_ties(port, xq, D, I, Dr, Ir, 4 * K, NPROBE, tol) <= 2


def test_sharded_kmeans_iter(ds, meshes):
    xt, _, _ = ds
    cent = xt[np.random.RandomState(5).permutation(len(xt))[:NLIST]]
    rs_, rc, ro = ref_sh.sharded_kmeans_iter(meshes[0], jnp.asarray(xt),
                                             jnp.asarray(cent))
    ps, pc, po = ftt.sharded_kmeans_iter(meshes[1], xt, cent)
    np.testing.assert_array_equal(pc.numpy(), np.asarray(rc))
    np.testing.assert_allclose(ps.numpy(), np.asarray(rs_), rtol=1e-5,
                               atol=1e-5 * np.abs(np.asarray(rs_)).max())
    np.testing.assert_allclose(float(po), float(ro), rtol=1e-5)
    # the shards' sums are the unsharded reduction's
    from faiss_tpu_torch.ops.kmeans_ops import kmeans_assign_update

    us, uc, uo, ua = kmeans_assign_update(torch.from_numpy(xt), torch.from_numpy(cent))
    np.testing.assert_array_equal(uc.numpy(), pc.numpy())
    assert ua.shape == (len(xt),) and int(ua.max()) < NLIST
    np.testing.assert_allclose(float(uo), float(po), rtol=1e-5)
    with pytest.raises(ValueError):  # 1999 rows do not split over 4 shards
        ftt.sharded_kmeans_iter(meshes[1], xt[:1999], cent)


def test_sharded_ivfpq_builder(ds, meshes):
    xt, xb, xq = ds
    ref = ref_sh.ShardedIVFPQBuilder(D_, NLIST, 4, 8, meshes[0])
    ref.train(xt, niter=2, pq_sample=4096)
    port = ftt.ShardedIVFPQBuilder(D_, NLIST, 4, 8, meshes[1])
    port.train(xt, niter=2, pq_sample=4096)
    # the same draws and sums: the coarse centroids agree to float32
    np.testing.assert_allclose(port.centroids, ref.centroids, rtol=1e-5, atol=1e-5)
    xp, _ = port_sh._shard_pad(xt, 4)
    _, _, ro = ref_sh.sharded_kmeans_iter(meshes[0], jnp.asarray(xp),
                                          jnp.asarray(ref.centroids))
    _, _, po = ftt.sharded_kmeans_iter(meshes[1], xp, port.centroids)
    np.testing.assert_allclose(float(po), float(ro), rtol=1e-5)
    # the search from faiss_tpu's trained state, added in two chunks
    ref.add(xb)
    built = convert.ivfpq_builder_from_arrays(ref.centroids, ref.pq.centroids,
                                              meshes[1])
    built.add(xb[:2500])
    built.add(xb[2500:], chunk=1000)
    Dr, Ir = ref.finalize().search(xq, K, nprobe=NPROBE)
    D, I = built.finalize().search(xq, K, nprobe=NPROBE)
    assert_same(D, I, Dr, Ir, xq, xb)


def adc64_in_probes(out, xq, probes, k):
    """float64 ADC (L2 by residual) of every entry of each query's probed
    lists, from the builder's own codes: the best k distances."""
    cent = out.centroids[0].double().numpy()
    cb = out.pq_codebooks[0].double().numpy()
    res = []
    lps = out.lists_per_shard
    for q in range(len(xq)):
        ds = []
        for ln in probes[q]:
            s, l = divmod(int(ln), lps)
            lists = out.lists[s]
            o, n = int(lists.offsets[l]), int(lists.lengths[l])
            codes = lists.codes[o : o + n].long().numpy()
            rec = cent[ln] + np.concatenate([cb[m, codes[:, m]]
                                             for m in range(cb.shape[0])], 1)
            ds.append(((xq[q].astype(np.float64) - rec) ** 2).sum(1))
        res.append(np.sort(np.concatenate(ds))[:k])
    return np.array(res)


def test_builder_codes_above_8_bits(ds, meshes):
    """faiss_tpu's add_preassigned casts the codes to uint8, so 10-bit codes
    wrap there (ROADMAP queue 3): the port keeps uint16 codes and its search
    is the float64 ADC of its probed lists."""
    xt, xb, xq = ds
    rs = np.random.RandomState(3)
    cent = xt[rs.permutation(len(xt))[:NLIST]]
    cb = rs.randn(4, 1024, D_ // 4).astype(np.float32) * 0.1
    b = convert.ivfpq_builder_from_arrays(cent, cb, meshes[1])
    b.add(xb)
    assert b._codes[0][0].dtype == np.uint16
    assert max(int(c.max()) for s in b._codes for c in s) > 255
    out = b.finalize()
    assert out.lists[0].codes.dtype == torch.int32
    D, I = out.search(xq, K, nprobe=2)
    qd = ((xq[:, None, :].astype(np.float64) - cent[None].astype(np.float64)) ** 2).sum(-1)
    probes = np.argsort(qd, 1, kind="stable")[:, :2]
    ref64 = adc64_in_probes(out, xq, probes, K)
    np.testing.assert_allclose(D, ref64, rtol=1e-5, atol=1e-5)


def test_sharded_ivf_extra_metric(ds, meshes, ivfflat):
    """Under L1 faiss_tpu's ShardedIVF scores inner products (ROADMAP queue
    3); the port's is the float64 L1 over its probed lists."""
    _, xb, xq = ds
    ref = ivfflat[L2]
    port = port_ivfflat(ref, MetricType.L1)
    D, I = ftt.ShardedIVF(port, meshes[1]).search(xq, K, nprobe=2)
    cent = ref.quantizer.vectors().astype(np.float64)
    q64 = xq.astype(np.float64)
    probes = np.argsort(np.abs(q64[:, None] - cent[None]).sum(-1), 1,
                        kind="stable")[:, :2]
    ln = ref._listnos_host
    for q in range(len(xq)):
        rows = np.nonzero(np.isin(ln, probes[q]))[0]
        d64 = np.abs(q64[q] - xb[ref._ids_host[rows]].astype(np.float64)).sum(1)
        np.testing.assert_allclose(D[q], np.sort(d64)[:K], rtol=1e-5)


@pytest.mark.parametrize("largest", [False, True])
def test_merge_topk_many(largest):
    rs = np.random.RandomState(7)
    vals = rs.randn(33, 4, 12).astype(np.float32)
    ids = rs.randint(0, 1 << 20, size=vals.shape).astype(np.int32)
    rv, ri = ref_merge(jnp.asarray(vals), jnp.asarray(ids), 10, largest=largest)
    v, i = merge_topk_many(torch.from_numpy(vals), torch.from_numpy(ids), 10,
                           largest=largest)
    np.testing.assert_array_equal(v.numpy(), np.asarray(rv))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ri))


def test_refusals(meshes, ivfpq, ivfflat):
    three = ftt.make_mesh(devices=["cpu"] * 3)
    with pytest.raises(ValueError, match="divisible"):
        ftt.ShardedIVF(port_ivfflat(ivfflat[L2]), three)
    with pytest.raises(ValueError, match="divisible"):
        ftt.ShardedIVFPQ(port_ivfpq(ivfpq[L2, True]), three)
    with pytest.raises(ValueError, match="divisible"):
        ftt.ShardedIVFPQBuilder(D_, NLIST, 4, 8, three)
    with pytest.raises(TypeError, match="ShardedIVFPQ"):
        ftt.ShardedIVF(port_ivfpq(ivfpq[L2, True]), meshes[1])
    with pytest.raises(TypeError):
        ftt.ShardedIVFPQ(port_ivfflat(ivfflat[L2]), meshes[1])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ftt.make_mesh()
    assert ftt.make_mesh(2, devices=["cpu"] * 4).size == 2
