"""Port parity for the extra metrics and fuzzy partitioning
(faiss_tpu_torch/ops/distances.py, models/flat.py, ops/ivf_ops.py and
ops/partitioning.py against faiss_tpu's), the port on the CPU.

The ten extra metrics (L1, Linf, Lp, Canberra, BrayCurtis, JensenShannon,
Jaccard, NaNEuclidean, ABS_INNER_PRODUCT, GOWER) go through the same seeded
numpy inputs in both packages: IndexFlat's searches equal faiss_tpu's and
float64 of the same formula within 1e-5 relative, ids tie-aware, and the
port's distance tiles equal float64. IVF-Flat under an extra metric is checked on the
port's side only, against float64 over the probed lists: faiss_tpu scores
every metric but L2 as an inner product there (ROADMAP queue 3).
``partition_fuzzy`` and ``histogram_shifted`` equal faiss_tpu's bit for
bit."""

import io

import numpy as np
import pytest
import torch

import faiss_tpu as ftj
import faiss_tpu_torch as ftt
from faiss_tpu.ops import partitioning as pj
from faiss_tpu_torch.metric import MetricType as MT
from faiss_tpu_torch.ops import distances as dt
from faiss_tpu_torch.utils.evaluation import ids_agree_tie_aware
from torch_threads import one_torch_thread  # noqa: F401

D, NB, NQ, K = 16, 1500, 24, 8
EXTRA = [MT.L1, MT.Linf, MT.Lp, MT.Canberra, MT.BrayCurtis, MT.JensenShannon,
         MT.Jaccard, MT.NaNEuclidean, MT.ABS_INNER_PRODUCT, MT.GOWER]
P = 3.0  # metric_arg of Lp


def inputs(metric, n, seed):
    """Rows for ``metric``: distributions (|x| summing to 1) for
    JensenShannon / Jaccard / BrayCurtis, 5% NaN entries for NaNEuclidean,
    and GOWER's mix of numeric [0, 1] and categorical (negative) columns
    with NaNs."""
    rs = np.random.RandomState(seed)
    x = rs.rand(n, D).astype(np.float32)
    if metric in (MT.JensenShannon, MT.Jaccard, MT.BrayCurtis):
        x = (x / x.sum(1, keepdims=True)).astype(np.float32)
    if metric in (MT.NaNEuclidean, MT.GOWER):
        x[rs.rand(n, D) < 0.05] = np.nan
    if metric == MT.GOWER:
        x[:, :4] = -rs.randint(1, 4, size=(n, 4)).astype(np.float32)
    if metric == MT.ABS_INNER_PRODUCT:
        x = x - 0.5
    return x


def metric64(x, y, metric, p=P):
    """[nx, ny] float64 distances by the formulas of faiss_tpu
    ops/distances.py:142-199."""
    x = x.astype(np.float64)[:, None, :]
    y = y.astype(np.float64)[None, :, :]
    with np.errstate(divide="ignore", invalid="ignore"):
        if metric == MT.L1:
            return np.abs(x - y).sum(-1)
        if metric == MT.Linf:
            return np.abs(x - y).max(-1)
        if metric == MT.Lp:
            return (np.abs(x - y) ** p).sum(-1)
        if metric == MT.Canberra:
            den = np.abs(x) + np.abs(y)
            return np.where(den > 0, np.abs(x - y) / den, 0.0).sum(-1)
        if metric == MT.BrayCurtis:
            num, den = np.abs(x - y).sum(-1), np.abs(x + y).sum(-1)
            return np.where(den > 0, num / den, 0.0)
        if metric == MT.JensenShannon:
            m = 0.5 * (x + y)

            def kl(a, b):
                return np.where(a > 0, a * np.log(a / b), 0.0)

            return (0.5 * (kl(x, m) + kl(y, m))).sum(-1)
        if metric == MT.Jaccard:
            num, den = np.minimum(x, y).sum(-1), np.maximum(x, y).sum(-1)
            return 1.0 - np.where(den > 0, num / den, 0.0)
        if metric == MT.NaNEuclidean:
            present = ~np.isnan(x) & ~np.isnan(y)
            s = np.where(present, x - y, 0.0) ** 2
            npres = present.sum(-1)
            return np.where(npres > 0, x.shape[-1] * s.sum(-1) / npres, np.inf)
        if metric == MT.ABS_INNER_PRODUCT:
            return np.abs(x * y).sum(-1)
        if metric == MT.GOWER:
            both = (x >= 0) & (y >= 0)
            valid = ~np.isnan(x) & ~np.isnan(y)
            per = np.where(both, np.abs(x - y), np.where(x == y, 0.0, 1.0))
            per = np.where(valid, per, 0.0)
            nv = valid.sum(-1)
            return np.where(nv > 0, per.sum(-1) / nv, np.nan)
    raise ValueError(metric)


def close(a, b64, rel=1e-5):
    """a (float32) within rel of b64 (float64), the scale each row's
    largest finite |b64|."""
    fin = np.isfinite(b64)
    assert (np.isfinite(a) == fin).all()
    scale = np.nanmax(np.where(fin, np.abs(b64), 0), axis=-1, keepdims=True) + 1e-12
    err = np.where(fin, np.abs(a - b64), 0) / scale
    assert err.max() <= rel, err.max()


def search64(xq, xb, metric, k, keep=None):
    """(D, I) of an exact float64 search, best-first, over the rows ``keep``
    [nq, nb] bool allows."""
    d = metric64(xq, xb, metric)
    sim = metric == MT.ABS_INNER_PRODUCT
    key = -d if sim else d
    if keep is not None:
        key = np.where(keep, key, np.inf)
    order = np.argsort(key, axis=1, kind="stable")[:, :k]
    Dk = np.take_along_axis(d, order, 1)
    ok = np.isfinite(np.take_along_axis(key, order, 1))
    return np.where(ok, Dk, -np.inf if sim else np.inf), np.where(ok, order, -1)


def agree(D, I, D64, I64, metric):
    """Distances within 1e-5 relative, ids tie-aware (descending metrics
    compared on their negation)."""
    close(D, D64)
    sgn = -1.0 if metric == MT.ABS_INNER_PRODUCT else 1.0
    tol = 2e-5 * (np.nanmax(np.abs(np.where(np.isfinite(D64), D64, 0)), 1) + 1e-12)
    assert ids_agree_tie_aware(sgn * D64, I64, sgn * D, I, tol).all()


@pytest.mark.parametrize("metric", EXTRA, ids=[m.name for m in EXTRA])
def test_distance_tile_matches_float64(metric, monkeypatch):
    """pairwise_distances against float64 (faiss_tpu's tile meets the same
    bound through its IndexFlat search, below), and the same values when the
    broadcast blocks are cut small (EXTRA_BLOCK_BYTES)."""
    x, y = inputs(metric, 40, 1), inputs(metric, 300, 2)
    got = dt.pairwise_distances(torch.from_numpy(x), torch.from_numpy(y), metric,
                                P).numpy()
    close(got, metric64(x, y, metric))
    monkeypatch.setattr(dt, "EXTRA_BLOCK_BYTES", 7 * 4 * D * 13)
    again = dt.pairwise_distances(torch.from_numpy(x), torch.from_numpy(y), metric, P)
    np.testing.assert_array_equal(again.numpy(), got)


@pytest.mark.parametrize("metric", EXTRA, ids=[m.name for m in EXTRA])
def test_flat_search_matches_reference(metric):
    """IndexFlat(d, metric, metric_arg): faiss_tpu's search and float64,
    over one tile and over several (db_chunk 512)."""
    xb, xq = inputs(metric, NB, 3), inputs(metric, NQ, 4)
    ref = ftj.IndexFlat(D, metric, P)
    ref.add(xb)
    Dr, Ir = ref.search(xq, K)
    port = ftt.IndexFlat(D, metric, P, device="cpu")
    port.add(xb)
    Dp, Ip = port.search(xq, K)
    D64, I64 = search64(xq, xb, metric, K)
    agree(Dp, Ip, D64, I64, metric)
    agree(Dr, Ir, D64, I64, metric)
    Dc, Ic = dt.knn(torch.from_numpy(xq), torch.from_numpy(xb), K, metric,
                    db_chunk=512, metric_arg=P)
    agree(Dc.numpy(), Ic.numpy(), D64, I64, metric)


@pytest.mark.parametrize("metric", [MT.L1, MT.ABS_INNER_PRODUCT, MT.GOWER],
                         ids=["L1", "ABS_INNER_PRODUCT", "GOWER"])
def test_flat_selector_and_range_search(metric):
    """An ID selector masks rows before the select (float64 over the kept
    rows); range_search equals faiss_tpu's (its hits, ids and distances)."""
    xb, xq = inputs(metric, NB, 5), inputs(metric, NQ, 6)
    port = ftt.IndexFlat(D, metric, device="cpu")
    port.add(xb)
    sel = ftt.IDSelectorRange(300, 900)
    Dp, Ip = port.search(xq, K, params=ftt.SearchParameters(sel=sel))
    keep = np.zeros((NQ, NB), bool)
    keep[:, 300:900] = True
    D64, I64 = search64(xq, xb, metric, K, keep)
    agree(Dp, Ip, D64, I64, metric)
    ref = ftj.IndexFlat(D, metric)
    ref.add(xb)
    d64 = metric64(xq, xb, metric)
    radius = float(np.nanmedian(d64))
    rr, rp = ref.range_search(xq, radius), port.range_search(xq, radius)
    np.testing.assert_array_equal(rr.lims, rp.lims)
    np.testing.assert_array_equal(rr.labels, rp.labels)
    np.testing.assert_allclose(rp.distances, rr.distances, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("metric", [MT.L1, MT.Linf, MT.Canberra, MT.ABS_INNER_PRODUCT],
                         ids=["L1", "Linf", "Canberra", "ABS_INNER_PRODUCT"])
def test_ivf_flat_extra_metric_against_float64(metric):
    """IndexIVFFlat under an extra metric: the coarse assignment and probes
    by the quantizer's metric, and the scan of the probed lists equal to
    float64 of the metric over exactly those lists (by probe, and through
    search_preassigned and range_search)."""
    xb, xq = inputs(metric, NB, 7), inputs(metric, NQ, 8)
    q = ftt.IndexFlat(D, metric, device="cpu")
    index = ftt.IndexIVFFlat(q, D, 8, metric, device="cpu")
    index.train(xb)
    index.add(xb)
    index.nprobe = 3
    Dp, Ip = index.search(xq, K)
    cent = q.vectors()
    _, probes = search64(xq, cent, metric, 3)
    lists = index._listnos_host
    keep = np.stack([np.isin(lists, probes[i]) for i in range(NQ)])
    ids = index._ids_host
    D64, pos = search64(xq, index._codes_host, metric, K, keep)
    agree(Dp, Ip, D64, np.where(pos >= 0, ids[np.maximum(pos, 0)], -1), metric)
    # the assignment is by the quantizer's metric
    _, a64 = search64(xb, cent, metric, 1)
    assert (lists == a64[:, 0]).mean() > 0.999
    cd = np.take_along_axis(metric64(xq, cent, metric), probes, 1).astype(np.float32)
    Ds, Is = index.search_preassigned(xq, K, probes, cd)
    agree(Ds, Is, D64, np.where(pos >= 0, ids[np.maximum(pos, 0)], -1), metric)
    radius = float(np.median(D64[:, K // 2]))
    res = index.range_search(xq, radius)
    d64 = metric64(xq, index._codes_host, metric)
    hit = keep & ((d64 > radius) if metric == MT.ABS_INNER_PRODUCT else (d64 < radius))
    for i in range(NQ):
        got = np.sort(res.labels[res.lims[i] : res.lims[i + 1]])
        want = np.sort(ids[hit[i]])
        near = np.abs(d64[i] - radius) <= 1e-5 * abs(radius)
        assert set(got) ^ set(want) <= set(ids[near])


def test_lp_metric_arg_through_factory_and_files():
    """metric_arg travels through index_factory and the npz container, both
    ways; the Lp searches equal float64 of sum |x - y|^p."""
    xb, xq = inputs(MT.Lp, NB, 9), inputs(MT.Lp, NQ, 10)
    port = ftt.index_factory(D, "Flat", MT.Lp, metric_arg=P, device="cpu")
    port.add(xb)
    assert port.metric_arg == P
    D64, I64 = search64(xq, xb, MT.Lp, K)
    agree(*port.search(xq, K), D64, I64, MT.Lp)
    ref = ftj.deserialize_index(ftt.serialize_index(port))
    assert ref.metric_arg == P and ref.metric_type == MT.Lp
    back = ftt.deserialize_index(ftj.serialize_index(ref), device="cpu")
    assert back.metric_arg == P
    agree(*back.search(xq, K), D64, I64, MT.Lp)
    ivf = ftt.index_factory(D, "IVF8,Flat", MT.Lp, metric_arg=P, device="cpu")
    assert ivf.metric_arg == P and ivf.quantizer.metric_arg == P
    rerank = dt.rerank_exact(torch.from_numpy(xq), torch.from_numpy(xb),
                             torch.from_numpy(I64[:, ::-1].copy()), K, MT.Lp,
                             metric_arg=P)
    agree(rerank[0].numpy(), rerank[1].numpy(), D64, I64, MT.Lp)


PARTITION_CASES = [
    ("float32", False, 20, 20), ("float32", True, 17, 40), ("int32", False, 9, 30),
    ("uint8", False, 33, 90), ("int16", True, 5, 5), ("int8", False, 64, 100),
]


@pytest.mark.parametrize("dtype,keep_max,q_min,q_max", PARTITION_CASES,
                         ids=[f"{c[0]}-{'max' if c[1] else 'min'}" for c in PARTITION_CASES])
def test_partition_fuzzy_bit_for_bit(dtype, keep_max, q_min, q_max):
    """vals, ids, threshold and q_out of faiss_tpu's partition_fuzzy, bit for
    bit, on rows with many ties (and a -0.0 / +0.0 pair for floats)."""
    rs = np.random.RandomState(11)
    if dtype == "float32":
        vals = rs.randint(-20, 20, size=(6, 128)).astype(np.float32) / 4
        vals[0, :2] = [-0.0, 0.0]
    else:
        info = np.iinfo(dtype)
        vals = rs.randint(max(info.min, -50), min(info.max, 50), size=(6, 128)).astype(dtype)
    ids = rs.permutation(6 * 128).reshape(6, 128).astype(np.int64)
    rv, ri, rt, rq = pj.partition_fuzzy(vals, ids, q_min, q_max, keep_max=keep_max)
    gv, gi, gt, gq = ftt.partition_fuzzy(torch.from_numpy(vals), torch.from_numpy(ids),
                                         q_min, q_max, keep_max=keep_max)
    np.testing.assert_array_equal(gv.numpy().view(np.uint8), np.asarray(rv).view(np.uint8))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(gt.numpy().view(np.uint8), np.asarray(rt).view(np.uint8))
    np.testing.assert_array_equal(gq.numpy(), np.asarray(rq))


def test_histogram_shifted_bit_for_bit():
    """histogram_shifted at shifts 0-3 and 30 (a logical shift of the
    negative differences), 8 and 16 bins."""
    import jax.numpy as jnp

    rs = np.random.RandomState(12)
    data = rs.randint(-40, 200, size=(5, 300)).astype(np.int32)
    for shift in (0, 1, 3, 30):
        for nbins in (8, 16):
            ref = pj.histogram_shifted(jnp.asarray(data), jnp.asarray(7),
                                       jnp.asarray(shift), nbins)
            got = ftt.histogram_shifted(torch.from_numpy(data), 7, shift, nbins)
            np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_extra_metric_flat_file_round_trip():
    """An L1 IndexFlat written by the port reads in faiss_tpu and back, its
    searches unchanged."""
    xb, xq = inputs(MT.L1, 500, 13), inputs(MT.L1, NQ, 14)
    port = ftt.IndexFlat(D, MT.L1, device="cpu")
    port.add(xb)
    D0, I0 = port.search(xq, K)
    buf = io.BytesIO()
    ftt.write_index(port, buf)
    ref = ftj.read_index(io.BytesIO(buf.getvalue()))
    Dr, Ir = ref.search(xq, K)
    agree(Dr, Ir, D0.astype(np.float64), I0, MT.L1)
    back = ftt.deserialize_index(ftj.serialize_index(ref), device="cpu")
    D1, I1 = back.search(xq, K)
    np.testing.assert_array_equal(D1, D0)
    np.testing.assert_array_equal(I1, I0)
