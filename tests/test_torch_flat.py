"""Port parity for exact flat search: the staged hi/lo screen store, the
screen and striped programs against faiss_tpu's (Pallas kernels in interpret
mode) on the same staged inputs, and IndexFlatL2/IndexFlatIP ``search`` and
``search_submit``/``search_collect`` against faiss_tpu's exact search on the
screen, striped and fused paths, including the storm fallback. On CPU
tensors the port's kernel wrappers run their plain versions; which path ran
is read from spies on the wrappers."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import faiss_tpu as ftj
from faiss_tpu.models.flat import _flat_screen_program as jax_screen
from faiss_tpu.models.flat import _flat_striped_program as jax_striped
from faiss_tpu.models.flat import _stage_flat_screen as jax_stage
from faiss_tpu.models.flat import _unpack_flat_lk
import faiss_tpu_torch as ftt
from faiss_tpu_torch.convert import flat_from_arrays
from faiss_tpu_torch.models import flat as port_flat
from faiss_tpu_torch.ops import distances as port_dops
from faiss_tpu_torch.ops import fused_knn
from faiss_tpu_torch.utils.evaluation import ids_agree_tie_aware
from torch_threads import one_torch_thread  # noqa: F401

D, NB, NQ = 16, 31000, 200  # NB >= PALLAS_MIN_NB, and wide enough to stripe


def bf16_to_torch(a):
    return torch.from_numpy(np.asarray(a).view(np.int16).copy()).view(
        torch.bfloat16
    )


def staged_to_torch(staged):
    yT_hi, yT_lo, n2s, ymax = staged
    return (bf16_to_torch(yT_hi), bf16_to_torch(yT_lo),
            torch.from_numpy(np.array(n2s)), torch.tensor(float(ymax)))


def check_certified(D_j, I_j, flag_j, D_t, I_t, flag_t, nq, tol):
    """Rows both packages certify hold the same ids (tie-aware) and
    distances; the port flags no more rows than the reference plus 1%."""
    assert flag_t.sum() <= flag_j.sum() + 0.01 * nq, (flag_t.sum(), flag_j.sum())
    ok = ~flag_j & ~flag_t
    assert ok.mean() > 0.5, ok.mean()
    agree = ids_agree_tie_aware(D_j[ok], I_j[ok], D_t[ok], I_t[ok], tol)
    assert agree.all(), np.where(~agree)
    same = I_j[ok] == I_t[ok]
    np.testing.assert_allclose(D_t[ok][same], D_j[ok][same], rtol=1e-5, atol=1e-4)


def test_stage_flat_screen_matches_reference():
    """hi/lo planes bit for bit, n2s and ymax to float32 rounding."""
    rs = np.random.RandomState(3)
    xb = (rs.randn(1000, 24) * np.exp(rs.randn(1000, 1))).astype(np.float32)
    for metric_l2 in (True, False):
        ref = jax_stage(jnp.asarray(xb), 128, 2048, metric_l2)
        got = port_flat._stage_flat_screen(torch.from_numpy(xb), 128, 2048, metric_l2)
        want = staged_to_torch(ref)
        for a, b in zip(got[:2], want[:2]):
            assert a.shape == b.shape == (128, 2048)
            assert torch.equal(a.view(torch.int16), b.view(torch.int16))
        np.testing.assert_allclose(got[2].numpy(), want[2].numpy(), rtol=1e-6)
        assert np.isinf(got[2].numpy()[0, 1000:]).all()
        np.testing.assert_allclose(float(got[3]), float(want[3]), rtol=1e-6)


@pytest.mark.parametrize("metric_l2", [True, False], ids=["L2", "IP"])
def test_screen_program_matches_reference(metric_l2):
    """test_flat.py:266's shapes (d=24, nb=4096, nq=128, k=10, qt=128,
    ct=512)."""
    rs = np.random.RandomState(21)
    d, nb, nq, k = 24, 4096, 128, 10
    xb = rs.randn(nb, d).astype(np.float32)
    xq = rs.randn(nq, d).astype(np.float32)
    staged = jax_stage(jnp.asarray(xb), 128, nb, metric_l2)
    packed = np.asarray(jax_screen(
        jnp.asarray(xq), *staged[:3], jnp.asarray(xb), staged[3], k, 128, 512,
        metric_l2, interpret=True,
    ))
    D_j, I_j = packed[:, :k], np.rint(packed[:, k : 2 * k]).astype(np.int64)
    flag_j = packed[:, 2 * k] != 0.0
    yT_hi, yT_lo, n2s, ymax = staged_to_torch(staged)
    D_t, I_t, flag_t = port_flat._flat_screen_program(
        torch.from_numpy(xq), yT_hi, yT_lo, n2s, torch.from_numpy(xb), ymax,
        k, 128, 512, metric_l2,
    )
    assert D_t.dtype == torch.float32 and I_t.dtype == torch.int64
    sign = 1.0 if metric_l2 else -1.0
    check_certified(sign * D_j, I_j, flag_j, sign * D_t.numpy(), I_t.numpy(),
                    flag_t.numpy(), nq, 1e-5 * 2 * d)


def test_striped_program_matches_reference():
    """test_flat.py:346's shapes: d=24, nb=31000, nq=32, k=128, P=2 stripes
    of 16384 columns (the tail stripe underfull), u=256, qt=32, ct=1024; no
    pad column leaks into the result."""
    rs = np.random.RandomState(33)
    d, nb, nq, k, P = 24, 31000, 32, 128, 2
    xb = rs.randn(nb, d).astype(np.float32)
    xq = rs.randn(nq, d).astype(np.float32)
    W = -(-(-(-nb // 1024) * 1024) // (P * 1024)) * 1024
    u = min(P * 128, k + 128)
    staged = jax_stage(jnp.asarray(xb), 128, P * W, True)
    packed = jax_striped(
        jnp.asarray(xq), *staged[:3], jnp.asarray(xb), staged[3], k, 32, 1024,
        P, u, True, interpret=True,
    )
    D_j, I_j, flag_j = _unpack_flat_lk(packed, k, False)
    D_t, I_t, flag_t = port_flat._flat_striped_program(
        torch.from_numpy(xq), *staged_to_torch(staged)[:3], torch.from_numpy(xb),
        staged_to_torch(staged)[3], k, 32, 1024, P, u, True,
    )
    I_t = I_t.numpy()
    assert (I_t >= 0).all() and (I_t < nb).all()
    check_certified(D_j, I_j.astype(np.int64), flag_j, D_t.numpy(), I_t,
                    flag_t.numpy(), nq, 1e-5 * 2 * d)


@pytest.fixture(scope="module")
def stores():
    rs = np.random.RandomState(7)
    xb = rs.randn(NB, D).astype(np.float32)
    xq = rs.randn(NQ, D).astype(np.float32)
    out = {}
    for name, cls in (("L2", ftj.IndexFlatL2), ("IP", ftj.IndexFlatIP)):
        ref = cls(D)
        ref.add(xb)
        out[name] = ref
    return out, xb, xq


class Spy:
    """Counts the calls of a kernel wrapper (the CPU runs its plain
    version, so its launch count stays 0)."""

    def __init__(self, monkeypatch, name):
        self.calls = 0
        self.fn = getattr(fused_knn, name)
        monkeypatch.setattr(fused_knn, name, self)

    def __call__(self, *args, **kwargs):
        self.calls += 1
        return self.fn(*args, **kwargs)


# (k, flat_screen, api, expected path)
CASES = [
    (1, True, "search", "screen"),
    (10, True, "submit_collect", "screen"),
    (100, True, "search", "screen"),
    (128, True, "submit_collect", "striped"),
    (10, False, "search", "fused"),
    (300, False, "submit_collect", "fused"),
]


@pytest.mark.parametrize("metric", ["L2", "IP"])
@pytest.mark.parametrize("k,flat_screen,api,path", CASES,
                         ids=[f"k{c[0]}-{c[3]}-{c[2]}" for c in CASES])
def test_search_matches_reference(stores, metric, k, flat_screen, api, path,
                                  monkeypatch):
    refs, xb, xq = stores
    ref = refs[metric]
    port = flat_from_arrays(ref.vectors(), ref.metric_type, device="cpu")
    assert isinstance(port, ftt.IndexFlat) and port.ntotal == NB
    port.flat_screen = flat_screen
    recon = Spy(monkeypatch, "ivf_recon_fused")
    fused = Spy(monkeypatch, "knn_fused")
    stats0 = dict(port_flat.striped_stats)
    D_j, I_j = ref.search(xq, k)
    if api == "search":
        D_t, I_t = port.search(xq, k)
    else:
        D_t, I_t = port.search_collect(port.search_submit(xq, k))
    assert D_t.dtype == np.float32 and I_t.dtype == np.int64
    assert D_t.shape == I_t.shape == (NQ, k)
    P = port._striped_plan(k)[0] if path == "striped" else 1
    assert recon.calls == {"screen": 1, "striped": P, "fused": 0}[path]
    assert fused.calls == (path == "fused")
    if path == "striped":
        assert P == 4 and port_flat.striped_stats["nq"] == stats0["nq"] + NQ
    assert port.flat_screen == flat_screen and port.flat_striped
    sign = 1.0 if metric == "L2" else -1.0
    tol = 1e-5 * ((xq**2).sum(1) + (xb**2).sum(1).max())
    agree = ids_agree_tie_aware(sign * D_j, I_j, sign * D_t, I_t, tol)
    assert agree.all(), np.where(~agree)
    same = I_j == I_t
    assert same.mean() > 0.99
    np.testing.assert_allclose(D_t[same], D_j[same], rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("k,path", [(10, "screen"), (128, "striped")])
def test_storm_falls_back_to_fused_path(k, path, monkeypatch):
    """A distance-concentrated store (every row within 0.01 of one point):
    the bf16 screen cannot certify most rows, so the first sub-batch storms,
    the path is switched off for the index, and the search is served by K3,
    still exact."""
    rs = np.random.RandomState(9)
    c = rs.randn(D).astype(np.float32)
    xb = (c + 0.01 * rs.randn(NB, D)).astype(np.float32)
    xq = (c + 0.01 * rs.randn(64, D)).astype(np.float32)
    port = ftt.IndexFlatL2(D, device="cpu")
    port.add(xb)
    fused = Spy(monkeypatch, "knn_fused")
    storms0 = port_flat.striped_stats["storms"]
    D_t, I_t = port.search(xq, k)
    assert fused.calls == 1
    if path == "screen":
        assert not port.flat_screen and port.flat_striped
    else:
        assert not port.flat_striped
        assert port_flat.striped_stats["storms"] == storms0 + 1
    x64, y64 = xq.astype(np.float64), xb.astype(np.float64)
    d64 = ((x64[:, None, :] - y64[None]) ** 2).sum(-1)
    I_e = np.argsort(d64, 1)[:, :k]
    D_e = np.take_along_axis(d64, I_e, 1)
    tol = 1e-6 * ((xq**2).sum(1) + (xb**2).sum(1).max())  # f32 expansion
    assert (np.abs(D_t - D_e) <= tol[:, None]).all()
    agree = ids_agree_tie_aware(D_e, I_e, D_t, I_t, 2 * tol)
    assert agree.all(), np.where(~agree)


@pytest.mark.parametrize("k,path", [(10, "screen"), (128, "striped")])
def test_uncertified_rows_are_repaired(k, path):
    """A tight cluster of 300 rows stored contiguously (so inside one
    stripe), and one query in ten aimed at it: those rows cannot be
    certified (the screen's k-th and 128th keys, or one stripe's 128 kept
    keys, sit inside the bf16 error band), stay below the storm share, and
    are repaired exactly; the path stays on."""
    rs = np.random.RandomState(4)
    c = rs.randn(D).astype(np.float32)
    xb = rs.randn(NB, D).astype(np.float32)
    xb[5000:5300] = c + 0.01 * rs.randn(300, D)
    xq = rs.randn(220, D).astype(np.float32)
    xq[::10] = c + 0.01 * rs.randn(22, D)
    ref = ftj.IndexFlatL2(D)
    ref.add(xb)
    port = flat_from_arrays(xb, ftt.METRIC_L2, device="cpu")
    stats = port_flat.screen_stats if path == "screen" else port_flat.striped_stats
    s0 = dict(stats)
    D_t, I_t = port.search(xq, k)
    D_j, I_j = ref.search(xq, k)
    flagged = stats["flagged"] - s0["flagged"]
    assert stats["nq"] - s0["nq"] == 220 and stats["storms"] == s0["storms"]
    assert 22 <= flagged <= 0.25 * 220, flagged
    assert port.flat_screen and port.flat_striped
    tol = 1e-6 * ((xq**2).sum(1) + (xb**2).sum(1).max())
    agree = ids_agree_tie_aware(D_j, I_j, D_t, I_t, tol)
    assert agree.all(), np.where(~agree)
    np.testing.assert_allclose(D_t, D_j, rtol=1e-5, atol=1e-4)


def test_small_store_plain_path_and_roles():
    """Below PALLAS_MIN_NB the plain chunked k-NN serves (with a tail
    chunk and k > nb padding), and IndexFlat keeps its roles: fp16 refine
    store with norms of the rounded rows, no norms for inner product."""
    rs = np.random.RandomState(2)
    xb = rs.randn(3000, D).astype(np.float32)
    xq = rs.randn(40, D).astype(np.float32)
    for metric in (ftt.METRIC_L2, ftt.METRIC_INNER_PRODUCT):
        ref = ftj.IndexFlat(D, int(metric))
        ref.add(xb)
        port = flat_from_arrays(ref.vectors(), metric, device="cpu")
        D_j, I_j = ref.search(xq, 5)
        D_t, I_t = port.search(xq, 5)
        np.testing.assert_array_equal(I_t, I_j)
        np.testing.assert_allclose(D_t, D_j, rtol=1e-5, atol=1e-4)
        d, i = port_dops.knn(torch.from_numpy(xq), torch.from_numpy(xb),
                                     3005, metric=metric, db_chunk=1024)
        assert (i[:, 3000:] == -1).all() and torch.isinf(d[:, 3000:]).all()
        np.testing.assert_array_equal(np.sort(i[:, :3000].numpy(), 1),
                                      np.tile(np.arange(3000), (40, 1)))
        np.testing.assert_array_equal(i[:, :5].numpy(), I_j)
        assert (port._norms is None) == (metric == ftt.METRIC_INNER_PRODUCT)
    f16 = ftt.IndexFlat(D, ftt.METRIC_L2, device="cpu")
    f16.storage_dtype = np.float16
    f16.add(xb)
    xb16 = xb.astype(np.float16).astype(np.float32)
    np.testing.assert_allclose(f16._consolidate().float().numpy(), xb16)
    np.testing.assert_allclose(f16._norms.numpy(), (xb16**2).sum(1), rtol=1e-6)
    # the other metrics take the plain k-NN, never the kernel paths
    # (tests/test_torch_metrics.py checks them against float64)
    l1 = ftt.IndexFlat(D, ftt.MetricType.L1, device="cpu")
    l1.add(np.tile(xb, (6, 1)))
    assert l1.ntotal >= l1.PALLAS_MIN_NB and not l1._use_fused_kernel(5)
