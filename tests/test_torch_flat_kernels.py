"""Kernels K2 and K3 (faiss_tpu_torch.ops.fused_knn): the plain PyTorch
versions against faiss_tpu's Pallas kernels (ivf_recon_fused_pallas with the
hi/lo planes, knn_fused_pallas; interpret mode) on the same inputs, against
an exhaustive numpy select, and the wrappers' input and device checks. The
CUDA kernels themselves are compared with the plain versions on the card by
chip_smoke.py."""

import numpy as np
import pytest
import torch

from faiss_tpu.models.flat import _stage_flat_screen as jax_stage
from faiss_tpu.ops.pallas_knn import ivf_recon_fused_pallas, knn_fused_pallas
from faiss_tpu_torch.ops import fused_knn
from faiss_tpu_torch.ops.fused_knn import (
    ivf_recon_fused,
    knn_fused,
    knn_fused_ref,
)
from faiss_tpu_torch.utils.evaluation import ids_agree_tie_aware
from torch_threads import one_torch_thread  # noqa: F401


def bf16_to_torch(a):
    """numpy/JAX bfloat16 array -> torch.bfloat16 tensor, bit for bit."""
    return torch.from_numpy(np.asarray(a).view(np.int16).copy()).view(
        torch.bfloat16
    )


@pytest.mark.parametrize("metric_l2", [True, False], ids=["L2", "IP"])
def test_k2_plain_version_matches_pallas_kernel(metric_l2):
    """K2 on the hi/lo screen store of test_flat.py:266 (d=24, nb=4096,
    nq=128, ct=512). Rows the Pallas kernel does not flag as lossy for their
    top KC hold the same ids (tie-aware) and keys within
    1e-4 * (||q||^2 + max ||y||^2): the kernels differ in the product (the
    TPU one drops ql * yl of its bf16 query split), not in the select."""
    import jax.numpy as jnp

    KC = 32
    rs = np.random.RandomState(21)
    d, nb, nq, d_pad = 24, 4096, 128, 128
    xb = rs.randn(nb, d).astype(np.float32)
    xq = np.zeros((nq, d_pad), np.float32)
    xq[:, :d] = rs.randn(nq, d)
    yT_hi, yT_lo, n2s, _ = jax_stage(jnp.asarray(xb), d_pad, nb, metric_l2)
    v, s, ev = ivf_recon_fused_pallas(
        jnp.asarray(xq), yT_hi, n2s, jnp.zeros((1, 1), jnp.int32), None,
        yT_lo=yT_lo, qt=128, ct=512, qdepth=3, interpret=True,
    )
    v, s, ev = map(np.asarray, (v, s, ev))
    keys, slots, floor = ivf_recon_fused(
        torch.from_numpy(xq), bf16_to_torch(yT_hi), torch.from_numpy(np.array(n2s)),
        bf16_to_torch(yT_lo), qt=128, ct=512,
    )
    keys, slots = keys.numpy(), slots.numpy()
    assert np.isinf(floor.numpy()).all()
    assert np.isfinite(keys).all() and (slots >= 0).all() and (slots < nb).all()
    exact = ev.min(1) >= v[:, KC - 1]
    assert exact.mean() > 0.5, exact.mean()
    tol = 1e-4 * ((xq**2).sum(1) + (xb**2).sum(1).max())
    e = exact
    assert (np.abs(keys[e, :KC] - v[e, :KC]) <= tol[e, None]).all()
    agree = ids_agree_tie_aware(v[e, :KC], s[e, :KC], keys[e, :KC],
                                slots[e, :KC], tol[e])
    assert agree.all(), np.where(~agree)


@pytest.mark.parametrize(
    "k_lanes,metric_l2", [(128, True), (256, False)], ids=["128-L2", "256-IP"],
)
def test_k3_plain_version_matches_pallas_kernel(k_lanes, metric_l2):
    """K3 at test_flat.py:227's shapes (d=16, nq=128, qt=128, ct=512) on a
    store of nb=4000 rows padded with zero columns to 4096: the pads are
    never selected. Values (with ||q||^2) agree to 1e-4 and ids tie-aware on
    the rows the Pallas kernel does not flag as lossy."""
    import jax.numpy as jnp

    rs = np.random.RandomState(5)
    d, nb, nbp, nq = 16, 4000, 4096, 128
    xb = rs.rand(nb, d).astype(np.float32)
    xq = rs.rand(nq, d).astype(np.float32)
    yT = np.zeros((d, nbp), np.float32)
    yT[:, :nb] = xb.T
    v, i, ev = knn_fused_pallas(
        jnp.asarray(xq), jnp.asarray(yT), np.int32(nb), metric_l2=metric_l2,
        qt=128, ct=512, k_lanes=k_lanes, interpret=True,
    )
    v, i, ev = map(np.asarray, (v, i, ev))
    pv, pi, pev = knn_fused(
        torch.from_numpy(xq), torch.from_numpy(yT), nb, metric_l2=metric_l2,
        qt=128, ct=512, k_lanes=k_lanes,
    )
    pv, pi, pev = pv.numpy(), pi.numpy(), pev.numpy()
    assert pv.shape == pi.shape == (nq, k_lanes) and pev.shape == (nq, 128)
    assert pi.dtype == np.int32 and (pi >= 0).all() and (pi < nb).all()
    np.testing.assert_array_equal(pev, np.inf if metric_l2 else -np.inf)
    clean = ev.min(1) >= v[:, -1] if metric_l2 else ev.max(1) <= v[:, -1]
    assert clean.mean() > 0.5, clean.mean()
    np.testing.assert_allclose(pv[clean], v[clean], rtol=1e-4, atol=1e-4)
    sign = 1.0 if metric_l2 else -1.0  # ascending keys for the tie check
    agree = ids_agree_tie_aware(sign * v[clean], i[clean], sign * pv[clean],
                                pi[clean], 1e-4)
    assert agree.all(), np.where(~agree)


def test_plain_versions_match_exhaustive_select():
    """K2 (one plane and hi/lo, on a column slice of a wider store) and K3
    (L2 and IP, nb below the store width, k_lanes above nb) against a
    float64 numpy sort of every score."""
    rs = np.random.RandomState(1)
    d, S, nq = 8, 1024, 16
    wide = torch.from_numpy(rs.randn(d, 2 * S).astype(np.float32))
    hi = wide.to(torch.bfloat16)
    lo = (wide - hi.float()).to(torch.bfloat16)
    n2 = (wide**2).sum(0, keepdim=True)
    n2[0, S + 1000 :] = float("inf")  # pads at the end of the slice
    xq = torch.from_numpy(rs.randn(nq, d).astype(np.float32))
    sl = slice(S, 2 * S)
    for planes in ((hi[:, sl], None), (hi[:, sl], lo[:, sl])):
        keys, slots, _ = ivf_recon_fused(xq, planes[0], n2[:, sl], planes[1],
                                         qt=16, ct=256)
        y = planes[0].double() + (0 if planes[1] is None else planes[1].double())
        sc = n2[:, sl].double().numpy() - 2.0 * xq.double().numpy() @ y.numpy()
        order = np.argsort(sc, 1, kind="stable")[:, :128]
        want = np.take_along_axis(sc, order, 1)
        np.testing.assert_allclose(keys.numpy(), want, rtol=1e-5, atol=1e-4)
        assert (slots.numpy() == order).mean() > 0.99
    yT = torch.zeros(d, 512)
    nb = 300
    yT[:, :nb] = wide[:, :nb]
    y64, x64 = yT[:, :nb].double().numpy(), xq.double().numpy()
    for metric_l2 in (True, False):
        vals, ids, _ = knn_fused_ref(xq, yT, nb, metric_l2=metric_l2,
                                     qt=16, ct=256, k_lanes=384)
        if metric_l2:
            sc = (x64**2).sum(1)[:, None] + (y64**2).sum(0)[None] - 2 * x64 @ y64
        else:
            sc = -(x64 @ y64)
        order = np.argsort(sc, 1, kind="stable")
        want = np.take_along_axis(sc, order, 1)
        if not metric_l2:
            want = -want
        np.testing.assert_allclose(vals.numpy()[:, :nb], want, rtol=1e-5, atol=1e-4)
        assert (ids.numpy()[:, :nb] == order).mean() > 0.99
        assert (ids.numpy()[:, nb:] == -1).all()
        assert (vals.numpy()[:, nb:] == (np.inf if metric_l2 else -np.inf)).all()


def test_wrappers_check_inputs_and_device():
    xq = torch.zeros(16, 8)
    yT = torch.zeros(8, 256, dtype=torch.bfloat16)
    n2 = torch.zeros(1, 256)
    before = (ivf_recon_fused.launches, knn_fused.launches)
    ivf_recon_fused(xq, yT, n2, yT, qt=16, ct=128)  # CPU: plain version
    with pytest.raises(ValueError, match="bfloat16"):
        ivf_recon_fused(xq, yT.float(), n2, qt=16, ct=128)
    with pytest.raises(ValueError, match="store planes"):
        ivf_recon_fused(xq, yT, n2, yT[:4], qt=16, ct=128)
    with pytest.raises(ValueError, match="multiple"):
        ivf_recon_fused(xq, yT, n2, qt=12, ct=128)
    with pytest.raises(ValueError, match="stride"):
        ivf_recon_fused(xq, yT.T.contiguous().T, n2, qt=16, ct=128)
    wide = torch.zeros(8, 514, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="boundary"):  # an odd first column
        ivf_recon_fused(xq, wide[:, 1:257], n2, qt=16, ct=128)
    with pytest.raises(ValueError, match="one device"):
        ivf_recon_fused(xq, yT, n2.to("meta"), qt=16, ct=128)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        ivf_recon_fused(*(t.to("meta") for t in (xq, yT, n2)), qt=16, ct=128)
    x = torch.zeros(16, 5)
    yTf = torch.zeros(5, 256)
    knn_fused(x, yTf, 200, qt=16, ct=128, k_lanes=256)  # CPU: plain version
    with pytest.raises(ValueError, match="k_lanes"):
        knn_fused(x, yTf, 200, qt=16, ct=128, k_lanes=100)
    with pytest.raises(ValueError, match="nb=300"):
        knn_fused(x, yTf, 300, qt=16, ct=128)
    with pytest.raises(ValueError, match="float32"):
        knn_fused(x.double(), yTf, 200, qt=16, ct=128)
    with pytest.raises(ValueError, match="boundary"):
        knn_fused(x, torch.zeros(5 * 256 + 1)[1:].view(5, 256), 200, qt=16, ct=128)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        knn_fused(x.to("meta"), yTf.to("meta"), 200, qt=16, ct=128)
    assert (ivf_recon_fused.launches, knn_fused.launches) == before


@pytest.mark.parametrize("name", sorted(fused_knn.KERNELS))
def test_cuda_build_raises_without_toolkit(name, monkeypatch, tmp_path):
    """No CPU fallback: without nvcc no kernel can be built and the build
    raises."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(fused_knn, "BUILD_DIR", tmp_path / "build")
    fused_knn.build_kernel.cache_clear()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        fused_knn.build_kernel(name)
