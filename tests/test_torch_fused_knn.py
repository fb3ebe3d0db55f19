"""Kernel K1 (faiss_tpu_torch.ops.fused_knn): the plain PyTorch version of
the dynamic-chunk recon scan against faiss_tpu's Pallas kernel
(ivf_recon_fused_dyn_pallas, interpret mode) on the same inputs, against an
exhaustive numpy select, and the wrapper's device and input checks. The CUDA
kernel itself is compared with the plain version on the card by
chip_smoke.py."""

import numpy as np
import pytest
import torch

import faiss_tpu as ftj
from faiss_tpu.ops.pallas_knn import ivf_recon_fused_dyn_pallas
from faiss_tpu_torch.ops import fused_knn
from faiss_tpu_torch.ops.fused_knn import (
    ivf_recon_fused_dyn,
    ivf_recon_fused_dyn_ref,
)
from faiss_tpu_torch.utils.evaluation import ids_agree_tie_aware
from torch_threads import one_torch_thread  # noqa: F401

D, NLIST, NB, CT, QT, NQ, KC = 16, 256, 3000, 256, 128, 256, 40


def bf16_to_torch(a):
    """numpy/JAX bfloat16 array -> torch.bfloat16 tensor, bit for bit."""
    return torch.from_numpy(np.asarray(a).view(np.int16).copy()).view(
        torch.bfloat16
    )


@pytest.fixture(scope="module")
def staged():
    rs = np.random.RandomState(5)
    xb = rs.randn(NB, D).astype(np.float32)
    index = ftj.IndexIVFPQFastScan(None, D, NLIST, 4, 4)
    index.FUSED_CT = CT
    index.cp.niter = 4
    index.cp.min_points_per_centroid = 1
    index.train(xb)
    index.add(xb)
    br = index._build_brute()
    nchunks = br["nchunks"]
    # per-tile worklists: ascending probed chunks, then the PAD chunk
    cmap = np.full((NQ // QT, 4), nchunks, np.int32)
    cmap[0, :3] = np.sort(rs.choice(nchunks, 3, replace=False))
    cmap[1] = np.sort(rs.choice(nchunks, 4, replace=False))
    xq = np.zeros((NQ, 128), np.float32)
    xq[:, :D] = xb[rs.choice(NB, NQ)] + 0.3 * rs.randn(NQ, D).astype(np.float32)
    return br, cmap, xq


def test_plain_version_matches_pallas_kernel(staged):
    import jax.numpy as jnp

    br, cmap, xq = staged
    v, s, ev = ivf_recon_fused_dyn_pallas(
        None, jnp.asarray(xq), br["yT"], br["n2s"], br["lid"],
        jnp.asarray(cmap), br["cgroup"], qt=QT, ct=CT, qdepth=2,
        penalized=False, interpret=True,
    )
    v, s, ev = map(np.asarray, (v, s, ev))
    n2 = np.asarray(br["n2s"])
    keys, slots, floor = ivf_recon_fused_dyn(
        torch.from_numpy(xq), bf16_to_torch(br["yT"]), torch.from_numpy(n2),
        torch.from_numpy(cmap), QT, CT,
    )
    keys, slots = keys.numpy(), slots.numpy()
    assert np.isinf(floor.numpy()).all()
    np.testing.assert_array_equal(slots == -1, np.isinf(keys))
    # rows the Pallas kernel did not flag as lossy hold its exact top-kc
    exact = ev.min(1) >= v[:, KC - 1]
    assert exact.mean() > 0.3, exact.mean()
    qn2 = (xq**2).sum(1)
    tol = 1e-4 * (qn2 + np.nanmax(np.where(np.isfinite(n2), n2, np.nan)))
    e = exact
    assert (np.abs(keys[e, :KC] - v[e, :KC]) <= tol[e, None]).all()
    agree = ids_agree_tie_aware(v[e, :KC], s[e, :KC], keys[e, :KC],
                                slots[e, :KC], tol[e])
    assert agree.all(), np.where(~agree)


def test_plain_version_matches_exhaustive_select():
    """Exact top-128 over the worklist chunks, -1 slots on +inf keys: a
    short worklist of one chunk with pads (fewer than 128 finite keys) and
    an all-PAD worklist."""
    rs = np.random.RandomState(1)
    d_pad, ct, nchunks, qt = 8, 64, 4, 16
    S = (nchunks + 1) * ct
    yT = torch.from_numpy(rs.randn(d_pad, S).astype(np.float32)).to(torch.bfloat16)
    yT[:, nchunks * ct :] = 0
    n2 = (yT.float() ** 2).sum(0, keepdim=True)
    n2[0, nchunks * ct :] = float("inf")  # the PAD chunk
    n2[0, 2 * ct + 40 : 3 * ct] = float("inf")  # pads at the end of chunk 2
    cmap = torch.tensor(
        [[0, 1, 3, nchunks], [2, nchunks, nchunks, nchunks],
         [nchunks] * 4], dtype=torch.int32,
    )
    xq = torch.from_numpy(rs.randn(3 * qt, d_pad).astype(np.float32))
    keys, slots, _ = ivf_recon_fused_dyn_ref(xq, yT, n2, cmap, qt, ct)
    y64 = yT.double().numpy()
    for r in range(3 * qt):
        cols = (cmap[r // qt].numpy()[:, None] * ct + np.arange(ct)).ravel()
        sc = n2.double().numpy()[0, cols] - 2.0 * xq[r].double().numpy() @ y64[:, cols]
        order = np.argsort(sc, kind="stable")[:128]
        want = np.full(128, np.inf)
        want[: len(order)] = sc[order]
        np.testing.assert_allclose(keys[r].numpy(), want, rtol=1e-5, atol=1e-4)
        fin = np.isfinite(want)
        assert set(slots[r].numpy()[fin]) == set(cols[order][fin[: len(order)]])
        assert (slots[r].numpy()[~fin] == -1).all()


def test_wrapper_checks_inputs_and_device():
    xq = torch.zeros(16, 8)
    yT = torch.zeros(8, 128, dtype=torch.bfloat16)
    n2 = torch.zeros(1, 128)
    cmap = torch.zeros(1, 2, dtype=torch.int32)
    before = ivf_recon_fused_dyn.launches
    ivf_recon_fused_dyn(xq, yT, n2, cmap, 16, 64)  # CPU: plain version
    with pytest.raises(ValueError, match="float32"):
        ivf_recon_fused_dyn(xq, yT.float(), n2, cmap, 16, 64)
    with pytest.raises(ValueError, match="multiple"):
        ivf_recon_fused_dyn(xq, yT, n2, cmap, 12, 64)
    with pytest.raises(ValueError, match="contiguous"):
        ivf_recon_fused_dyn(xq, yT.T.contiguous().T, n2, cmap, 16, 64)
    # a tensor that is neither on the CPU nor on a CUDA card never reaches
    # the plain version
    meta = [t.to("meta") for t in (xq, yT, n2, cmap)]
    with pytest.raises(ValueError, match="CUDA or CPU"):
        ivf_recon_fused_dyn(*meta, 16, 64)
    assert ivf_recon_fused_dyn.launches == before


def test_cuda_build_raises_without_toolkit(monkeypatch, tmp_path):
    """No CPU fallback: without nvcc the CUDA kernel cannot be built and the
    build raises."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        fused_knn._nvcc()
