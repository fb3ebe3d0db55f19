"""Port parity: the IVF-PQ search layout and decoded store of
faiss_tpu_torch against faiss_tpu, built from one trained faiss_tpu index
(faiss_tpu_torch.convert), plus the port's own encode and build on CPU."""

import numpy as np
import pytest
import torch

import faiss_tpu as ftj
import faiss_tpu_torch as ftt
from faiss_tpu_torch.convert import refine_flat_from_arrays
from torch_threads import one_torch_thread  # noqa: F401

D, NLIST, NB, M, CT = 16, 256, 3000, 4, 256


def mixture(rs, n, ncent=64, d=D):
    """Small Gaussian mixture in the shape of bench.py's generator."""
    cent = np.random.RandomState(99).rand(ncent, d).astype(np.float32)
    scales = (1.0 / (np.arange(d) + 1.0)).astype(np.float32) * 0.4
    a = rs.randint(ncent, size=n)
    return (cent[a] + rs.randn(n, d).astype(np.float32) * scales).astype(np.float32)


@pytest.fixture(scope="module")
def pair():
    xb = mixture(np.random.RandomState(7), NB)
    base = ftj.IndexIVFPQFastScan(None, D, NLIST, M, 4)
    base.FUSED_CT = CT
    base.cp.niter = 4
    base.cp.min_points_per_centroid = 1
    ref = ftj.IndexRefineFlat(base, store_float16=True)
    ref.train(xb)
    ref.add(xb)
    port = refine_flat_from_arrays(
        base.quantizer.vectors(), base.pq.centroids, base._codes_host,
        base._listnos_host, base._ids_host, ref.refine_index.vectors(),
        device="cpu", store_float16=True,
    )
    port.base_index.FUSED_CT = CT
    return ref, port, xb


def bf16_ulp(x):
    """Spacing of bf16 numbers at |x| (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), np.float32(2.0**-126))))
    return np.exp2(e - 7)


def test_layout_matches_reference(pair):
    ref, port, _ = pair
    bj = ref.base_index._build_brute()
    bt = port.base_index._build_brute()
    np.testing.assert_array_equal(bj["slot_map"], bt["slot_map"])
    for name in ("chunk_first", "chunk_last", "cgroup"):
        np.testing.assert_array_equal(
            np.asarray(bj[name]), bt[name].numpy(), err_msg=name
        )
    assert bj["nchunks"] == bt["nchunks"]
    np.testing.assert_array_equal(np.asarray(bj["cn2g"]), bt["cn2g"].numpy())
    n2j, n2t = np.asarray(bj["n2s"]), bt["n2s"].numpy()
    np.testing.assert_array_equal(np.isinf(n2j), np.isinf(n2t))
    fin = np.isfinite(n2j)
    np.testing.assert_allclose(n2t[fin], n2j[fin], rtol=1e-6)


def test_decoded_store_within_one_bf16_ulp(pair):
    ref, port, _ = pair
    yj = np.asarray(ref.base_index._build_brute()["yT"]).astype(np.float32)
    yt = port.base_index._build_brute()["yT"].float().numpy()
    assert yj.shape == yt.shape
    diff = np.abs(yj - yt)
    assert (diff <= bf16_ulp(np.maximum(np.abs(yj), np.abs(yt)))).all()
    # most entries round identically
    assert (diff == 0).mean() > 0.99


def test_encode_and_assign_match_reference(pair):
    """The port's coarse assignment and residual PQ encode of the stored
    vectors agree with the codes faiss_tpu stored (float32 rounding may
    flip a near-tie)."""
    ref, port, xb = pair
    base = port.base_index
    xd = torch.from_numpy(xb)
    assign = base._assign(xd)
    assert (assign.numpy() == ref.base_index._listnos_host).mean() > 0.99
    codes = base.encode_vectors(xd, torch.from_numpy(
        ref.base_index._listnos_host.astype(np.int64)))
    assert (codes == ref.base_index._codes_host).all(1).mean() > 0.99
    packed = base.pq.compute_codes(xb[:200])
    np.testing.assert_array_equal(base.pq.unpack_codes(packed),
                                  base.pq.compute_codes_int(xb[:200]))
    assert (packed == ref.base_index.pq.compute_codes(xb[:200])).all(1).mean() > 0.99


def test_port_build_is_self_consistent():
    """The port trains, adds and stages on its own: every input slot is
    packed exactly once, norms are +inf exactly on pads, and the store
    holds c_list + pq_decode(code) to bf16 rounding."""
    xb = mixture(np.random.RandomState(3), 2000)
    base = ftt.IndexIVFPQFastScan(None, D, 64, M, 4, device="cpu")
    base.FUSED_CT = CT
    base.cp.niter = 4
    base.cp.min_points_per_centroid = 1
    base.train(xb)
    base.add(xb)
    br = base._build_brute()
    sm = br["slot_map"]
    assert np.array_equal(np.sort(sm[sm >= 0]), np.arange(len(xb)))
    assert len(sm) == (br["nchunks"] + 1) * CT
    n2s = br["n2s"].numpy()[0]
    np.testing.assert_array_equal(np.isinf(n2s), sm < 0)
    yT = br["yT"].float().numpy()
    assert (yT[D:] == 0).all() and (yT[:, sm < 0] == 0).all()
    take = np.where(sm >= 0)[0][::17]
    want = (
        base.pq.decode_int(base._codes_host[sm[take]])
        + base.quantizer.vectors()[base._listnos_host[sm[take]]]
    )
    np.testing.assert_allclose(yT[:D, take].T, want, rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(
        n2s[take], (want**2).sum(1), rtol=1e-4, atol=1e-4
    )
