"""Port parity for the vector transforms (faiss_tpu_torch/transforms.py
against faiss_tpu/transforms.py).

- ``apply`` and ``reverse_transform`` of every transform against
  faiss_tpu's holding the same matrices (carried across with
  faiss_tpu_torch.convert.transform_from_arrays), within 1e-5 * |x|^2: the
  port runs a float32 torch.mm where faiss_tpu runs a float32 numpy matmul,
  and the two round differently.
- Training that stays on the host in float64 numpy (PCA, ITQ, the random
  rotation, Hadamard, centering) gives faiss_tpu's arrays bit for bit.
- OPQ trains its PQ with the port's k-means, whose RNG differs from
  faiss_tpu's: its rotation is held to the objective (the PQ
  reconstruction error after the rotation within 5% of faiss_tpu's OPQ and
  below that of a PQ with no rotation), not to the matrix."""

import numpy as np
import pytest

import faiss_tpu as ftj
import faiss_tpu_torch as ftt
from faiss_tpu_torch.convert import transform_from_arrays
from torch_threads import one_torch_thread  # noqa: F401

D, N = 16, 2000


def correlated(rs, n, d=D):
    """Gaussian rows with a random anisotropic covariance: a PQ gains from a
    rotation on them."""
    mix = np.random.RandomState(5).randn(d, d) * (0.9 ** np.arange(d))[None, :]
    return (rs.randn(n, d) @ mix.T).astype(np.float32)


@pytest.fixture(scope="module")
def x():
    return correlated(np.random.RandomState(1), N)


def trained_ref(kind, x):
    """A trained faiss_tpu transform of ``kind``."""
    d = x.shape[1]
    vt = {
        "pca": lambda: ftj.PCAMatrix(d, 8),
        "pca_white_rot": lambda: ftj.PCAMatrix(d, d, -0.5, True),
        "opq": lambda: ftj.OPQMatrix(d, 4),
        "rr": lambda: ftj.RandomRotationMatrix(d, 12),
        "hadamard": lambda: ftj.HadamardRotation(d),
        "itq": lambda: ftj.ITQMatrix(d),
        "itq_transform": lambda: ftj.ITQTransform(d, d),
        "itq_transform_pca": lambda: ftj.ITQTransform(d, 8, do_pca=True),
        "l2norm": lambda: ftj.NormalizationTransform(d, 2.0),
        "l3norm": lambda: ftj.NormalizationTransform(d, 3.0),
        "center": lambda: ftj.CenteringTransform(d),
        "remap_uniform": lambda: ftj.RemapDimensionsTransform(d, 24, True),
        "pad": lambda: ftj.RemapDimensionsTransform(d, 20, False),
    }[kind]()
    if kind == "opq":
        vt.niter = 4
    if kind == "rr":
        vt.init(7)
    if kind == "itq":
        vt.max_iter = 10
    vt.train(x)
    return vt


def carried(vt):
    """The port's transform holding faiss_tpu's arrays."""
    name = type(vt).__name__
    kw = dict(device="cpu")
    if name == "ITQTransform":
        return transform_from_arrays(name, vt.d_in, vt.d_out, vt.pca_then_itq.A,
                                     mean=vt.mean, **kw)
    if name == "RemapDimensionsTransform":
        return transform_from_arrays(name, vt.d_in, vt.d_out, dim_map=vt.map, **kw)
    if name == "NormalizationTransform":
        return transform_from_arrays(name, vt.d_in, vt.d_out, norm=vt.norm, **kw)
    if name == "CenteringTransform":
        return transform_from_arrays(name, vt.d_in, vt.d_out, mean=vt.mean, **kw)
    extra = {}
    if name == "PCAMatrix":
        extra = dict(mean=vt.mean, eigen_power=vt.eigen_power,
                     random_rotation=vt.random_rotation)
    if name == "OPQMatrix":
        extra = dict(M=vt.M)
    return transform_from_arrays(name, vt.d_in, vt.d_out, vt.A, vt.b, **extra, **kw)


KINDS = ["pca", "pca_white_rot", "opq", "rr", "hadamard", "itq", "itq_transform",
         "itq_transform_pca", "l2norm", "l3norm", "center", "remap_uniform", "pad"]
REVERSIBLE = {"pca", "rr", "opq", "hadamard", "itq", "l2norm", "l3norm",
              "center", "remap_uniform", "pad"}


@pytest.mark.parametrize("kind", KINDS)
def test_apply_and_reverse_match_reference(x, kind):
    vt = trained_ref(kind, x)
    pt = carried(vt)
    assert type(pt).__name__ == type(vt).__name__
    assert (pt.d_in, pt.d_out) == (vt.d_in, vt.d_out)
    xs = correlated(np.random.RandomState(2), 300)
    tol = 1e-5 * (xs.astype(np.float64) ** 2).sum(1)
    yj, yt = vt.apply(xs), pt.apply(xs)
    assert yt.dtype == np.float32 and yt.shape == yj.shape == (300, vt.d_out)
    assert (np.abs(yt - yj).max(1) <= tol).all()
    if kind in REVERSIBLE:
        rj, rt = vt.reverse_transform(yj), pt.reverse_transform(yj)
        assert rt.shape == rj.shape == (300, vt.d_in)
        assert (np.abs(rt - rj).max(1) <= tol).all()
        if kind in ("opq", "hadamard", "itq", "center", "pad"):
            # orthonormal or invertible: the round trip gives x back
            np.testing.assert_allclose(pt.reverse_transform(yt), xs, atol=1e-4)
    else:  # whitening is not orthonormal; ITQTransform has no reverse
        err = RuntimeError if kind == "pca_white_rot" else NotImplementedError
        for t in (vt, pt):
            with pytest.raises(err):
                t.reverse_transform(yj)


@pytest.mark.parametrize("kind", ["pca", "pca_white_rot", "rr", "hadamard", "itq",
                                  "itq_transform", "itq_transform_pca", "center"])
def test_host_training_matches_reference_bitwise(x, kind):
    """PCA, ITQ, the random rotation, Hadamard and centering train on the
    host as faiss_tpu does: the same arrays, bit for bit."""
    vt = trained_ref(kind, x)
    d = x.shape[1]
    pt = {
        "pca": lambda: ftt.PCAMatrix(d, 8, device="cpu"),
        "pca_white_rot": lambda: ftt.PCAMatrix(d, d, -0.5, True, device="cpu"),
        "rr": lambda: ftt.RandomRotationMatrix(d, 12, device="cpu"),
        "hadamard": lambda: ftt.HadamardRotation(d, device="cpu"),
        "itq": lambda: ftt.ITQMatrix(d, device="cpu"),
        "itq_transform": lambda: ftt.ITQTransform(d, d, device="cpu"),
        "itq_transform_pca": lambda: ftt.ITQTransform(d, 8, do_pca=True, device="cpu"),
        "center": lambda: ftt.CenteringTransform(d, device="cpu"),
    }[kind]()
    if kind == "rr":
        pt.init(7)
    if kind == "itq":
        pt.max_iter = 10
    pt.train(x)
    assert pt.is_trained
    if kind.startswith("itq_transform"):  # its mean, then its PCA-then-ITQ matrix
        assert np.array_equal(vt.mean, pt.mean)
        vt, pt = vt.pca_then_itq, pt.pca_then_itq
    names = {"pca": ("A", "b", "mean", "eigenvalues", "PCAMat"),
             "pca_white_rot": ("A", "b", "mean", "eigenvalues", "PCAMat"),
             "center": ("mean",)}.get(kind, ("A",))
    for name in names:
        a, b = getattr(vt, name), getattr(pt, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    if hasattr(vt, "is_orthonormal"):
        assert pt.is_orthonormal == vt.is_orthonormal


def test_pca_subsamples_and_gram_trick_as_reference():
    """PCA past max_points_per_d rows (the seeded subsample) and with fewer
    rows than dimensions (the gram trick): faiss_tpu's arrays bitwise."""
    rs = np.random.RandomState(3)
    for n, d, d_out, cap in ((700, 16, 16, 40), (10, 16, 4, 1000)):
        x = correlated(rs, n, d)
        vt, pt = ftj.PCAMatrix(d, d_out), ftt.PCAMatrix(d, d_out, device="cpu")
        vt.max_points_per_d = pt.max_points_per_d = cap
        vt.train(x)
        pt.train(x)
        for name in ("A", "b", "mean", "eigenvalues"):
            assert np.array_equal(getattr(vt, name), getattr(pt, name)), (n, name)


def pq_error(A, x, M):
    """Mean squared reconstruction error of a port PQ (8 bits) trained on
    the rotated rows x A^T (A = None: no rotation)."""
    xr = x if A is None else (x.astype(np.float64) @ A.T.astype(np.float64)).astype(np.float32)
    pq = ftt.ProductQuantizer(xr.shape[1], M, 8, device="cpu")
    pq.cp.niter = 10
    pq.train(xr)
    rec = pq.decode_int(pq.compute_codes_int(xr))
    return float(((rec.astype(np.float64) - xr) ** 2).sum(1).mean())


def test_opq_objective_matches_reference(x):
    M, niter = 4, 8
    ref = ftj.OPQMatrix(D, M)
    port = ftt.OPQMatrix(D, M, device="cpu")
    ref.niter = port.niter = niter
    ref.train(x)
    port.train(x)
    assert port.is_trained and port.is_orthonormal
    np.testing.assert_allclose(port.A @ port.A.T, np.eye(D), atol=1e-5)
    e_port, e_ref, e_none = (pq_error(port.A, x, M), pq_error(ref.A, x, M),
                             pq_error(None, x, M))
    assert e_port <= 1.05 * e_ref, (e_port, e_ref)
    assert e_port < e_none, (e_port, e_none)


def test_opq_reduced_dimension_starts_from_pca(x):
    """OPQm_d (d2 < d) starts from the PCA basis: an orthonormal [d2, d]
    rotation whose reconstruction error beats plain PCA-then-PQ's."""
    port = ftt.OPQMatrix(D, 4, 8, device="cpu")
    port.niter = 6
    port.train(x)
    assert port.A.shape == (8, D) and port.is_orthonormal
    pca = ftt.PCAMatrix(D, 8, device="cpu")
    pca.train(x)
    assert pq_error(port.A, x, 4) <= 1.01 * pq_error(pca.PCAMat[:8], x, 4)


def test_untrained_apply_raises_and_chain_stays_on_device(x):
    vt = ftt.PCAMatrix(D, 8, device="cpu")
    with pytest.raises(RuntimeError, match="not trained"):
        vt.apply(x[:4])
    with pytest.raises(ValueError, match="power-of-two"):
        ftt.HadamardRotation(12, device="cpu")
    vt.train(x)
    import torch

    y = vt.apply_tensor(torch.from_numpy(x[:4]))
    assert isinstance(y, torch.Tensor) and y.device.type == "cpu"
    np.testing.assert_allclose(y.numpy(), vt.apply(x[:4]), rtol=0, atol=0)
