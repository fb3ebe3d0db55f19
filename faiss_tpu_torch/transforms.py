"""Vector transforms (counterpart of faiss_tpu/transforms.py; reference:
faiss/VectorTransform.{h,cpp}).

Training stays on the host in float64 numpy (eigh, svd, QR), as faiss_tpu
trains, so PCAMatrix, ITQMatrix, ITQTransform, RandomRotationMatrix and
HadamardRotation hold faiss_tpu's matrices bit for bit on the same input.
OPQMatrix trains its product quantizer with the port's ProductQuantizer on
the transform's device: its rotation then differs from faiss_tpu's by the
k-means RNG, not by its objective.

Each transform takes a keyword-only ``device``. ``apply`` and
``reverse_transform`` take and return numpy float32; the work runs on that
device as float32 torch ops (a linear transform is one ``torch.mm``, with
TF32 off). IndexPreTransform chains ``apply_tensor``, which stays on the
device from the first transform to the last."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


class VectorTransform:
    """reference: VectorTransform.h:25."""

    def __init__(self, d_in: int, d_out: int, *, device):
        self.d_in = int(d_in)
        self.d_out = int(d_out)
        self.device = torch.device(device)
        self.is_trained = True

    def train(self, x) -> None:
        del x

    def apply(self, x) -> np.ndarray:
        x = np.ascontiguousarray(x, np.float32)
        return self.apply_tensor(torch.from_numpy(x)).cpu().numpy()

    def apply_tensor(self, x: torch.Tensor) -> torch.Tensor:
        """float32 [n, d_in] on any device -> [n, d_out] on this one."""
        if not self.is_trained:
            raise RuntimeError(f"{type(self).__name__} is not trained")
        return self._apply(x.to(self.device, torch.float32))

    def _apply(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def reverse_transform(self, y) -> np.ndarray:
        y = np.ascontiguousarray(y, np.float32)
        return self.reverse_tensor(torch.from_numpy(y)).cpu().numpy()

    def reverse_tensor(self, y: torch.Tensor) -> torch.Tensor:
        return self._reverse(y.to(self.device, torch.float32))

    def _reverse(self, y: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError(f"{type(self).__name__} is not reversible")

    def _dev(self, name: str) -> torch.Tensor:
        """The host array attribute ``name`` (A, b, mean) as a float32
        tensor on the device, uploaded again when the attribute is
        replaced."""
        a = getattr(self, name)
        cache = self.__dict__.setdefault("_dev_cache", {})
        if name not in cache or cache[name][0] is not a:
            cache[name] = (a, torch.from_numpy(np.ascontiguousarray(a, np.float32))
                           .to(self.device))
        return cache[name][1]


class LinearTransform(VectorTransform):
    """y = A x + b (reference: VectorTransform.h:71)."""

    def __init__(self, d_in: int, d_out: int, have_bias: bool = False, *,
                 device):
        super().__init__(d_in, d_out, device=device)
        self.have_bias = have_bias
        self.A: Optional[np.ndarray] = None  # [d_out, d_in]
        self.b: Optional[np.ndarray] = None  # [d_out]
        self.is_orthonormal = False

    def _apply(self, x):
        y = torch.mm(x, self._dev("A").T)
        if self.have_bias and self.b is not None:
            y = y + self._dev("b")
        return y

    def set_is_orthonormal(self) -> None:
        """A A^T ~= I (LinearTransform::set_is_orthonormal), on the host as
        faiss_tpu checks it."""
        if self.A is None:
            return
        prod = self.A @ self.A.T
        self.is_orthonormal = bool(
            np.allclose(prod, np.eye(self.d_out), atol=1e-4)
        )

    def _reverse(self, y):
        if not self.is_orthonormal:
            self.set_is_orthonormal()
        if not self.is_orthonormal:
            raise RuntimeError("reverse_transform requires orthonormal A")
        if self.have_bias and self.b is not None:
            y = y - self._dev("b")
        return torch.mm(y, self._dev("A"))


def _host_apply(lt: LinearTransform, x: np.ndarray) -> np.ndarray:
    """faiss_tpu's float32 numpy apply of ``lt`` (x A^T + b), for training
    steps that must match it bit for bit."""
    y = x @ lt.A.T
    if lt.have_bias and lt.b is not None:
        y = y + lt.b
    return y.astype(np.float32)


def _random_orthogonal(d_out: int, d_in: int, seed: int) -> np.ndarray:
    rs = np.random.RandomState(seed)
    g = rs.randn(max(d_out, d_in), d_in).astype(np.float64)
    q, _ = np.linalg.qr(g)
    return q[:d_out].astype(np.float32)


class RandomRotationMatrix(LinearTransform):
    """QR-orthogonalized Gaussian rotation (VectorTransform.h:115)."""

    def __init__(self, d_in: int, d_out: int, *, device):
        super().__init__(d_in, d_out, have_bias=False, device=device)
        self.is_trained = False

    def init(self, seed: int = 1234) -> None:
        self.A = _random_orthogonal(self.d_out, self.d_in, seed)
        self.is_orthonormal = True
        self.is_trained = True

    def train(self, x) -> None:
        del x
        if not self.is_trained:
            self.init()


class PCAMatrix(LinearTransform):
    """PCA with optional whitening and random rotation
    (VectorTransform.h:154). eigen_power: 0 = plain PCA, -0.5 = whitening;
    random_rotation applies a random orthogonal basis after the PCA."""

    def __init__(self, d_in: int, d_out: int, eigen_power: float = 0.0,
                 random_rotation: bool = False, *, device):
        super().__init__(d_in, d_out, have_bias=True, device=device)
        self.eigen_power = float(eigen_power)
        self.epsilon = 0.0
        self.random_rotation = random_rotation
        self.max_points_per_d = 1000
        self.balanced_bins = 0
        self.mean: Optional[np.ndarray] = None
        self.eigenvalues: Optional[np.ndarray] = None
        self.PCAMat: Optional[np.ndarray] = None
        self.is_trained = False

    def train(self, x) -> None:
        """faiss_tpu transforms.py:129, on the host in float64."""
        x = np.ascontiguousarray(x, np.float64)
        n, d = x.shape
        if d != self.d_in:
            raise ValueError(f"expected [n, {self.d_in}] training vectors")
        if n > self.max_points_per_d * d:
            sub = np.random.RandomState(123).permutation(n)[: self.max_points_per_d * d]
            x = x[sub]
            n = len(x)
        self.mean = x.mean(axis=0)
        xc = x - self.mean
        if n >= d:
            cov = (xc.T @ xc) / n
            eigvals, eigvecs = np.linalg.eigh(cov)
            order = np.argsort(-eigvals)
            eigvals = np.maximum(eigvals[order], 0.0)
            eigvecs = eigvecs[:, order]
        else:  # the gram trick for n < d
            gram = (xc @ xc.T) / n
            gv, gu = np.linalg.eigh(gram)
            order = np.argsort(-gv)
            gv = np.maximum(gv[order], 0.0)
            gu = gu[:, order]
            eigvecs = xc.T @ gu
            norms = np.linalg.norm(eigvecs, axis=0)
            eigvecs = eigvecs / np.maximum(norms, 1e-15)
            eigvals = gv
        self.eigenvalues = eigvals.astype(np.float32)
        self.PCAMat = eigvecs.T.astype(np.float32)  # rows = components
        self.prepare_Ab()
        self.is_trained = True

    def prepare_Ab(self) -> None:
        A = self.PCAMat[: self.d_out].astype(np.float64)  # [d_out, d_in]
        if self.eigen_power != 0:
            ev = np.maximum(self.eigenvalues[: self.d_out], 0.0) + self.epsilon
            A = A * (ev**self.eigen_power)[:, None]
        if self.random_rotation:
            rr = _random_orthogonal(self.d_out, self.d_out, 1234).astype(np.float64)
            A = rr @ A
        self.A = A.astype(np.float32)
        self.b = (-(A @ self.mean)).astype(np.float32)
        self.set_is_orthonormal()


class NormalizationTransform(VectorTransform):
    """Per-vector L_norm normalization (VectorTransform.h:301)."""

    def __init__(self, d: int, norm: float = 2.0, *, device):
        super().__init__(d, d, device=device)
        self.norm = float(norm)

    def _apply(self, x):
        if self.norm == 2.0:
            norms = torch.linalg.vector_norm(x, dim=1, keepdim=True)
        else:
            norms = x.abs().pow(self.norm).sum(1, keepdim=True).pow(1.0 / self.norm)
        return x / norms.clamp_min(1e-20)

    def _reverse(self, y):
        return y  # the identity (VectorTransform.h:310)


class CenteringTransform(VectorTransform):
    """Subtract the mean (VectorTransform.h:316)."""

    def __init__(self, d: int, *, device):
        super().__init__(d, d, device=device)
        self.mean: Optional[np.ndarray] = None
        self.is_trained = False

    def train(self, x) -> None:
        self.mean = np.ascontiguousarray(x, np.float32).mean(0)
        self.is_trained = True

    def _apply(self, x):
        return x - self._dev("mean")

    def _reverse(self, y):
        return y + self._dev("mean")


class RemapDimensionsTransform(VectorTransform):
    """Permute or pad dimensions (VectorTransform.h:278); map[j] = -1 leaves
    output dimension j at zero."""

    def __init__(self, d_in: int, d_out: int, uniform_or_map=True, *, device):
        super().__init__(d_in, d_out, device=device)
        if isinstance(uniform_or_map, (list, np.ndarray)):
            self.map = np.asarray(uniform_or_map, np.int64)
        elif uniform_or_map:  # spread the input dimensions uniformly
            self.map = np.full(d_out, -1, np.int64)
            for i in range(min(d_in, d_out)):
                self.map[i * d_out // max(d_in, 1)] = i
        else:
            self.map = np.array(
                [i if i < d_in else -1 for i in range(d_out)], np.int64
            )

    def _index(self):
        valid = np.nonzero(self.map >= 0)[0]
        dev = self.device
        return (torch.from_numpy(valid).to(dev),
                torch.from_numpy(self.map[valid]).to(dev))

    def _apply(self, x):
        dst, src = self._index()
        out = x.new_zeros((len(x), self.d_out))
        out[:, dst] = x[:, src]
        return out

    def _reverse(self, y):
        dst, src = self._index()
        out = y.new_zeros((len(y), self.d_in))
        out[:, src] = y[:, dst]
        return out


class HadamardRotation(LinearTransform):
    """Normalized Hadamard rotation with sign flips (VectorTransform.h:133)."""

    def __init__(self, d: int, seed: int = 1234, *, device):
        if d & (d - 1):
            raise ValueError("HadamardRotation requires power-of-two d")
        super().__init__(d, d, have_bias=False, device=device)
        h = np.array([[1.0]])
        while h.shape[0] < d:
            h = np.block([[h, h], [h, -h]])
        signs = np.where(np.random.RandomState(seed).rand(d) < 0.5, -1.0, 1.0)
        self.A = (h * signs[None, :] / np.sqrt(d)).astype(np.float32)
        self.is_orthonormal = True


class OPQMatrix(LinearTransform):
    """OPQ rotation (VectorTransform.h:255): alternate a PQ of M
    sub-quantizers (8 bits) over the rotated vectors and an orthogonal
    Procrustes update of the rotation (faiss_tpu transforms.py:251). The
    products and SVDs run on the host in float64; the PQ trains and encodes
    on the transform's device with the port's ProductQuantizer."""

    def __init__(self, d: int, M: int, d2: int = -1, *, device):
        d2 = d if d2 <= 0 else d2
        super().__init__(d, d2, have_bias=False, device=device)
        self.M = int(M)
        self.niter = 25  # outer iterations
        self.niter_pq = 4
        self.max_train_points = 256 * 256
        self.pq = None  # optionally a caller's ProductQuantizer
        self.is_trained = False
        self.verbose = False

    def train(self, x) -> None:
        from .codecs.pq import ProductQuantizer

        x = np.ascontiguousarray(x, np.float32)
        if len(x) > self.max_train_points:
            x = x[np.random.RandomState(123).permutation(len(x))[
                : self.max_train_points]]
        d, d2 = x.shape[1], self.d_out
        if d2 < d:  # start from the PCA basis, else a random rotation
            pca = PCAMatrix(d, d2, device=self.device)
            pca.train(x)
            A = pca.PCAMat[:d2].astype(np.float64)
        else:
            A = _random_orthogonal(d2, d, 1234).astype(np.float64)
        pq = self.pq or ProductQuantizer(d2, self.M, 8, device=self.device)
        pq.cp.niter = self.niter_pq
        xd = x.astype(np.float64)
        for it in range(self.niter):
            xt = (xd @ A.T).astype(np.float32)
            pq.train(xt)
            recon = pq.decode_int(pq.compute_codes_int(xt)).astype(np.float64)
            # orthogonal Procrustes: min ||x A^T - recon|| over orthonormal A
            u, _, vt = np.linalg.svd(xd.T @ recon, full_matrices=False)
            A = (u @ vt).T  # [d2, d]
            if self.verbose:
                err = ((xd @ A.T - recon) ** 2).sum()
                print(f"OPQ iter {it}: err {err:.3f}")
        self.A = A.astype(np.float32)
        self.is_orthonormal = True
        self.is_trained = True


class ITQMatrix(LinearTransform):
    """Iterative-quantization rotation (VectorTransform.h:211): alternate the
    sign assignment and a Procrustes update (Gong & Lazebnik)."""

    def __init__(self, d: int, *, device):
        super().__init__(d, d, have_bias=False, device=device)
        self.max_iter = 50
        self.seed = 123
        self.is_trained = False

    def train(self, x) -> None:
        x = np.ascontiguousarray(x, np.float64)
        rot = _random_orthogonal(self.d_in, self.d_in, self.seed).astype(np.float64)
        for _ in range(self.max_iter):
            b = np.sign(x @ rot.T)
            b[b == 0] = 1
            u, _, vt = np.linalg.svd(x.T @ b, full_matrices=False)
            rot = (u @ vt).T
        self.A = rot.astype(np.float32)
        self.is_orthonormal = True
        self.is_trained = True


class ITQTransform(VectorTransform):
    """Centering, an optional PCA, then the ITQ rotation
    (VectorTransform.h:225)."""

    def __init__(self, d_in: int, d_out: int, do_pca: bool = False, *, device):
        super().__init__(d_in, d_out, device=device)
        self.do_pca = do_pca
        self.mean: Optional[np.ndarray] = None
        self.pca_then_itq: Optional[LinearTransform] = None
        self.is_trained = False

    def train(self, x) -> None:
        x = np.ascontiguousarray(x, np.float32)
        self.mean = x.mean(0)
        xc = x - self.mean
        itq = ITQMatrix(self.d_out, device=self.device)
        if self.do_pca or self.d_out != self.d_in:
            pca = PCAMatrix(self.d_in, self.d_out, device=self.device)
            pca.train(xc)
            itq.train(_host_apply(pca, xc))
            lt = LinearTransform(self.d_in, self.d_out, False, device=self.device)
            lt.A = itq.A @ pca.A
            self.pca_then_itq = lt
        else:
            itq.train(xc)
            self.pca_then_itq = itq
        self.is_trained = True

    def _apply(self, x):
        return self.pca_then_itq.apply_tensor(x - self._dev("mean"))
