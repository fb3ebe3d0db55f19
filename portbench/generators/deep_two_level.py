"""The two-level mixture that stands in for Deep1B's descriptors: ``ncoarse``
unit-norm modes, ``nsub`` Gaussian sub-directions under each, anisotropic
noise, and rows L2-normalised as the real set's are. The generator of
benchs/bench_deep10m.py:42-91: its modes come, as there, from numpy's
RandomState of the fixed ``mixture_seed``, so every run serves the same
distribution; the rows are drawn on the card from a run's
``torch.Generator``."""

import numpy as np
import torch


class Sampler:
    """Draws rows of the mixture on ``device``."""

    def __init__(self, params, d, device):
        rs = np.random.RandomState(params["mixture_seed"])
        coarse = rs.randn(params["ncoarse"], d).astype(np.float32)
        coarse /= np.linalg.norm(coarse, axis=1, keepdims=True)
        subdirs = (rs.randn(params["ncoarse"], params["nsub"], d).astype(np.float32)
                   * params["subdir_std"])
        self.d = d
        self.p = params
        self.coarse = torch.from_numpy(coarse).to(device)
        self.subdirs = torch.from_numpy(subdirs).to(device)
        self.scales = 1.0 / torch.sqrt(
            torch.arange(d, device=device, dtype=torch.float32) + 1.0)

    def draw(self, n, gen):
        """[n, d] float32 unit rows on the generator's device."""
        dev, p = gen.device, self.p
        ci = torch.randint(p["ncoarse"], (n,), generator=gen, device=dev)
        si = torch.randint(p["nsub"], (n,), generator=gen, device=dev)
        noise = torch.randn(n, self.d, generator=gen, device=dev)
        x = (self.coarse[ci] + p["sub_scale"] * self.subdirs[ci, si]
             + noise * (self.scales * p["noise"]))
        return x / (x.norm(dim=1, keepdim=True) + 1e-9)


def make(params, d, device):
    return Sampler(params, d, device)
