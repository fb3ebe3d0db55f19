"""The Gaussian mixture that stands in for SIFT1M: ``ncent`` centres drawn
uniformly in [0, 1]^d, each row a centre plus Gaussian noise whose scale
falls as ``noise / (j + 1)`` along dimension j. The generator of
bench.py:228-244: its centres come, as there, from numpy's RandomState of
the fixed ``mixture_seed``, so every run serves the same distribution; the
rows are drawn on the card from a run's ``torch.Generator``."""

import numpy as np
import torch


class Sampler:
    """Draws rows of the mixture on ``device``."""

    def __init__(self, params, d, device):
        rs = np.random.RandomState(params["mixture_seed"])
        cent = rs.rand(params["ncent"], d).astype(np.float32)
        self.d = d
        self.cent = torch.from_numpy(cent).to(device)
        self.scales = params["noise"] / (
            torch.arange(d, device=device, dtype=torch.float32) + 1.0)

    def draw(self, n, gen):
        """[n, d] float32 rows on the generator's device."""
        dev = gen.device
        a = torch.randint(self.cent.shape[0], (n,), generator=gen, device=dev)
        noise = torch.randn(n, self.d, generator=gen, device=dev)
        return self.cent[a] + noise * self.scales


def make(params, d, device):
    return Sampler(params, d, device)
