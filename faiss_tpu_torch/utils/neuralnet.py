"""The small neural-net layers and the QINCo codec (counterpart of
faiss_tpu/utils/neuralnet.py; reference: faiss/utils/NeuralNet.{h,cpp},
Linear / Embedding / FFN at NeuralNet.h:23-129, and the QINCo codec of
IndexNeuralNetCodec.h; Huijben et al., "Residual Quantization with Implicit
Neural Codebooks", 2024).

The layers are ``nn.Module``s whose state-dict names are faiss_tpu's (those
of the public torch QINCo): ``codebook0.weight``, ``steps.{m}.codebook.weight``,
``steps.{m}.MLPconcat.{weight,bias}`` and
``steps.{m}.residual_blocks.{l}.{0,2}.{weight,bias}``; ``load_state`` takes
faiss_tpu's numpy dict. A QINCo step scores every one of its K codes per row:
the concat layer splits into the codebook's part (K rows, once) and the
partial reconstruction's (n rows, once), and the residual blocks run on the
[rows, K, d] block, tiled over rows so that a block's hidden layer stays
under ENCODE_TILE_BYTES. ``train_qinco`` trains with autograd and Adam
(optax's adam defaults), on faiss_tpu's batches: ``RandomState(seed)``
permutations, partial batches skipped."""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

# bytes of one encode tile's [rows, K, max(d, h)] float32 hidden block
ENCODE_TILE_BYTES = 256 << 20


class Linear(nn.Linear):
    """y = x W^T + b (reference: NeuralNet.h:42)."""


class Embedding(nn.Embedding):
    """Code -> vector table (reference: NeuralNet.h:60)."""


class FFN(nn.Sequential):
    """Linear-ReLU-Linear block (reference: NeuralNet.h:77); its layers are
    ``0`` and ``2`` in the state dict."""

    def __init__(self, d: int, h: int):
        super().__init__(Linear(d, h), nn.ReLU(), Linear(h, d))

    @property
    def linear1(self) -> Linear:
        return self[0]

    @property
    def linear2(self) -> Linear:
        return self[2]


class QINCoStep(nn.Module):
    """One QINCo step: its codebook conditioned on the partial
    reconstruction by a concat layer and L residual FFN blocks (reference:
    NeuralNet.h QINCoStep)."""

    def __init__(self, d: int, K: int, L: int, h: int):
        super().__init__()
        self.d, self.K, self.L, self.h = d, K, L, h
        self.codebook = Embedding(K, d)
        self.MLPconcat = Linear(2 * d, d)
        self.residual_blocks = nn.ModuleList([FFN(d, h) for _ in range(L)])

    def _blocks(self, z: torch.Tensor) -> torch.Tensor:
        for blk in self.residual_blocks:
            z = z + blk(z)
        return z

    def decode(self, xhat: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
        """The conditioned codeword of each (partial reconstruction, code)."""
        zqs = self.codebook(codes.long())
        zqs = zqs + self.MLPconcat(torch.cat([zqs, xhat], dim=-1))
        return self._blocks(zqs)

    def decode_all(self, xhat: torch.Tensor) -> torch.Tensor:
        """The conditioned codewords of all K codes [n, K, d]."""
        w, b = self.MLPconcat.weight, self.MLPconcat.bias
        cb = self.codebook.weight
        z = cb + cb @ w[:, : self.d].T + b  # [K, d]
        z = z[None] + (xhat @ w[:, self.d :].T)[:, None, :]
        return self._blocks(z)

    def encode(self, xhat: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """The code whose conditioned codeword best matches x - xhat, the
        first on ties; rows in tiles."""
        rows = max(1, ENCODE_TILE_BYTES // (4 * self.K * max(self.d, self.h)))
        out = []
        for s in range(0, len(x), rows):
            cand = self.decode_all(xhat[s : s + rows])
            target = (x[s : s + rows] - xhat[s : s + rows])[:, None, :]
            out.append((cand - target).square().sum(-1).argmin(1))
        return torch.cat(out) if out else torch.zeros(0, dtype=torch.int64,
                                                      device=x.device)


class QINCo(nn.Module):
    """The M-step QINCo decoder and encoder (reference: NeuralNet.h
    QINCo:107)."""

    def __init__(self, d: int, K: int, L: int, M: int, h: int):
        super().__init__()
        self.d, self.K, self.L, self.M, self.h = d, K, L, M, h
        self.codebook0 = Embedding(K, d)
        self.steps = nn.ModuleList([QINCoStep(d, K, L, h) for _ in range(M - 1)])

    @property
    def device(self) -> torch.device:
        return self.codebook0.weight.device

    @torch.no_grad()
    def decode(self, codes: torch.Tensor) -> torch.Tensor:
        codes = codes.long()
        xhat = self.codebook0(codes[:, 0])
        for m, step in enumerate(self.steps):
            xhat = xhat + step.decode(xhat, codes[:, m + 1])
        return xhat

    @torch.no_grad()
    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """Codes [n, M] int64: step 0 the nearest level-0 codeword, then
        each step's best conditioned codeword."""
        x = x.float()
        cb0 = self.codebook0.weight
        d2 = (x.square().sum(1)[:, None] + cb0.square().sum(1)[None, :]
              - 2 * x @ cb0.T)
        codes = [d2.argmin(1)]
        xhat = cb0[codes[0]]
        for step in self.steps:
            codes.append(step.encode(xhat, x))
            xhat = xhat + step.decode(xhat, codes[-1])
        return torch.stack(codes, 1)

    def load_state(self, state: Dict[str, np.ndarray]) -> None:
        """Load a flat numpy dict of faiss_tpu's (torch state-dict) names."""
        dev = self.device
        self.load_state_dict({k: torch.as_tensor(np.asarray(v, np.float32), device=dev)
                              for k, v in state.items()})

    def state_numpy(self) -> Dict[str, np.ndarray]:
        return {k: v.detach().cpu().numpy() for k, v in self.state_dict().items()}


def qinco_init(d, K, L, M, h, x0=None, *, seed=0, device="cuda"):
    """A starting state: the level-0 codebook by 10 k-means iterations over
    x0[:K * 64] where x0 holds at least K rows, else N(0, 0.1^2); the step
    codebooks N(0, 0.01^2) and the layers He-normal, zero biases, as
    faiss_tpu's ``_qinco_init``, drawn from a ``torch.Generator``."""
    gen = torch.Generator().manual_seed(seed)

    def rnd(shape, scale):
        return (torch.randn(shape, generator=gen) * scale).numpy()

    params = {}
    if x0 is not None and len(x0) >= K:
        from ..clustering import Clustering, ClusteringParameters

        cp = ClusteringParameters()
        cp.niter = 10
        clus = Clustering(d, K, cp, device=device)
        clus.train(np.ascontiguousarray(x0[: K * 64], np.float32))
        params["codebook0.weight"] = np.asarray(clus.centroids, np.float32)
    else:
        params["codebook0.weight"] = rnd((K, d), 0.1)
    for m in range(M - 1):
        p = f"steps.{m}."
        params[p + "codebook.weight"] = rnd((K, d), 0.01)
        params[p + "MLPconcat.weight"] = rnd((d, 2 * d), (2.0 / (2 * d)) ** 0.5)
        params[p + "MLPconcat.bias"] = np.zeros(d, np.float32)
        for l in range(L):
            q = f"{p}residual_blocks.{l}."
            params[q + "0.weight"] = rnd((h, d), (2.0 / d) ** 0.5)
            params[q + "0.bias"] = np.zeros(h, np.float32)
            params[q + "2.weight"] = rnd((d, h), (2.0 / h) ** 0.5)
            params[q + "2.bias"] = np.zeros(d, np.float32)
    return params


def _qinco_loss(model: QINCo, xb: torch.Tensor) -> torch.Tensor:
    """The mean over steps of the batch's mean squared error after each
    step, codes chosen by hard argmin (faiss_tpu neuralnet.py:229)."""
    cb0 = model.codebook0.weight
    d2 = xb.square().sum(1)[:, None] + cb0.square().sum(1)[None, :] - 2.0 * xb @ cb0.T
    xhat = cb0[d2.argmin(1)]
    loss = (xb - xhat).square().sum(1).mean()
    for step in model.steps:
        cand = step.decode_all(xhat)  # [n, K, d]
        err = (cand - (xb - xhat)[:, None, :]).square().sum(-1)
        code = err.detach().argmin(1)
        xhat = xhat + cand[torch.arange(len(xb), device=xb.device), code]
        loss = loss + (xb - xhat).square().sum(1).mean()
    return loss / model.M


def train_qinco(x: np.ndarray, K: int, M: int, L: int = 2, h: int = 256,
                epochs: int = 4, batch: int = 1024, lr: float = 1e-3,
                seed: int = 0, verbose: bool = False,
                init_state: Optional[Dict[str, np.ndarray]] = None, *,
                device="cuda") -> QINCo:
    """Train a QINCo codec on ``x`` (faiss_tpu neuralnet.py:186) on
    ``device``; ``init_state`` (a numpy state dict) replaces the seeded
    start. The returned model's ``train_losses`` holds each epoch's mean
    batch loss."""
    x = np.ascontiguousarray(x, np.float32)
    n, d = x.shape
    device = torch.device(device)
    if init_state is None:
        init_state = qinco_init(d, K, L, M, h, x, seed=seed, device=device)
    model = QINCo(d, K, L, M, h).to(device)
    model.load_state(init_state)
    opt = torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)
    xd = torch.from_numpy(x).to(device)
    rs = np.random.RandomState(seed)
    nb = max(1, n // batch)
    model.train_losses = []
    for ep in range(epochs):
        perm = rs.permutation(n)
        tot = torch.zeros((), device=device)
        for b in range(nb):
            rows = perm[b * batch : (b + 1) * batch]
            if len(rows) < batch:
                continue
            loss = _qinco_loss(model, xd[torch.from_numpy(rows).to(device)])
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            tot += loss.detach()
        model.train_losses.append(float(tot) / max(1, nb))
        if verbose:
            print(f"[qinco] epoch {ep}: loss {model.train_losses[-1]:.4f}")
    return model
