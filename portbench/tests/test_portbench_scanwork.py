"""The scan work count against a count by hand over a tiny trained index:
the probed lists' slots for the operations, the union's for the bytes."""

import numpy as np
import torch

import faiss_tpu_torch as ft
from portbench import scanwork


def test_need_counts_probed_slots_and_the_union():
    rng = np.random.default_rng(0)
    xb = rng.standard_normal((6000, 16)).astype(np.float32)
    base = ft.index_factory(16, "IVF32,PQ4x4fs", device="cpu")
    base.cp.niter = 3
    index = ft.IndexRefineFlat(base)
    index.train(xb)
    index.add(xb)
    base.nprobe = 3
    xq = rng.standard_normal((100, 16)).astype(np.float32)

    cent = base.quantizer.vectors().astype(np.float64)
    home = (((xb[:, None, :] - cent[None]) ** 2).sum(-1)).argmin(1)
    sizes = np.bincount(home, minlength=32)  # each row sits in its nearest list
    d = ((xq[:, None, :] - cent[None]) ** 2).sum(-1)
    probed = np.argsort(d, axis=1)[:, :3]
    ops = 2 * 16 * sizes[probed].sum()
    nbytes = 2 * 16 * sizes[np.unique(probed)].sum() + 100 * (4 * 16 + 8 * 40)
    assert scanwork.need(index, [xq], 40, torch.device("cpu")) == (ops, nbytes)
    assert sizes.sum() == 6000


def test_unwrap_reaches_the_ivf_under_a_rotation():
    index = ft.index_factory(16, "OPQ4,IVF8,PQ4x4fs,RFlat", device="cpu")
    pre, ivf = scanwork.unwrap(index)
    assert pre is index and type(ivf).__name__ == "IndexIVFPQFastScan"
