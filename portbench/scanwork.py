"""The scan work that a batch of queries needs from an IVF index, whichever
kernel does it, and the least time the card could take for it.

Each query scores every vector-holding slot of the ``nprobe`` lists that
its coarse centroids pick: one product of ``d`` terms (2 d operations, at
the data's d, not a padded width) per (query, slot) pair. The store columns
of the union of the batch's probed lists are read once, in bf16 (2 bytes a
dimension), with each query (d float32) and its ``kc`` candidates out (a
float32 key and an int32 slot each). The least time is the larger of the
operations over the card's bf16 peak and the bytes over its memory
bandwidth (``peaks.json``)."""

import json
from pathlib import Path

import numpy as np
import torch

from .reference.knn import tf32_off

PEAKS = Path(__file__).resolve().parent / "peaks.json"


def peaks(card):
    """The peak rates of ``card`` (its torch.cuda name), or None."""
    with open(PEAKS) as f:
        return json.load(f)["cards"].get(card)


def nodes(index):
    """The index's tree from the outside in: PreTransform, Refine, IVF (by
    their own attributes: a PreTransform forwards reads to its inner index)."""
    out = [index]
    while True:
        own = vars(out[-1])
        nxt = own.get("index") if "chain" in own else own.get("base_index")
        if nxt is None:
            return out
        out.append(nxt)


def unwrap(index):
    """(pre-transform or None, IVF index) of a PreTransform / Refine tree."""
    tree = nodes(index)
    return next((n for n in tree if "chain" in vars(n)), None), tree[-1]


def ivf_lists(index):
    """(centroids [nlist, d] float32, slots per list [nlist]) of the IVF."""
    from faiss_tpu_torch.ivflib import get_invlist_range
    _, ivf = unwrap(index)
    listnos = get_invlist_range(ivf, 0, ivf.nlist)[1]
    sizes = np.bincount(listnos, minlength=ivf.nlist).astype(np.int64)
    return np.ascontiguousarray(ivf.quantizer.vectors(), np.float32), sizes


def need(index, batches, kc, device):
    """Operations and bytes of the scan work of ``batches`` (host query
    arrays as the index was given them)."""
    pre, ivf = unwrap(index)
    cent, sizes = ivf_lists(index)
    c = torch.from_numpy(cent).to(device)
    cn2 = c.square().sum(1)
    sz = torch.from_numpy(sizes).to(device)
    d = ivf.d
    ops = nbytes = 0
    with tf32_off():
        for x in batches:
            xt = pre.apply_chain(x) if pre is not None else x
            q = torch.from_numpy(np.ascontiguousarray(xt, np.float32)).to(device)
            probed = torch.topk(cn2[None, :] - 2.0 * (q @ c.T), ivf.nprobe,
                                dim=1, largest=False).indices
            ops += 2 * d * int(sz[probed].sum())
            nbytes += 2 * d * int(sz[torch.unique(probed)].sum())
            nbytes += q.shape[0] * (4 * x.shape[1] + 8 * kc)
    return ops, nbytes


def least_time(ops, nbytes, peak):
    """(seconds, the bound that sets them: "operations" or "bytes")."""
    t_ops = ops / peak["bf16_flops"]
    t_bytes = nbytes / peak["hbm_bytes_per_s"]
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
