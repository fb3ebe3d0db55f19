"""List-major batched IVF search (counterpart of
faiss_tpu/contrib/big_batch_search.py; the reference's
contrib/big_batch_search.py:23).

For a huge query batch the work is reordered list by list: each inverted
list is decoded once and scored against every query that probes it. The
(query, probe) pairs are sorted by list once, as are the stored codes, so a
list finds its queries and its codes as two contiguous slices. The scoring
runs on the index's device (faiss_tpu scores in numpy): the list's
reconstructions, one product with its queries, and a merge into the
running top-k, which stays on the device until the end or a checkpoint.
A checkpoint (``D``, ``I``, ``next_list``) lets an interrupted search
resume; InterruptCallback.check() runs before every list."""

from __future__ import annotations

import os

import numpy as np
import torch

from ..callbacks import InterruptCallback
from ..codecs.pq import codes_tensor
from ..metric import MetricType


def _csr_by_value(values: np.ndarray, n_bins: int):
    """Sort ``values`` ascending: (order, starts) with
    ``order[starts[v]:starts[v+1]]`` the positions holding ``v``."""
    order = np.argsort(values, kind="stable")
    starts = np.searchsorted(values[order], np.arange(n_bins + 1))
    return order, starts


def _sorted_decoder(index, slot_order):
    """(decode(s0, s1, list_no) -> reconstructions [s1 - s0, d] float32 on the
    device) of the codes sorted by list once: on the device for IVF-Flat
    (the codes are the vectors) and IVF-PQ, else through the index's host
    decode."""
    from ..models.ivf_flat import IndexIVFFlat
    from ..models.ivf_pq import IndexIVFPQ

    dev, codes = index.device, index._codes_host[slot_order]
    if type(index) is IndexIVFFlat:
        xs = torch.from_numpy(np.ascontiguousarray(codes, np.float32)).to(dev)
        return lambda s0, s1, ln: xs[s0:s1]
    if isinstance(index, IndexIVFPQ):
        cs = codes_tensor(codes, dev)
        return lambda s0, s1, ln: index._decode_dev(
            cs[s0:s1], torch.full((s1 - s0,), ln, dtype=torch.long, device=dev))
    return lambda s0, s1, ln: torch.from_numpy(index.decode_vectors(
        codes[s0:s1], np.full(s1 - s0, ln, np.int64))).to(dev)


def big_batch_search(index_ivf, xq, k: int, verbose: int = 0,
                     checkpoint_path=None, checkpoint_every: int = 64):
    """List-major search at the index's ``nprobe``: (D, I) as the index's
    own exact search within the probed lists returns, up to tie order."""
    dev = index_ivf.device
    xq = np.ascontiguousarray(xq, np.float32)
    nq, nprobe, nlist = len(xq), index_ivf.nprobe, index_ivf.nlist
    xd = torch.from_numpy(xq).to(dev)
    probes = index_ivf._quantizer_search(xd, nprobe)[1].cpu().numpy()
    is_l2 = index_ivf.metric_type == MetricType.L2
    qn = xd.square().sum(1)

    # ONE sort of the (query, probe) pairs by list and ONE of the stored
    # codes: every list reads its queries and its codes as slices
    pair_order, pair_starts = _csr_by_value(probes.ravel().astype(np.int64), nlist)
    pair_q = torch.from_numpy(pair_order // nprobe).to(dev)
    slot_order, slot_starts = _csr_by_value(
        index_ivf._listnos_host.astype(np.int64), nlist)
    ids = torch.from_numpy(index_ivf._ids_host[slot_order]).to(dev)
    decode = _sorted_decoder(index_ivf, slot_order)

    D = torch.full((nq, k), float("inf"), device=dev)
    I = torch.full((nq, k), -1, dtype=torch.int64, device=dev)
    start_list = 0
    if checkpoint_path is not None and os.path.exists(checkpoint_path):
        with np.load(checkpoint_path) as z:
            D = torch.from_numpy(z["D"]).to(dev)
            I = torch.from_numpy(z["I"]).to(dev)
            start_list = int(z["next_list"])
        if verbose:
            print(f"resuming at list {start_list}")

    for ln in range(start_list, nlist):
        InterruptCallback.check()
        p0, p1 = int(pair_starts[ln]), int(pair_starts[ln + 1])
        s0, s1 = int(slot_starts[ln]), int(slot_starts[ln + 1])
        if p1 > p0 and s1 > s0:
            qsel = pair_q[p0:p1]
            recon = decode(s0, s1, ln).float()
            ip = xd[qsel] @ recon.T
            d = (qn[qsel][:, None] + recon.square().sum(1)[None, :] - 2.0 * ip
                 if is_l2 else -ip)
            # the running top-k merged with this list's scores
            dc = torch.cat([D[qsel], d], 1)
            ic = torch.cat([I[qsel], ids[s0:s1].expand(p1 - p0, -1)], 1)
            v, pos = torch.topk(dc, k, dim=1, largest=False, sorted=True)
            D[qsel] = v
            I[qsel] = torch.gather(ic, 1, pos)
        if checkpoint_path is not None and (ln + 1) % checkpoint_every == 0:
            np.savez(checkpoint_path, D=D.cpu().numpy(), I=I.cpu().numpy(),
                     next_list=ln + 1)
            if verbose:
                print(f"checkpointed at list {ln + 1}")
    D, I = D.cpu().numpy(), I.cpu().numpy()
    return (D if is_l2 else -D), I
