"""Torch interop (counterpart of faiss_tpu/contrib/torch_utils.py; the
reference's contrib/torch_utils.py).

Importing this module installs the reference's contract on every index of
the port (``handle_torch_Index``): the methods of ``_PATCHED_METHODS``
accept torch tensors, on any device, and when any argument was a tensor
they return tensors on the device of the first one (the query tensor of a
search). The index computes on its own device either way; the tensors pass
through numpy. The standalone helpers (``torch_knn``,
``torch_pairwise_distances``, ``torch_kmeans``) compute on the device of
their input tensor.

faiss_tpu's ``torch_to_jax`` and ``jax_to_torch`` are not here: they hand
arrays to and from JAX, which the port does not import.

    import faiss_tpu_torch.contrib.torch_utils   # patches the Index tree
    index.add(torch_tensor)
    D, I = index.search(torch_queries, k)          # tensors on its device
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..base import Index


def is_torch(x) -> bool:
    return isinstance(x, torch.Tensor)


def torch_to_numpy(t) -> np.ndarray:
    if is_torch(t):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def numpy_to_torch(a, like=None):
    """``a`` as a tensor, on the device of ``like`` when it is a tensor."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if is_torch(like) and like.device.type != "cpu":
        t = t.to(like.device)
    return t


# ---------------------------------------------------------------------------
# method patching (handle_torch_Index, reference torch_utils.py:149)
# ---------------------------------------------------------------------------


def _wrap_inputs_outputs(fn):
    @functools.wraps(fn)
    def wrapper(self, *args, **kwargs):
        ref = next((a for a in list(args) + list(kwargs.values()) if is_torch(a)), None)
        if ref is None:
            return fn(self, *args, **kwargs)
        args = tuple(torch_to_numpy(a) if is_torch(a) else a for a in args)
        kwargs = {k: torch_to_numpy(v) if is_torch(v) else v for k, v in kwargs.items()}
        out = fn(self, *args, **kwargs)
        if isinstance(out, tuple):
            return tuple(numpy_to_torch(o, ref) if isinstance(o, np.ndarray) else o
                         for o in out)
        if isinstance(out, np.ndarray):
            return numpy_to_torch(out, ref)
        return out

    wrapper._torch_wrapped = True
    return wrapper


_PATCHED_METHODS = (
    "train",
    "add",
    "add_with_ids",
    "search",
    "search_and_reconstruct",
    "assign",
    "reconstruct",
    "reconstruct_n",
    "reconstruct_batch",
    "sa_encode",
    "sa_decode",
)


def handle_torch_Index(cls=Index) -> None:
    """Wrap the methods of ``cls`` and of every subclass that defines one of
    ``_PATCHED_METHODS`` to take and return torch tensors (reference:
    handle_torch_Index, contrib/torch_utils.py)."""

    def patch_tree(c):
        for name in _PATCHED_METHODS:
            fn = c.__dict__.get(name)
            if fn is None or getattr(fn, "_torch_wrapped", False):
                continue
            setattr(c, name, _wrap_inputs_outputs(fn))
        for sub in c.__subclasses__():
            patch_tree(sub)

    patch_tree(cls)


# install on import, as the reference module does
handle_torch_Index(Index)


# ---------------------------------------------------------------------------
# standalone wrappers (contrib/torch/{clustering,quantization}.py surface)
# ---------------------------------------------------------------------------


def torch_knn(xq, xb, k: int, metric=None):
    """Exact k-NN of two tensors on ``xq``'s device: (D, I) there."""
    from ..extra import knn as knn_fn
    from ..metric import MetricType

    D, I = knn_fn(torch_to_numpy(xq), torch_to_numpy(xb), k,
                  metric=metric if metric is not None else MetricType.L2,
                  device=xq.device)
    return numpy_to_torch(D, xq), numpy_to_torch(I, xq)


def torch_pairwise_distances(xq, xb, metric=None):
    from ..extra import pairwise_distances
    from ..metric import MetricType

    D = pairwise_distances(torch_to_numpy(xq), torch_to_numpy(xb),
                           metric=metric if metric is not None else MetricType.L2,
                           device=xq.device)
    return numpy_to_torch(D, xq)


def torch_kmeans(x, k: int, niter: int = 25, **kwargs):
    """k-means of a tensor on its device (contrib/torch/clustering.py):
    (centroids, assignment) as tensors there."""
    from ..clustering import Kmeans

    km = Kmeans(x.shape[1], k, niter=niter, device=x.device, **kwargs)
    xn = torch_to_numpy(x)
    km.train(xn)
    _, I = km.assign(xn)
    return numpy_to_torch(km.centroids, x), numpy_to_torch(np.asarray(I).ravel(), x)


def search_with_torch(index, xq, k: int):
    """(D, I) of ``index.search`` as tensors on ``xq``'s device."""
    D, I = index.search(torch_to_numpy(xq), k)
    return numpy_to_torch(D, xq), numpy_to_torch(I, xq)


def add_with_torch(index, xb):
    index.add(torch_to_numpy(xb))
