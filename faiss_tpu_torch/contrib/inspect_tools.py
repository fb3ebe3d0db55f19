"""Index introspection (counterpart of faiss_tpu/contrib/inspect_tools.py;
the reference's contrib/inspect_tools.py). Host arrays out."""

from __future__ import annotations

import numpy as np
import torch


def _host(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else a


def get_invlist(index_ivf, list_no: int):
    """ids and codes of one inverted list, in add order."""
    mask = index_ivf._listnos_host == list_no
    return index_ivf._ids_host[mask], index_ivf._codes_host[mask]


def get_invlist_sizes(index_ivf) -> np.ndarray:
    return np.bincount(index_ivf._listnos_host, minlength=index_ivf.nlist).astype(np.int64)


def get_flat_data(index_flat) -> np.ndarray:
    return index_flat.vectors()


def get_pq_centroids(pq) -> np.ndarray:
    return np.array(_host(pq.centroids))


def get_LinearTransform_matrix(vt):
    return _host(vt.A), _host(vt.b)


def print_object_fields(obj) -> None:
    for name, val in vars(obj).items():
        if isinstance(val, (np.ndarray, torch.Tensor)):
            print(f"{name}: array {tuple(val.shape)} {val.dtype}")
        else:
            print(f"{name}: {val!r}")
