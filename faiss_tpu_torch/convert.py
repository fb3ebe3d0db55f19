"""Build port indexes from the state of faiss_tpu indexes.

The state is handed over as numpy arrays, so this module needs neither JAX
nor faiss_tpu. With both packages serving the same trained state, search
parity does not depend on k-means RNG. For a faiss_tpu flat index ``flat``
the state is ``flat.vectors()`` and its metric; for a faiss_tpu
``IndexRefineFlat(IndexIVFPQFastScan(...))`` named ``ref`` the arrays are::

    base = ref.base_index
    refine_flat_from_arrays(
        base.quantizer.vectors(), base.pq.centroids, base._codes_host,
        base._listnos_host, base._ids_host, ref.refine_index.vectors(),
        device=..., store_float16=True)
"""

from __future__ import annotations

import numpy as np

from .metric import MetricType
from .models.flat import IndexFlat, IndexFlatL2
from .models.ivf_pq import IndexIVFPQ, IndexIVFPQFastScan
from .models.meta import IndexRefineFlat


def flat_from_arrays(xb, metric=MetricType.L2, *, device) -> IndexFlat:
    """IndexFlat (METRIC_L2 or METRIC_INNER_PRODUCT) holding the rows
    ``xb`` [n, d] in order, as a faiss_tpu flat index's ``vectors()`` gives
    them."""
    xb = np.ascontiguousarray(xb, np.float32)
    if xb.ndim != 2:
        raise ValueError(f"xb must be [n, d], got shape {xb.shape}")
    index = IndexFlat(xb.shape[1], MetricType(metric), device=device)
    index.add(xb)
    return index


def ivfpq_from_arrays(centroids, pq_centroids, codes, listnos, ids, *, device
                      ) -> IndexIVFPQ:
    """IndexIVFPQ (IndexIVFPQFastScan when nbits = 4) from coarse centroids
    [nlist, d], PQ codebooks [M, ksub, dsub], unpacked codes [n, M] uint8,
    coarse list numbers [n] and ids [n]."""
    centroids = np.ascontiguousarray(centroids, np.float32)
    pq_centroids = np.ascontiguousarray(pq_centroids, np.float32)
    codes = np.ascontiguousarray(codes, np.uint8)
    listnos = np.ascontiguousarray(listnos, np.int32).ravel()
    ids = np.ascontiguousarray(ids, np.int64).ravel()
    nlist, d = centroids.shape
    M, ksub, _ = pq_centroids.shape
    n = len(codes)
    if codes.shape != (n, M) or len(listnos) != n or len(ids) != n:
        raise ValueError("codes, listnos and ids disagree in length or M")
    if n and not (0 <= listnos.min() and listnos.max() < nlist):
        raise ValueError("list numbers out of range")
    nbits = ksub.bit_length() - 1
    quantizer = IndexFlatL2(d, device=device)
    quantizer.add(centroids)
    cls = IndexIVFPQFastScan if nbits == 4 else IndexIVFPQ
    index = cls(quantizer, d, nlist, M, nbits, device=device)
    index.pq.set_centroids(pq_centroids)
    index.is_trained = True
    index.add_encoded(codes, listnos, ids)
    return index


def refine_flat_from_arrays(centroids, pq_centroids, codes, listnos, ids,
                            refine_rows, *, device, store_float16=True
                            ) -> IndexRefineFlat:
    """IndexRefineFlat over :func:`ivfpq_from_arrays`; ``refine_rows``
    [n, d] are the refine store's rows in add order."""
    base = ivfpq_from_arrays(
        centroids, pq_centroids, codes, listnos, ids, device=device
    )
    return IndexRefineFlat(base, refine_rows, store_float16=store_float16)
