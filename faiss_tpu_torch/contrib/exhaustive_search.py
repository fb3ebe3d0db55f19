"""Streaming exact ground truth and range search with a result cap
(counterpart of faiss_tpu/contrib/exhaustive_search.py; the reference's
contrib/exhaustive_search.py)."""

from __future__ import annotations

import numpy as np

from ..extra import ResultHeap, knn as knn_fn
from ..metric import MetricType


def knn_ground_truth(xq, db_iterator, k: int, metric=MetricType.L2, *,
                     device="cuda"):
    """Exact k-NN of ``xq`` against a database streamed in blocks
    (contrib/exhaustive_search.py:15 knn_ground_truth): each block's k-NN
    runs on ``device``, and the host merges them, so memory stays bounded by
    the block size."""
    xq = np.ascontiguousarray(xq, np.float32)
    rh = ResultHeap(len(xq), k, keep_max=metric == MetricType.INNER_PRODUCT)
    i0 = 0
    for xbi in db_iterator:
        ni = len(xbi)
        Di, Ii = knn_fn(xq, xbi, min(k, ni), metric=metric, device=device)
        rh.add_result(Di, Ii + i0)
        i0 += ni
    rh.finalize()
    return rh.D, rh.I


def range_search_max_results(index, x, radius, max_results=1e9, min_results=0):
    """Range search that shrinks the radius until the result count is at
    most ``max_results`` (contrib/exhaustive_search.py:277); the searches
    run on the index's device."""
    while True:
        res = index.range_search(x, radius)
        nres = int(res.lims[-1])
        if nres <= max_results or nres <= min_results:
            return radius, res.lims, res.distances, res.labels
        radius *= 0.8 if index.metric_type == MetricType.L2 else 1.25
