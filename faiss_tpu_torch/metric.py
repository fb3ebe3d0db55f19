"""Metric types (counterpart of faiss_tpu/metric.py).

Same enum values as the reference metric enum (faiss/MetricType.h:29-48), so
indexes and user code translate between the two packages directly.

  - METRIC_INNER_PRODUCT: similarity, higher is better ("max" metric).
  - METRIC_L2: *squared* L2 distance, lower is better.
  - the other metrics are "min" metrics but ABS_INNER_PRODUCT.
"""

from __future__ import annotations

import enum


class MetricType(enum.IntEnum):
    """Distance/similarity metric (reference: faiss/MetricType.h:29)."""

    INNER_PRODUCT = 0
    L2 = 1
    L1 = 2
    Linf = 3
    Lp = 4  # requires metric_arg = p

    Canberra = 20
    BrayCurtis = 21
    JensenShannon = 22
    Jaccard = 23
    NaNEuclidean = 24
    GOWER = 25
    ABS_INNER_PRODUCT = 26


METRIC_INNER_PRODUCT = MetricType.INNER_PRODUCT
METRIC_L2 = MetricType.L2
METRIC_L1 = MetricType.L1
METRIC_Linf = MetricType.Linf
METRIC_Lp = MetricType.Lp
METRIC_Canberra = MetricType.Canberra
METRIC_BrayCurtis = MetricType.BrayCurtis
METRIC_JensenShannon = MetricType.JensenShannon
METRIC_Jaccard = MetricType.Jaccard
METRIC_NaNEuclidean = MetricType.NaNEuclidean
METRIC_GOWER = MetricType.GOWER
METRIC_ABS_INNER_PRODUCT = MetricType.ABS_INNER_PRODUCT


def is_similarity_metric(metric: MetricType) -> bool:
    """True if larger values mean closer (reference: MetricType.h:51)."""
    return metric in (MetricType.INNER_PRODUCT, MetricType.ABS_INNER_PRODUCT)
