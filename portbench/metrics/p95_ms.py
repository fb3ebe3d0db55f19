"""p95_ms: the 95th percentile of a batch's latency, from its submit to
its answer on the host, over every batch of the window (numpy's linear
interpolation)."""

import numpy as np


def read(run):
    lat = [b[3] - b[2] for b in run.batches]
    return float(np.percentile(lat, 95)) * 1e3 if lat else None
