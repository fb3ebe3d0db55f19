"""faiss_tpu_torch — the PyTorch and CUDA port of faiss_tpu for one NVIDIA
H100 (Hopper, sm_90a).

faiss_tpu (JAX on a TPU) stays beside it as the reference. This package
imports torch and numpy only, never jax or faiss_tpu. Plain tensor work is
PyTorch; each TPU kernel on a ported path is a hand-written Hopper kernel
under ``csrc/``, built with nvcc at first use. Every index takes an explicit
``device``.

Ported so far:

  - IVF-PQ search — ``IndexIVFPQ`` (4 or 8 bits, by residual or not) and
    ``IndexIVFPQFastScan`` with ``train``, ``add``, ``search`` (big batches
    through the ADC kernels or the exhaustive ADC scan, everything else by
    probe) and ``search_preassigned``; ``IndexRefineFlat`` over them with
    ``search`` and ``search_submit``/``search_collect`` at any nprobe,
    with strict probing (the default) or soft probing, over the bf16
    decoded store or, beyond ``recon_scan_max_bytes``, the codes; and
    ``IndexIVFPQR``;
  - exact flat search — ``IndexFlatL2`` and ``IndexFlatIP`` with ``add``,
    ``search`` and ``search_submit``/``search_collect`` for k <= 2048 through
    the bf16 hi/lo screen, the striped large-k screen and the fused exact
    kernel;
  - IVF-Flat search — ``IndexIVFFlat`` (L2) with ``train``, ``add``,
    ``search``, ``search_submit``/``search_collect``, ``search_preassigned``
    and ``reconstruct*``: big batches through the dynamic-chunk and the
    exhaustive scans over bf16 hi/lo store planes with an exact re-rank,
    strict (exact within the probed lists, the default) or soft probing;
    everything else through the exact scan by probe.
"""

import torch

# The coarse GEMM, the k-means assignments, the PQ encode, exact flat search
# and the plain kernel versions are float32 contracts: no TF32 anywhere.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from .base import Index, SearchParameters, query_buckets  # noqa: E402,F401
from .clustering import Clustering, ClusteringParameters  # noqa: E402,F401
from .codecs.pq import ProductQuantizer  # noqa: E402,F401
from .metric import METRIC_INNER_PRODUCT, METRIC_L2, MetricType  # noqa: E402,F401
from .models.flat import IndexFlat, IndexFlatIP, IndexFlatL2  # noqa: E402,F401
from .models.ivf import IndexIVF, SearchParametersIVF  # noqa: E402,F401
from .models.ivf_flat import IndexIVFFlat  # noqa: E402,F401
from .models.ivf_pq import (  # noqa: E402,F401
    IndexIVFPQ,
    IndexIVFPQFastScan,
    IndexIVFPQR,
)
from .models.meta import IndexRefine, IndexRefineFlat  # noqa: E402,F401
from .utils.evaluation import recall_at_k  # noqa: E402,F401
