"""Multi-device distribution (counterpart of faiss_tpu/parallel): the
sharded indexes over a mesh of devices, sharded search and the shard merge."""

from .sharded import (  # noqa: F401
    Mesh,
    ShardedFlat,
    ShardedIVF,
    ShardedIVFPQ,
    ShardedIVFPQBuilder,
    ShardedRefinedIVFPQ,
    make_mesh,
    sharded_kmeans_iter,
)
