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
    everything else through the exact scan by probe;
  - ID selectors — ``IDSelectorRange``, ``IDSelectorArray``,
    ``IDSelectorBatch``, ``IDSelectorBitmap``, ``IDSelectorNot``/``And``/
    ``Or``/``XOr``/``All`` in every search of the flat, IVF-Flat and IVF-PQ
    indexes (masked k-NN, or by probe), and ``IndexIDMap``/``IndexIDMap2``
    with the selector translated to their ids;
  - the flat remainder — ``range_search``, ``remove_ids``, ``merge_from``,
    ``reconstruct*`` and ``sa_*`` of ``IndexFlat``; ``IndexFlatSQ8`` and
    Refine(SQ8), ``IndexRefine`` over IVF-PQ with an SQ8 store, on the same
    fused path; ``IndexFlat1D``;
  - training — ``Clustering`` with weights, every init (random, k-means++,
    AFK-MC2), integer and frozen centroids and uint8 points kept uint8 on
    the device; ``SuperKMeans``, ``kmeans_clustering``, ``Kmeans``,
    ``kmeans1d`` and ``ProgressiveDimClustering``;
  - the scalar quantizers — ``ScalarQuantizer`` with every quantizer type
    and range statistic, ``IndexScalarQuantizer`` (the flat search over the
    decoded rows) and ``IndexIVFScalarQuantizer`` (by probe, L2 or inner
    product, by residual or not);
  - the IVF remainder — the inner-product metric of IVF-Flat and IVF-PQ
    (spherical k-means for the coarse quantizer; by probe), ``remove_ids``,
    ``merge_from``, ``update_vectors``, ``range_search``, the direct map and
    ``IndexIVFStats``;
  - the meta layer — the vector transforms (``PCAMatrix``, ``OPQMatrix``,
    ``RandomRotationMatrix``, ``HadamardRotation``, ``ITQMatrix``,
    ``ITQTransform``, ``NormalizationTransform``, ``CenteringTransform``,
    ``RemapDimensionsTransform``, ``LinearTransform``) and
    ``IndexPreTransform``; ``IndexRefine`` over any base and any refine
    store, ``IndexRefineFlat`` with an f32, f16 or SQ8 store;
    ``IndexSplitVectors`` and ``IndexRandom``;
  - the PQ and Hamming family — ``ProductQuantizer`` at any nbits from 1
    to 16 (``Train_shared``, the ADC and SDC tables, ``search``),
    ``IndexPQ`` and ``IndexPQFastScan`` (ADC, SDC and polysemous search,
    ``range_search``, ``sa_*``, ``merge_from``), ``PolysemousTraining``
    with ``SimulatedAnnealingParameters``, the polysemous filter and
    ``do_polysemous_training`` of IVF-PQ, IVF-PQ at any nbits;
    ``IndexLSH``; the binary indexes ``IndexBinaryFlat``,
    ``IndexBinaryFlat1Bit``, ``IndexBinaryIVF``, ``IndexBinaryFromFloat``,
    ``IndexBinaryHash`` and ``IndexBinaryMultiHash``;
  - the graph indexes, their graphs built and walked on the host in C++
    (``csrc/host/``, built with g++ at first use) over the port's storage
    on the device — ``IndexHNSWFlat``, ``IndexHNSWFlatPanorama``,
    ``IndexHNSWPQ``, ``IndexHNSWSQ``, ``IndexHNSW2Level`` (over
    ``Index2Layer``, with ``flip_to_ivf``), ``IndexNSGFlat``,
    ``IndexNSGPQ``, ``IndexNSGSQ`` (a deterministic NN-descent),
    ``IndexNNDescentFlat`` and ``IndexBinaryHNSW``, with ``hnsw_stats``,
    ``nsg_stats`` and the interrupt callbacks;
  - the coarse quantizers other than flat — ``MultiIndexQuantizer`` and
    ``MultiIndexQuantizer2`` (the IMI, its tables and merge on the device),
    an ``IndexHNSWFlat`` over the centroids, or any index of the port, as
    the quantizer of every IVF index;
  - the additive quantizers — ``ResidualQuantizer`` (beam-search
    encoding), ``LocalSearchQuantizer`` (ICM and iterated local search),
    ``ProductResidualQuantizer``, ``ProductLocalSearchQuantizer`` with every
    norm storage, their flat indexes (``IndexResidualQuantizer``, ...,
    the FastScan forms) and IVF indexes (``IndexIVFResidualQuantizer``,
    ..., eight classes); RaBitQ — ``RaBitQuantizer``, ``MultiBitRaBitQ``,
    ``IndexRaBitQ``, ``IndexRaBitQFastScan``, ``IndexIVFRaBitQ`` and
    ``IndexIVFRaBitQFastScan``, 1-bit and multi-bit, ID selectors honoured;
  - the rest of faiss_tpu's codecs and small indexes — every metric of
    ``IndexFlat`` and ``IndexIVFFlat`` (L1, Linf, Lp, Canberra, BrayCurtis,
    JensenShannon, Jaccard, NaNEuclidean, ABS_INNER_PRODUCT, GOWER, with
    ``metric_arg``); ``partition_fuzzy`` and ``histogram_shifted``;
    ``EDENQuantizer``, ``IndexEDEN`` and ``IndexIVFEDEN``; the Zn lattice
    (``ZnSphereSearch``, ``ZnSphereCodec``, ``ZnSphereCodecAlt``,
    ``IndexLattice``); ``IndexFlatPanorama`` and ``IndexIVFFlatPanorama``;
    the neural codecs (``utils.neuralnet.QINCo`` and ``train_qinco``,
    ``IndexNeuralNetCodec``, ``IndexQINCo``); ``IndexIVFFlatDedup``,
    ``IndexRowwiseMinMax``, ``IndexRowwiseMinMaxFP16``,
    ``IndexIVFIndependentQuantizer`` and ``IndexIVFSpectralHash``;
  - ``index_factory`` over the classes above, and index files
    (``write_index``, ``read_index``, ``serialize_index``,
    ``deserialize_index``, ``write_index_binary``, ``read_index_binary``,
    ``IO_FLAG_MMAP``) in faiss_tpu's npz container, each package reading
    the other's;
  - the multi-device layer — ``parallel.sharded`` (``make_mesh`` over a
    list of devices, ``ShardedFlat``, ``ShardedIVF``, ``ShardedIVFPQ``,
    ``ShardedIVFPQBuilder``, ``ShardedRefinedIVFPQ``,
    ``sharded_kmeans_iter``) and the host compositions ``IndexShards``,
    ``IndexReplicas`` and ``IndexShardsIVF``; the IVF list tooling
    ``ivflib`` (``merge_into``, ``shard_ivf_index_centroids``,
    ``clone_index``, ``SlidingIndexWindow``, ...) and ``invlists``
    (array, slice, hstack, vstack and on-disk inverted lists,
    ``replace_invlists``);
  - the tools — the reference library's own file format (``io_ref``:
    ``read_ref_index``, ``write_ref_index``; ``read_index`` sniffs it),
    ``reverse_index_factory``, the auto-tuning of ``autotune``
    (``ParameterSpace``, ``OperatingPoints``, the criteria), the benchmark
    framework ``bench_fw``, the standalone ops of ``extra`` (``knn``,
    ``pairwise_distances``, ``knn_hamming``, ``kmin``/``kmax``,
    ``merge_knn_results``, ``ResultHeap``, the diversity filter, bitstring
    packing), ``MatrixStats``, the datasets of ``utils.datasets``, the
    ``contrib`` modules (exhaustive search, inspection, clustering, the
    list-major ``big_batch_search``, ``ondisk``, ``offline_ivf``, the
    socket ``client_server``, ``torch_utils``) and the C API
    (``c_api``, built with gcc at first use).

The port does all that faiss_tpu does, except ``contrib.torch_utils``'s
``torch_to_jax`` and ``jax_to_torch``, which hand arrays to JAX.
"""

import torch

# The coarse GEMM, the k-means assignments, the PQ encode, exact flat search
# and the plain kernel versions are float32 contracts: no TF32 anywhere.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from .base import (  # noqa: E402,F401
    IDSelector,
    IDSelectorAll,
    IDSelectorAnd,
    IDSelectorArray,
    IDSelectorBatch,
    IDSelectorBitmap,
    IDSelectorNot,
    IDSelectorOr,
    IDSelectorRange,
    IDSelectorXOr,
    Index,
    RangeSearchResult,
    SearchParameters,
    query_buckets,
)
from .clustering import (  # noqa: E402,F401
    Clustering,
    ClusteringParameters,
    Kmeans,
    ProgressiveDimClustering,
    ProgressiveDimClusteringParameters,
    SuperKMeans,
    SuperKMeansParameters,
    kmeans1d,
    kmeans_clustering,
)
from .callbacks import (  # noqa: E402,F401
    InterruptCallback,
    InterruptedException,
    PythonInterruptCallback,
    TimeoutCallback,
)
from .codecs.polysemous import (  # noqa: E402,F401
    PolysemousTraining,
    SimulatedAnnealingParameters,
)
from .codecs.aq import (  # noqa: E402,F401
    AdditiveQuantizer,
    LocalSearchQuantizer,
    ProductAdditiveQuantizer,
    ProductLocalSearchQuantizer,
    ProductResidualQuantizer,
    ResidualQuantizer,
)
from .codecs.pq import ProductQuantizer  # noqa: E402,F401
from .codecs.rabitq import MultiBitRaBitQ, RaBitQuantizer  # noqa: E402,F401
from .codecs.sq import QuantizerType, RangeStat, ScalarQuantizer  # noqa: E402,F401
from .metric import (  # noqa: E402,F401
    METRIC_ABS_INNER_PRODUCT,
    METRIC_BrayCurtis,
    METRIC_Canberra,
    METRIC_GOWER,
    METRIC_INNER_PRODUCT,
    METRIC_Jaccard,
    METRIC_JensenShannon,
    METRIC_L1,
    METRIC_L2,
    METRIC_Linf,
    METRIC_Lp,
    METRIC_NaNEuclidean,
    MetricType,
    is_similarity_metric,
)
from .ops.partitioning import histogram_shifted, partition_fuzzy  # noqa: E402,F401
from .codecs.eden import EDENQuantizer, EDENScaleType  # noqa: E402,F401
from .codecs.lattice import (  # noqa: E402,F401
    ZnSphereCodec,
    ZnSphereCodecAlt,
    ZnSphereSearch,
)
from .models.flat import (  # noqa: E402,F401
    IndexFlat,
    IndexFlat1D,
    IndexFlatIP,
    IndexFlatL2,
    IndexFlatSQ8,
)
from .models.ivf import (  # noqa: E402,F401
    IndexIVF,
    IndexIVFStats,
    SearchParametersIVF,
    indexIVF_stats,
)
from .models.ivf_flat import IndexIVFFlat  # noqa: E402,F401
from .models.binary import (  # noqa: E402,F401
    IndexBinary,
    IndexBinaryFlat,
    IndexBinaryFlat1Bit,
    IndexBinaryFromFloat,
    IndexBinaryHash,
    IndexBinaryHNSW,
    IndexBinaryIVF,
    IndexBinaryMultiHash,
)
from .models.lsh import IndexLSH  # noqa: E402,F401
from .models.extra_indexes import (  # noqa: E402,F401
    Index2Layer,
    IndexIVFFlatDedup,
    IndexIVFIndependentQuantizer,
    IndexIVFSpectralHash,
    IndexRowwiseMinMax,
    IndexRowwiseMinMaxFP16,
)
from .models.eden import IndexEDEN, IndexIVFEDEN  # noqa: E402,F401
from .models.lattice import IndexLattice  # noqa: E402,F401
from .models.neuralnet_codec import IndexNeuralNetCodec, IndexQINCo  # noqa: E402,F401
from .models.panorama import IndexFlatPanorama, IndexIVFFlatPanorama  # noqa: E402,F401
from .models.hnsw import (  # noqa: E402,F401
    HNSW,
    HNSWStats,
    IndexHNSW,
    IndexHNSW2Level,
    IndexHNSWFlat,
    IndexHNSWFlatPanorama,
    IndexHNSWPQ,
    IndexHNSWSQ,
    SearchParametersHNSW,
    hnsw_stats,
)
from .models.imi import MultiIndexQuantizer, MultiIndexQuantizer2  # noqa: E402,F401
from .models.nsg import (  # noqa: E402,F401
    IndexNNDescentFlat,
    IndexNSGFlat,
    IndexNSGPQ,
    IndexNSGSQ,
    NSGStats,
    nsg_stats,
)
from .models.pq import IndexPQ, IndexPQFastScan  # noqa: E402,F401
from .models.aq import (  # noqa: E402,F401
    IndexAdditiveQuantizer,
    IndexAdditiveQuantizerFastScan,
    IndexIVFAdditiveQuantizer,
    IndexIVFAdditiveQuantizerFastScan,
    IndexIVFLocalSearchQuantizer,
    IndexIVFLocalSearchQuantizerFastScan,
    IndexIVFProductLocalSearchQuantizer,
    IndexIVFProductLocalSearchQuantizerFastScan,
    IndexIVFProductResidualQuantizer,
    IndexIVFProductResidualQuantizerFastScan,
    IndexIVFResidualQuantizer,
    IndexIVFResidualQuantizerFastScan,
    IndexLocalSearchQuantizer,
    IndexLocalSearchQuantizerFastScan,
    IndexProductLocalSearchQuantizer,
    IndexProductLocalSearchQuantizerFastScan,
    IndexProductResidualQuantizer,
    IndexProductResidualQuantizerFastScan,
    IndexResidualQuantizer,
    IndexResidualQuantizerFastScan,
)
from .models.rabitq import (  # noqa: E402,F401
    IndexIVFRaBitQ,
    IndexIVFRaBitQFastScan,
    IndexRaBitQ,
    IndexRaBitQFastScan,
)
from .models.sq import IndexIVFScalarQuantizer, IndexScalarQuantizer  # noqa: E402,F401
from .models.ivf_pq import (  # noqa: E402,F401
    IVFFastScanStats,
    IndexIVFPQ,
    IndexIVFPQFastScan,
    IndexIVFPQR,
    ivf_fast_scan_stats,
)
from .models.meta import (  # noqa: E402,F401
    IndexIDMap,
    IndexIDMap2,
    IndexPreTransform,
    IndexRandom,
    IndexRefine,
    IndexRefineFlat,
    IndexReplicas,
    IndexShards,
    IndexShardsIVF,
    IndexSplitVectors,
)
from .transforms import (  # noqa: E402,F401
    CenteringTransform,
    HadamardRotation,
    ITQMatrix,
    ITQTransform,
    LinearTransform,
    NormalizationTransform,
    OPQMatrix,
    PCAMatrix,
    RandomRotationMatrix,
    RemapDimensionsTransform,
    VectorTransform,
)
from .factory import index_factory  # noqa: E402,F401
from .io import (  # noqa: E402,F401
    IO_FLAG_MMAP,
    IO_FLAG_READ_ONLY,
    deserialize_index,
    read_index,
    read_index_binary,
    serialize_index,
    write_index,
    write_index_binary,
)
from .utils.evaluation import recall_at_k  # noqa: E402,F401
from .ivflib import (  # noqa: E402,F401
    SlidingIndexWindow,
    add_preassigned,
    clone_index,
    extract_index_ivf,
    get_invlist_range,
    merge_into,
    replace_ivf_quantizer,
    search_preassigned,
    shard_ivf_index_centroids,
    try_extract_index_ivf,
)
from .invlists import (  # noqa: E402,F401
    ArrayInvertedLists,
    HStackInvertedLists,
    InvertedLists,
    InvertedListsIOHook,
    OnDiskInvertedLists,
    SliceInvertedLists,
    VStackInvertedLists,
    replace_invlists,
)
from .parallel.sharded import (  # noqa: E402,F401
    Mesh,
    ShardedFlat,
    ShardedIVF,
    ShardedIVFPQ,
    ShardedIVFPQBuilder,
    ShardedRefinedIVFPQ,
    make_mesh,
    sharded_kmeans_iter,
)
from .io_ref import read_ref_index, write_ref_index  # noqa: E402,F401
from .extra import (  # noqa: E402,F401
    ResultHeap,
    bucket_sort,
    diversity_search,
    diversity_select,
    kmax,
    kmin,
    knn,
    knn_gpu,
    knn_hamming,
    merge_knn_results,
    pack_bitstrings,
    pairwise_distances,
    rand,
    randint,
    randn,
    unpack_bitstrings,
)
from .autotune import (  # noqa: E402,F401
    AutoTuneCriterion,
    IntersectionCriterion,
    OneRecallAtRCriterion,
    OperatingPoint,
    OperatingPoints,
    ParameterRange,
    ParameterSpace,
)
from .factory_tools import reverse_index_factory  # noqa: E402,F401
from .stats import MatrixStats  # noqa: E402,F401
from .bench_fw import (  # noqa: E402,F401
    Benchmark,
    DatasetDescriptor,
    IndexDescriptor,
    run_benchmark,
)

# the ScalarQuantizer type aliases at module level, as faiss_tpu sets them
# (faiss-style: ScalarQuantizer_QT_8bit, ...)
for _qt in QuantizerType:
    globals()[f"ScalarQuantizer_{_qt.name}"] = _qt
del _qt
