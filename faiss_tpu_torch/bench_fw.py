"""Declarative benchmark framework (reference: benchs/bench_fw/).

The reference's bench_fw drives reproducible index benchmarks from
descriptors: a DatasetDescriptor names the data, an IndexDescriptor names a
factory string plus construction/search parameter grids, and Benchmark
trains/builds/sweeps them, recording Pareto-optimal (accuracy, time)
operating points (benchs/bench_fw/benchmark.py, descriptors.py,
optimize.py). This module is the port's counterpart of faiss_tpu/bench_fw.py,
built on the autotune machinery (OperatingPoints); results serialize to
plain JSON. Indexes are built, read and searched on the benchmark's
``device`` (the card unless the caller passes another); search times are
host-clock times of searches that return host arrays.

Typical use:

    ds = DatasetDescriptor(d=64, nb=10000, nq=100, nt=5000)
    idx = IndexDescriptor("IVF64,PQ8x4fs", search_params={"nprobe": [1, 4, 16]})
    bench = Benchmark(ds, [idx], k=10, device="cuda")
    results = bench.run()
    print(json.dumps(results, indent=2))

An index family the file writer cannot write (it raises TypeError) is not
cached and the benchmark goes on; faiss_tpu catches only
NotImplementedError there, so the same benchmark stops at such a family.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


from .autotune import OperatingPoints, ParameterSpace, _combinations
from .base import require_device
from .factory import index_factory
from .io import read_index, write_index
from .metric import MetricType
from .utils.datasets import Dataset, SyntheticDataset
from .utils.evaluation import knn_intersection_measure


@dataclass
class DatasetDescriptor:
    """Names a dataset (reference: bench_fw/descriptors.py:56).

    Either give (d, nb, nq, nt[, seed]) for synthetic data, or a
    ``dataset`` instance implementing utils.datasets.Dataset.
    """

    d: int = 0
    nb: int = 0
    nq: int = 0
    nt: int = 0
    seed: int = 1338
    metric: str = "L2"
    dataset: Optional[Dataset] = None
    name: str = ""

    def load(self, device="cuda") -> Dataset:
        if self.dataset is not None:
            return self.dataset
        return SyntheticDataset(
            self.d, self.nt, self.nb, self.nq, metric=self.metric,
            seed=self.seed, device=device,
        )

    def label(self) -> str:
        if self.name:
            return self.name
        return f"syn_{self.d}d_{self.nb}n_{self.seed}"


@dataclass
class IndexDescriptor:
    """Names an index build (reference: bench_fw/descriptors.py:24).

    ``factory`` is an index_factory string (or ``path`` a serialized index);
    ``construction_params`` are ParameterSpace parameters set before
    train/add (e.g. {"k_factor_rf": 8}); ``search_params`` maps a
    ParameterSpace parameter name -> list of values swept at search time
    (cartesian product, the first name varying slowest).
    """

    factory: Optional[str] = None
    path: Optional[str] = None
    construction_params: Dict[str, Any] = field(default_factory=dict)
    search_params: Dict[str, List[Any]] = field(default_factory=dict)
    training_size: Optional[int] = None

    def label(self) -> str:
        return self.factory or self.path or "?"


class Benchmark:
    """Train/build/sweep a set of index descriptors over one dataset and
    record Pareto-optimal operating points (reference:
    bench_fw/benchmark.py Benchmark.benchmark)."""

    def __init__(self, dataset: DatasetDescriptor,
                 indexes: List[IndexDescriptor], k: int = 10,
                 nrun: int = 1, verbose: bool = False,
                 io: Optional["BenchmarkIO"] = None, *, device="cuda"):
        self.device = require_device(device)
        self.dataset = dataset
        self.indexes = indexes
        self.k = int(k)
        self.nrun = int(nrun)
        self.verbose = verbose
        self.io = io

    def _log(self, msg):
        if self.verbose:
            import sys

            print(f"[bench_fw] {msg}", file=sys.stderr, flush=True)

    def run(self) -> Dict[str, Any]:
        ds = self.dataset.load(self.device)
        ps = ParameterSpace()
        xt, xb, xq = ds.get_train(), ds.get_database(), ds.get_queries()
        gt = ds.get_groundtruth(self.k)
        out: Dict[str, Any] = {
            "dataset": self.dataset.label(),
            "k": self.k,
            "indexes": [],
        }
        for desc in self.indexes:
            self._log(f"building {desc.label()}")
            d = xb.shape[1]
            cached = (
                self.io.load_index(self.dataset.label(), desc, self.device)
                if self.io is not None and not desc.path
                else None
            )
            if cached is not None:
                index = cached
                t_train = t_add = 0.0
            elif desc.path:
                index = read_index(desc.path, device=self.device)
                t_train = t_add = 0.0
            else:
                metric = (
                    MetricType.INNER_PRODUCT
                    if self.dataset.metric in ("IP", "INNER_PRODUCT")
                    else MetricType.L2
                )
                index = index_factory(d, desc.factory, metric, device=self.device)
                for name, val in desc.construction_params.items():
                    ps.set_index_parameter(index, name, val)
                t0 = time.time()
                ts = desc.training_size
                index.train(xt[:ts] if ts else xt)
                t_train = time.time() - t0
                t0 = time.time()
                index.add(xb)
                t_add = time.time() - t0
                if self.io is not None:
                    try:
                        self.io.save_index(index, self.dataset.label(), desc)
                    except (NotImplementedError, TypeError):
                        pass  # index family without io support yet
            ops = OperatingPoints()
            rows = []
            for combo in _combinations(desc.search_params.items()):
                for name, val in combo.items():
                    ps.set_index_parameter(index, name, val)
                # warmup (compile) run, then timed runs
                index.search(xq, self.k)
                t0 = time.time()
                for _ in range(self.nrun):
                    _, I = index.search(xq, self.k)
                t_search = (time.time() - t0) / self.nrun
                recall = knn_intersection_measure(I[:, : self.k], gt)
                key = json.dumps(combo, sort_keys=True)
                optimal = ops.add(recall, t_search, key)
                rows.append(
                    {
                        "params": combo,
                        "recall": round(float(recall), 4),
                        "time_s": round(t_search, 6),
                        "qps": round(len(xq) / max(t_search, 1e-9), 1),
                        "optimal": bool(optimal),
                    }
                )
                self._log(
                    f"  {key}: recall={recall:.4f} {t_search*1000:.1f} ms"
                )
            out["indexes"].append(
                {
                    "factory": desc.label(),
                    "train_s": round(t_train, 3),
                    "add_s": round(t_add, 3),
                    "points": rows,
                    "pareto": [
                        {"recall": round(p.perf, 4), "time_s": round(p.t, 6),
                         "params": json.loads(p.key)}
                        for p in ops.optimal_pts
                    ],
                }
            )
        return out


class BenchmarkIO:
    """File-backed artifact cache (reference: bench_fw/benchmark_io.py).

    Built indexes and sweep results are cached in ``basedir`` keyed by a
    hash of (dataset label, factory, construction params): re-running a
    benchmark config skips training/building anything already on disk,
    and result JSONs accumulate per config for later aggregation."""

    def __init__(self, basedir: str):
        import os

        self.basedir = basedir
        os.makedirs(basedir, exist_ok=True)

    def _key(self, ds_label: str, desc: "IndexDescriptor") -> str:
        import hashlib

        blob = json.dumps(
            [ds_label, desc.factory or desc.path,
             desc.construction_params, desc.training_size],
            sort_keys=True,
        )
        return hashlib.sha1(blob.encode()).hexdigest()[:16]

    def index_path(self, ds_label, desc):
        import os

        return os.path.join(self.basedir, f"idx_{self._key(ds_label, desc)}.npz")

    def load_index(self, ds_label, desc, device="cuda"):
        import os

        p = self.index_path(ds_label, desc)
        return read_index(p, device=device) if os.path.exists(p) else None

    def save_index(self, index, ds_label, desc):
        write_index(index, self.index_path(ds_label, desc))

    def write_result(self, result: Dict[str, Any], name: str):
        import os

        with open(os.path.join(self.basedir, f"{name}.json"), "w") as f:
            json.dump(result, f, indent=2)

    def read_result(self, name: str):
        import os

        p = os.path.join(self.basedir, f"{name}.json")
        if not os.path.exists(p):
            return None
        with open(p) as f:
            return json.load(f)


@dataclass
class Optimizer:
    """Two-stage factory exploration (reference: bench_fw/optimize.py).

    Stage 1 sweeps every candidate factory's search grid on the dataset;
    stage 2 keeps the candidates that hit ``min_accuracy`` and are
    Pareto-optimal in (accuracy, time) across ALL candidates — the
    reference's benchmark_and_filter_candidates flow."""

    k: int = 10
    nrun: int = 1
    min_accuracy: float = 0.0
    io: Optional[BenchmarkIO] = None
    verbose: bool = False
    device: Any = "cuda"

    def optimize(
        self, dataset: DatasetDescriptor, candidates: List[IndexDescriptor]
    ) -> Dict[str, Any]:
        bench = Benchmark(
            dataset, candidates, k=self.k, nrun=self.nrun,
            verbose=self.verbose, io=self.io, device=self.device,
        )
        results = bench.run()
        # global Pareto filter over every (factory, params) point
        ops = OperatingPoints()
        pts = []
        for entry in results["indexes"]:
            for row in entry["points"]:
                if row["recall"] < self.min_accuracy:
                    continue
                key = json.dumps(
                    {"factory": entry["factory"], "params": row["params"]},
                    sort_keys=True,
                )
                ops.add(row["recall"], row["time_s"], key)
                pts.append((entry["factory"], row))
        winners = [json.loads(p.key) for p in ops.optimal_pts]
        keep = {w["factory"] for w in winners}
        return {
            "dataset": results["dataset"],
            "all": results,
            "pareto": winners,
            "filtered_candidates": [
                d for d in candidates if (d.factory or d.path) in keep
            ],
        }


def run_benchmark(config: Dict[str, Any], *, device="cuda") -> Dict[str, Any]:
    """Config-file entry point (the bench_fw CLI analogue): a dict with
    "dataset" (DatasetDescriptor fields) and "indexes" (list of
    IndexDescriptor fields), e.g. parsed from JSON. Optional "basedir"
    engages the BenchmarkIO artifact cache; "min_accuracy" switches to the
    Optimizer flow and adds a global Pareto filter; "device" (or the
    argument) says where the indexes live."""
    device = config.get("device", device)
    ds = DatasetDescriptor(**config["dataset"])
    idxs = [IndexDescriptor(**ic) for ic in config["indexes"]]
    io = BenchmarkIO(config["basedir"]) if config.get("basedir") else None
    if "min_accuracy" in config:
        opt = Optimizer(
            k=config.get("k", 10), nrun=config.get("nrun", 1),
            min_accuracy=config["min_accuracy"], io=io,
            verbose=config.get("verbose", False), device=device,
        )
        return opt.optimize(ds, idxs)
    bench = Benchmark(
        ds, idxs, k=config.get("k", 10), nrun=config.get("nrun", 1),
        verbose=config.get("verbose", False), io=io, device=device,
    )
    return bench.run()


def main(argv=None):
    """CLI: python -m faiss_tpu_torch.bench_fw CONFIG.json [OUT.json]"""
    import sys

    argv = argv if argv is not None else sys.argv[1:]
    with open(argv[0]) as f:
        config = json.load(f)
    result = run_benchmark(config)
    blob = json.dumps(result, indent=2)
    if len(argv) > 1:
        with open(argv[1], "w") as f:
            f.write(blob)
    else:
        print(blob)


if __name__ == "__main__":
    main()
