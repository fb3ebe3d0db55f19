"""Config-driven offline IVF pipeline (reference: demos/offline_ivf/
offline_ivf.py + run.py; counterpart of faiss_tpu/contrib/offline_ivf.py).

The reference runs a production batch pipeline over file-sharded billion-
scale datasets from a YAML config: train a shared index once, encode each
dataset shard into its own IVF index file, merge the shards into one
on-disk index, then run (checkpointable) big-batch search and write result
files. faiss_tpu's form, kept here: JSON configs, .npy/memmap shard files,
`merge_ondisk` for the merged index and `big_batch_search` for the query
stage. Every index is built, read and searched on the pipeline's
``device`` (the argument, else the config's "device", else the card); the
index files are the npz container, which faiss_tpu reads too. ``evaluate``
takes its exact neighbours from extra.knn on that device.

Config schema (see tests/test_torch_contrib.py for a worked example)::

    {
      "d": 32,                      # vector dim
      "output": "/path/workdir",    # artifact directory
      "index": "IVF64,PQ8",         # index_factory string
      "nprobe": 8,
      "device": "cuda",            # optional
      "k": 10,
      "training_sample": 10000,
      "datasets": {
        "db":      {"files": ["a.npy", "b.npy"], "root": "/path"},
        "queries": {"files": ["q.npy"], "root": "/path"}
      }
    }

Step methods mirror the reference CLI commands (run.py --command):
``train_index``, ``index_shard``, ``merge_index``, ``search``,
``evaluate``, ``consistency_check``, ``index_stats``.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np

from ..base import require_device
from ..extra import knn
from ..factory import index_factory
from ..io import read_index, write_index
from .big_batch_search import big_batch_search
from .ondisk import merge_ondisk


class DatasetSpec:
    """File-sharded dataset view (reference: demos/offline_ivf/dataset.py).

    Iterates .npy shard files without loading everything in memory
    (np.load(mmap_mode="r"))."""

    def __init__(self, spec: Dict, d: int):
        self.root = spec.get("root", "")
        self.files = list(spec["files"])
        self.d = d

    def paths(self) -> List[str]:
        return [os.path.join(self.root, f) for f in self.files]

    def size(self) -> int:
        return sum(self._open(p).shape[0] for p in self.paths())

    def _open(self, path):
        return np.load(path, mmap_mode="r")

    def iterate(self, batch: int = 100_000):
        for p in self.paths():
            arr = self._open(p)
            for i0 in range(0, len(arr), batch):
                yield np.ascontiguousarray(
                    arr[i0 : i0 + batch], dtype=np.float32
                )

    def sample(self, n: int, seed: int = 123) -> np.ndarray:
        """Training sample spread uniformly across shards."""
        paths = self.paths()
        per = max(1, n // len(paths))
        rs = np.random.RandomState(seed)
        out = []
        for p in paths:
            arr = self._open(p)
            take = min(per, len(arr))
            idx = np.sort(rs.choice(len(arr), take, replace=False))
            out.append(np.ascontiguousarray(arr[idx], dtype=np.float32))
        return np.concatenate(out)[:n]


class OfflineIVF:
    """The pipeline driver (reference: OfflineIVF, offline_ivf.py:37)."""

    def __init__(self, cfg: Dict, db: str = "db", queries: str = "queries", *,
                 device=None):
        self.cfg = cfg
        self.device = require_device(device or cfg.get("device", "cuda"))
        self.d = int(cfg["d"])
        self.out = cfg["output"]
        os.makedirs(self.out, exist_ok=True)
        self.factory = cfg["index"]
        self.nprobe = int(cfg.get("nprobe", 8))
        self.k = int(cfg.get("k", 10))
        self.db = DatasetSpec(cfg["datasets"][db], self.d)
        self.queries = (
            DatasetSpec(cfg["datasets"][queries], self.d)
            if queries in cfg["datasets"]
            else None
        )

    # -- paths ---------------------------------------------------------------
    def empty_index_path(self) -> str:
        return os.path.join(self.out, "empty.index.npz")

    def shard_index_path(self, i: int) -> str:
        return os.path.join(self.out, f"shard_{i:04d}.index.npz")

    def merged_index_path(self) -> str:
        return os.path.join(self.out, "merged.index.npz")

    # -- steps ---------------------------------------------------------------
    def train_index(self) -> str:
        """Train the shared empty index once (offline_ivf.py:195)."""
        nt = int(self.cfg.get("training_sample", 100_000))
        xt = self.db.sample(nt)
        index = index_factory(self.d, self.factory, device=self.device)
        index.train(xt)
        write_index(index, self.empty_index_path())
        return self.empty_index_path()

    def index_shard(self, shard: Optional[int] = None) -> List[str]:
        """Encode each db file into its own index file, ids offset by the
        shard's global start (offline_ivf.py:231 with add_with_ids)."""
        paths = self.db.paths()
        written = []
        offset = 0
        for i, p in enumerate(paths):
            arr = np.load(p, mmap_mode="r")
            n = len(arr)
            if shard is None or shard == i:
                index = read_index(self.empty_index_path(), device=self.device)
                ids = np.arange(offset, offset + n, dtype=np.int64)
                index.add_with_ids(
                    np.ascontiguousarray(arr, dtype=np.float32), ids
                )
                write_index(index, self.shard_index_path(i))
                written.append(self.shard_index_path(i))
            offset += n
        return written

    def merge_index(self) -> str:
        """Merge shard indexes into one index with on-disk payload
        (offline_ivf.py:302, via contrib/ondisk merge_ondisk)."""
        index = read_index(self.empty_index_path(), device=self.device)
        shard_paths = [
            self.shard_index_path(i) for i in range(len(self.db.paths()))
        ]
        for p in shard_paths:
            if not os.path.exists(p):
                raise FileNotFoundError(f"missing shard index {p}")
        merge_ondisk(
            index, shard_paths, os.path.join(self.out, "merged.ivfdata")
        )
        write_index(index, self.merged_index_path())
        return self.merged_index_path()

    def search(self, use_big_batch: bool = True):
        """Query stage: big-batch search over the merged index with a
        resumable checkpoint (offline_ivf.py:633); writes I/D .npy files."""
        assert self.queries is not None, "config has no queries dataset"
        index = read_index(self.merged_index_path(), device=self.device)
        index.nprobe = self.nprobe
        xq = np.concatenate(list(self.queries.iterate()))
        if use_big_batch:
            D, I = big_batch_search(
                index, xq, self.k,
                checkpoint_path=os.path.join(self.out, "search.ckpt.npz"),
            )
        else:
            D, I = index.search(xq, self.k)
        np.save(os.path.join(self.out, "I.npy"), I)
        np.save(os.path.join(self.out, "D.npy"), D)
        return D, I

    def evaluate(self, sample: int = 1000) -> float:
        """Recall of the merged index against the exact k-NN on a query
        sample (offline_ivf.py:397)."""
        assert self.queries is not None
        xq = np.concatenate(list(self.queries.iterate()))[:sample]
        I = np.load(os.path.join(self.out, "I.npy"))[: len(xq)]
        xb = np.concatenate(list(self.db.iterate()))
        gt = knn(xq, xb, self.k, device=self.device)[1]
        inter = np.mean(
            [
                len(np.intersect1d(I[i, : self.k], gt[i]))
                for i in range(len(xq))
            ]
        )
        return float(inter) / self.k

    def consistency_check(self, nprobe_sample: int = 64) -> None:
        """Sanity checks mirroring offline_ivf.py:817: shard sizes add up,
        merged ntotal matches the dataset, a probe query returns its own
        id at distance ~0."""
        total = self.db.size()
        index = read_index(self.merged_index_path(), device=self.device)
        assert index.ntotal == total, (index.ntotal, total)
        probe = next(self.db.iterate(batch=nprobe_sample))[:nprobe_sample]
        index.nprobe = max(self.nprobe, 16)
        D, I = index.search(probe, 1)
        found = (I[:, 0] == np.arange(len(probe))).mean()
        assert found > 0.5, f"self-lookup found only {found:.0%}"

    def index_stats(self) -> Dict:
        """Invlist statistics of the merged index (offline_ivf.py:806)."""
        index = read_index(self.merged_index_path(), device=self.device)
        sizes = np.bincount(index._listnos_host, minlength=index.nlist)
        return {
            "ntotal": int(index.ntotal),
            "nlist": int(index.nlist),
            "min": int(sizes.min()),
            "max": int(sizes.max()),
            "mean": float(sizes.mean()),
            "empty": int((sizes == 0).sum()),
        }


def main(argv=None):
    """CLI mirroring demos/offline_ivf/run.py --command dispatch:

        python -m faiss_tpu_torch.contrib.offline_ivf CONFIG.json COMMAND [shard]
    """
    import sys

    argv = argv if argv is not None else sys.argv[1:]
    with open(argv[0]) as f:
        cfg = json.load(f)
    oivf = OfflineIVF(cfg)
    cmd = argv[1]
    if cmd == "train_index":
        print(oivf.train_index())
    elif cmd == "index_shard":
        shard = int(argv[2]) if len(argv) > 2 else None
        print("\n".join(oivf.index_shard(shard)))
    elif cmd == "merge_index":
        print(oivf.merge_index())
    elif cmd == "search":
        D, I = oivf.search()
        print(f"wrote {I.shape} results to {oivf.out}")
    elif cmd == "evaluate":
        print(f"recall@{oivf.k} = {oivf.evaluate():.4f}")
    elif cmd == "consistency_check":
        oivf.consistency_check()
        print("ok")
    elif cmd == "index_stats":
        print(json.dumps(oivf.index_stats(), indent=2))
    else:
        raise SystemExit(f"unknown command {cmd!r}")


if __name__ == "__main__":
    main()
