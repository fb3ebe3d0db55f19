"""Everything a run needs, found by the names in BENCHMARK.json: a cell's
configuration (``configs/<config>.json``), its traffic mix
(``traffic/<traffic>.json``), its limits (``limits/<cell>.json``), the
generator its configuration names (``generators/<name>.py``) and each
metric's reader (``metrics/<metric>.py``). Adding a configuration, a mix or
a metric is adding files and entries; no file here names one."""

import hashlib
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path):
    with open(path) as f:
        return json.load(f)


def _module(kind, name):
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} module {path}")
    spec = importlib.util.spec_from_file_location(f"portbench.{kind}.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def generator(name):
    """The module ``generators/<name>.py``: ``make(params, d, gen)``."""
    return _module("generators", name)


def reader(metric):
    """The function ``read(run)`` of ``metrics/<metric>.py``."""
    return _module("metrics", metric).read


def stream_seed(seed, *parts):
    """A 63-bit seed for one named stream of a run's inputs."""
    key = ":".join(str(p) for p in (seed,) + parts).encode()
    return int.from_bytes(hashlib.sha256(key).digest()[:8], "little") >> 1


class Cell:
    """One entry of ``workloads`` with its configuration, mix, limits and
    the metrics it reports."""

    def __init__(self, bench, name, root=ROOT):
        by_name = {w["name"]: w for w in bench["workloads"]}
        if name not in by_name:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        w = by_name[name]
        self.name = name
        self.chips = int(w["chips"])
        cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
        self.config = load_json(root / cfg_entry["file"])
        self.traffic = load_json(HERE / "traffic" / f"{w['traffic']}.json")
        self.limits = load_json(HERE / "limits" / f"{name}.json")
        self.end_to_end = [m for m in bench["end_to_end"] if self._has(m)]
        e2e = {m["name"] for m in self.end_to_end}
        self.per_layer = [
            m for m in bench["per_layer"]
            if (name in m["workloads"] if "workloads" in m else m["moves"] in e2e)
        ]

    def _has(self, metric):
        return "workloads" not in metric or self.name in metric["workloads"]

    def serving(self):
        """The serving point: the configuration's, with the mix's changes."""
        return {**self.config["serving"], **self.traffic.get("serving", {})}


def load_cell(name, root=ROOT):
    return Cell(load_json(root / "BENCHMARK.json"), name, root)
