"""Every call that blocks the host on the card inside a cell's submits and
collects, and whether the program marks it as a ``tracing.wait``: a short
run of the cell (warm-up and a window of ``--seconds``) with
``torch.cuda.set_sync_debug_mode("warn")`` and a CPU profiler on around
each submit and collect, so the program records its spans. Not run by the
benchmark's own runs.

    python3 portbench/tools/syncsites.py --workload <cell> --seed <n> \\
        --seconds 2 [--log syncsites_<cell>.log]

Prints one JSON line: the blocking calls per batch after the first (which
builds the search layout), how many lay in no wait span, and the count of
each site; the log holds the stack of every call outside a wait."""

import argparse
import json
import sys
import traceback
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[0] = str(ROOT)

from portbench import run, spec  # noqa: E402

SYNC_WARNING = "called a synchronizing CUDA operation"


class Watch:
    """The cell's index with its submits and collects watched."""

    def __init__(self, index):
        import torch
        from faiss_tpu_torch import tracing
        self.torch, self.tracing, self.index = torch, tracing, index
        self.n = {"submit": 0, "collect": 0}
        self.found = []

    def _watched(self, kind, fn, *args):
        """fn(*args) watched; batch j's submit and collect are the j-th of
        their kind (the loop collects in order)."""
        torch = self.torch
        batch = self.n[kind]
        self.n[kind] += 1
        seen = []

        def show(message, category, filename, lineno, file=None, line=None):
            if SYNC_WARNING not in str(message):
                return
            stack = getattr(self.tracing._local, "stack", None) or []
            waits = [s.name for s in stack if s.nbytes is not None]
            frames = [f"{Path(f.filename).name}:{f.lineno} {f.name}"
                      for f in traceback.extract_stack()[:-1]
                      if "faiss_tpu_torch" in f.filename]
            seen.append({"batch": batch, "kind": kind,
                         "site": waits[-1] if waits else None,
                         "span": stack[-1].name if stack else None,
                         "frames": frames[-4:]})

        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = show
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CPU]):
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    out = fn(*args)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
        self.found.extend(seen)
        return out

    def search_submit(self, x, k):
        return self._watched("submit", self.index.search_submit, x, k)

    def search_collect(self, h):
        return self._watched("collect", self.index.search_collect, h)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--log")
    args = ap.parse_args()
    cell = spec.load_cell(args.workload)
    watch = []

    def fault(index):
        watch.append(Watch(index))
        return watch[0]

    r = run.run_cell(cell, args.seed, args.seconds, False, "cuda", fault=fault)
    w = watch[0]
    batches = w.n["collect"]
    steady = [f for f in w.found if f["batch"] > 0]  # batch 0 builds the layout
    outside = [f for f in w.found if f["site"] is None]
    sites = {}
    for f in steady:
        sites[f["site"] or "(no wait)"] = sites.get(f["site"] or "(no wait)", 0) + 1
    if args.log:
        with open(args.log, "w") as f:
            for x in outside:
                f.write(json.dumps(x) + "\n")
    print(json.dumps({
        "workload": cell.name, "seed": args.seed, "correct": r["correct"],
        "batches": batches,
        "blocking_calls_per_batch_after_the_first": len(steady) / max(1, batches - 1),
        "outside_a_wait": len(outside),
        "outside_a_wait_after_the_first_batch": sum(f["batch"] > 0 for f in outside),
        "sites_after_the_first_batch": {k: v / max(1, batches - 1) for k, v in sites.items()},
    }), flush=True)


if __name__ == "__main__":
    main()
