"""The host cost of one ``faiss_tpu_torch.tracing`` span and wait, with no
profiler running and under the harness's profiler (CPU and CUDA activity):
the best of several timed loops of ``with span(...): pass``, less the same
loop that only calls a function. Not run by the benchmark's own runs.

    python3 portbench/tools/spancost.py

Prints one JSON line, in ns per span."""

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[0] = str(ROOT)

from portbench.trace import Profiler  # noqa: E402


def in_with(n, fn):
    t = time.perf_counter_ns()
    for _ in range(n):
        with fn():
            pass
    return (time.perf_counter_ns() - t) / n


def called(n, fn):
    t = time.perf_counter_ns()
    for _ in range(n):
        fn()
    return (time.perf_counter_ns() - t) / n


def best(n, fn, repeat, loop=in_with):
    return min(loop(n, fn) for _ in range(repeat))


def main():
    import torch
    from faiss_tpu_torch import tracing
    kinds = {"span": lambda: tracing.span("spancost.span"),
             "wait": lambda: tracing.wait("spancost.wait", 8)}
    base = best(200_000, lambda: None, 5, loop=called)  # the loop and one call
    off = {k: best(200_000, f, 9) - base for k, f in kinds.items()}
    if torch.cuda.is_available():
        torch.zeros(1, device="cuda")
    prof = Profiler()
    prof.start_stop()  # the first start sets up CUPTI
    prof.start()
    on = {k: best(5_000, f, 5) - base for k, f in kinds.items()}
    prof.prof.stop()
    print(json.dumps({"off_ns": off, "on_ns": on, "loop_ns": base,
                      "spans_recorded": len(tracing.spans()),
                      "dropped": tracing.dropped()}), flush=True)


if __name__ == "__main__":
    main()
