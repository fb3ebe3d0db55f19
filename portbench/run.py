"""Runs one cell of the benchmark of faiss_tpu_torch on this machine's card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell's configuration, traffic mix, limits and metric readers are found
by name (``portbench/spec.py``). A run makes its data on the card from the
seed, builds the index through faiss_tpu_torch's own entry points (its
factory, then ``train`` and ``add``), warms up the mix's own batch shape,
offers the mix for ``--seconds`` seconds, then checks every answer of the
window against the plain reference (``portbench/correct.py``). The last
line of standard output is one JSON object: with ``--trace 0`` the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics, read from a
device trace of a part of the window. The numbers compared for ``correct``
are the last lines of standard error and the ``checks`` key of that line.
The line before it names the card, its power limit and SM clock, and where
K1 came from (built by nvcc in this run, or found in the build cache)."""

import time

T0 = time.perf_counter()
T0_WALL = time.time()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / ".portbench_cache"
# every kernel cache the program or torch may write stays in the checkout, at
# a fixed path
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["PYTORCH_KERNEL_CACHE_PATH"] = str(CACHE / "torch_kernels")
if __name__ == "__main__":
    sys.path[0] = str(ROOT)  # import portbench.*, and no module of this folder by its bare name

import numpy as np  # noqa: E402

from portbench import correct, loop, scanwork, spec  # noqa: E402
from portbench.scanwork import nodes  # noqa: E402
from portbench.trace import Profiler, Trace, program_kernel_names  # noqa: E402

FORBIDDEN = {"jax", "jaxlib", "flax", "faiss_tpu"}
WARMUP_BATCHES = 8  # of the mix's own batch shape
RECALL_ROWS = 32  # rows a batch, drawn from the seed, for the recall checks
# the traced part of a --trace 1 window: from 30% of it, for 3 s, ending by 90%
TRACE_FROM, TRACE_TO, TRACE_MAX_S = 0.3, 0.9, 3.0


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def card_info():
    """The card's name, power limit and SM clocks from nvidia-smi."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=30,
        ).stdout.strip().splitlines()
    except (OSError, subprocess.TimeoutExpired):
        return "nvidia-smi unavailable"
    return "; ".join(out) if out else "nvidia-smi gave nothing"


class Queries:
    """A mix's batches of queries, drawn on the device from the seed: batch
    j of stream ``tag`` comes from its own generator, so any batch can be
    drawn again. On the card each batch is drawn on a side stream one
    batch ahead and copied into pinned host memory, so the host seldom
    waits for it."""

    def __init__(self, sampler, n, seed, tag, device, ring):
        import torch
        self.torch, self.sampler, self.n = torch, sampler, n
        self.seed, self.tag, self.device = seed, tag, device
        cuda = device.type == "cuda"
        self.side = torch.cuda.Stream(device) if cuda else None
        self.bufs = [torch.empty(n, sampler.d, pin_memory=cuda) for _ in range(ring)]
        self.ready = {}

    def gen(self, j):
        g = self.torch.Generator(device=self.device)
        g.manual_seed(spec.stream_seed(self.seed, self.tag, j))
        return g

    def on_device(self, j):
        """Batch j on the device, drawn again."""
        return self.sampler.draw(self.n, self.gen(j))

    def _launch(self, j):
        buf = self.bufs[j % len(self.bufs)]
        with self.torch.cuda.stream(self.side):
            buf.copy_(self.on_device(j), non_blocking=True)
            ev = self.torch.cuda.Event()
            ev.record(self.side)
        self.ready[j] = ev

    def __call__(self, j):
        """Batch j as the host array that the index is given."""
        buf = self.bufs[j % len(self.bufs)]
        if self.side is None:
            buf.copy_(self.on_device(j))
            return buf.numpy()
        if j not in self.ready:
            self._launch(j)
        self.ready.pop(j).synchronize()
        self._launch(j + 1)
        return buf.numpy()


def draw_rows(sampler, n, gen, out=None, chunk=1 << 20):
    """n rows in chunks of the same draws whether kept on the host
    (``out``, a host tensor) or returned on the device."""
    import torch
    dev_rows = None if out is not None else torch.empty(n, sampler.d, device=gen.device)
    for s in range(0, n, chunk):
        x = sampler.draw(min(chunk, n - s), gen)
        (out if out is not None else dev_rows)[s:s + len(x)].copy_(x)
    return dev_rows


def recall_sample(seed, j, n):
    """The rows of batch j (of n) that the recall checks read, drawn from
    the seed anew for every batch."""
    rng = np.random.default_rng(spec.stream_seed(seed, "sample", j))
    return np.sort(rng.choice(n, min(RECALL_ROWS, n), replace=False))


def has_own(obj, key):
    return key in vars(obj) or hasattr(type(obj), key)


def build(ft, cfg, device):
    """The configuration's index, made by the factory and trained later."""
    ix = cfg["index"]
    index = ft.index_factory(cfg["d"], ix["factory"], device=device)
    if "refine_flat_store" in ix:
        index = ft.IndexRefineFlat(index, store=ix["refine_flat_store"])
    nodes(index)[-1].cp.niter = ix["kmeans_niter"]
    return index


def serve_at(index, serving):
    """Each knob of the serving point on the innermost index that has it."""
    for key, value in serving.items():
        owner = next((n for n in reversed(nodes(index)) if has_own(n, key)), None)
        if owner is None:
            raise KeyError(f"no index of the tree takes {key!r}")
        setattr(owner, key, value)


def program_counters():
    """The program's counters: ivf_fast_scan_stats and the kernel wrappers'
    launch counts."""
    import faiss_tpu_torch as ft
    from faiss_tpu_torch.ops import fused_knn
    out = {f"ivf_fast_scan_stats.{k}": v
           for k, v in vars(ft.ivf_fast_scan_stats).items()
           if isinstance(v, (int, float))}
    for name, fn in vars(fused_knn).items():
        if callable(fn) and isinstance(getattr(fn, "launches", None), int):
            for a, v in vars(fn).items():
                if isinstance(v, int):
                    out[f"fused_knn.{name}.{a}"] = v
    return out


def k1_source(counters):
    """Where this process's K1 came from: nvcc in this run or the build
    cache."""
    if not counters.get("fused_knn.ivf_recon_fused_dyn.launches"):
        return "not launched by this cell"
    from faiss_tpu_torch.ops import fused_knn
    lib, _ = fused_knn.build_kernel("ivf_recon_dyn")  # cached: no second build
    path = Path(lib._name)
    made = "nvcc in this run" if path.stat().st_mtime >= T0_WALL else "build cache hit"
    return f"{made} ({path.relative_to(ROOT) if path.is_relative_to(ROOT) else path})"


class Run:
    """What the metric readers read: host records, readings, counters, the
    trace, and the index while it is alive."""

    def __init__(self, **kw):
        self.notes = []
        self.__dict__.update(kw)

    def note(self, text):
        self.notes.append(text)


def read_metrics(metrics, run):
    """Each metric its reader finds something for, with its unit."""
    out = {}
    for m in metrics:
        v = spec.reader(m["name"])(run)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def run_cell(cell, seed, seconds, traced, device, fault=None, log=None):
    """One run of ``cell``; returns the result line's object, or None where a
    forbidden module was loaded (named through ``log``). ``fault(index)``,
    for tests, breaks the timed path underneath the harness."""
    import torch
    t_torch = time.perf_counter()
    import faiss_tpu_torch as ft

    log = log or (lambda s: print(s, file=sys.stderr, flush=True))
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    cfg, mix, serving = cell.config, cell.traffic, cell.serving()

    def gen(*parts):
        g = torch.Generator(device=dev)
        g.manual_seed(spec.stream_seed(seed, *parts))
        return g

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    t_ft = time.perf_counter()
    if cuda:
        torch.zeros(1, device=dev)
    t_init = time.perf_counter()
    sampler = spec.generator(cfg["data"]["generator"]).make(cfg["data"], cfg["d"], dev)
    # the training rows come from the configuration's fixed seed, as in the
    # generators' originals: every run trains the same index, and the seed
    # draws the base and the queries it serves
    xt = torch.empty(cfg["nt"], cfg["d"])
    g_train = torch.Generator(device=dev)
    g_train.manual_seed(spec.stream_seed(cfg["data"]["train_seed"], "train"))
    draw_rows(sampler, cfg["nt"], g_train, out=xt)
    xb = torch.empty(cfg["nb"], cfg["d"])
    draw_rows(sampler, cfg["nb"], gen("base"), out=xb)
    t_data = time.perf_counter()
    index = build(ft, cfg, dev)
    index.train(xt.numpy())
    index.add(xb.numpy())
    del xt, xb
    gc.collect()
    serve_at(index, serving)
    if fault is not None:
        index = fault(index)
    sync()
    t_build = time.perf_counter()
    ring = loop.IN_FLIGHT + 2
    warm = Queries(sampler, mix["batch"], seed, "warmup", dev, ring)
    loop.drive(index, mix, warm, lambda j, D, I: None, 3600.0,
               max_batches=WARMUP_BATCHES)
    if traced:  # the profiler's first start is slow: pay it in set-up
        Profiler().start_stop()
    sync()
    del warm
    setup_s = time.perf_counter() - T0
    log(f"set-up {setup_s:.2f} s: imports to torch {t_torch - T0:.2f} s, faiss_tpu_torch "
        f"import {t_ft - t_torch:.2f} s, CUDA start {t_init - t_ft:.2f} s, data "
        f"{t_data - t_init:.2f} s, train + add {t_build - t_data:.2f} s, warm-up "
        f"{time.perf_counter() - t_build:.2f} s")

    queries = Queries(sampler, mix["batch"], seed, "query", dev, ring)
    answers = []
    c0 = program_counters()
    setup_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    profiler = Profiler() if traced else None
    trace_at = (TRACE_FROM * seconds, TRACE_TO * seconds, TRACE_MAX_S)
    rec, window_s = loop.drive(
        index, mix, queries, lambda j, D, I: answers.append((j, D, I)), seconds,
        trace_at=trace_at, profiler=profiler)
    sync()
    mem_window = torch.cuda.max_memory_allocated(dev) if cuda else 0
    bad = forbidden_modules()
    if bad:
        log(f"forbidden modules loaded: {', '.join(bad)}")
        return None
    c1 = program_counters()
    kc = max(mix["k"], int(round(mix["k"] * serving.get("k_factor", 1))))
    run = Run(cell=cell, seed=seed, seconds=seconds, traced=traced, device=dev,
              setup_s=setup_s, window_s=window_s, batches=rec.batches,
              queries=sum(b[1] for b in rec.batches), mem_window_bytes=mem_window,
              counters={k: c1[k] - c0.get(k, 0) for k in c1}, k=mix["k"], kc=kc,
              card=torch.cuda.get_device_name(dev) if cuda else "cpu", index=index,
              trace=None, readings=None,
              queries_of=lambda js: [queries.on_device(j).cpu().numpy() for j in js])
    run.peak = scanwork.peaks(run.card)
    out_metrics, device_extra, breakdown = {}, {}, None
    if traced:
        events = getattr(profiler, "events", None)
        if events is None:
            raise RuntimeError("the window ended before its traced part began")
        pkg = Path(ft.__file__).resolve().parent
        run.trace = Trace(events, program_kernel_names(pkg))
        device_extra = {"busy_s": run.trace.busy_s(), "window_s": run.trace.window_s}
        breakdown = {"device_ops": [list(x) for x in run.trace.top_ops()],
                     "idle_gaps": [list(x) for x in run.trace.idle_gaps()]}
        out_metrics = read_metrics(cell.per_layer, run)
    run.index = index = None
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    base = draw_rows(sampler, cfg["nb"], gen("base"))
    run.readings = correct.check_answers(
        answers, queries.on_device, base, cfg["guarantees"]["store_precision"],
        lambda j, n: recall_sample(seed, j, n), mix["k"])
    del base
    log(f"reference {time.perf_counter() - t_ref:.2f} s over {run.readings['rows']} "
        f"rows ({RECALL_ROWS} a batch for recall)")
    checks = correct.checks(run.readings, cell.limits,
                            cfg["guarantees"]["recall1_at_10_min"])
    if not traced:
        out_metrics = read_metrics(cell.end_to_end, run)
    for text in run.notes:
        log(text)
    result = {
        "correct": all(correct.holds(c) for c in checks.values()),
        "attempted": run.queries,
        "failed": run.readings["bad_rows"],
        "metrics": out_metrics,
        "device": {"platform": "gpu" if cuda else "cpu", "kind": run.card,
                   "count": cell.chips, "memory_peak_bytes": max(setup_peak, mem_window),
                   **device_extra},
    }
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import torch
    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda")
    bad = forbidden_modules()
    if result is None or bad:
        print(f"portbench: forbidden modules loaded: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    print(f"portbench: card {card_info()}; {torch.cuda.device_count()} device(s); "
          f"K1 {k1_source(program_counters())}", flush=True)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} {c['holds']} {c['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
