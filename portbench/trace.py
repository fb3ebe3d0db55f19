"""The device trace of a traced part of the window, and the arithmetic that
the per-layer readers share: which device operations ran when, which host
span launched each, which kernels are the program's own, and the unions and
gaps of their intervals.

The trace is torch.profiler's (CUPTI) over CPU and CUDA activity, exported
as a Chrome trace into a temporary directory under ``TMPDIR``, read back and
deleted. Events keep their microsecond times. The harness names its host
spans ``make_batch#j``, ``submit#j``, ``collect#j`` and ``record#j`` for
batch j, inside one ``traced_window`` span; a device operation belongs to
the span in which the host made the runtime call that launched it (the two
share a correlation id). Operations launched from ``make_batch`` spans are
the harness's own query draws and are left out of every reading."""

import json
import os
import re
import shutil
import tempfile
from bisect import bisect_right
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cuda_runtime", "cuda_driver")
SPAN_RE = re.compile(r"^(make_batch|submit|collect|record)#(\d+)$")
HARNESS_SPANS = ("make_batch",)
LIBRARY_NS = re.compile(r"\b(at|c10|cub|cutlass|thrust|cublas\w*)::")


def normalize(chrome):
    """The events of a Chrome trace that the readers use, as dicts with
    name, cat, ts, end (microseconds), tid and corr."""
    out = []
    for e in chrome.get("traceEvents", []):
        cat = e.get("cat")
        if e.get("ph") != "X" or cat not in DEVICE_CATS + HOST_CATS + ("user_annotation",):
            continue
        ts = float(e["ts"])
        args = e.get("args") or {}
        out.append({"name": e.get("name", ""), "cat": cat, "ts": ts,
                    "end": ts + float(e.get("dur", 0.0)), "tid": e.get("tid"),
                    "corr": args.get("correlation")})
    return out


class Profiler:
    """torch.profiler over CPU and CUDA activity, started and stopped around
    the traced part of the window."""

    def __init__(self):
        self.prof = None

    def start(self):
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.start()

    def start_stop(self):
        """Start and stop without reading: the first start in a process
        sets up CUPTI, which takes seconds."""
        self.start()
        self.prof.stop()

    def stop(self):
        """Stop, export, read back and delete; returns normalize()'s list."""
        self.prof.stop()
        tmp = tempfile.mkdtemp(prefix="portbench_trace_")
        try:
            path = os.path.join(tmp, "trace.json")
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                return normalize(json.load(f))
        finally:
            shutil.rmtree(tmp, ignore_errors=True)


def program_kernel_names(pkg_dir):
    """The kernels that the program builds itself: each ``__global__``
    function of its ``csrc/`` sources and each ``@triton.jit`` function of
    its Python files."""
    pkg_dir = Path(pkg_dir)
    names = set()
    glob_re = re.compile(
        r"__global__\s+(?:void\s+)?(?:__launch_bounds__\s*\([^)]*\)\s*)?"
        r"(?:void\s+)?(\w+)\s*\(")
    for p in sorted((pkg_dir / "csrc").glob("*.cu*")):
        names.update(glob_re.findall(p.read_text()))
    jit_re = re.compile(r"@triton\.jit[^\n]*\n(?:\s*@[^\n]*\n)*\s*def\s+(\w+)")
    for p in sorted(pkg_dir.rglob("*.py")):
        text = p.read_text()
        if "triton" in text:
            names.update(jit_re.findall(text))
    return names


def kernel_base(name):
    """A kernel's function name without return type, namespaces, template
    arguments and parameters."""
    s = name.replace("(anonymous namespace)", "anon")
    if s.startswith("void "):
        s = s[5:]
    out, depth = [], 0
    for ch in s:
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth = max(0, depth - 1)
        elif depth == 0:
            out.append(ch)
    s = "".join(out).split("(")[0]
    return s.rsplit("::", 1)[-1].strip()


def union(intervals):
    """Sorted, merged (start, end) intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        elif b > a:
            out.append([a, b])
    return [tuple(x) for x in out]


def length(intervals):
    return sum(b - a for a, b in union(intervals))


class Trace:
    """The normalized events of one traced part of a window."""

    def __init__(self, events, program_kernels):
        self.program_kernels = set(program_kernels)
        ann = [e for e in events if e["cat"] == "user_annotation"]
        win = [e for e in ann if e["name"] == "traced_window"]
        if not win:
            raise ValueError("the trace holds no traced_window span")
        self.t0, self.t1 = win[0]["ts"], win[0]["end"]
        self.spans = sorted((e for e in ann if SPAN_RE.match(e["name"])),
                            key=lambda e: e["ts"])
        self._starts = [e["ts"] for e in self.spans]
        self.host_calls = [e for e in events if e["cat"] in HOST_CATS]
        launcher = {}
        for e in self.host_calls:
            span = self.span_at(e["ts"])
            if span is not None and e["corr"] is not None:
                launcher[e["corr"]] = span["name"]
        self.device = []
        for e in events:
            if e["cat"] in DEVICE_CATS:
                label = launcher.get(e["corr"])
                if label and SPAN_RE.match(label).group(1) in HARNESS_SPANS:
                    continue
                self.device.append(dict(e, span=label))

    @property
    def window_s(self):
        return (self.t1 - self.t0) * 1e-6

    def span_at(self, t):
        """The harness span that holds host time t, or None."""
        i = bisect_right(self._starts, t) - 1
        if i >= 0 and self.spans[i]["end"] >= t:
            return self.spans[i]
        return None

    def clipped(self):
        """The device operations' intervals cut to the traced window."""
        return [(max(e["ts"], self.t0), min(e["end"], self.t1))
                for e in self.device if e["end"] > self.t0 and e["ts"] < self.t1]

    def busy_s(self):
        return length(self.clipped()) * 1e-6

    def batches(self):
        """Batches whose submit and collect spans both lie in the window."""
        seen = {}
        for s in self.spans:
            kind, j = SPAN_RE.match(s["name"]).groups()
            if s["ts"] >= self.t0 and s["end"] <= self.t1:
                seen.setdefault(int(j), set()).add(kind)
        return sorted(j for j, kinds in seen.items() if {"submit", "collect"} <= kinds)

    def is_program_kernel(self, e):
        return (e["cat"] == "kernel" and not LIBRARY_NS.search(e["name"])
                and kernel_base(e["name"]) in self.program_kernels)

    def ops_of(self, batches):
        """Device operations launched from the submit or collect spans of
        ``batches``."""
        labels = {f"{k}#{j}" for j in batches for k in ("submit", "collect")}
        return [e for e in self.device if e["span"] in labels]

    def syncs_of(self, batches):
        """Host synchronisations and device-to-host copies made inside the
        submit and collect spans of ``batches``."""
        labels = {f"{k}#{j}" for j in batches for k in ("submit", "collect")}
        d2h = {e["corr"] for e in self.device
               if e["cat"] == "gpu_memcpy" and "DtoH" in e["name"]}
        n = 0
        for e in self.host_calls:
            span = self.span_at(e["ts"])
            if span is None or span["name"] not in labels:
                continue
            n += "Synchronize" in e["name"] or e["corr"] in d2h
        return n

    def top_ops(self, n=10):
        """The device operations that took most time in the window, by name."""
        tot = {}
        for e in self.device:
            a, b = max(e["ts"], self.t0), min(e["end"], self.t1)
            if b > a:
                name = kernel_base(e["name"]) if e["cat"] == "kernel" else e["name"]
                tot[name] = tot.get(name, 0.0) + (b - a) * 1e-6
        return sorted(tot.items(), key=lambda kv: -kv[1])[:n]

    def idle_gaps(self, n=10):
        """The longest stretches of the window with nothing on the device,
        each named after the harness span the host was in when it began."""
        gaps, t = [], self.t0
        for a, b in union(self.clipped()) + [(self.t1, self.t1)]:
            if a > t:
                span = self.span_at(t)
                name = SPAN_RE.match(span["name"]).group(1) if span else "loop"
                gaps.append((name, (a - t) * 1e-6))
            t = max(t, b)
        return sorted(gaps, key=lambda g: -g[1])[:n]
