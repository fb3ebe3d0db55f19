"""The program's own spans (``faiss_tpu_torch.tracing``) read against the
device trace of a traced window.

The program times its spans with ``time.perf_counter_ns()``; the trace has
a clock of its own. The harness stamps each batch's submit with
``time.perf_counter()`` just before it opens ``submit#j``, so the offset
between the clocks is the median over the traced batches of ``submit#j``'s
start less that stamp. A request (a root span and the spans under it)
belongs to batch j when its root lies inside ``submit#j`` or ``collect#j``
and j is a traced batch (``Trace.batches``). Every root of the session has
to lie inside a harness submit or collect within ``TOLERANCE_US``; where
one does not, where spans were dropped, or where the program records none
(a program without ``tracing``), the readers find nothing, and the first
says why in the run's notes.

The per-span table, written once to the notes, gives for each span name of
the traced batches: spans per batch; host self time (the span less its
children) and time in waits inside it (its own where it is a wait), in ms
per 1000 queries; device ms per 1000 queries of the operations it launched
(an operation's launching runtime call, by correlation id, falls in the
innermost span that holds it); and the idle time of the card whose gaps
began while the host was in it."""

import statistics
from bisect import bisect_right

from portbench.trace import SPAN_RE, length, union

TOLERANCE_US = 50.0
OUTSIDE = "(no program span of a traced batch)"


def program_spans():
    """The program's spans of the newest profiling session and the count it
    dropped, or None where the program records no spans."""
    try:
        from faiss_tpu_torch import tracing
    except ImportError:
        return None
    return tracing.spans(), tracing.dropped()


def intersect(a, b):
    """Length of the overlap of two lists of merged, sorted intervals."""
    i = j = 0
    tot = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        tot += max(0.0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return tot


def idle_intervals(trace):
    """The stretches of the traced window with nothing on the card."""
    out, t = [], trace.t0
    for a, b in union(trace.clipped()) + [(trace.t1, trace.t1)]:
        if a > t:
            out.append((t, a))
        t = max(t, b)
    return out


def innermost(spans, times):
    """For each of ``times`` (ascending), the innermost of ``spans`` (dicts
    with ts, end and name, nested as one thread opens them) that holds it,
    or None."""
    order = sorted(spans, key=lambda s: (s["ts"], -s["end"]))
    out, stack, i = [], [], 0
    for t in times:
        while i < len(order) and order[i]["ts"] <= t:
            while stack and stack[-1]["end"] < order[i]["ts"]:
                stack.pop()
            stack.append(order[i])
            i += 1
        while stack and stack[-1]["end"] < t:
            stack.pop()
        out.append(stack[-1] if stack else None)
    return out


class Mapped:
    """The program's spans of one traced window on the trace's clock, each
    a dict with its batch (None outside the traced batches)."""

    def __init__(self, run, spans, offset_us, worst_us, offsets):
        self.run, self.trace = run, run.trace
        self.spans, self.offset_us, self.worst_us = spans, offset_us, worst_us
        self.offsets = offsets
        self.js = self.trace.batches()
        traced = set(self.js)
        self.queries = sum(b[1] for b in run.batches if b[0] in traced)
        self.mine = [s for s in spans if s["batch"] is not None]
        self.roots = union((s["ts"], s["end"]) for s in self.mine if s["root"])
        self.waits = [s for s in self.mine if s["nbytes"] is not None]

    def per_kq(self, us):
        return us * 1e-3 / (self.queries / 1000.0)

    def waits_per_batch(self):
        return len(self.waits) / len(self.js)

    def host_busy_ms_per_kq(self):
        return self.per_kq(length(self.roots)
                           - length((s["ts"], s["end"]) for s in self.waits))

    def idle_in_program_pct(self):
        t = self.trace
        return 100.0 * intersect(idle_intervals(t), self.roots) / (t.t1 - t.t0)

    def table(self):
        """{name: [count/batch, self, waits, device, idle]}, the last four in
        ms per 1000 queries; ``OUTSIDE`` gathers device and idle time that
        no span of a traced batch holds."""
        t, rows = self.trace, {}

        def row(name):
            return rows.setdefault(name, [0.0] * 5)

        kids, waited = {}, {}
        for s in self.mine:
            kids.setdefault(s["parent"], []).append(s)
        for w in self.waits:
            for i in w["above"] | {w["index"]}:
                waited[i] = waited.get(i, 0.0) + w["end"] - w["ts"]
        for s in self.mine:
            r = row(s["name"])
            r[0] += 1
            r[1] += s["end"] - s["ts"] - length(
                (c["ts"], c["end"]) for c in kids.get(s["index"], ()))
            r[2] += waited.get(s["index"], 0.0)
        call_ts = {e["corr"]: e["ts"] for e in t.host_calls if e["corr"] is not None}
        ops = sorted(((call_ts[e["corr"]], e) for e in t.device
                      if e["corr"] in call_ts), key=lambda p: p[0])
        for (_, e), s in zip(ops, innermost(self.mine, [p[0] for p in ops])):
            a, b = max(e["ts"], t.t0), min(e["end"], t.t1)
            if b > a:
                row(s["name"] if s else OUTSIDE)[3] += b - a
        gaps = idle_intervals(t)
        for (a, b), s in zip(gaps, innermost(self.mine, [g[0] for g in gaps])):
            row(s["name"] if s else OUTSIDE)[4] += b - a
        n = len(self.js)
        return {k: [v[0] / n] + [self.per_kq(x) for x in v[1:]]
                for k, v in rows.items()}

    def describe(self):
        """The per-span table and the clock mapping, as text."""
        lines = [
            f"program spans: {len(self.js)} traced batches, {self.queries} queries; "
            f"clock offset {self.offset_us:.3f} us (per-batch spread "
            f"{max(self.offsets) - min(self.offsets):.3f} us); every root within "
            f"{self.worst_us:.3f} us of its harness span",
            f"{'span':<36} {'n/batch':>8} {'self':>9} {'waits':>9} {'device':>9} "
            f"{'idle':>9}  (ms per 1000 queries)",
        ]
        tab = self.table()
        for name in sorted(tab, key=lambda k: k == OUTSIDE):  # in the order entered
            c, *ms = tab[name]
            lines.append(f"{name:<36} {c:>8.2f} " + " ".join(f"{v:>9.4f}" for v in ms))
        return "\n".join(lines)


def _map(run):
    t = run.trace
    got = program_spans()
    if t is None or got is None:
        return None
    spans, dropped = got
    if dropped:
        return f"the program dropped {dropped} spans past its bound"
    if not spans:
        return "the program recorded no spans in the traced window"
    harness = {s["name"]: s for s in t.spans}
    stamps = {b[0]: b[2] for b in run.batches}
    offsets = [harness[f"submit#{j}"]["ts"] - stamps[j] * 1e6
               for j in t.batches() if j in stamps]
    if not offsets:
        return "no traced batch to set the clocks by"
    off = statistics.median(offsets)
    traced = set(t.batches())
    by_index = {}
    for s in spans:
        by_index[s.index] = {
            "index": s.index, "parent": s.parent, "name": s.name, "nbytes": s.nbytes,
            "ts": s.start_ns * 1e-3 + off, "end": s.end_ns * 1e-3 + off}
    starts = [h["ts"] for h in t.spans]
    worst = 0.0
    for s in by_index.values():
        s["root"] = s["parent"] not in by_index
        if not s["root"]:
            continue
        i = bisect_right(starts, 0.5 * (s["ts"] + s["end"])) - 1
        h = t.spans[i] if i >= 0 else None
        kind, j = SPAN_RE.match(h["name"]).groups() if h else ("", "-1")
        if kind not in ("submit", "collect"):
            return (f"root {s['name']} at {s['ts']:.3f}-{s['end']:.3f} us lies in no "
                    "harness submit or collect span")
        out = max(h["ts"] - s["ts"], s["end"] - h["end"], 0.0)
        if out > TOLERANCE_US:
            return (f"root {s['name']} lies {out:.3f} us outside {h['name']} "
                    f"(more than {TOLERANCE_US:g} us)")
        worst = max(worst, out)
        s["batch"] = int(j) if int(j) in traced else None
    for s in sorted(by_index.values(), key=lambda s: s["index"]):
        if not s["root"]:
            up = by_index[s["parent"]]
            s["batch"], s["above"] = up["batch"], up["above"] | {up["index"]}
        else:
            s["above"] = frozenset()
    if not any(s["batch"] is not None for s in by_index.values()):
        return "no program span lies in a traced batch"
    return Mapped(run, list(by_index.values()), off, worst, offsets)


def mapped(run):
    """The run's Mapped spans, or None (with a note the first time) where
    there is nothing to read."""
    if "program_spans" not in vars(run):
        m = _map(run)
        if isinstance(m, str):
            run.note(f"program spans: none read: {m}")
            m = None
        elif m is not None:
            run.note(m.describe())
        run.program_spans = m
    return run.program_spans
