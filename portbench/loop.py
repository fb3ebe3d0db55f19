"""The one traffic generator: a closed loop that keeps ``IN_FLIGHT``
batches outstanding through ``search_submit`` / ``search_collect`` (the next
batch is submitted before the oldest is collected) and records when each
was submitted and answered. Every batch of a mix holds its ``batch``
queries searched for its ``k`` neighbours."""

import time
from collections import deque
from contextlib import nullcontext

IN_FLIGHT = 2


def _span(traced, name):
    if not traced:
        return nullcontext()
    import torch
    return torch.profiler.record_function(name)


class Recorder:
    """Per batch: (j, n, t_submit, t_done) in perf_counter seconds."""

    def __init__(self):
        self.batches = []


def drive(index, mix, make_batch, on_result, seconds, max_batches=None,
          trace_at=None, profiler=None):
    """Offer batches 0, 1, ... for ``seconds`` seconds (or ``max_batches``
    of them), then collect all that are outstanding. ``make_batch(j)`` returns the host
    queries of batch j, which may be reused once batch j is collected;
    ``on_result(j, D, I)`` sees each answer. With ``profiler``, tracing runs
    from the first batch boundary past ``trace_at[0]`` seconds into the
    window for ``trace_at[2]`` seconds, to the first boundary past that or
    past ``trace_at[1]`` seconds into the window. Returns
    (Recorder, window seconds from the first submit to the last answer)."""
    rec = Recorder()
    k = mix["k"]
    pending = deque()
    traced = profiler is not None
    tracing = None
    t_start = time.perf_counter()
    t_stop = t_start + seconds
    j = 0
    while True:
        now = time.perf_counter()
        if traced and tracing is None and now >= t_start + trace_at[0]:
            profiler.start()
            tracing = _span(True, "traced_window")
            tracing.__enter__()
            t_trace_end = min(time.perf_counter() + trace_at[2], t_start + trace_at[1])
        if traced and tracing and now >= t_trace_end:
            tracing.__exit__(None, None, None)
            profiler.events = profiler.stop()
            tracing = False
        if (len(pending) < IN_FLIGHT and now < t_stop
                and (max_batches is None or j < max_batches)):
            with _span(traced, f"make_batch#{j}"):
                x = make_batch(j)
            t_sub = time.perf_counter()
            with _span(traced, f"submit#{j}"):
                h = index.search_submit(x, k)
            pending.append((j, len(x), h, t_sub))
            j += 1
            continue
        if not pending:
            break
        jj, n, h, t_sub = pending.popleft()
        with _span(traced, f"collect#{jj}"):
            D, I = index.search_collect(h)
        rec.batches.append((jj, n, t_sub, time.perf_counter()))
        with _span(traced, f"record#{jj}"):
            on_result(jj, D, I)
    if traced and tracing:
        tracing.__exit__(None, None, None)
        profiler.events = profiler.stop()
    window = rec.batches[-1][3] - rec.batches[0][2] if rec.batches else 0.0
    return rec, window
