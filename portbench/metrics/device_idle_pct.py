"""device_idle_pct: the share of the traced window in which no operation
of the program (kernel, copy or memset) ran on the card; the intervals are
taken as a union. The harness's own query draws are left out."""


def read(run):
    t = run.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s)
