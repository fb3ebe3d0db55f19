"""qps: queries answered in the window over the window's seconds, from the
first submit to the last answer on the host."""


def read(run):
    return run.queries / run.window_s if run.window_s > 0 else None
