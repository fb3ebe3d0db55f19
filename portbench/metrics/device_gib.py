"""device_gib: the peak of device memory allocated during the window (the
allocator's count, reset as the window opens, after the harness has freed
its copies of the data)."""


def read(run):
    return run.mem_window_bytes / 2**30 if run.mem_window_bytes else None
