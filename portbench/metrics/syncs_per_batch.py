"""syncs_per_batch: CUDA synchronisations and device-to-host copies that the
host made inside the harness's submit and collect spans of the traced
batches, per batch (the profiler's runtime events)."""


def read(run):
    t = run.trace
    if t is None:
        return None
    js = t.batches()
    return t.syncs_of(js) / len(js) if js else None
