"""host_waits_per_batch: the program's ``wait`` spans (a blocking host-device
call each: a pageable copy up, a read back, a scalar read) in the requests
of the traced batches, per batch; the program's own count of the sites
that syncs_per_batch counts from the runtime's events (progspans.py)."""

from portbench import progspans


def read(run):
    m = progspans.mapped(run)
    return None if m is None else m.waits_per_batch()
