"""host_busy_ms_per_kq: the host time the program spent in the traced
batches' requests, outside its waits on the card: the union of their root
spans less the union of their ``wait`` spans, in ms per 1000 of their
queries (progspans.py)."""

from portbench import progspans


def read(run):
    m = progspans.mapped(run)
    return None if m is None else m.host_busy_ms_per_kq()
