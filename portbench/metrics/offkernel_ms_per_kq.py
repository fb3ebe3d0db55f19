"""offkernel_ms_per_kq: device time of the kernels that are not the
program's own scan kernels (PyTorch's and cuBLAS's), launched by the
traced batches, per 1000 of their queries."""

from portbench.trace import length


def read(run):
    t = run.trace
    if t is None:
        return None
    js = t.batches()
    traced = set(js)
    n = sum(b[1] for b in run.batches if b[0] in traced)
    if not n:
        return None
    other = [(e["ts"], e["end"]) for e in t.ops_of(js)
             if e["cat"] == "kernel" and not t.is_program_kernel(e)]
    return length(other) * 1e-3 / (n / 1000.0)
