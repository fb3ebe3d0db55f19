"""scan_kernel_roofline: the least time the card could take for the scan
work that the traced batches' queries need (scanwork.py: the slots of each
query's probed lists, the union of their store columns read once) over
the device time of the scan kernels those batches launched: the kernels
that faiss_tpu_torch builds itself (its csrc/ and Triton sources), told
apart from PyTorch's and cuBLAS's by name. Nothing where no such kernel
ran."""

from portbench import scanwork
from portbench.trace import length


def read(run):
    t = run.trace
    if t is None or run.peak is None:
        return None
    js = t.batches()
    scans = [(e["ts"], e["end"]) for e in t.ops_of(js) if t.is_program_kernel(e)]
    if not scans:
        return None
    t_scan = length(scans) * 1e-6
    ops, nbytes = scanwork.need(run.index, run.queries_of(js), run.kc, run.device)
    t_need, bound = scanwork.least_time(ops, nbytes, run.peak)
    run.note(f"scan_kernel_roofline: {len(js)} batches, {ops:.4e} operations, "
             f"{nbytes:.4e} bytes, least time {t_need * 1e3:.4f} ms set by "
             f"{bound}; scan kernels {t_scan * 1e3:.4f} ms")
    return 100.0 * t_need / t_scan
