"""scan_chunk_pct: the share of the store's chunks that the refined IVF-PQ
big batches scanned over the window, from the program's counters
(ivf_fast_scan_stats): chunks_scanned / (chunks_scanned + chunks_skipped),
the arithmetic of benchs/bench_deep10m.py's chunk_scan_frac."""


def read(run):
    c = run.counters
    s = c.get("ivf_fast_scan_stats.chunks_scanned", 0)
    k = c.get("ivf_fast_scan_stats.chunks_skipped", 0)
    return 100.0 * s / (s + k) if s + k else None
