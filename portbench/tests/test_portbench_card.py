"""A tiny run of each cell on the card, both trace modes: correct, the
end-to-end metrics, and the per-layer metrics and device times read from
the trace. Skips without a card; on the card:
``python3 -m pytest portbench/tests -m card``."""

import pytest

from portbench.run import run_cell


@pytest.mark.card
@pytest.mark.parametrize("name", ["sift1m_ivfpq_rflat.bulk_k10",
                                  "sift1m_ivfpq_rflat.bulk_k100"])
def test_tiny_cell_on_the_card(tiny_cell, name):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    cell = tiny_cell(name)
    r = run_cell(cell, 2**31 + 3, 2.0, False, "cuda")
    assert r["correct"], r["checks"]
    assert {m["name"] for m in cell.end_to_end} == set(r["metrics"])
    assert {"qps", "recall_at_k", "device_gib", "setup_s"} <= set(r["metrics"])
    assert r["device"]["platform"] == "gpu" and r["device"]["memory_peak_bytes"] > 0
    t = run_cell(cell, 2**31 + 4, 3.0, True, "cuda")
    assert t["correct"], t["checks"]
    assert 0 < t["device"]["busy_s"] <= t["device"]["window_s"]
    assert {"device_idle_pct", "offkernel_ms_per_kq", "syncs_per_batch"} <= set(t["metrics"])
    assert t["breakdown"]["device_ops"] and len(t["breakdown"]["idle_gaps"]) <= 10
