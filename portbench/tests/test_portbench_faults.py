"""Whole runs of a tiny cell on the CPU (the harness's look for a card
skipped): sound runs come out correct, and runs with the timed path broken
underneath, or with the control in the program's place, come out not
correct."""

import numpy as np
import pytest

from portbench.control import control_fault
from portbench.faults import FAULTS, wrap_collect
from portbench.run import run_cell

SEED = 2**31 + 101


def run(cell, fault=None, seed=SEED, seconds=1.0):
    return run_cell(cell, seed, seconds, False, "cpu", fault=fault, log=lambda s: None)


CELLS = ["sift1m_ivfpq_rflat.bulk_k10", "deep10m_opq_ivfpq_rflat.bulk_k10",
         "sift1m_ivfpq_rflat.bulk_k100"]


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(tiny_cell, name):
    cell = tiny_cell(name)
    r = run(cell)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0
    # device_gib reads the card's allocator: nothing to read on the CPU
    assert set(r["metrics"]) == {m["name"] for m in cell.end_to_end} - {"device_gib"}
    assert {"qps", "recall_at_k", "setup_s"} <= set(r["metrics"])
    assert ("p95_ms" in r["metrics"]) == (name != "sift1m_ivfpq_rflat.bulk_k10")
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("alter", sorted(FAULTS))
def test_broken_timed_path_is_not_correct(tiny_cell, name, alter):
    r = run(tiny_cell(name), fault=wrap_collect(FAULTS[alter]))
    assert not r["correct"]
    assert r["checks"]["dist_err"]["value"] > r["checks"]["dist_err"]["limit"]


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(tiny_cell, name):
    cell = tiny_cell(name)
    r = run(cell, fault=control_fault(cell, SEED, "cpu"))
    assert not r["correct"]
    c = r["checks"]
    assert c["dist_err"]["value"] > 3 * c["dist_err"]["limit"]
    assert c["bad_rows"]["value"] == 0  # it fails on precision alone


def test_same_seed_same_answers(tiny_cell):
    """Two runs of one seed answer the batches they share alike."""
    cell = tiny_cell()
    seen = []

    def keep(index):
        collect = index.search_collect

        def kept(handle):
            D, I = collect(handle)
            seen[-1].append(I.copy())
            return D, I
        index.search_collect = kept
        return index
    for _ in range(2):
        seen.append([])
        run(cell, fault=keep, seconds=0.5)
    n = min(len(seen[0]), len(seen[1]))
    assert n >= 1
    assert all(np.array_equal(a, b) for a, b in zip(seen[0][:n], seen[1][:n]))
