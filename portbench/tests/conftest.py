"""Shared set-up of the harness's own tests (``python -m pytest portbench/tests``):
the repository root on the import path, the ``card`` marker for the tests
that need a CUDA card (each decides inside itself and skips without one),
and a tiny cell that runs the whole harness on the CPU."""

import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one")


def tiny(cell_name="sift1m_ivfpq_rflat.bulk_k10", **traffic):
    """The cell at a size the CPU runs in seconds: the same generator, index
    family, serving knobs and checks, over 20,000 rows of d = 32."""
    from portbench import spec
    cell = spec.load_cell(cell_name)
    cell.config = copy.deepcopy(cell.config)
    cfg = cell.config
    cfg.update(d=32, nb=20000, nt=4000)
    fac = cfg["index"]["factory"]
    cfg["index"]["factory"] = ("OPQ8,IVF64,PQ8x4fs,RFlat" if fac.startswith("OPQ")
                               else "IVF64,PQ8x4fs")
    cfg["index"]["kmeans_niter"] = 4
    cfg["serving"]["pipeline_batch"] = 256
    # the tiny index's own floor: 64 lists of 312 rows at nprobe 1 hold fewer
    # of the true neighbours than the published sizes do
    cfg["guarantees"]["recall1_at_10_min"] = 0.5
    cell.traffic = dict(cell.traffic, batch=256, **traffic)
    return cell


@pytest.fixture
def tiny_cell():
    return tiny
