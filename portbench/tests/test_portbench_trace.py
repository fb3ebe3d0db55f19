"""The per-layer readers' arithmetic over a small trace fixture with known
answers (fixtures/trace_small.json: batches 5 and 6 whole in the traced
window, batch 4's collect and batch 7's submit at its edges, one harness
draw), and the kernel names the program builds."""

import json
from pathlib import Path

import numpy as np
import pytest

from portbench import scanwork, spec
from portbench.run import Run
from portbench.trace import Trace, kernel_base, normalize, program_kernel_names

HERE = Path(__file__).resolve().parent
PKG = HERE.parents[1] / "faiss_tpu_torch"
NAMES = {"ivf_recon_dyn_kernel", "merge_splits"}


@pytest.fixture
def trace():
    with open(HERE / "fixtures" / "trace_small.json") as f:
        return Trace(normalize(json.load(f)), NAMES)


def fake_run(trace, **kw):
    batches = [(j, 8192, 0.0, 0.0) for j in (4, 5, 6, 7)]
    return Run(trace=trace, batches=batches, counters={}, index=None, kc=80,
               device="cpu", peak={"bf16_flops": 989e12, "hbm_bytes_per_s": 3.35e12},
               queries_of=lambda js: [np.zeros((8192, 4), np.float32) for _ in js], **kw)


def test_normalize_keeps_what_the_readers_use():
    with open(HERE / "fixtures" / "trace_small.json") as f:
        ev = normalize(json.load(f))
    assert {e["cat"] for e in ev} == {"user_annotation", "cuda_runtime", "kernel",
                                      "gpu_memcpy"}
    assert all(e["end"] >= e["ts"] for e in ev)


def test_batches_busy_and_idle(trace):
    assert trace.batches() == [5, 6]
    assert trace.window_s == pytest.approx(1e-3)
    # union: 3 + 5 + 50 + 130 + 10 + 160 + 10 + 100 (clipped at the end) us;
    # the harness's draw at 30-35 us is left out
    assert trace.busy_s() == pytest.approx(468e-6)
    idle = spec.reader("device_idle_pct")(fake_run(trace))
    assert idle == pytest.approx(53.2)


def test_idle_gaps_name_the_host_span(trace):
    gaps = trace.idle_gaps()
    assert [g[0] for g in gaps[:4]] == ["collect", "collect", "loop", "loop"]
    assert [round(g[1] * 1e6) for g in gaps] == [170, 170, 90, 60, 20, 10, 10, 2]
    assert sum(g[1] for g in gaps) == pytest.approx(1e-3 - 468e-6)


def test_top_ops(trace):
    top = dict(trace.top_ops())
    assert top["ivf_recon_dyn_kernel"] == pytest.approx(350e-6)
    assert top["Memcpy DtoH (Device -> Pageable)"] == pytest.approx(23e-6)
    assert "distribution_elementwise_grid_stride_kernel" not in top
    assert list(top)[0] == "ivf_recon_dyn_kernel"


def test_syncs_per_batch(trace):
    # submit#5 one stream sync (its HtoD copy does not count); collect#5 a
    # DtoH copy and a sync; collect#6 a DtoH copy and a device sync
    assert spec.reader("syncs_per_batch")(fake_run(trace)) == pytest.approx(2.5)


def test_offkernel_ms_per_kq(trace):
    # batches 5 and 6: 20 + 50 + 10 us of library kernels over 16,384 queries
    v = spec.reader("offkernel_ms_per_kq")(fake_run(trace))
    assert v == pytest.approx(0.080 / 16.384)


def test_scan_kernel_roofline(trace, monkeypatch):
    # scan kernels of batches 5 and 6: 100 + 10 + 150 us; the work counted
    # is bound by its operations here
    monkeypatch.setattr(scanwork, "need", lambda index, qs, kc, dev: (1e9, 3.35e6))
    run = fake_run(trace)
    v = spec.reader("scan_kernel_roofline")(run)
    assert v == pytest.approx(100 * (1e9 / 989e12) / 260e-6)
    assert "set by operations" in run.notes[0]
    monkeypatch.setattr(scanwork, "need", lambda index, qs, kc, dev: (1e6, 3.35e8))
    assert spec.reader("scan_kernel_roofline")(fake_run(trace)) == pytest.approx(
        100 * 1e-4 / 260e-6)


def test_readers_find_nothing_to_read():
    run = fake_run(None)
    for name in ("device_idle_pct", "scan_kernel_roofline", "offkernel_ms_per_kq",
                 "syncs_per_batch", "scan_chunk_pct"):
        assert spec.reader(name)(run) is None


def test_scan_chunk_pct():
    run = fake_run(None)
    run.counters = {"ivf_fast_scan_stats.chunks_scanned": 3,
                    "ivf_fast_scan_stats.chunks_skipped": 9}
    assert spec.reader("scan_chunk_pct")(run) == pytest.approx(25.0)


def test_least_time_names_its_bound():
    peak = {"bf16_flops": 989e12, "hbm_bytes_per_s": 3.35e12}
    assert scanwork.least_time(989e12, 1.0, peak) == (1.0, "operations")
    assert scanwork.least_time(1.0, 6.7e12, peak) == (2.0, "bytes")


def test_program_kernel_names_hold_the_scan_kernels():
    names = program_kernel_names(PKG)
    assert {"ivf_recon_dyn_kernel", "ivf_recon_kernel", "merge_splits",
            "adc_dyn_kernel", "adc_mma_kernel"} <= names
    assert "__launch_bounds__" not in names


@pytest.mark.parametrize("name,base", [
    ("void ivf_recon_dyn_kernel<64>(recon_mma::Args, int)", "ivf_recon_dyn_kernel"),
    ("void at::native::(anonymous namespace)::f<float, 4>(long)", "f"),
    ("sm90_xmma_gemm_f32f32_tf32f32_f32_tn_n", "sm90_xmma_gemm_f32f32_tf32f32_f32_tn_n"),
    ("void tile_select::merge_splits(float const*)", "merge_splits"),
])
def test_kernel_base(name, base):
    assert kernel_base(name) == base


def test_library_kernel_of_the_same_name_is_not_the_programs(trace):
    e = {"cat": "kernel", "name": "void at::native::merge_splits(float const*)"}
    assert not trace.is_program_kernel(e)
    assert trace.is_program_kernel({"cat": "kernel", "name": "void merge_splits(int)"})
