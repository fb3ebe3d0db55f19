"""In a fresh process the harness loads no JAX and not the JAX package
(top-level names compared whole: faiss_tpu_torch is not faiss_tpu), and the
plain reference loads nothing of the program."""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "faiss_tpu"}


def loaded_after(code):
    prog = (f"import sys; sys.path.insert(0, {str(ROOT)!r}); {code}; import json; "
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True, text=True,
                         timeout=300, cwd=ROOT, env={"PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_and_program_load_no_jax():
    top = loaded_after(
        "import portbench.run as r, portbench.control, portbench.correct; "
        "import faiss_tpu_torch, faiss_tpu_torch.ops.fused_knn; "
        "[__import__('portbench.spec', fromlist=['x']).reader(m) for m in "
        "('qps', 'p95_ms', 'recall_at_k', 'device_gib', 'setup_s', 'device_idle_pct', "
        "'scan_kernel_roofline', 'scan_chunk_pct', 'offkernel_ms_per_kq', "
        "'syncs_per_batch')]")
    assert "faiss_tpu_torch" in top
    assert not top & FORBIDDEN


def test_reference_loads_nothing_of_the_program():
    top = loaded_after("import portbench.reference.knn")
    assert "torch" in top
    assert not top & (FORBIDDEN | {"faiss_tpu_torch"})


def test_run_refuses_without_a_card():
    """The command exits with a code other than 0 and prints no result where
    no card is found (this sandbox's torch is built for the CPU)."""
    import pytest
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "sift1m_ivfpq_rflat.bulk_k10", "--seed", "1", "--seconds", "1"],
                         capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
