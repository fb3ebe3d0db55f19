"""faiss_tpu_torch.tracing on the CPU: the program's spans record only while a
torch profiler runs, and a search records the span tree of its path.

Three small indexes built by the port itself at test_torch_meta.py's sizes
(d 16, 1500 rows, 32 lists, PQ4x4fs, 128 queries, FUSED_CT 256, big
batches from 64 queries in sub-batches of 64): IndexRefineFlat over
IVF-PQ on the fused path (k 10, k_factor 4) and on the eager path (k 100,
k_factor 4: 400 candidates), and the fused path behind an OPQ rotation.
Each profiled search records its tree, one request id for its submit and
its collect, and a ``wait`` at every blocking host-device call: per
sub-batch the query copy up, then the three reads of the collect. A
profiling session's list starts at its first span after one that found the
profiler off, so each test searches once unprofiled before it profiles."""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

import faiss_tpu_torch as ftt
from faiss_tpu_torch import tracing
from torch_threads import one_torch_thread  # noqa: F401

D, NB, NQ, NLIST = 16, 1500, 128, 32


def mixture(rs, n, ncent=64, d=D):
    """Small Gaussian mixture in the shape of bench.py's generator."""
    cent = np.random.RandomState(99).rand(ncent, d).astype(np.float32)
    scales = (1.0 / (np.arange(d) + 1.0)).astype(np.float32) * 0.4
    a = rs.randint(ncent, size=n)
    return (cent[a] + rs.randn(n, d).astype(np.float32) * scales).astype(np.float32)


def build(factory):
    rs = np.random.RandomState(61)
    xb = mixture(rs, NB)
    index = ftt.index_factory(D, factory, device="cpu")
    if not factory.endswith("RFlat"):
        index = ftt.IndexRefineFlat(index, store="f16")
    refine = index.index if isinstance(index, ftt.IndexPreTransform) else index
    base = refine.base_index
    base.cp.niter = 4
    base.cp.min_points_per_centroid = 1
    base.FUSED_CT, base.big_batch_threshold, base.pipeline_batch = 256, 64, 64
    base.strict_probe, base.soft_engage_frac, base.nprobe = False, 1.0, 2
    refine.k_factor = 4
    index.train(xb)
    index.add(xb)
    return index, base, mixture(rs, NQ)


@pytest.fixture(scope="module")
def indexes():
    return {"ivfpq": build("IVF32,PQ4x4fs"), "opq": build("OPQ4,IVF32,PQ4x4fs,RFlat")}


SUB_SUBMIT = ["    sbbr.h2d", "    sbbr.worklists", "    sbbr.scan", "    sbbr.rerank"]
SUB_COLLECT = ["    collect.ndropped", "    collect.d2h_dist", "    collect.d2h_slots",
               "    collect.id_map"]
FUSED = (["IndexRefine.search_submit",
          "  sbbr.sub_batch", "    sbbr.h2d", "    sbbr.bucket", *SUB_SUBMIT[1:],
          "  sbbr.sub_batch", *SUB_SUBMIT]
         + ["IndexRefine.search_collect"]
         + ["  collect.sub_batch", *SUB_COLLECT] * 2)
EAGER = ["IndexRefine.search_submit",
         "  eager.base_search",
         "    xla.sub_batch", "      xla.h2d", "      xla.d2h_dist", "      xla.d2h_ids",
         "  eager.rerank", "    eager.h2d_queries", "    eager.h2d_candidates",
         "    eager.d2h_dist", "    eager.d2h_ids",
         "IndexRefine.search_collect"]
OPQ = (["IndexPreTransform.search_submit",
        "  pretransform.apply_chain", "    pretransform.h2d", "    pretransform.d2h"]
       + ["  " + s for s in FUSED[:FUSED.index("IndexRefine.search_collect")]]
       + FUSED[FUSED.index("IndexRefine.search_collect"):])
# (index, k, the tree, waits per sub-batch of the submit and of the collect)
CASES = {"fused": ("ivfpq", 10, FUSED, 1, 3), "eager": ("ivfpq", 100, EAGER, 3, 0),
         "opq": ("opq", 10, OPQ, 1, 3)}


def tree(spans):
    """Each span's name indented by its depth, in the order entered."""
    depth = {}
    out = []
    for s in spans:
        depth[s.index] = depth[s.parent] + 1 if s.parent in depth else 0
        out.append("  " * depth[s.index] + s.name)
    return out


def profiled_search(index, base, xq, k):
    base._dyn_bucket = None  # the first search of an nprobe sizes the worklists
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        h = index.search_submit(xq, k)
        D_, I_ = index.search_collect(h)
    return prof, h, D_, I_


@pytest.mark.parametrize("case", sorted(CASES))
def test_profiled_search_records_its_span_tree(indexes, case):
    which, k, want, waits_submit, waits_collect = CASES[case]
    index, base, xq = indexes[which]
    D0, I0 = index.search(xq, k)
    _, h, D_, I_ = profiled_search(index, base, xq, k)
    np.testing.assert_array_equal(I_, I0)
    np.testing.assert_array_equal(D_, D0)
    spans = tracing.spans()
    assert tracing.dropped() == 0
    assert tree(spans) == want
    assert len(h) == 2 and h[0] == ("eager" if case == "eager" else "fused")
    assert {s.rid for s in spans} == {h.rid}
    by_index = {s.index: s for s in spans}
    for s in spans:
        assert s.start_ns <= s.end_ns
        if s.parent is not None:
            p = by_index[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
    waits = [s for s in spans if s.nbytes is not None]
    assert all(s.nbytes > 0 for s in waits)
    subs = [s for s in spans if s.name.endswith("sub_batch")]
    per_sub = [sum(w.parent == s.index for w in waits) for s in subs]
    top = [s for s in subs if not s.name.startswith("collect")]
    assert per_sub[:len(top)] == [waits_submit + (i == 0 and case != "eager")
                                  for i in range(len(top))]
    assert per_sub[len(top):] == [waits_collect] * (len(subs) - len(top))


def test_one_request_id_a_search(indexes):
    """Two searches in flight: each collect takes its own submit's id."""
    index, base, xq = indexes["ivfpq"]
    index.search(xq, 10)
    with profile(activities=[ProfilerActivity.CPU]):
        h1 = index.search_submit(xq, 10)
        h2 = index.search_submit(xq[:64], 10)
        index.search_collect(h2)
        index.search_collect(h1)
    roots = [s for s in tracing.spans() if s.parent is None]
    assert [(s.name, s.rid) for s in roots] == [
        ("IndexRefine.search_submit", h1.rid), ("IndexRefine.search_submit", h2.rid),
        ("IndexRefine.search_collect", h2.rid), ("IndexRefine.search_collect", h1.rid)]
    assert h1.rid != h2.rid


def test_off_records_nothing_and_enters_no_range(indexes, monkeypatch):
    """With no profiler, a search records no span and never enters
    record_function; its handle is the plain tuple. The next profiling
    session starts from an empty list."""
    index, base, xq = indexes["opq"]
    entered = []
    with profile(activities=[ProfilerActivity.CPU]):
        index.search(xq, 10)
    before = tracing.spans()
    assert before
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: entered.append(name))
    h = index.search_submit(xq, 10)
    index.search_collect(h)
    assert type(h) is tuple and h[0] == "fused"
    assert entered == [] and tracing.spans() == before
    monkeypatch.undo()
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("only"):
            pass
    assert [s.name for s in tracing.spans()] == ["only"]


def test_chrome_trace_nests_the_program_under_the_caller(indexes, tmp_path):
    index, base, xq = indexes["opq"]
    index.search(xq, 10)
    base._dyn_bucket = None
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("caller"):
            index.search_collect(index.search_submit(xq, 10))
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    caller = next(e for e in events if e["name"] == "caller")
    names = {s.name for s in tracing.spans()}
    mine = [e for e in events if e["name"] in names]
    assert {e["name"] for e in mine} == names
    assert len(mine) == len(tracing.spans())

    def inside(e, outer):
        return (e["tid"] == outer["tid"] and e["ts"] >= outer["ts"]
                and e["ts"] + e["dur"] <= outer["ts"] + outer["dur"])

    assert all(inside(e, caller) for e in mine)
    submit = next(e for e in mine if e["name"] == "IndexPreTransform.search_submit")
    scans = [e for e in mine if e["name"] == "sbbr.scan"]
    assert len(scans) == 2 and all(inside(e, submit) for e in scans)


def test_spans_are_bounded(monkeypatch):
    monkeypatch.setattr(tracing, "MAX_SPANS", 3)
    with tracing.span("unprofiled"):
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(5):
            with tracing.wait(f"w{i}", 4):
                pass
    assert [s.name for s in tracing.spans()] == ["w0", "w1", "w2"]
    assert tracing.dropped() == 2
