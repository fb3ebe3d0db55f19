"""The program-span readers (progspans.py) over a fixture with known answers
(fixtures/progspans_small.json): a traced window of 1000 us in which batches
1 and 2 are whole and batch 3 only submits, the program's spans on its own
clock, and the harness's submit stamps, 2 us before each submit#j opens.
On the trace's clock the requests are:

- batch 1: submit root 15-105 (sub-batch 20-100: wait h2d 22-30, scan
  40-60), collect root 250-530 (sub-batch 260-520: waits ndropped 262-268
  and d2h_dist 270-470, id map 480-500);
- batch 2: submit root 135-225 (sub-batch 140-220: h2d 142-150, scan
  160-180), collect root 680-960 (sub-batch 690-950: d2h_dist 700-900, id
  map 910-930);
- batch 3: submit root 565-655 (h2d 570-575), not a traced batch.

The card is busy 25-29, 60-440, 460-468, 572-574 and 890-898 (the harness's
draw at 6-9 is left out): 402 us of the window."""

import copy
import json
from pathlib import Path

import pytest

from portbench import progspans, spec
from portbench.run import Run
from portbench.trace import Trace, normalize
from faiss_tpu_torch.tracing import Span

HERE = Path(__file__).resolve().parent
NAMES = {"ivf_recon_dyn_kernel"}
READERS = ("host_waits_per_batch", "host_busy_ms_per_kq", "idle_in_program_pct")


@pytest.fixture
def fixture():
    with open(HERE / "fixtures" / "progspans_small.json") as f:
        return json.load(f)


def make_run(fx, monkeypatch, shift_us=0.0, dropped=0):
    """A run over the fixture, with ``shift_us`` added to the program's
    clock (its spans and the harness's stamps alike)."""
    spans = [Span(i, p, r, n, a + round(shift_us * 1e3), b + round(shift_us * 1e3), nb)
             for i, p, r, n, a, b, nb in fx["program_spans"]]
    monkeypatch.setattr(progspans, "program_spans", lambda: (spans, dropped))
    batches = [(j, n, t + shift_us * 1e-6, d) for j, n, t, d in fx["batches"]]
    return Run(trace=Trace(normalize(fx["trace"]), NAMES), batches=batches)


@pytest.mark.parametrize("shift_us", [0.0, 7.25e6, -3.5e3])
def test_clock_mapping_under_a_planted_offset(fixture, monkeypatch, shift_us):
    run = make_run(fixture, monkeypatch, shift_us)
    m = progspans.mapped(run)
    assert m.offset_us == pytest.approx(fixture["planted_offset_us"] - shift_us, abs=1e-3)
    assert m.js == [1, 2] and m.queries == 2000
    assert m.worst_us == pytest.approx(0.0, abs=1e-3)
    by_index = {s["index"]: s for s in m.spans}
    assert by_index[11]["ts"] == pytest.approx(270.0, abs=1e-3)
    assert by_index[11]["end"] == pytest.approx(470.0, abs=1e-3)
    assert [by_index[i]["batch"] for i in (0, 4, 8, 13, 15, 17)] == [1, 2, 1, None, 2, 2]
    assert spec.reader("host_waits_per_batch")(run) == pytest.approx(2.5)


def test_the_three_readers(fixture, monkeypatch):
    run = make_run(fixture, monkeypatch)
    # waits: batch 1 h2d, ndropped, d2h_dist; batch 2 h2d, d2h_dist
    assert spec.reader("host_waits_per_batch")(run) == pytest.approx(2.5)
    # roots 90 + 90 + 280 + 280 us less waits 8 + 6 + 200 + 8 + 200 us, over
    # 2000 queries
    assert spec.reader("host_busy_ms_per_kq")(run) == pytest.approx(0.318 / 2)
    # idle while in a traced root: 15-25, 29-60, 440-460, 468-530, 680-890,
    # 898-960 us
    assert spec.reader("idle_in_program_pct")(run) == pytest.approx(39.5)
    assert spec.reader("device_idle_pct")(run) == pytest.approx(59.8)
    assert len(run.notes) == 1 and "every root within 0.000 us" in run.notes[0]


def test_the_per_span_table(fixture, monkeypatch):
    run = make_run(fixture, monkeypatch)
    tab = progspans.mapped(run).table()
    # per 1000 queries: us / 2000 q = ms / 1000 q * 2
    want = {  # name: count per batch, self, waits, device, idle (us)
        "IndexRefine.search_submit": (1, 20, 16, 0, 0),
        "sbbr.sub_batch": (1, 104, 16, 0, 0),
        "sbbr.h2d": (1, 16, 16, 8, 31),
        "sbbr.scan": (1, 40, 0, 380, 0),
        "IndexRefine.search_collect": (1, 40, 406, 0, 0),
        "collect.sub_batch": (1, 74, 406, 0, 0),
        "collect.ndropped": (0.5, 6, 6, 0, 0),
        "collect.d2h_dist": (1, 400, 400, 16, 226),
        "collect.id_map": (1, 40, 0, 0, 0),
        progspans.OUTSIDE: (0, 0, 0, 2, 341),
    }
    assert set(tab) == set(want)
    for name, (n, *us) in want.items():
        assert tab[name][0] == pytest.approx(n), name
        assert tab[name][1:] == pytest.approx([u * 1e-3 / 2 for u in us], abs=1e-9), name
    assert sum(r[4] for r in tab.values()) == pytest.approx(0.598 / 2)
    text = run.notes[0] if run.notes else progspans.mapped(run).describe()
    assert "collect.d2h_dist" in text and "(ms per 1000 queries)" in text


@pytest.mark.parametrize("end_us,maps", [(695.0, True), (720.0, False)])
def test_a_root_outside_its_harness_span(fixture, monkeypatch, end_us, maps):
    """Batch 3's submit root ends past submit#3 (560-660 us) by 35 us, inside
    the tolerance, or by 60 us, outside it: then every reader finds
    nothing and the note says why."""
    fx = copy.deepcopy(fixture)
    row = next(r for r in fx["program_spans"] if r[0] == 13)
    row[5] += round((end_us - 655.0) * 1e3)
    run = make_run(fx, monkeypatch)
    values = [spec.reader(n)(run) for n in READERS]
    if maps:
        assert None not in values
        assert progspans.mapped(run).worst_us == pytest.approx(end_us - 660.0, abs=1e-3)
    else:
        assert values == [None] * 3
        assert len(run.notes) == 1
        assert "60.000 us outside submit#3" in run.notes[0]


def test_nothing_to_read(fixture, monkeypatch):
    """No trace, a program that records no spans (one older than
    tracing.py) and a session that dropped spans: the readers find nothing
    and do not raise."""
    assert all(spec.reader(n)(Run(trace=None, batches=[])) is None for n in READERS)
    run = make_run(fixture, monkeypatch)
    monkeypatch.setattr(progspans, "program_spans", lambda: None)
    assert all(spec.reader(n)(run) is None for n in READERS)
    assert run.notes == []
    run = make_run(fixture, monkeypatch, dropped=3)
    assert all(spec.reader(n)(run) is None for n in READERS)
    assert "dropped 3 spans" in run.notes[0]
