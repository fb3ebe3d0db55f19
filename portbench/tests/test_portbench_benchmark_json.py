"""BENCHMARK.json keeps the contract's shape and charset, and every name in
it finds its files."""

import json
import re
from pathlib import Path

import pytest

from portbench import spec

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_text():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [m["name"] for m in metrics]
    names += [c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert TEXT.match(w["why"]) and w["chips"] in (1, 4)
    for c in BENCH["configs"]:
        assert TEXT.match(c["source"]) and TEXT.match(c["why"])
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
    for m in metrics:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert TEXT.match(m["layer"])
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        if "roofline" in m["name"]:
            assert m["name"].endswith("_roofline") and m["unit"] == "%"
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_finds_its_files(name):
    cell = spec.load_cell(name)
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    for m in cell.end_to_end + cell.per_layer:
        assert callable(spec.reader(m["name"]))
    assert spec.generator(cell.config["data"]["generator"])
    assert cell.limits["dist_err_max"] > 0
    assert 0 < cell.config["guarantees"]["recall1_at_10_min"] <= 1


def test_configs_are_used_and_have_files_of_their_own():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("portbench/") and (ROOT / c["file"]).is_file()


def test_a_full_check_fits_its_time():
    n = 24  # the most cells the benchmark may ever hold
    total = (2 + 14 * n) * (BENCH["run_seconds"] + 60) + n * 2 * 90 + 1200
    assert total <= 43200


def test_four_chip_cells_are_few():
    fours = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert fours <= max(1, len(BENCH["workloads"]) // 4)
