"""``BENCHMARK.json`` against the benchmark's contract, and the harness's
promise that a configuration, a mix, a metric or a cell is added by adding
files and entries alone."""
from __future__ import annotations

import json
import re

import pytest

from benchmark import spec as spec_mod
from benchmark.loops import Loop
from benchmark.tests import tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SPEC = spec_mod.load()
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_keys_and_sizes():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(SPEC).encode()) <= 64 * 1024
    assert 1 <= len(SPEC["paths"]) <= 16 and all(PATH.match(p) and ".." not in p for p in SPEC["paths"])
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    assert 1 <= len(SPEC["configs"]) <= 24 and 1 <= len(SPEC["workloads"]) <= 24
    assert 1 <= len(SPEC["end_to_end"]) <= 16 and 1 <= len(SPEC["per_layer"]) <= 128


def test_names_units_and_lines():
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    for group in (SPEC["configs"], SPEC["workloads"], metrics):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names), names
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher"), m
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock"), m
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0 < m["bound"] <= 0.25 and m["bound"] >= 0.01
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert LINE.match(m["layer"])
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert LINE.match(c["source"]) and LINE.match(c["why"]) and len(c["reduced"]) <= 16
        assert c["file"].startswith("benchmark/configs/")
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4) and LINE.match(w["why"])
    assert "setup_s" in {m["name"] for m in SPEC["end_to_end"]}
    setup = next(m for m in SPEC["end_to_end"] if m["name"] == "setup_s")
    assert "workloads" not in setup


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_has_its_files_and_metrics(cell):
    w = spec_mod.cell(SPEC, cell)
    assert spec_mod.config_file(SPEC, w)["numbers"]
    assert issubclass(spec_mod.loop(spec_mod.traffic(w)["loop"]), Loop)
    assert spec_mod.limits(w)["view_gap"] > 0
    e2e = [m["name"] for m in spec_mod.end_to_end(SPEC, w)]
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = spec_mod.per_layer(SPEC, w)
    assert layer
    for m in spec_mod.end_to_end(SPEC, w) + layer:
        assert callable(spec_mod.reader(m["name"]))


def test_every_metric_moves_an_end_to_end_metric_its_cells_report():
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", CELLS):
            reported = {x["name"] for x in spec_mod.end_to_end(SPEC, spec_mod.cell(SPEC, cell))}
            assert m["moves"] in reported, (m["name"], cell)
    for m in SPEC["end_to_end"]:
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    layers = {}
    for m in SPEC["per_layer"]:
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_at_most_a_quarter_of_the_cells_take_four_chips():
    assert sum(w["chips"] == 4 for w in SPEC["workloads"]) <= max(1, len(CELLS) // 4)


def test_a_cell_a_mix_a_loop_and_a_metric_added_as_files_and_entries(tmp_path, monkeypatch):
    root = tiny.make(tmp_path / "copy")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    (root / "benchmark" / "loops" / "chunked_again.py").write_text(
        "from benchmark import spec\n\n\nclass Again(spec.loop('chunked')):\n    pass\n\n\nLOOP = Again\n")
    mix = json.loads((root / "benchmark" / "traffic" / "chunked.json").read_text())
    mix["episode_ticks"] = 6
    mix["loop"] = "chunked_again"
    (root / "benchmark" / "traffic" / "chunked6.json").write_text(json.dumps(mix))
    (root / "benchmark" / "metrics" / "episodes_done.py").write_text(
        "def read(ctx):\n    return ctx['ticks'] / 6\n")
    spec["workloads"].append({"name": "point-pushpull-chunked6", "config": "point-pushpull", "traffic": "chunked6",
                              "chips": 1, "why": "a longer episode"})
    spec["end_to_end"][0]["workloads"].append("point-pushpull-chunked6")
    spec["per_layer"].append({"name": "episodes_done", "unit": "episodes", "better": "higher",
                              "source": "program_counter", "layer": "tamp.sim_loop", "moves": "tick_rate",
                              "workloads": ["point-pushpull-chunked6"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    (root / "benchmark" / "limits" / "point-pushpull-chunked6.json").write_text('{"view_gap": 1e-4}')
    line = tiny.run(root, monkeypatch, "--workload", "point-pushpull-chunked6", "--seed", "7", "--seconds", "0.1")
    assert line["correct"] and line["attempted"] % 6 == 0 and "tick_rate" in line["metrics"]
    line = tiny.run(root, monkeypatch, "--workload", "point-pushpull-chunked6", "--seed", "7", "--seconds", "0.1",
                    "--trace", "1")
    assert line["metrics"]["episodes_done"]["value"] >= 1
