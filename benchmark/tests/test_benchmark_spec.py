"""``BENCHMARK.json`` against the benchmark's contract, and the harness's
promise that a configuration, a mix, a metric or a cell is added by adding
files and entries alone."""
from __future__ import annotations

import hashlib
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
    cfg_file = spec_mod.config_file(SPEC, w)
    assert cfg_file["numbers"]
    ref = spec_mod.reference(cfg_file["reference"])
    assert isinstance(ref.Scene, type) and callable(ref.bounds)
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


def _hashes(root) -> dict:
    return {p: hashlib.sha256(p.read_bytes()).hexdigest() for p in sorted(root.rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts and p.name != "BENCHMARK.json"}


def test_a_cell_a_mix_a_loop_and_a_metric_added_as_files_and_entries(tmp_path, monkeypatch):
    """Two cells added: one on a configuration that is there, and one on a
    configuration that names a reference of its own, written here, which
    reports a bound kind of its own that a new metric reads.  No file that
    was there changes, ``BENCHMARK.json`` aside, which gains entries."""
    root = tiny.make(tmp_path / "copy")
    before, harness = _hashes(root), _hashes(tiny.REPO / "benchmark")
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

    (root / "benchmark" / "reference" / "tick_doubled.py").write_text(
        "from benchmark.reference import tick\n\nScene = tick.Scene\n\n\n"
        "def bounds(scene, seeds_per_tick):\n    out = tick.bounds(scene, seeds_per_tick)\n"
        "    out['doubled_rollout'] = [2 * b for b in out['rollout']]\n    return out\n")
    cfg = json.loads((root / "benchmark" / "configs" / "point-pushpull.json").read_text())
    cfg["reference"] = "tick_doubled"
    (root / "benchmark" / "configs" / "point-pushpull-doubled.json").write_text(json.dumps(cfg))
    (root / "benchmark" / "metrics" / "doubled_rollout_ms.py").write_text(
        "import statistics\n\n\ndef read(ctx):\n    b = ctx['bounds'].get('doubled_rollout')\n"
        "    return statistics.median(b) if b else None\n")
    spec["configs"].append({"name": "point-pushpull-doubled", "source": "https://github.com/tud-amr/m3p2i-aip",
                            "file": "benchmark/configs/point-pushpull-doubled.json", "reduced": [],
                            "why": "the point configuration under a reference of its own"})
    spec["workloads"].append({"name": "point-pushpull-doubled-chunked6", "config": "point-pushpull-doubled",
                              "traffic": "chunked6", "chips": 1, "why": "a configuration with its own reference"})
    spec["end_to_end"][0]["workloads"].append("point-pushpull-doubled-chunked6")
    spec["per_layer"].append({"name": "doubled_rollout_ms", "unit": "ms", "better": "lower",
                              "source": "program_counter", "layer": "csrc kernels", "moves": "tick_rate",
                              "workloads": ["point-pushpull-doubled-chunked6"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    (root / "benchmark" / "limits" / "point-pushpull-doubled-chunked6.json").write_text('{"view_gap": 1e-4}')
    line = tiny.run(root, monkeypatch, "--workload", "point-pushpull-doubled-chunked6", "--seed", "8",
                    "--seconds", "0.1", "--trace", "1")
    assert line["correct"] and line["metrics"]["doubled_rollout_ms"]["value"] > 0
    after = _hashes(root)
    assert {p: after[p] for p in before} == before and _hashes(tiny.REPO / "benchmark") == harness
    assert len(after) == len(before) + 8  # a loop, a mix, a reference, a configuration, two metrics, two limits
