"""A copy of the benchmark's data at a size a CPU test run holds: K=16 x T=4,
three settle steps, two-tick chunks, four-tick episodes checked at ticks 0 and 2,
three seeds a batch.  The copy holds ``BENCHMARK.json`` and
``benchmark/{configs,traffic,limits,metrics,loops,reference}``; the rest of the
harness and the program stay where they are (a reference file of the copy imports
its frozen modules from the repository's ``benchmark.reference.plain``)."""
from __future__ import annotations

import json
import pathlib
import shutil

import benchmark.spec as spec_mod

REPO = pathlib.Path(__file__).resolve().parents[2]


def make(dst: pathlib.Path) -> pathlib.Path:
    (dst / "benchmark").mkdir(parents=True)
    shutil.copy(REPO / "BENCHMARK.json", dst)
    for sub in ("metrics", "limits", "loops", "reference"):
        shutil.copytree(REPO / "benchmark" / sub, dst / "benchmark" / sub,
                        ignore=shutil.ignore_patterns("__pycache__"))
    for sub in ("configs", "traffic"):
        (dst / "benchmark" / sub).mkdir()
    for f in (REPO / "benchmark" / "configs").glob("*.json"):
        c = json.loads(f.read_text())
        c["overrides"] += ["mppi.num_samples=16", "mppi.horizon=4"]
        c["numbers"].update({"mppi.num_samples": 16, "mppi.horizon": 4})
        c["settle_steps"] = 3
        (dst / "benchmark" / "configs" / f.name).write_text(json.dumps(c))
    for f in (REPO / "benchmark" / "traffic").glob("*.json"):
        t = json.loads(f.read_text())
        t.update(chunk=2, episode_ticks=4, warm_seconds=0, check_ticks=[0, 2], checks_per_tick=1, trace_ticks=2)
        if "seeds" in t:
            t["seeds"] = 3
        (dst / "benchmark" / "traffic" / f.name).write_text(json.dumps(t))
    return dst


def run(root: pathlib.Path, monkeypatch, *args: str) -> dict:
    """``run.py``'s line for ``args`` on the CPU over the data under ``root``."""
    from benchmark import run as run_mod

    monkeypatch.setattr(spec_mod, "ROOT", root)
    return run_mod.run([*args, "--device", "cpu"])
