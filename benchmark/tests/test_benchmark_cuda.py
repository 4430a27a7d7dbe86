"""On the card (``M3P2I_TEST_CUDA=1``): a short run of each cell is
correct at its own size, and the bf16 control of each is not.

    M3P2I_TEST_CUDA=1 python -m pytest benchmark/tests/test_benchmark_cuda.py -q
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from benchmark import spec as spec_mod
from benchmark.tests.tiny import REPO

CELLS = [w["name"] for w in spec_mod.load()["workloads"]]


@pytest.fixture
def card():
    if os.environ.get("M3P2I_TEST_CUDA", "") != "1":
        pytest.skip("the benchmark's card tests run with M3P2I_TEST_CUDA=1")
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")


def _last_json(cmd: list) -> dict:
    out = subprocess.run([sys.executable, *cmd], cwd=REPO, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_is_correct(card, cell):
    line = _last_json(["benchmark/run.py", "--workload", cell, "--seed", "2147483647", "--seconds", "3"])
    assert line["correct"] and line["device"]["platform"] == "gpu"


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_bf16_control_is_not_correct(card, cell):
    out = _last_json(["benchmark/control.py", "--workload", cell, "--seeds", "5", "--control-seeds", "5",
                      "--seconds", "2", "--precisions", "bf16"])
    limit = spec_mod.limits(spec_mod.cell(spec_mod.load(), cell))["view_gap"]
    assert out["upper"]["bf16"] > limit >= out["lower"]


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [2147483701, 2147483702, 2147483703])
def test_half_the_batch_at_b20_is_not_correct(card, seed, monkeypatch, capsys):
    """The later half of the 20 seeds' view rows zeroed where the batched
    chunk produces them (the CPU tests' fault), at the cell's own size."""
    from benchmark import run as run_mod
    from benchmark.loops import Loop
    from benchmark.tests.test_benchmark_reference import _half_the_batch

    _half_the_batch(monkeypatch)
    monkeypatch.setattr(Loop, "warm", lambda self: None)
    line = run_mod.run(["--workload", "point-pushpull-batch20", "--seed", str(seed), "--seconds", "3"])
    with capsys.disabled():
        print(f"half the batch, seed {seed}: {line['checked']}, {line['failed']} of {line['ticks_checked']} failed")
    assert not line["correct"] and line["failed"] >= 1
