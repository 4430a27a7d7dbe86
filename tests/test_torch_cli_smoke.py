"""The README's Quick start commands through the port's ``run_tamp`` script.

Twin of tests/test_cli_smoke.py: each command of ``README.md:48-65`` (the
heijn, boxer, albert and albert push_reach lines included) parses through
``python -m m3p2i_aip_tpu_torch.scripts.run_tamp``'s argv grammar with
``device=cpu``, builds the scene and the planner, settles and ticks once at
a tiny K (in process with a two-step warm-up; the module entry point once,
with the script's own 150).  Without ``device=cpu`` the script runs on the
card, so on a host with no GPU it raises instead of running on the CPU.
"""
import functools
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from m3p2i_aip_tpu_torch.scripts import run_tamp
from m3p2i_aip_tpu_torch.tamp import sim_loop

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_TINY = ["mppi.num_samples=16", "n_steps=1", "device=cpu"]
_TINY_LADDER = _TINY + ["mppi.refine_iters=1"]  # the panda and albert refine ladders, one rung
_COMMANDS = [
    ["task=navigation", "goal=[-3, 3]"],
    ["task=push", "goal=[-1, -1]"],
    ["task=pull", "goal=[0, 0]"],
    ["task=push_pull", "multi_modal=True", "goal=[-3.75, -3.75]"],
    ["task=push_pull", "multi_modal=True", "goal=[-3.75, -3.75]", 'actors=["box"]',
     "initial_actor_positions=[[3.75, 3.75]]"],
    ["-cn", "config_panda"],
    ["-cn", "config_panda", "multi_modal=True", "cube_on_shelf=True"],
    ["-cn", "config_heijn"],
    ["-cn", "config_boxer"],
    ["-cn", "config_albert"],
    ["-cn", "config_albert", "task=push_reach", "goal=[3.0, 0.0, 0.6]"],
]


@pytest.fixture
def short_warmup(monkeypatch):
    monkeypatch.setattr(run_tamp, "run_sim", functools.partial(sim_loop.run_sim, warmup=2))


@pytest.mark.parametrize("argv", _COMMANDS, ids=lambda a: "_".join(a).replace(" ", ""))
def test_readme_command_parses_builds_ticks(argv, capsys, short_warmup):
    ladder = "config_panda" in argv or "config_albert" in argv
    log = run_tamp.main(list(argv) + (_TINY_LADDER if ladder else _TINY))
    assert log.steps == 1
    assert all(np.isfinite(np.asarray(x)).all() for x in log.robot_pos + log.box_pos)
    assert "steps=1 " in capsys.readouterr().out


def test_record_writes_frames(tmp_path, short_warmup):
    pytest.importorskip("matplotlib")
    run_tamp.main(["task=push", "goal=[-1, -1]", f"--record={tmp_path}", "--interactive"] + _TINY)
    assert "frame_00000.png" in os.listdir(tmp_path)


def test_module_entry_point_runs():
    """``python -m m3p2i_aip_tpu_torch.scripts.run_tamp ... device=cpu``."""
    proc = subprocess.run(
        [sys.executable, "-m", "m3p2i_aip_tpu_torch.scripts.run_tamp", "task=navigation", "goal=[-3, 3]"] + _TINY,
        cwd=_REPO, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1].startswith("steps=1 success_step=None")


def test_without_device_cpu_the_script_needs_the_card():
    if torch.cuda.is_available():
        return  # the call would run on the card
    with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
        run_tamp.main(["task=navigation", "goal=[-3, 3]", "mppi.num_samples=16", "n_steps=1"])
