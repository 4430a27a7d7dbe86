"""Single-process reactive TAMP: the planner and the actuated sim ticking in
one process on one device (the one-process replacement of the reference's
two terminals).

Port of ``scripts/run_tamp.py``, with the same argv grammar (the config
overrides and ``-cn NAME`` of ``load_config_from_argv``, ``--interactive``
and ``--record=DIR``) plus ``device=`` (``cuda``, the default, or ``cpu``)
and ``--eager``: each tick runs compiled by default (one replay of a CUDA
graph on the card, ``tamp/graph_tick.py``), eagerly with ``--eager``.
Run from the repository root:

    python -m m3p2i_aip_tpu_torch.scripts.run_tamp task=navigation goal="[-3, 3]"
    python -m m3p2i_aip_tpu_torch.scripts.run_tamp task=push goal="[-1, -1]"
    python -m m3p2i_aip_tpu_torch.scripts.run_tamp task=push_pull multi_modal=True goal="[-3.75, -3.75]"
    python -m m3p2i_aip_tpu_torch.scripts.run_tamp -cn config_panda multi_modal=True cube_on_shelf=True
    python -m m3p2i_aip_tpu_torch.scripts.run_tamp -cn config_albert task=push_reach goal="[3.0, 0.0, 0.6]"

``--interactive`` lets a human disturb the scene while the planner runs
(i/j/k/l shove the box or cubeA, v toggles a live ASCII view with the
planned trajectories, q quits).  ``--record=DIR`` writes the run's frames
and a GIF to DIR (point family only; needs matplotlib).
"""
from __future__ import annotations

import sys

import numpy as np

from m3p2i_aip_tpu_torch.config.config_store import load_config_from_argv
from m3p2i_aip_tpu_torch.envs import make_env
from m3p2i_aip_tpu_torch.tamp.sim_loop import run_sim
from m3p2i_aip_tpu_torch.utils.render import save_frames


def pop_option(argv, key: str, default):
    """``key=value`` taken out of ``argv``: (value or ``default``, the rest)."""
    value, rest = default, []
    for a in argv:
        if a.startswith(key + "="):
            value = a.split("=", 1)[1]
        else:
            rest.append(a)
    return value, rest


def pop_flag(argv, flag: str):
    """Whether ``flag`` (``--eager``) is in ``argv``, and the rest."""
    return flag in argv, [a for a in argv if a != flag]


def main(argv):
    """Parse, build on the device and run until success or ``n_steps``;
    prints the run's summary line and returns its TickLog."""
    device, argv = pop_option(argv, "device", "cuda")
    record, argv = pop_option(argv, "--record", None)
    eager, argv = pop_flag(argv, "--eager")
    cfg = load_config_from_argv(argv, default_config="config_point")
    log = run_sim(cfg, verbose=True, interactive="--interactive" in argv, device=device,
                  graphs=False if eager else None)
    n = max(1, len(log.replan_s))
    print(
        f"steps={log.steps} success_step={log.success_step} collisions={log.collisions} "
        f"replan_hz={1.0 / max(sum(log.replan_s) / n, 1e-9):.1f} sim_hz={1.0 / max(sum(log.sim_s) / n, 1e-9):.1f}"
    )
    if record:
        print(f"frames -> {save_frames(make_env(cfg, device), log, record, goal=np.asarray(cfg.goal, float))}")
    return log


if __name__ == "__main__":
    main(sys.argv[1:])
