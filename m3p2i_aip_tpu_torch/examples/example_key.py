"""Teleop of the point env: a scripted drive, or a live keyboard drive.

Port of ``examples/example_key.py``: the reference drives one env with the
keyboard (isaacgym_wrapper.py:439-460, WASD -> +/-2 velocity) and optionally
demos suction.  By default the same velocity commands are scripted and the
ASCII view printed every 15 steps; ``--interactive`` reads w/a/s/d (drive),
space (stop), x (toggle suction) and q (quit) from a raw-mode terminal,
with the ASCII view as the live viewer.

    python -m m3p2i_aip_tpu_torch.examples.example_key [--suction] [--interactive] [device=cuda|cpu]
"""
from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch

from m3p2i_aip_tpu_torch.config.config_store import load_config
from m3p2i_aip_tpu_torch.envs import make_env
from m3p2i_aip_tpu_torch.scripts.run_tamp import pop_option
from m3p2i_aip_tpu_torch.utils import skill_utils
from m3p2i_aip_tpu_torch.utils.render import render_point_env

# the keyboard_control velocity map (isaacgym_wrapper.py:439-460)
_DRIVE = {"up": (0.0, 2.0), "down": (0.0, -2.0), "left": (-2.0, 0.0), "right": (2.0, 0.0)}
_KEYS = {"w": (0.0, 2.0), "s": (0.0, -2.0), "a": (-2.0, 0.0), "d": (2.0, 0.0), " ": (0.0, 0.0)}
SCRIPT = ["up"] * 30 + ["right"] * 20 + ["down"] * 25 + ["left"] * 20


def _suction_ext(env, cfg, state, robot_pos):
    """The real env's suction forces (threshold 1.5) between box and robot."""
    ext = env.zero_ext()
    f_box, f_robot = skill_utils.calculate_suction(state.dyn_pos[env.box_slot], robot_pos, float(cfg.kp_suction), 1.5)
    dyn = ext.dyn.clone()
    dyn[env.box_slot] = f_box
    return dataclasses.replace(ext, robot=f_robot, dyn=dyn)


def interactive(device) -> None:
    """Keyboard teleop in the terminal (``utils/teleop.KeyboardTeleop``): the
    reference's keyboard_control, paced to real time, the ASCII view redrawn
    every step."""
    import time

    from m3p2i_aip_tpu_torch.utils.teleop import KeyboardTeleop

    cfg = load_config("config_point")
    env = make_env(cfg, device)
    state = env.init_state()
    u = torch.zeros(2, dtype=torch.float32, device=device)
    suction_on = False
    with KeyboardTeleop() as keys:
        if not keys.active:
            print("stdin is not a terminal: run from an interactive shell")
            return
        print("teleop: w/a/s/d drive, space stop, x suction, q quit")
        t = time.time()
        while True:
            for key in keys.poll():
                if key == "q":
                    return
                if key == "x":
                    suction_on = not suction_on
                if key in _KEYS:
                    u = torch.tensor(_KEYS[key], dtype=torch.float32, device=device)
            ext = _suction_ext(env, cfg, state, state.q[:2]) if suction_on else env.zero_ext()
            state = env.step(state, u, ext)
            t = skill_utils.time_tracking(t, cfg.sim.dt)
            sys.stdout.write("\x1b[2J\x1b[H")
            print(f"u={u.cpu().numpy()} suction={'ON' if suction_on else 'off'}"
                  f"  robot={np.round(state.q.cpu().numpy(), 2)}  (q quits)")
            print(render_point_env(env, state))


def main(argv) -> object:
    """The scripted drive (or, with ``--interactive``, the live one); returns
    the final env state of the scripted drive."""
    device, argv = pop_option(argv, "device", "cuda")
    if "--interactive" in argv:
        return interactive(device)
    cfg = load_config("config_point")
    env = make_env(cfg, device)
    state = env.init_state()
    for i, key in enumerate(SCRIPT):
        u = torch.tensor(_DRIVE[key], dtype=torch.float32, device=device)
        ext = _suction_ext(env, cfg, state, state.q) if "--suction" in argv else env.zero_ext()
        state = env.step(state, u, ext)
        if i % 15 == 0:
            print(f"step {i:3d} key={key:5s} robot={np.round(state.q.cpu().numpy(), 2)}")
            print(render_point_env(env, state))
    return state


if __name__ == "__main__":
    main(sys.argv[1:])
