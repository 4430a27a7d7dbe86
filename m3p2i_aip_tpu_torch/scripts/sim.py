"""Actuated sim client: terminal 2 of the reference's two-terminal workflow.

Port of ``scripts/sim.py`` (run_sim:19-58): one real env on the device, a
150-step warm-up, then per tick the dyn-obs motion, ``run_tamp`` and
``get_suction`` over RPC, the real env's suction and step, and soft
real-time pacing.  The argv grammar is the planner's plus ``device=``
(``cuda``, the default, or ``cpu``).  Start the planner server first
(``m3p2i_aip_tpu_torch.scripts.reactive_tamp``, or the JAX package's), then:

    python -m m3p2i_aip_tpu_torch.scripts.sim task=push goal="[-1, -1]"
    python -m m3p2i_aip_tpu_torch.scripts.sim -cn config_panda

While it runs, i/j/k/l shove the box, v toggles the ASCII view with the
planner's top trajectories (the ``get_trajs`` RPC), q quits; inert when
stdin is not a tty.
"""
from __future__ import annotations

import dataclasses
import sys
import time
from typing import Callable, Optional

import torch

from m3p2i_aip_tpu_torch.config.config_store import load_config_from_argv
from m3p2i_aip_tpu_torch.envs import make_env, update_dyn_obs
from m3p2i_aip_tpu_torch.scripts.reactive_tamp import PORT
from m3p2i_aip_tpu_torch.scripts.run_tamp import pop_option
from m3p2i_aip_tpu_torch.tamp.sim_loop import real_suction_ext
from m3p2i_aip_tpu_torch.utils import rpc
from m3p2i_aip_tpu_torch.utils.render import render_point_env
from m3p2i_aip_tpu_torch.utils.skill_utils import time_tracking
from m3p2i_aip_tpu_torch.utils.teleop import SHOVE_KEYS, KeyboardTeleop


def _shove(env, state, dxy):
    """Displace the box mid-run (play_with_cube's cube dragging)."""
    if "box" not in env.params.actor_names:
        return state
    pos = state.dyn_pos.clone()
    pos[env.box_slot] += torch.as_tensor(dxy, dtype=torch.float32, device=pos.device)
    return dataclasses.replace(state, dyn_pos=pos)


def drive(cfg, planner, n_ticks: int = 10000, pace: bool = True, device="cuda", until: Optional[Callable] = None):
    """The client's loop against ``planner`` (an ``rpc.Client``, or any
    object with ``run_tamp``, ``get_suction`` and ``get_trajs``): a 150-step
    warm-up, then up to ``n_ticks`` ticks, paced to ``cfg.sim.dt`` when
    ``pace``; it stops early on q or where ``until(env, state)`` holds after
    a step.
    Sets ``cfg.suction_active`` from the planner every tick, as the
    reference's client does.  Returns (env, final state, the seconds of
    each tick's ``run_tamp`` round trip, the seconds of each whole tick)."""
    env = make_env(cfg, device)
    state = env.init_state()
    zero_u = torch.zeros(env.nu, dtype=torch.float32, device=env.device)
    for _ in range(150):
        state = env.step(state, zero_u, env.zero_ext())
    rpc_s, tick_s, show_view, t = [], [], False, time.time()
    with KeyboardTeleop() as keys:
        for i in range(n_ticks):
            keys_now = keys.poll()
            if "q" in keys_now:
                break
            for key in keys_now:
                if key == "v":
                    show_view = not show_view
                elif key in SHOVE_KEYS and env.env_type == "point_env":
                    state = _shove(env, state, SHOVE_KEYS[key])
            t0 = time.perf_counter()
            state = update_dyn_obs(env, state, i)
            dof, root = env.dof_state_view(state).cpu().numpy(), env.root_state_view(state).cpu().numpy()
            t1 = time.perf_counter()
            action = planner.run_tamp(dof, root)
            rpc_s.append(time.perf_counter() - t1)
            action = torch.as_tensor(action, dtype=torch.float32, device=env.device)
            cfg.suction_active = bool(planner.get_suction())
            state = env.step(state, action, real_suction_ext(cfg, env, state, action))
            tick_s.append(time.perf_counter() - t0)
            if show_view and env.env_type == "point_env":
                print("\x1b[2J\x1b[H" + render_point_env(env, state, trajs=planner.get_trajs()))
            if pace:
                t = time_tracking(t, cfg.sim.dt)
            if until is not None and until(env, state):
                break
    return env, state, rpc_s, tick_s


def run_sim(argv) -> None:
    device, argv = pop_option(argv, "device", "cuda")
    cfg = load_config_from_argv(argv, default_config="config_point")
    planner = rpc.Client().connect("127.0.0.1", PORT)
    print("Server found; warming up")
    try:
        drive(cfg, planner, device=device)
    finally:
        planner.close()


if __name__ == "__main__":
    run_sim(sys.argv[1:])
