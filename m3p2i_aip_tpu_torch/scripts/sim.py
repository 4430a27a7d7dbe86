"""Actuated sim client: terminal 2 of the reference's two-terminal workflow.

Port of ``scripts/sim.py`` (run_sim:19-58): one real env on the device, a
150-step warm-up, then per tick the dyn-obs motion, ``run_tamp`` and
``get_suction`` over RPC, the real env's suction and step, and soft
real-time pacing.  The warm-up and each tick's step run compiled by default
(the reference jits ``env.step``): the warm-up is 150 replays of one step's
CUDA graph on the card, and a tick is one replay of the client's step
(suction, step and the next tick's dyn-obs motion; :class:`ClientStep`),
whose static outputs hold the views the next ``run_tamp`` sends.  On the
CPU the same bodies run over static buffers; ``--eager`` steps eagerly.
The argv grammar is the planner's plus ``device=`` (``cuda``, the default,
or ``cpu``) and ``--eager``.  Start the planner server first
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

import numpy as np
import torch

from m3p2i_aip_tpu_torch.config.config_store import load_config_from_argv
from m3p2i_aip_tpu_torch.envs import make_env, update_dyn_obs, update_dyn_obs_device
from m3p2i_aip_tpu_torch.scripts.reactive_tamp import PORT
from m3p2i_aip_tpu_torch.scripts.run_tamp import pop_flag, pop_option
from m3p2i_aip_tpu_torch.tamp.graph_tick import EAGER, TickGraphs, TickProgram, clone, copy_into, env_steps
from m3p2i_aip_tpu_torch.tamp.sim_loop import real_suction_ext, real_suction_ext_device
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


def client_views(env, state) -> torch.Tensor:
    """The dof and root views ``run_tamp`` sends, flat in one tensor."""
    return torch.cat([env.dof_state_view(state).reshape(-1), env.root_state_view(state).reshape(-1)])


def client_body(cfg, env):
    """The client's tick after the planner's answer, as a program body:
    carry (env state, tick counter i), inputs (action, suction grant);
    the real env's suction forces and step, then tick i + 1's dyn-obs
    motion (its phase from the device counter, whose sign is
    ``update_dyn_obs``'s); outputs (the state after the step, the views of
    tick i + 1)."""
    def body(carry, inputs):
        state, i = carry
        action, suction = inputs
        state = env.step(state, action, real_suction_ext_device(cfg, env, state, action, suction))
        nxt = update_dyn_obs_device(env, state, i + 1)
        return (nxt, i + 1), (state, client_views(env, nxt))

    return body


class ClientStep:
    """The sim client's compiled tick (key: env type, no seed axis,
    "client", whether the task can pull).  Built after the warm-up: tick
    0's dyn-obs motion is applied here (``update_dyn_obs``) and its views
    made; each call then loads the planner's action and suction grant into
    the step's input buffers and replays it.  The state a call returns is
    the program's static output: read it before the next call."""

    def __init__(self, ticks: TickGraphs, cfg, env, state) -> None:
        self.env = env
        state = update_dyn_obs(env, state, 0)
        counter = torch.zeros((), dtype=torch.int64, device=env.device)
        inputs = (torch.zeros(env.nu, dtype=torch.float32, device=env.device),
                  torch.zeros((), dtype=torch.bool, device=env.device))
        key = (env.env_type, None, "client", cfg.task in ("pull", "push_pull"))
        self.prog = ticks.program(key, lambda: TickProgram(ticks, key, client_body(cfg, env), (state, counter),
                                                           inputs))
        self.prog.load((state, counter), inputs)
        self._views = client_views(env, state)
        self._dof_n = env.dof_state_view(state).numel()
        self._root_shape = tuple(env.root_state_view(state).shape)

    def views(self) -> tuple:
        """This tick's (dof, root) views on the host: one fetch."""
        v = self._views.cpu().numpy()
        return v[: self._dof_n], v[self._dof_n :].reshape(self._root_shape)

    def __call__(self, action, suction: bool):
        """One replay: the real env's suction and step under ``action``,
        then the next tick's dyn-obs motion.  Returns the state after the
        step (a static output)."""
        action_buf, suction_buf = self.prog.inputs
        action_buf.copy_(torch.as_tensor(np.asarray(action, np.float32)))
        suction_buf.fill_(bool(suction))
        self.prog.step()
        self._views = self.prog.outputs[1]
        return self.prog.outputs[0]

    def shove(self, dxy) -> None:
        """Displace the box in the static carry (it commutes with the
        dyn-obs motion already applied) and refresh the views."""
        state, i = self.prog.carry
        copy_into(self.prog.carry, (_shove(self.env, state, dxy), i))
        self._views = client_views(self.env, self.prog.carry[0])


def drive(cfg, planner, n_ticks: int = 10000, pace: bool = True, device="cuda", until: Optional[Callable] = None,
          graphs: Optional[bool] = None):
    """The client's loop against ``planner`` (an ``rpc.Client``, or any
    object with ``run_tamp``, ``get_suction`` and ``get_trajs``): a 150-step
    warm-up, then up to ``n_ticks`` ticks, paced to ``cfg.sim.dt`` when
    ``pace``; it stops early on q or where ``until(env, state)`` holds after
    a step.  ``graphs``: None (the default) compiles the warm-up and each
    tick's step (:class:`ClientStep`), False steps eagerly (the reference's
    order of host calls, and the reference the compiled client equals bit
    for bit).
    Sets ``cfg.suction_active`` from the planner every tick, as the
    reference's client does.  Returns (env, final state, the seconds of
    each tick's ``run_tamp`` round trip, the seconds of each whole tick)."""
    env = make_env(cfg, device)
    ticks = TickGraphs(env.device, graphs)
    zero_u = torch.zeros(env.nu, dtype=torch.float32, device=env.device)
    state = env_steps(ticks, env, env.init_state(), zero_u, env.zero_ext(), 150)
    step = None if ticks.mode == EAGER else ClientStep(ticks, cfg, env, state)
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
                    if step is None:
                        state = _shove(env, state, SHOVE_KEYS[key])
                    else:
                        step.shove(SHOVE_KEYS[key])
            t0 = time.perf_counter()
            if step is None:
                state = update_dyn_obs(env, state, i)
                dof, root = env.dof_state_view(state).cpu().numpy(), env.root_state_view(state).cpu().numpy()
            else:
                dof, root = step.views()
            t1 = time.perf_counter()
            action = planner.run_tamp(dof, root)
            rpc_s.append(time.perf_counter() - t1)
            cfg.suction_active = bool(planner.get_suction())
            if step is None:
                action = torch.as_tensor(action, dtype=torch.float32, device=env.device)
                state = env.step(state, action, real_suction_ext(cfg, env, state, action))
            else:
                state = step(action, cfg.suction_active)
            tick_s.append(time.perf_counter() - t0)
            if show_view and env.env_type == "point_env":
                print("\x1b[2J\x1b[H" + render_point_env(env, state, trajs=planner.get_trajs()))
            if pace:
                t = time_tracking(t, cfg.sim.dt)
            if until is not None and until(env, state):
                break
    return env, clone(state), rpc_s, tick_s


def run_sim(argv) -> None:
    device, argv = pop_option(argv, "device", "cuda")
    eager, argv = pop_flag(argv, "--eager")
    cfg = load_config_from_argv(argv, default_config="config_point")
    planner = rpc.Client().connect("127.0.0.1", PORT)
    print("Server found; warming up")
    try:
        drive(cfg, planner, device=device, graphs=False if eager else None)
    finally:
        planner.close()


if __name__ == "__main__":
    run_sim(sys.argv[1:])
