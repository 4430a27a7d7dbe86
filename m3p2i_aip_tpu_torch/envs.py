"""Environment construction for the point family, the panda and the albert,
in torch.

Port of ``m3p2i_aip_tpu/envs.py``: the per-actor YAMLs are packed into
tensors on one device once, and the scene is exposed as a bundle of functions
closed over those params.  The K rollouts' plain version and the real system
share one step function (a leading K axis vs none); on a card the point
family's and the panda's real systems step in one launch of their kernels
(``ops/point_step.py``, ``ops/panda_step.py``), bit for bit that function.
The Isaac-layout views (an interleaved dof state, a root state [A, 13]) and
their loaders carry one real state over the two-terminal RPC boundary
(``tamp/reactive_tamp.py`` ``ReactiveTAMPServer``).
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Callable

import numpy as np
import torch

from m3p2i_aip_tpu_torch.models import albert, panda_env, panda_fk, point_env
from m3p2i_aip_tpu_torch.ops import panda_step, point_step
from m3p2i_aip_tpu_torch.ops.quat import mat_to_quat, quat_from_yaw
from m3p2i_aip_tpu_torch.sim.sim_config import load_env_cfgs

_POINT_ENVS = ("point_env", "heijn_env", "boxer_env")


@dataclass
class Env:
    """A scene as a bundle of functions (all closed over the params)."""

    env_type: str
    params: Any
    nu: int  # action dimension
    nx: int  # interleaved dof-state dimension
    step: Callable  # (state, u, ext) -> state
    init_state: Callable  # () -> state
    zero_ext: Callable  # (batch=()) -> ext
    dof_state_view: Callable  # (state) -> [nx]
    load_dof_state: Callable  # (state, dof) -> state
    root_state_view: Callable  # (state) -> [A, 13]
    load_root_state: Callable  # (state, root) -> state
    view: Callable  # (state) -> dict for the host-side task planner (syncs)
    view_vec: Callable  # (state) -> packed [V] device tensor (no sync)
    view_unpack: Callable  # ([V] host array) -> same dict as `view`
    traj_point: Callable  # (state) -> [..., 2] point for trajectory views
    dyn_obs_slot: int = -1  # index into the dynamic-body arrays for "dyn-obs"
    box_slot: int = -1  # index into the dynamic-body arrays for "box"
    dyn_obs_step: Any = None  # [D, 2] tensor: +0.01 on the dyn-obs row

    @property
    def device(self) -> torch.device:
        return self.params.device


def make_env(cfg, device="cuda") -> Env:
    """Build the scene named by ``cfg.env_type`` on ``device``, with the
    ``actors`` / ``initial_actor_positions`` spawn overrides and the
    ``fric_noise`` shorthand (``m3p2i_aip_tpu/envs.py:46``)."""
    if cfg.env_type not in _POINT_ENVS + ("panda_env", "albert_env"):
        raise ValueError(f"unknown env_type {cfg.env_type!r}")
    actors = load_env_cfgs(cfg.env_type)
    for name, pos in zip(cfg.actors, cfg.initial_actor_positions):
        hits = [a for a in actors if a.name == name]
        if not hits:
            raise ValueError(f"initial_actor_positions: no actor named {name!r} in {cfg.env_type}")
        p = list(map(float, pos))
        hits[0].init_pos = p + hits[0].init_pos[len(p):]
    if float(getattr(cfg, "fric_noise", 0.0)) > 0.0:
        for a in actors:
            if not a.fixed and a.type != "robot":
                a.noise_percentage_friction = float(cfg.fric_noise)
    if cfg.env_type == "panda_env":
        return _make_panda_env(cfg, actors, device)
    if cfg.env_type == "albert_env":
        return _make_albert_env(cfg, actors, device)
    return _make_point_env(cfg, actors, device)


def dof_state_view(state):
    """The Isaac-layout dof state of every family: ``q`` and ``qd``
    interleaved, [q0, qd0, q1, qd1, ...] (``point_env.py:576``,
    ``panda_env.py:446``, ``albert.py:199``)."""
    return torch.stack([state.q, state.qd], dim=-1).flatten(-2)


def load_dof_state(state, dof):
    """``q`` and ``qd`` of ``state`` from an interleaved dof state."""
    pairs = dof.unflatten(-1, (state.q.shape[-1], 2))
    return replace(state, q=pairs[..., 0], qd=pairs[..., 1])


def _domain_rng(cfg, actors):
    """Seeded RNG when any actor requests friction/size randomization."""
    wants = any(a.noise_percentage_friction or a.noise_sigma_size for a in actors)
    return np.random.default_rng(cfg.mppi.seed_val) if wants else None


def _make_point_env(cfg, actors, device) -> Env:
    params = point_env.build_params(actors, cfg.sim, rng=_domain_rng(cfg, actors), device=device)
    names = list(params.actor_names)
    box_slot = params.dyn_actor_idx.index(names.index("box")) if "box" in names else 0
    dynobs_slot = params.dyn_actor_idx.index(names.index("dyn-obs")) if "dyn-obs" in names else -1
    dynobs_actor = params.dyn_actor_idx[dynobs_slot] if dynobs_slot >= 0 else 0
    D = params.dyn_half.shape[0]
    dyn_obs_step = torch.zeros(D, 2, dtype=torch.float32, device=params.device)
    if dynobs_slot >= 0:
        dyn_obs_step[dynobs_slot] = 0.01

    def view_vec(state):
        """The planner observations packed into ONE small device tensor:
        [robot_pos(2), robot_vel(2), box_pos(2), box_quat(4), dynobs_contact(1)]."""
        cf = torch.sum(torch.abs(state.contact_force[..., dynobs_actor, :2]), dim=-1)
        return torch.cat(
            [
                state.q[..., :2],
                state.qd[..., :2],
                state.dyn_pos[..., box_slot, :],
                quat_from_yaw(state.dyn_yaw[..., box_slot]),
                cf[..., None],
            ],
            dim=-1,
        )

    def view_unpack(vec) -> dict:
        vec = np.asarray(vec)
        return {
            "robot_pos": vec[0:2],
            "robot_vel": vec[2:4],
            "box_pos": vec[4:6],
            "box_quat": vec[6:10],
            "dynobs_contact": float(vec[10]),
        }

    def view(state):
        return view_unpack(view_vec(state).cpu().numpy())

    return Env(
        env_type="point_env",  # planner-facing family; the robot varies via params
        params=params,
        nu=point_env.robot_nu(params),
        nx=2 * point_env.robot_nq(params),
        step=point_step.make_step(params),  # one kernel launch on a card
        init_state=lambda: point_env.init_state(params),
        zero_ext=lambda batch=(): point_env.zero_ext(params, batch),
        dof_state_view=dof_state_view,
        load_dof_state=load_dof_state,
        root_state_view=lambda s: point_env.root_state_view(params, s),
        load_root_state=lambda s, r: point_env.load_root_state(params, s, r),
        view=view,
        view_vec=view_vec,
        view_unpack=view_unpack,
        traj_point=lambda s: s.q[..., :2],
        dyn_obs_slot=dynobs_slot,
        box_slot=box_slot,
        dyn_obs_step=dyn_obs_step,
    )


def _make_panda_env(cfg, actors, device) -> Env:
    """The panda scene (``m3p2i_aip_tpu/envs.py:218``).  Its dyn-obs plate
    never moves (the reference's panda offsets are zero), so the scene has
    no dyn-obs slot for ``update_dyn_obs_device``."""
    params = panda_env.build_params(actors, cfg.sim, cube_on_shelf=cfg.cube_on_shelf, device=device)

    def view_vec(state):
        """The AIF planner's observations in ONE device tensor:
        [cube_state(7), cube_goal(7), ee_state(7), attached(1)]."""
        links = panda_fk.fk(state.q, params.base_pos)
        lf_pos, lf_rot = links["leftfinger"]
        ee_pos = (lf_pos + links["rightfinger"][0]) / 2.0
        return torch.cat(
            [
                state.body_pos[..., 1, :],
                state.body_quat[..., 1, :],
                state.body_pos[..., 2, :],
                state.body_quat[..., 2, :],
                ee_pos,
                mat_to_quat(lf_rot),
                state.attached[..., None],
            ],
            dim=-1,
        )

    def view_unpack(vec) -> dict:
        vec = np.asarray(vec)
        return {
            "cube_state": vec[0:7],
            "cube_goal": vec[7:14],
            "ee_state": vec[14:21],
            "attached": float(vec[21]),
        }

    def view(state):
        return view_unpack(view_vec(state).cpu().numpy())

    return Env(
        env_type="panda_env",
        params=params,
        nu=9,
        nx=18,
        step=panda_step.make_step(params),  # one kernel launch on a card
        init_state=lambda: panda_env.init_state(params),
        zero_ext=lambda batch=(): panda_env.zero_ext(params, batch),
        dof_state_view=dof_state_view,
        load_dof_state=load_dof_state,
        root_state_view=lambda s: panda_env.root_state_view(params, s),
        load_root_state=lambda s, r: panda_env.load_root_state(params, s, r),
        view=view,
        view_vec=view_vec,
        view_unpack=view_unpack,
        traj_point=lambda s: panda_fk.fk(s.q, params.base_pos)["ee"][0][..., :2],
    )


def _make_albert_env(cfg, actors, device) -> Env:
    """The albert mobile manipulator (``m3p2i_aip_tpu/envs.py:162``): a
    diff-drive base + panda arm, with a pushable box when the scene ships
    one.  It takes no external forces and has no dyn-obs."""
    params = albert.build_params(actors, cfg.sim, device=device)

    def view_vec(state):
        """[base_pose(3), base_vel(3), ee_pos(3), box_pos(2)] in one device
        tensor (the box rows park at 1e3 in a boxless scene)."""
        ee_pos = albert.fk(state)["ee"][0]
        return torch.cat([state.q[..., :3], state.qd[..., :3], ee_pos, state.box_pos], dim=-1)

    def view_unpack(vec) -> dict:
        vec = np.asarray(vec)
        return {
            "robot_pos": vec[0:2],
            "robot_yaw": float(vec[2]),
            "robot_vel": vec[3:5],
            "ee_pos": vec[6:9],
            "box_pos": vec[9:11],
        }

    def view(state):
        return view_unpack(view_vec(state).cpu().numpy())

    # the base moves in the dofs and the box is not an Isaac actor here: one
    # constant identity root, and loading a root changes nothing
    root = torch.zeros(1, 13, dtype=torch.float32, device=params.device)
    root[0, 6] = 1.0

    return Env(
        env_type="albert_env",
        params=params,
        nu=13,
        nx=24,
        step=lambda s, u, e: albert.step(params, s, u),
        init_state=lambda: albert.init_state(params),
        zero_ext=lambda batch=(): albert.zero_ext(batch, params.device),
        dof_state_view=dof_state_view,
        load_dof_state=load_dof_state,
        root_state_view=lambda s: root,
        load_root_state=lambda s, r: s,
        view=view,
        view_vec=view_vec,
        view_unpack=view_unpack,
        traj_point=lambda s: s.q[..., :2],
    )


def update_dyn_obs_device(env: Env, state, i, period: int = 100):
    """Oscillate the dynamic obstacle by +-[0.01, 0.01] per tick in a square
    wave (``isaacgym_wrapper.py:205-220``).  ``i`` is the tick index: a host
    int (the eager tick: the phase costs no device round trip), or an int64
    device scalar (the compiled tick's counter: a graph replays the sign of
    the tick it runs, never the one it was captured at).  Both compare the
    phase with the same integer bounds, so the sign is the same."""
    if env.dyn_obs_slot < 0:
        return state
    phase = i % period
    if torch.is_tensor(i):
        sign = torch.where((period // 4 < phase) & (phase < 3 * period // 4), 1.0, -1.0)
    else:
        sign = 1.0 if (period // 4 < phase < 3 * period // 4) else -1.0
    return replace(state, dyn_pos=state.dyn_pos + sign * env.dyn_obs_step)


def update_dyn_obs(env: Env, state, i: int, period: int = 100):
    """The host twin of :func:`update_dyn_obs_device`
    (``m3p2i_aip_tpu/envs.py:291``, the sim client's per-tick call): the
    same square wave, its half-period edges compared in float as the
    reference compares them."""
    if env.dyn_obs_slot < 0:
        return state
    sign = 1.0 if (period / 4 < i % period < 3 * period / 4) else -1.0
    return replace(state, dyn_pos=state.dyn_pos + sign * env.dyn_obs_step)


def command_world_vel(params, q, action):
    """World-frame commanded base velocity of a point-family robot (the
    suction alignment gate): wheel speeds go through the diff-drive FK for
    the boxer; point/heijn actions are already world velocities."""
    if params.robot_type == "boxer":
        v = params.wheel_radius * (action[..., 0] + action[..., 1]) * 0.5
        return v[..., None] * torch.stack([torch.cos(q[..., 2]), torch.sin(q[..., 2])], dim=-1)
    return action[..., :2]
