"""REACTIVE_TAMP orchestrator, point family: task planner + objective + M3P2I.

Port of the point parts of ``m3p2i_aip_tpu/tamp/reactive_tamp.py``.  One
control tick is dyn-obs motion, a K-sample replan, the real-env suction
decision and the real-env step, all as tensor work on one device; a chunk
runs ``length`` ticks with no host sync inside and returns the per-tick
observation views in one tensor.  The success gate inside a chunk is a
device-side done latch that freezes the planner and real-env state with
``torch.where`` (``_run_chunk_impl``), so chunked task times equal per-tick
task times.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from m3p2i_aip_tpu_torch.envs import Env, command_world_vel, make_env, update_dyn_obs_device
from m3p2i_aip_tpu_torch.ops.rollout import make_point_rollout
from m3p2i_aip_tpu_torch.planners.motion_planner.cost_functions import PointObjective
from m3p2i_aip_tpu_torch.planners.motion_planner.m3p2i import M3P2I
from m3p2i_aip_tpu_torch.planners.motion_planner.mppi import TaskParams, make_task_params
from m3p2i_aip_tpu_torch.planners.task_planner.task_planner import set_task_planner
from m3p2i_aip_tpu_torch.utils import skill_utils
from m3p2i_aip_tpu_torch.utils.tree import tree_where


def build_task_planner(cfg, env: Env, objective: PointObjective):
    """The host-side symbolic planner of one seeded run, with the pocket-
    endgame latches armed from the scene's arena (reactive_tamp.py:58)."""
    tp = set_task_planner(cfg)
    p = env.params
    if p.arena_bound > 0.0 and hasattr(tp, "configure_pocket_endgame"):
        half_x = float(p.dyn_half[objective.box_dyn_slot, 0])
        tp.configure_pocket_endgame(
            float(p.arena_bound) - 2.0 * float(p.robot_radius) - half_x,
            proximity_latch=(p.robot_type == "boxer"),
            min_clearance=float(p.robot_radius) + half_x + 0.1,
        )
    return tp


class ReactiveTAMP:
    def __init__(self, cfg, env: Optional[Env] = None, device="cpu") -> None:
        self.device = torch.device(device)
        if self.device.type == "cuda":
            # fp32 throughout: no TF32 in matmuls or convolutions
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.cfg = cfg
        self.env = env if env is not None else make_env(cfg, self.device)
        if self.env.env_type != "point_env":
            raise NotImplementedError(
                f"env_type {self.env.env_type!r} is not ported yet: see ROADMAP.md Queue 1"
            )
        self.objective = PointObjective.from_cfg(self.env.params, cfg)
        self.task_planner = build_task_planner(cfg, self.env, self.objective)
        self.task_success = False

        # per-sample friction randomization: active when an actor YAML sets
        # noise_percentage_friction > 0
        noise = self.env.params.dyn_fric_noise.cpu().numpy()
        rollout = make_point_rollout(
            self.env.params,
            float(cfg.kp_suction),
            cfg.mppi.num_samples,
            cfg.mppi.horizon,
            bool(cfg.multi_modal),
            boxer_continuous_align=bool(cfg.mppi.boxer_continuous_align),
        )
        self.motion_planner = M3P2I(
            cfg, rollout, fric_noise=noise if np.any(noise) else None, device=self.device
        )
        self.mppi_state = self.motion_planner.init_state()
        # on-device success gate for chunks (False = benchmark mode: every
        # tick replans regardless of goal distance)
        self.device_gate = True
        self._tp_key = None
        self._tp_cached: Optional[TaskParams] = None

    # ------------------------------------------------------------------ api
    def tamp_interface_view(self, view: dict) -> TaskParams:
        """Update plan -> gripper -> success on a host observation dict, and
        return the (cached) device TaskParams.  Parity: tamp_interface
        (reactive_tamp.py:75-81)."""
        self.task_planner.update_plan(view)
        self.motion_planner.update_gripper_command(self.task_planner.task)
        self.task_success = self.task_planner.check_task_success(view)
        zup = float(getattr(self.task_planner, "zup_gate", 0.0))
        # the symbolic plan changes rarely: skip the host->device copies on
        # unchanged ticks
        key = (self.task_planner.task, tuple(np.ravel(self.task_planner.curr_goal)), zup)
        if self._tp_key != key:
            self._tp_key = key
            self._tp_cached = make_task_params(
                self.task_planner.task, self.task_planner.curr_goal, "none", zup, device=self.device
            )
        return self._tp_cached

    @property
    def multi_modal_suction(self) -> bool:
        return bool(self.cfg.multi_modal)

    def _suction_ext_device(self, mppi_state, real_state, task: TaskParams, action):
        """Real-env suction as tensor work (skill_utils.py:36-56 and the
        real-env branch of calculate_suction, threshold 1.5).  The pull-vs-push
        arbitration reads the PRE-command weights, as the reference's
        get_suction reports the preference from before ``command``."""
        ext = self.env.zero_ext()
        if not (bool(self.cfg.suction_active) or self.multi_modal_suction):
            return ext
        box_slot = self.env.box_slot
        box_pos = real_state.dyn_pos[box_slot]
        robot_pos = real_state.q[:2]
        on = (task.task_id == 2) | (task.task_id == 3)
        if self.multi_modal_suction:
            w, half_K = mppi_state.weights, self.motion_planner.half_K
            on = on & (torch.sum(w[half_K:]) > torch.sum(w[:half_K]))
        dir_rb = robot_pos - box_pos
        cmd_vel = command_world_vel(self.env.params, real_state.q, action)
        on = on & (torch.sum(cmd_vel * dir_rb) > 0) & (torch.linalg.vector_norm(dir_rb) < 0.6)
        f_box, f_robot = skill_utils.calculate_suction(box_pos, robot_pos, float(self.cfg.kp_suction), threshold=1.5)
        rows = [torch.where(on, f_box, 0.0) if d == box_slot else ext.dyn[d] for d in range(ext.dyn.shape[0])]
        return dataclasses.replace(ext, robot=torch.where(on, f_robot, 0.0), dyn=torch.stack(rows))

    def _point_success_device(self, real_state, task: TaskParams):
        """PLANNER_SIMPLE's success gate as a device bool: navigation = robot
        strictly within 0.1 m, push family = box within 0.1 m inclusive."""
        goal2 = task.goal[:2]
        nav_ok = torch.linalg.vector_norm(real_state.q[:2] - goal2) < 0.1
        box_ok = torch.linalg.vector_norm(real_state.dyn_pos[self.env.box_slot] - goal2) <= 0.1
        push_family = (task.task_id >= 1) & (task.task_id <= 3)
        return torch.where(task.task_id == 0, nav_ok, push_family & box_ok)

    def _tick(self, mppi_state, real_state, task: TaskParams, i: int):
        """One control tick: dyn-obs motion, replan, real-env suction, step."""
        real_state = update_dyn_obs_device(self.env, real_state, i)
        pre_state = mppi_state  # the PRE-command weights drive the arbitration
        action_seq, mppi_state, aux = self.motion_planner._command_impl(mppi_state, real_state, task)
        action = action_seq[0]
        ext = self._suction_ext_device(pre_state, real_state, task, action)
        real_state = self.env.step(real_state, action, ext)
        return action, mppi_state, real_state, aux

    def tick_fused(self, mppi_state, real_state, task: TaskParams, i: int):
        """One tick; returns (action, mppi_state, real_state, view_vec)."""
        action, ms, rs, _ = self._tick(mppi_state, real_state, task, i)
        return action, ms, rs, self.env.view_vec(rs)

    def _run_chunk_impl(self, mppi_state, real_state, task, i0: int, length: int, gate: bool = True, done0=None):
        """``length`` ticks with no host sync.  Returns (mppi_state,
        real_state, views [length, nv], n_ticks, done).

        With ``gate`` on, a device done latch (pre-set by ``done0``) freezes
        both states with ``torch.where`` from the tick the success gate
        fires, exactly as the JAX while-loop stops there; the remaining ticks
        still run, masked, and their view rows stay zero.  ``n_ticks``
        counts the ticks up to and including the latching one.
        """
        nv = self.env.view_vec(real_state).shape[-1]
        views = torch.zeros(length, nv, dtype=torch.float32, device=self.device)
        if not gate:
            for k in range(length):
                _, mppi_state, real_state, _ = self._tick(mppi_state, real_state, task, i0 + k)
                views[k] = self.env.view_vec(real_state)  # in place into the chunk buffer
            return mppi_state, real_state, views, length, False
        done = torch.zeros((), dtype=torch.bool, device=self.device) if done0 is None else done0
        n_ticks = torch.zeros((), dtype=torch.int32, device=self.device)
        for k in range(length):
            active = ~done
            _, ms, rs, _ = self._tick(mppi_state, real_state, task, i0 + k)
            mppi_state = tree_where(active, ms, mppi_state)
            real_state = tree_where(active, rs, real_state)
            views[k] = torch.where(active, self.env.view_vec(real_state), 0.0)  # in place
            n_ticks = n_ticks + active.to(torch.int32)
            done = done | (active & self._point_success_device(real_state, task))
        return mppi_state, real_state, views, n_ticks, done

    def run_chunk(self, mppi_state, real_state, task, i0: int, length: int):
        return self._run_chunk_impl(mppi_state, real_state, task, i0, length, self.device_gate)
