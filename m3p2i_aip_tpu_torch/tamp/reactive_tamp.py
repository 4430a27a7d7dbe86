"""REACTIVE_TAMP orchestrator: task planner + objective + M3P2I.

Port of ``m3p2i_aip_tpu/tamp/reactive_tamp.py``.  ``run_tamp`` is the
reference's per-tick API (sync the plan, replan from one real state, return
the first action); ``ReactiveTAMPServer`` speaks it over the two-terminal
RPC boundary with Isaac-layout numpy tensors.  One point-family or albert tick is dyn-obs motion, a K-sample replan, the
real-env suction decision and the real-env step, all as tensor work on one
device (the albert has no dyn-obs and no suction); a chunk
runs ``length`` ticks with no host sync inside and returns the per-tick
observation views in one tensor.  The point success gate inside a chunk is a
device-side done latch that freezes the planner and real-env state with
``torch.where`` (``_run_chunk_impl``), so chunked task times equal per-tick
task times.

Compiled ticks (``tamp/graph_tick.py``): each chunk and the per-tick
``tick_fused`` run one tick body over static buffers, captured once on the
card as a CUDA graph and replayed every tick (the JAX package's jitted tick
and scan); ``graphs=False`` keeps the eager tick, the same body called with
a host tick index and fresh tensors, which the compiled one equals bit for
bit.  The per-tick API's planner call (``run_tamp``, the RPC server's) is
the planner's own compiled ``MPPI.command`` (the JAX package's jitted
``MPPI._command``), whose program lives in the planner's ``TickGraphs``,
shared here as ``ticks``; the gradient steps inside a tick
(``graph_tick.repeat``) and a sample-sharded planner on one card (each
shard's rollout on a stream of its own, branches of one graph) compile
too.  Only a planner sharded over distinct cards runs eagerly, by rule
(``MPPI.compiled``).

The panda chunk (``_run_chunk_panda_impl``) runs the active-inference
reach -> pick -> place decision on the device every tick
(``_panda_gate_device``, with the wedged-pick stall detector
``_zup_update``), so a stage switch needs no host sync either.  After
success the panda chunk keeps planning and stepping the env with the action
zeroed, as the JAX chunk does; it does not freeze the state.

Seed batches (``tamp/batch_loop.py``): every device-side piece here is
written over leading dims, so the same chunk functions run B seeded runs at
once when the planner state, the real state and the TaskParams carry a
leading seed axis B.  The done latch is then [B] and freezes each seed on
its own; a ``done0`` pre-latch lets a batch keep dispatching while single
seeds have finished, as the JAX package's vmapped chunks do.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from m3p2i_aip_tpu_torch.envs import Env, command_world_vel, make_env, update_dyn_obs_device
from m3p2i_aip_tpu_torch.models import panda_fk
from m3p2i_aip_tpu_torch.ops.albert_rollout import make_albert_rollout
from m3p2i_aip_tpu_torch.ops.panda_rollout import make_panda_rollout
from m3p2i_aip_tpu_torch.ops.quat import general_ori_cube2goal
from m3p2i_aip_tpu_torch.ops.rollout import make_point_rollout
from m3p2i_aip_tpu_torch.planners.motion_planner.cost_functions import (
    AlbertObjective,
    PandaObjective,
    PointObjective,
)
from m3p2i_aip_tpu_torch.planners.motion_planner.m3p2i import M3P2I
from m3p2i_aip_tpu_torch.planners.motion_planner.mppi import TaskParams, make_task_params
from m3p2i_aip_tpu_torch.planners.task_planner.task_planner import (
    ZUP_IMPROVE_M,
    ZUP_RELEASE_M,
    ZUP_STALL_TICKS,
    set_task_planner,
)
from m3p2i_aip_tpu_torch.tamp.graph_tick import TickProgram, clone, part
from m3p2i_aip_tpu_torch.utils import profiling, skill_utils
from m3p2i_aip_tpu_torch.utils.tree import tree_where


def build_task_planner(cfg, env: Env, objective):
    """The host-side symbolic planner of one seeded run, with the pocket-
    endgame latches armed from a point scene's arena (reactive_tamp.py:58).
    On the albert's open floor only the stall latch is armed, with the
    reposition standoff kept outside the cost's keep-out radius."""
    tp = set_task_planner(cfg)
    p = env.params
    if not hasattr(tp, "configure_pocket_endgame"):
        return tp
    if env.env_type == "point_env" and p.arena_bound > 0.0:
        half_x = float(p.dyn_half[objective.box_dyn_slot, 0])
        tp.configure_pocket_endgame(
            float(p.arena_bound) - 2.0 * float(p.robot_radius) - half_x,
            proximity_latch=(p.robot_type == "boxer"),
            min_clearance=float(p.robot_radius) + half_x + 0.1,
        )
    elif env.env_type == "albert_env":
        tp.configure_pocket_endgame(10.0, proximity_latch=False, min_clearance=objective.clearance_r)
    return tp


class ReactiveTAMP:
    """``graphs``: None (the default) compiles the tick and the command (a
    CUDA graph on ``cuda``, the static-buffer body on the CPU), False runs
    them eagerly, True insists on CUDA graphs (raises on the CPU); see
    ``graph_tick``.  The planner owns the programs' ``TickGraphs``, and
    ``ticks`` is the same object."""

    def __init__(self, cfg, env: Optional[Env] = None, device="cuda", graphs: Optional[bool] = None) -> None:
        self.device = torch.device(device)
        if self.device.type == "cuda":
            # fp32 throughout: no TF32 in matmuls or convolutions
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.cfg = cfg
        self.env = env if env is not None else make_env(cfg, self.device)
        K, T, multi_modal = cfg.mppi.num_samples, cfg.mppi.horizon, bool(cfg.multi_modal)
        noise = None
        if self.env.env_type == "panda_env":
            self.objective = PandaObjective.from_cfg(self.env.params, cfg)
            rollout = make_panda_rollout(self.env.params, float(cfg.pre_height_diff), K, T, multi_modal)
        elif self.env.env_type == "albert_env":
            self.objective = AlbertObjective(self.env.params)
            rollout = make_albert_rollout(self.env.params, self.objective, K, T)
        else:
            self.objective = PointObjective.from_cfg(self.env.params, cfg)
            rollout = make_point_rollout(
                self.env.params,
                float(cfg.kp_suction),
                K,
                T,
                multi_modal,
                boxer_continuous_align=bool(cfg.mppi.boxer_continuous_align),
            )
            # per-sample friction randomization: active when an actor YAML
            # sets noise_percentage_friction > 0
            noise = self.env.params.dyn_fric_noise.cpu().numpy()
        self.task_planner = build_task_planner(cfg, self.env, self.objective)
        self.task_success = False
        self.motion_planner = M3P2I(
            cfg, rollout, fric_noise=noise if noise is not None and np.any(noise) else None, device=self.device,
            graphs=graphs,
        )
        self.mppi_state = self.motion_planner.init_state()
        self.suction_active = int(cfg.suction_active)
        self.top_trajs: Optional[torch.Tensor] = None  # [20, T, 2] of the last replan, on the device
        self._zero_action = torch.zeros(self.env.nu, dtype=torch.float32, device=self.device)
        # on-device success gate for chunks (False = benchmark mode: every
        # tick replans regardless of goal distance)
        self.device_gate = True
        self._tp_key = None
        self._tp_cached: Optional[TaskParams] = None
        self.ticks = self.motion_planner.ticks  # one pool and one mode for the command and the ticks

    # ------------------------------------------------------------------ api
    def run_tamp(self, real_state) -> torch.Tensor:
        """One replanning tick from one real state: sync the plan, then the
        first action [nu] of the optimized sequence (reactive_tamp.py:200);
        zeros once the task has succeeded."""
        task_params = self.tamp_interface(real_state)
        if self.task_success:
            return self._zero_action
        return self._command(real_state, task_params)[0]

    def run_tamp_sequence(self, real_state) -> torch.Tensor:
        """:meth:`run_tamp`, returning the first ``u_per_command`` actions
        [u_per_command, nu] (reactive_tamp.py:217)."""
        task_params = self.tamp_interface(real_state)
        u = self.cfg.mppi.u_per_command
        if self.task_success:
            return torch.zeros(u, self.env.nu, dtype=torch.float32, device=self.device)
        return self._command(real_state, task_params)[:u]

    def _command(self, real_state, task: TaskParams) -> torch.Tensor:
        """One replan from ``real_state`` (``MPPI.command``, compiled unless
        the planner runs eagerly); the new planner state (``get_suction``
        reads its weights) and the top trajectories kept.  Returns the
        action sequence [T, nu]."""
        action_seq, self.mppi_state, aux = self.motion_planner.command(self.mppi_state, real_state, task)
        self.top_trajs = aux["top_trajs"]
        return action_seq

    def tamp_interface(self, real_state) -> TaskParams:
        """:meth:`tamp_interface_view` on a real state (one device->host read)."""
        return self.tamp_interface_view(self.env.view(real_state))

    def tamp_interface_view(self, view: dict, i: Optional[int] = None) -> TaskParams:
        """Update plan -> gripper -> success on a host observation dict, and
        return the (cached) device TaskParams: a ``tamp.plan`` span, its
        request the tick index ``i``.  Parity: tamp_interface
        (reactive_tamp.py:75-81)."""
        with profiling.span("tamp.plan", i):
            self.task_planner.update_plan(view)
            gripper = self.motion_planner.update_gripper_command(self.task_planner.task)
            self.task_success = self.task_planner.check_task_success(view)
            grip = gripper if self.env.env_type == "panda_env" else "none"
            zup = float(getattr(self.task_planner, "zup_gate", 0.0))
            # the symbolic plan changes rarely: skip the host->device copies on
            # unchanged ticks
            key = (self.task_planner.task, tuple(np.ravel(self.task_planner.curr_goal)), grip, zup)
            if self._tp_key != key:
                self._tp_key = key
                self._tp_cached = make_task_params(
                    self.task_planner.task, self.task_planner.curr_goal, grip, zup, device=self.device
                )
            return self._tp_cached

    @property
    def multi_modal_suction(self) -> bool:
        return bool(self.cfg.multi_modal) and self.env.env_type == "point_env"

    def _suction_ext_device(self, mppi_state, real_state, task: TaskParams, action):
        """Real-env suction as tensor work (skill_utils.py:36-56 and the
        real-env branch of calculate_suction, threshold 1.5).  The pull-vs-push
        arbitration reads the PRE-command weights, as the reference's
        get_suction reports the preference from before ``command``."""
        ext = self.env.zero_ext(real_state.q.shape[:-1])
        if self.env.env_type != "point_env" or not (bool(self.cfg.suction_active) or self.multi_modal_suction):
            return ext
        box_slot = self.env.box_slot
        box_pos = real_state.dyn_pos[..., box_slot, :]
        robot_pos = real_state.q[..., :2]
        on = (task.task_id == 2) | (task.task_id == 3)
        if self.multi_modal_suction:
            w, half_K = mppi_state.weights, self.motion_planner.half_K
            on = on & (torch.sum(w[..., half_K:], dim=-1) > torch.sum(w[..., :half_K], dim=-1))
        dir_rb = robot_pos - box_pos
        cmd_vel = command_world_vel(self.env.params, real_state.q, action)
        on = on & (torch.sum(cmd_vel * dir_rb, dim=-1) > 0) & (torch.linalg.vector_norm(dir_rb, dim=-1) < 0.6)
        on = on[..., None]  # over the xy of each force
        f_box, f_robot = skill_utils.calculate_suction(box_pos, robot_pos, float(self.cfg.kp_suction), threshold=1.5)
        rows = [torch.where(on, f_box, 0.0) if d == box_slot else ext.dyn[..., d, :] for d in range(ext.dyn.shape[-2])]
        return dataclasses.replace(ext, robot=torch.where(on, f_robot, 0.0), dyn=torch.stack(rows, dim=-2))

    def _point_success_device(self, real_state, task: TaskParams):
        """PLANNER_SIMPLE's success gate as a device bool: navigation = robot
        strictly within 0.1 m, push family = box within 0.1 m inclusive.  On
        the albert, push_reach gates on its box and ee_reach never latches
        here (the host checks it per tick when the chunk drains)."""
        goal2 = task.goal[..., :2]
        nav_ok = torch.linalg.vector_norm(real_state.q[..., :2] - goal2, dim=-1) < 0.1
        if self.env.env_type == "albert_env":
            box_ok = torch.linalg.vector_norm(real_state.box_pos - goal2, dim=-1) <= 0.1
            return torch.where(task.task_id == 0, nav_ok, (task.task_id == 9) & box_ok)
        box_ok = torch.linalg.vector_norm(real_state.dyn_pos[..., self.env.box_slot, :] - goal2, dim=-1) <= 0.1
        push_family = (task.task_id >= 1) & (task.task_id <= 3)
        return torch.where(task.task_id == 0, nav_ok, push_family & box_ok)

    def _tick(self, mppi_state, real_state, task: TaskParams, i):
        """One control tick: dyn-obs motion, replan, real-env suction, step.
        ``i`` is the tick index: a host int, or the compiled tick's device
        counter."""
        real_state = update_dyn_obs_device(self.env, real_state, i)
        pre_state = mppi_state  # the PRE-command weights drive the arbitration
        action_seq, mppi_state, aux = self.motion_planner._command_impl(mppi_state, real_state, task)
        action = action_seq[..., 0, :]
        ext = self._suction_ext_device(pre_state, real_state, task, action)
        with part("step"):  # counted while captured: graph.step_nodes
            real_state = self.env.step(real_state, action, ext)
        return action, mppi_state, real_state, aux

    # ------------------------------------------------------- the tick bodies
    # Each body maps (carry, inputs) to (next carry, outputs): the eager
    # loops call it with a host tick index, the compiled tick
    # (``graph_tick.TickProgram``) over static buffers with a device counter.
    def _open_tick(self, carry, task: TaskParams):
        """The ungated tick: carry (mppi_state, real_state, i); outputs
        (action, view row, top trajectories)."""
        ms, rs, i = carry
        action, ms, rs, aux = self._tick(ms, rs, task, i)
        return (ms, rs, i + 1), (action, self.env.view_vec(rs), aux["top_trajs"])

    def _gated_tick(self, carry, task: TaskParams):
        """The tick behind the done latch: carry (mppi_state, real_state,
        done, n_ticks, i); output the view row, zero once latched."""
        ms, rs, done, n_ticks, i = carry
        active = ~done
        _, ms_next, rs_next, _ = self._tick(ms, rs, task, i)
        ms = tree_where(active, ms_next, ms)
        rs = tree_where(active, rs_next, rs)
        view = torch.where(active[..., None], self.env.view_vec(rs), 0.0)
        n_ticks = n_ticks + active.to(torch.int32)
        done = done | (active & self._point_success_device(rs, task))
        return (ms, rs, done, n_ticks, i + 1), view

    def _compiled(self) -> bool:
        """Whether this planner's ticks run compiled (``MPPI.compiled``)."""
        return self.motion_planner.compiled()

    def _program(self, kind: str, body, carry, inputs) -> TickProgram:
        """The compiled tick of ``kind`` for this carry's seed count (made at
        first use with ``carry`` and ``inputs`` as its buffers' templates),
        loaded with ``carry`` and ``inputs``.  Raises if the planner's
        generators are no longer those the program registered."""
        lead = carry[0].mean_action.shape[:-2]
        key = (kind, lead[0] if lead else None)
        gens = self.motion_planner.generators(lead)
        prog = self.ticks.program(key, lambda: TickProgram(self.ticks, key, body, carry, inputs, gens))
        if not prog.registered(gens):
            raise RuntimeError(f"the compiled tick {key} was made with other generators than the planner's")
        prog.load(carry, inputs)
        return prog

    def _counter(self, i0: int) -> torch.Tensor:
        return torch.full((), i0, dtype=torch.int64, device=self.device)

    # ------------------------------------------------------------ the ticks
    def tick_fused(self, mppi_state, real_state, task: TaskParams, i: int):
        """One tick; returns (action, mppi_state, real_state, view_vec).  The
        replan's top trajectories stay on the device in ``top_trajs``
        (reactive_tamp.py:343): nothing is read back unless a caller
        renders them.  Compiled, it is one replay of the ungated tick.  A
        ``tamp.tick`` span, the replay a device ``tick`` span."""
        with profiling.span("tamp.tick", i):
            carry = (mppi_state, real_state, i)
            if self._compiled():
                carry = (mppi_state, real_state, self._counter(i))
                prog = self._program("open", self._open_tick, carry, task)
                with profiling.device_span("tick", i, self.device):
                    prog.step()
                carry, outs = prog.carry_out(), clone(prog.outputs)
            else:
                carry, outs = self._open_tick(carry, task)
            action, view, self.top_trajs = outs
            return action, carry[0], carry[1], view

    def _run_chunk_impl(self, mppi_state, real_state, task, i0: int, length: int, gate: bool = True, done0=None):
        """``length`` ticks with no host sync.  Returns (mppi_state,
        real_state, views [length, nv], n_ticks, done); for a seed batch
        views [B, length, nv], n_ticks [B] and done [B].

        With ``gate`` on, a device done latch (pre-set by ``done0``) freezes
        both states with ``torch.where`` from the tick the success gate
        fires, exactly as the JAX while-loop stops there; the remaining ticks
        still run, masked, and their view rows stay zero.  ``n_ticks``
        counts the ticks up to and including the latching one.  In a batch
        the latch is per seed, and a seed entered with ``done0`` set runs no
        tick and keeps its state.  Compiled, each tick is a replay of the
        (gated or open) tick's graph and its view row is copied into the
        chunk's views after it.  A ``tamp.chunk`` span, its request ``i0``;
        the replays and row copies a device ``chunk`` span.
        """
        with profiling.span("tamp.chunk", i0):
            lead = mppi_state.mean_action.shape[:-2]  # () or (B,)
            nv = self.env.view_vec(real_state).shape[-1]
            views = torch.zeros(lead + (length, nv), dtype=torch.float32, device=self.device)
            body, carry = self._open_tick, (mppi_state, real_state, i0)
            if gate:
                done = torch.zeros(lead, dtype=torch.bool, device=self.device) if done0 is None else done0
                body, carry = self._gated_tick, (mppi_state, real_state, done,
                                                 torch.zeros(lead, dtype=torch.int32, device=self.device), i0)
            if self._compiled():
                carry = carry[:-1] + (self._counter(i0),)
                prog = self._program("gated" if gate else "open", body, carry, task)
                with profiling.device_span("chunk", i0, self.device):
                    for k in range(length):
                        prog.step()
                        views[..., k, :] = prog.outputs if gate else prog.outputs[1]
                carry = prog.carry_out()
            else:
                for k in range(length):
                    carry, out = body(carry, task)
                    views[..., k, :] = out if gate else out[1]  # in place into the chunk buffer
        if not gate:
            return carry[0], carry[1], views, length, False
        ms, rs, done, n_ticks, _ = carry
        return ms, rs, views, n_ticks, done

    def run_chunk(self, mppi_state, real_state, task, i0: int, length: int):
        return self._run_chunk_impl(mppi_state, real_state, task, i0, length, self.device_gate)

    # ----------------------------------------------- on-device panda AIF gate
    def zup_zs0(self) -> torch.Tensor:
        """Initial [best_d, stall_n, gate, latch_d] carry of the wedged-pick
        stall detector (thresholds shared with the host planner's mirror)."""
        return torch.tensor([1e9, 0.0, 0.0, 0.0], dtype=torch.float32, device=self.device)

    @staticmethod
    def _zup_update(zs, d, in_pick, att):
        """One stall-detector step on device scalars (reactive_tamp.py:479):
        the gate turns on after ZUP_STALL_TICKS attached pick ticks without a
        ZUP_IMPROVE_M gain toward the place goal, and off after ZUP_RELEASE_M
        of progress past the latch."""
        best, n, gate, latch = zs[..., 0], zs[..., 1], zs[..., 2], zs[..., 3]
        improved = d < best - ZUP_IMPROVE_M
        best = torch.minimum(best, d)
        active = in_pick & (att > 0.5)
        n = torch.where(active & ~improved, n + 1.0, 0.0)
        was_on = gate > 0.5
        turn_on = n >= float(ZUP_STALL_TICKS)
        latch = torch.where(active & turn_on & ~was_on, d, latch)
        release = d < latch - ZUP_RELEASE_M
        gate = torch.where(active & ((was_on & ~release) | turn_on), 1.0, 0.0)
        best = torch.where(in_pick, best, 1e9)
        return torch.stack([best, n, gate, latch], dim=-1)

    def _panda_gate_device(self, real_state, stage, zs):
        """The PLANNER_AIF_PANDA decision as device tensors
        (reactive_tamp.py:497): a 3-stage latch reach -> pick -> place on
        the geometric thresholds with the pick/place hysteresis, the stall
        detector, and the TaskParams built from device tensors (no host
        read).  Returns (TaskParams, new_stage, success, new_zs)."""
        p = self.env.params
        ee = panda_fk.fk(real_state.q, p.base_pos)["ee"][0]
        cube, cube_q = real_state.body_pos[..., 1, :], real_state.body_quat[..., 1, :]
        goal_pos, goal_q = real_state.body_pos[..., 2, :], real_state.body_quat[..., 2, :]
        th = float(self.cfg.pre_height_diff) + 0.005
        pre_place = torch.cat([goal_pos[..., :2], goal_pos[..., 2:] + th, goal_q], dim=-1)
        reach_cost = torch.linalg.vector_norm(ee - cube, dim=-1)
        dist_cost = torch.linalg.vector_norm(pre_place[..., :2] - cube[..., :2], dim=-1)
        # the host passes (goal quat, cube quat) in this order (task_planner.py:94-98)
        ori_cost = general_ori_cube2goal(goal_q, cube_q)
        new_stage = torch.where(
            (dist_cost + ori_cost < 0.03) | (stage >= 2),
            2,
            torch.where((reach_cost < th) | (stage >= 1), 1, 0),
        ).to(torch.int32)
        zs = self._zup_update(
            zs, torch.linalg.vector_norm(pre_place[..., :3] - cube, dim=-1), new_stage == 1, real_state.attached
        )
        task = TaskParams(
            task_id=(4 + new_stage).to(torch.int32),
            goal=pre_place,
            # reach / place -> open (1), pick -> close (2) (m3p2i.py:22-28)
            gripper=torch.where(new_stage == 1, 2, 1).to(torch.int32),
            zup_gate=zs[..., 2],
        )
        success = (new_stage == 2) & (dist_cost < 0.04)
        return task, new_stage, success, zs

    def _panda_tick(self, carry, ext):
        """The panda tick: carry (mppi_state, real_state, stage, zs, done);
        the zero external forces as its input; outputs the view row (the
        stage and the latch are the carry's)."""
        ms, rs, stage, zs, done = carry
        task, stage, succ, zs = self._panda_gate_device(rs, stage, zs)
        done = done | succ
        action_seq, ms, _ = self.motion_planner._command_impl(ms, rs, task)
        action = torch.where(done[..., None], 0.0, action_seq[..., 0, :])
        with part("step"):  # counted while captured: graph.step_nodes
            rs = self.env.step(rs, action, ext)
        return (ms, rs, stage, zs, done), self.env.view_vec(rs)

    def _run_chunk_panda_impl(self, mppi_state, real_state, stage, zs, length: int, done0=None):
        """``length`` panda ticks with no host sync: the AIF gate, the replan
        and the real-env step per tick.  A latched success zeroes the action
        but keeps planning and stepping (reactive_tamp.py:566).  ``done0``
        pre-latches the gate, so a chunk entered already done keeps its
        zero-action freeze: a finished seed of a batch never resumes
        planning, even if its cube later drifts past the success threshold
        (reactive_tamp.py:547-578).  Returns (mppi_state, real_state, stage,
        zs, done, views [length, 22], stages [length], dones [length]); for a
        seed batch (``stage`` [B], ``zs`` [B, 4]) done is [B] and the
        per-tick outputs are [B, length, ...].  Compiled, each tick is a
        replay of the panda tick's graph, its rows copied out after it.  A
        ``tamp.chunk`` span (no request: the panda chunk has no tick index);
        the replays and row copies a device ``chunk`` span."""
        with profiling.span("tamp.chunk"):
            lead = stage.shape
            done = torch.zeros(lead, dtype=torch.bool, device=self.device) if done0 is None else done0
            ext = self.env.zero_ext(lead)
            nv = self.env.view_vec(real_state).shape[-1]
            views = torch.empty(lead + (length, nv), dtype=torch.float32, device=self.device)
            stages = torch.empty(lead + (length,), dtype=torch.int32, device=self.device)
            dones = torch.empty(lead + (length,), dtype=torch.bool, device=self.device)
            carry = (mppi_state, real_state, stage, zs, done)
            prog = None
            if self._compiled():
                prog = self._program("panda", self._panda_tick, carry, ext)
            with profiling.device_span("chunk", None, self.device):
                for k in range(length):
                    if prog is None:
                        carry, view = self._panda_tick(carry, ext)
                    else:
                        prog.step()
                        carry, view = prog.carry, prog.outputs
                    views[..., k, :], stages[..., k], dones[..., k] = view, carry[2], carry[4]
            if prog is not None:
                carry = prog.carry_out()
            return (*carry, views, stages, dones)

    def run_chunk_panda(self, mppi_state, real_state, stage, zs, length: int):
        stage = torch.as_tensor(stage, dtype=torch.int32, device=self.device)
        zs = torch.as_tensor(zs, dtype=torch.float32, device=self.device)
        return self._run_chunk_panda_impl(mppi_state, real_state, stage, zs, length)

    # -------------------------------------------------------------- queries
    def get_trajs(self) -> Optional[torch.Tensor]:
        """The last replan's top-20 rollout trajectories (reactive_tamp.py:596)."""
        return self.top_trajs

    def get_suction(self) -> int:
        """The pull preference of the current weights, read after the
        command (reactive_tamp.py:600); the fused tick's suction reads the
        weights from before it, as the JAX package does."""
        self.suction_active = self.motion_planner.get_pull_preference(self.mppi_state)
        return int(self.suction_active)


class ReactiveTAMPServer:
    """The reference's RPC surface (``run_tamp(dof_state, root_state)`` with
    Isaac-layout tensors, ``get_suction``, ``get_trajs``;
    reactive_tamp.py:609) over an in-process :class:`ReactiveTAMP` on
    ``device``, its planner call compiled (``graphs`` as the planner's:
    False runs it eagerly).  Serve it with
    ``m3p2i_aip_tpu_torch.utils.rpc.Server``."""

    def __init__(self, cfg, device="cuda", graphs: Optional[bool] = None) -> None:
        self.tamp = ReactiveTAMP(cfg, device=device, graphs=graphs)
        self._state = self.tamp.env.init_state()

    def run_tamp(self, dof_state, root_state) -> np.ndarray:
        """Load the client's state into this server's env state, replan, and
        return the action as numpy."""
        env, dev = self.tamp.env, self.tamp.device
        state = env.load_dof_state(self._state, torch.as_tensor(dof_state, dtype=torch.float32, device=dev))
        self._state = env.load_root_state(state, torch.as_tensor(root_state, dtype=torch.float32, device=dev))
        return self.tamp.run_tamp(self._state).cpu().numpy()

    def get_trajs(self) -> Optional[np.ndarray]:
        trajs = self.tamp.get_trajs()
        return None if trajs is None else trajs.cpu().numpy()

    def get_suction(self) -> int:
        return self.tamp.get_suction()
