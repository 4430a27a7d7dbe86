"""The plain reference of one closed-loop control tick.

A :class:`Scene` is built from a configuration file of ``benchmark/configs``
with the frozen plain modules under ``benchmark/reference/plain`` (the
port's plain PyTorch versions, kernels and compiled programs left out): the
scene, the planner with its Halton-spline deltas and friction scales worked
out again from the planner seed, and the plain rollouts and weights.

:meth:`Scene.tick` computes one tick from a checkpoint: the real-env state,
the planner state and the exploration generator's state where a tick
starts, the tick index and, for a point-family scene, the task the host
planner handed the chunk.  A checkpoint at an episode's start carries none
of the program's state: the reference settles the scene itself and seeds
its own generator from the planner seed.
The tick returns the observation row after the real-env step, the row the
program's chunk writes for that tick.

``precision`` selects the control: ``"tf32"`` lets float32 matrix products
run in TF32; ``"bf16"`` rounds every tensor that passes between the tick's
stages (the states, the sampled actions, the costs, the weights, the
command and the stepped state) to bfloat16.

The tick records each call that a kernel of the program does in its place
(:attr:`Scene.calls`): every rollout (K1, K3), every weights update (K2)
and, in a point-family scene, the real-env step (K5).  :func:`bounds`
gives the yardstick's bound of each, by kind.  This is the reference of the
point family and the panda; a configuration file names it as ``"tick"``.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import numpy as np
import torch

from benchmark.reference.plain.config.config_store import load_config
from benchmark.reference.plain.envs import command_world_vel, make_env, update_dyn_obs_device
from benchmark.reference.plain.models import panda_fk
from benchmark.reference.plain.ops import weights as weights_mod
from benchmark.reference.plain.ops.panda_rollout import make_panda_rollout
from benchmark.reference.plain.ops.quat import general_ori_cube2goal
from benchmark.reference.plain.ops.rollout import make_point_rollout
from benchmark.reference.plain.planners.motion_planner import mppi as mppi_mod
from benchmark.reference.plain.planners.motion_planner.m3p2i import M3P2I
from benchmark.reference.plain.planners.motion_planner.mppi import MPPIState, TaskParams
from benchmark.reference.plain.planners.task_planner_constants import ZUP_IMPROVE_M, ZUP_RELEASE_M, ZUP_STALL_TICKS
from benchmark.reference.plain.sim import pbd2d
from benchmark.reference.plain.utils import skill_utils
from benchmark.yardstick import roofline


def bf16(x):
    """``x`` rounded to bfloat16 and back, leaf by leaf (floats only)."""
    if torch.is_tensor(x):
        return x.bfloat16().float() if x.is_floating_point() else x
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{f.name: bf16(getattr(x, f.name)) for f in dataclasses.fields(x)})
    if isinstance(x, tuple):
        return tuple(bf16(v) for v in x)
    return x


def config_of(cfg_file: dict):
    """The configuration a file of ``benchmark/configs`` states, composed by
    the reference's own copy of the config grammar."""
    return load_config(cfg_file["port_config"], list(cfg_file["overrides"]))


class Scene:
    """The reference's scene and planner for one configuration file."""

    def __init__(self, cfg_file: dict, device, precision: Optional[str] = None, count_live: bool = False) -> None:
        self.device = torch.device(device)
        self.precision = precision
        self.count_live = count_live  # count each rollout's and step's live contacts (K1's and K5's operations)
        self._live: Optional[list] = None
        self.cfg = cfg = config_of(cfg_file)
        self.env = make_env(cfg, self.device)
        K, T, mm = cfg.mppi.num_samples, cfg.mppi.horizon, bool(cfg.multi_modal)
        self.is_panda = self.env.env_type == "panda_env"
        noise = None
        if self.is_panda:
            rollout = make_panda_rollout(self.env.params, float(cfg.pre_height_diff), K, T, mm)
        else:
            rollout = make_point_rollout(self.env.params, float(cfg.kp_suction), K, T, mm,
                                         boxer_continuous_align=bool(cfg.mppi.boxer_continuous_align))
            noise = self.env.params.dyn_fric_noise.cpu().numpy()
        self.rollout_spec = rollout.spec
        self.calls: list = []  # (kind, inputs, live contacts) of every kernel's call of the last tick
        self.planner = M3P2I(cfg, self._recorded(rollout),
                             fric_noise=noise if noise is not None and np.any(noise) else None, device=self.device)
        self.settle_steps = int(cfg_file["settle_steps"])
        self._settled = None

    # ------------------------------------------------------------ the stages
    def _recorded(self, rollout):
        """``rollout`` with each call's inputs recorded (the yardstick counts
        a kernel's work from them) and, in the bf16 control, its costs
        rounded."""

        def wrapped(sim_state_k, acts, task, k0=None):
            self._live = [] if self.count_live else None
            try:
                cost, traj = rollout(sim_state_k, acts, task)
            finally:
                live, self._live = self._live, None
            self.calls.append(("rollout", (sim_state_k, acts, task), live))
            return (bf16(cost), traj) if self.precision == "bf16" else (cost, traj)

        wrapped.spec = rollout.spec
        return wrapped

    @contextlib.contextmanager
    def _stages(self):
        """The weights recorded (and rounded in the bf16 control) for the
        duration of a tick; TF32 on in the TF32 control, off otherwise."""
        plain = weights_mod.multimodal_weights
        tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        on = self.precision == "tf32"
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = on

        def weights(cost, gamma, half_K, eta_u=10.0, eta_l=3.0):
            self.calls.append(("weights", (cost, gamma, half_K, eta_u, eta_l), None))
            out = plain(cost, gamma, half_K, eta_u, eta_l)
            return bf16(tuple(out)) if self.precision == "bf16" else out

        resolve = pbd2d.resolve_contact

        def counted(contact, *args, **kwargs):
            if self._live is not None:
                self._live.append(torch.count_nonzero(contact.pen > 0))
            return resolve(contact, *args, **kwargs)

        mppi_mod.multimodal_weights = weights
        pbd2d.resolve_contact = counted
        try:
            yield
        finally:
            mppi_mod.multimodal_weights = plain
            pbd2d.resolve_contact = resolve
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32

    # ------------------------------------------------------------ the start
    def settled_state(self):
        """The configuration's initial state after ``settle_steps`` zero-action
        steps (the program's warm-up)."""
        if self._settled is None:
            env = self.env
            state = env.init_state()
            zero_u = torch.zeros(env.nu, dtype=torch.float32, device=self.device)
            for _ in range(self.settle_steps):
                state = env.step(state, zero_u, env.zero_ext())
            self._settled = state
        return self._settled

    # ------------------------------------------------------------- the tick
    def _planner_state(self, ck: dict) -> MPPIState:
        """The planner state a checkpoint starts from: at an episode's start
        the reference's own fresh state (its generator seeded and its U drawn,
        as a fresh planner's); else the program's state, with the deltas and
        friction scales worked out again from the seed and the generator
        set to the program's."""
        planner = self.planner
        planner.reseed(int(ck["seed_val"]))
        if ck["start"]:
            return planner.init_state()
        planner.generator.set_state(ck["generator"])
        ms = ck["mppi_state"]
        return dataclasses.replace(ms, halton_delta=planner._delta, fric_scale_k=planner._fric_scale)

    def _suction_ext(self, pre_state, real_state, task: TaskParams, action):
        """The real env's suction forces of the fused tick (the program's
        ``ReactiveTAMP._suction_ext_device``)."""
        env, cfg = self.env, self.cfg
        ext = env.zero_ext(real_state.q.shape[:-1])
        mm_suction = bool(cfg.multi_modal) and env.env_type == "point_env"
        if env.env_type != "point_env" or not (bool(cfg.suction_active) or mm_suction):
            return ext
        box_slot = env.box_slot
        box_pos = real_state.dyn_pos[..., box_slot, :]
        robot_pos = real_state.q[..., :2]
        on = (task.task_id == 2) | (task.task_id == 3)
        if mm_suction:
            w, half_K = pre_state.weights, self.planner.half_K
            on = on & (torch.sum(w[..., half_K:], dim=-1) > torch.sum(w[..., :half_K], dim=-1))
        dir_rb = robot_pos - box_pos
        cmd_vel = command_world_vel(env.params, real_state.q, action)
        on = on & (torch.sum(cmd_vel * dir_rb, dim=-1) > 0) & (torch.linalg.vector_norm(dir_rb, dim=-1) < 0.6)
        on = on[..., None]
        f_box, f_robot = skill_utils.calculate_suction(box_pos, robot_pos, float(cfg.kp_suction), threshold=1.5)
        rows = [torch.where(on, f_box, 0.0) if d == box_slot else ext.dyn[..., d, :] for d in range(ext.dyn.shape[-2])]
        return dataclasses.replace(ext, robot=torch.where(on, f_robot, 0.0), dyn=torch.stack(rows, dim=-2))

    @staticmethod
    def _zup_update(zs, d, in_pick, att):
        """The wedged-pick stall detector (the program's ``_zup_update``)."""
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

    def _panda_gate(self, real_state, stage, zs):
        """The reach -> pick -> place decision (the program's
        ``_panda_gate_device``): (TaskParams, stage, success, zs)."""
        p = self.env.params
        ee = panda_fk.fk(real_state.q, p.base_pos)["ee"][0]
        cube, cube_q = real_state.body_pos[..., 1, :], real_state.body_quat[..., 1, :]
        goal_pos, goal_q = real_state.body_pos[..., 2, :], real_state.body_quat[..., 2, :]
        th = float(self.cfg.pre_height_diff) + 0.005
        pre_place = torch.cat([goal_pos[..., :2], goal_pos[..., 2:] + th, goal_q], dim=-1)
        reach_cost = torch.linalg.vector_norm(ee - cube, dim=-1)
        dist_cost = torch.linalg.vector_norm(pre_place[..., :2] - cube[..., :2], dim=-1)
        ori_cost = general_ori_cube2goal(goal_q, cube_q)
        new_stage = torch.where(
            (dist_cost + ori_cost < 0.03) | (stage >= 2), 2, torch.where((reach_cost < th) | (stage >= 1), 1, 0)
        ).to(torch.int32)
        zs = self._zup_update(zs, torch.linalg.vector_norm(pre_place[..., :3] - cube, dim=-1), new_stage == 1,
                              real_state.attached)
        task = TaskParams(task_id=(4 + new_stage).to(torch.int32), goal=pre_place,
                          gripper=torch.where(new_stage == 1, 2, 1).to(torch.int32), zup_gate=zs[..., 2])
        return task, new_stage, (new_stage == 2) & (dist_cost < 0.04), zs

    def tick(self, ck: dict) -> torch.Tensor:
        """The observation row [V] after one tick from checkpoint ``ck``."""
        self.calls = []
        dev = self.device
        ms = self._planner_state(ck)
        rs = self.settled_state() if ck["start"] else ck["real_state"]
        lowp = self.precision == "bf16"
        with self._stages():
            if lowp:
                ms, rs = bf16(ms), bf16(rs)
            if self.is_panda:
                if ck["start"]:  # a fresh gate: reach, the stall detector at rest, not done
                    stage, zs, done = 0, [1e9, 0.0, 0.0, 0.0], False
                else:
                    stage, zs, done = ck["stage"], ck["zs"], ck["done"]
                stage = torch.as_tensor(stage, dtype=torch.int32, device=dev)
                zs = torch.as_tensor(zs, dtype=torch.float32, device=dev)
                done = torch.as_tensor(done, dtype=torch.bool, device=dev)
                task, stage, succ, zs = self._panda_gate(rs, stage, zs)
                done = done | succ
                action_seq, _, _ = self.planner._command_impl(ms, rs, task)
                action = torch.where(done[..., None], 0.0, action_seq[..., 0, :])
                ext = self.env.zero_ext()
            else:
                task = TaskParams(**{k: v.to(dev) for k, v in ck["task"].items()})
                rs = update_dyn_obs_device(self.env, rs, int(ck["i"]))
                action_seq, _, _ = self.planner._command_impl(ms, rs, task)
                action = action_seq[..., 0, :]
                ext = self._suction_ext(ms, rs, task, bf16(action) if lowp else action)
            if lowp:
                action = bf16(action)
            rs = self._step(rs, action, ext)
            if lowp:
                rs = bf16(rs)
            return self.env.view_vec(rs)

    def _step(self, state, action, ext):
        """The real-env step; in a point-family scene recorded as a call of
        K5 (its inputs, its output, its live contacts)."""
        if self.is_panda:
            return self.env.step(state, action, ext)
        self._live = [] if self.count_live else None
        try:
            out = self.env.step(state, action, ext)
        finally:
            live, self._live = self._live, None
        self.calls.append(("step", (state, action, ext, out), live))
        return out


def _total(live) -> int:
    return int(torch.stack(live).sum()) if live else 0


def bounds(scene: Scene, seeds_per_tick: int) -> dict:
    """The yardstick's bounds of the last reference tick's kernel calls:
    {"rollout": [ms, ...], "weights": [ms, ...], "step": [ms, ...]}, each
    times the seeds a batched launch carries."""
    from benchmark.reference.plain.ops import panda_rollout, rollout as point_rollout
    from benchmark.reference.plain.ops.weights import beta_rounds

    spec = scene.rollout_spec
    out = {"rollout": [], "weights": [], "step": []}
    for kind, args, live in scene.calls:
        if kind == "rollout":
            sim_state_k, acts, task = args
            K = acts.shape[-3]
            if scene.is_panda:
                inputs = (*panda_rollout.rollout_inputs(sim_state_k, task), acts)
                ops = roofline.panda_rollout_ops(spec, K)
            else:
                inputs = (*point_rollout.rollout_inputs(sim_state_k, task), acts)
                ops = roofline.point_rollout_ops(spec, K, _total(live))
            out["rollout"].append(seeds_per_tick * roofline.rollout_bound_ms(spec, inputs, K, ops))
        elif kind == "weights":
            cost, gamma, half_K, eta_u, eta_l = args
            rounds = beta_rounds(cost, gamma, half_K, eta_u, eta_l)[0]
            out["weights"].append(seeds_per_tick * roofline.weights_bound_ms(cost, gamma, half_K, rounds))
        else:
            state, action, ext, stepped = args
            out["step"].append(seeds_per_tick * roofline.point_step_bound_ms(scene.env.params, state, action, ext,
                                                                             stepped, _total(live)))
    return out
