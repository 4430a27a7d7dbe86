"""Task-indexed running costs over the point-env and panda states, in torch.

Port of ``PointObjective`` and ``PandaObjective``
(``m3p2i_aip_tpu/planners/motion_planner/cost_functions.py:40-452``).  Every cost is a pure function
``(state, u, task, mode) -> (cost, ext_forces)`` over a leading sample axis;
the returned suction forces thread into the NEXT dynamics step, as the
reference's pull cost mutating the live sim did.  The reference's half-batch
split is a per-sample ``mode`` (0 = push half, 1 = pull half).

Task selection is data: all four costs are evaluated and ``torch.where``
picks one per the traced ``task_id``, so a task switch never branches on the
host.
"""
from __future__ import annotations

import torch

from benchmark.reference.plain.models import panda_env as pa
from benchmark.reference.plain.models import panda_fk
from benchmark.reference.plain.models import point_env as pe
from benchmark.reference.plain.ops.norm import vector_norm
from benchmark.reference.plain.ops.quat import general_ori_cube2goal, general_ori_ee2cube_mat
from benchmark.reference.plain.sim import pbd2d
from benchmark.reference.plain.utils.skill_utils import calculate_suction


class PointObjective:
    """navigation / push / pull / push_pull (and reposition = navigation)."""

    # rollout suction gate 1/dist > 1.8; the real env uses 1.5 (the
    # reference's intentional difference, skill_utils.py:79-82, mirrored)
    suction_threshold = 1.8

    def __init__(
        self,
        params: pe.PointEnvParams,
        kp_suction: float,
        multi_modal: bool,
        boxer_continuous_align: bool = True,
    ):
        self.params = params
        self.kp_suction = float(kp_suction)
        self.multi_modal = bool(multi_modal)
        self.boxer_continuous_align = bool(boxer_continuous_align)
        names = list(params.actor_names)
        self.box_dyn_slot = params.dyn_actor_idx.index(names.index("box"))
        self.dynobs_actor = names.index("dyn-obs")
        self._box_half_x = float(params.dyn_half[self.box_dyn_slot, 0])  # host copy

    @classmethod
    def from_cfg(cls, params: pe.PointEnvParams, cfg) -> "PointObjective":
        return cls(
            params,
            kp_suction=float(cfg.kp_suction),
            multi_modal=bool(cfg.multi_modal),
            boxer_continuous_align=bool(getattr(cfg.mppi, "boxer_continuous_align", True)),
        )

    def _dist_terms(self, state, goal):
        """Parity: Objective.calculate_dist (cost_functions.py:41-50)."""
        block_pos = state.dyn_pos[..., self.box_dyn_slot, :]
        robot_to_block = state.q[..., :2] - block_pos
        block_to_goal = goal - block_pos
        d_rb = vector_norm(robot_to_block, dim=-1)
        d_bg = vector_norm(block_to_goal, dim=-1)
        dist_cost = d_rb + d_bg * 10.0
        cos_theta = torch.sum(robot_to_block * block_to_goal, dim=-1) / torch.clamp(
            d_rb * d_bg, min=1e-9
        )
        return dist_cost, cos_theta, block_pos, d_rb, d_bg

    def _motion_cost(self, state):
        """Binarized dyn-obs contact (cost_functions.py:158-170, point branch)."""
        f = state.contact_force[..., self.dynobs_actor, :2]
        coll = torch.sum(torch.abs(f), dim=-1)
        return torch.where(coll > 0.1, 1000.0, 0.0)

    def _navigation(self, state, goal):
        return vector_norm(state.q[..., :2] - goal, dim=-1) + self._motion_cost(state)

    def _push(self, terms):
        dist_cost, cos_theta = terms[0], terms[1]
        if self.params.robot_type == "boxer" and self.boxer_continuous_align:
            # continuous side alignment for the diff-drive base: 0 at the
            # ideal push pose, growing smoothly to 3 between box and goal
            align = 1.5 * (1.0 + cos_theta)
        else:
            align = torch.clamp(cos_theta, min=0.0)  # (cost_functions.py:57-58)
        return 3.0 * dist_cost + 1.0 * align

    def _wall_crush(self, state):
        """Max penetration of the robot circle into the static geometry."""
        p = self.params
        c = pbd2d.circle_vs_obb(state.q[..., None, :2], p.robot_radius, p.stat_pos, p.stat_yaw, p.stat_half)
        return torch.amax(c.pen, dim=-1)

    def _pull(self, state, goal, mode, terms):
        dist_cost, cos_theta, block_pos, d_rb, d_bg = terms
        p = self.params
        pos_dir = block_pos - state.q[..., :2]
        towards_block = torch.sum(state.qd[..., :2] * pos_dir, dim=-1) > 0.0

        f_box, f_robot = calculate_suction(
            block_pos, state.q[..., :2], self.kp_suction, self.suction_threshold
        )
        # no suction when moving toward the block (cost_functions.py:72-73);
        # multi-modal: the push half (mode 0) gets none (:74-75)
        off = towards_block
        if self.multi_modal:
            off = off | (mode == 0)
        f_box = torch.where(off[..., None], 0.0, f_box)
        f_robot = torch.where(off[..., None], 0.0, f_robot)

        align = torch.clamp(-cos_theta, min=0.0)  # (cost_functions.py:81-82)
        vel_cost = torch.where(towards_block & (d_rb <= 0.5), 0.6, 0.0)
        crush_pen = self._wall_crush(state)
        if float(p.arena_bound) > 0.0:
            # boundary contact counts as crush (5 cm margin), so arbitration
            # vetoes pulls into zero-clearance pockets
            lim = float(p.arena_bound) - float(p.robot_radius)
            at_edge = torch.amax(torch.abs(state.q[..., :2]), dim=-1) > lim - 0.05
            crush_pen = torch.where(at_edge, 1.0, crush_pen)
            if self.multi_modal and p.robot_type == "boxer":
                # pocket-goal endgame veto, diff-drive only
                rr = float(p.robot_radius)
                pocket_lim = float(p.arena_bound) - (2.0 * rr + self._box_half_x)
                goal_in_pocket = torch.amax(torch.abs(goal), dim=-1) > pocket_lim
                crush_pen = torch.where(goal_in_pocket & (d_bg < 1.0), 1.0, crush_pen)
        crush = torch.where(crush_pen > 0.02, 1000.0, 0.0)
        cost = 3.0 * dist_cost + 3.0 * vel_cost + 7.0 * align + crush
        return cost, self._ext(f_robot, f_box)

    def _ext(self, f_robot, f_box) -> pe.PointExtForces:
        D = self.params.dyn_half.shape[0]
        zero = torch.zeros_like(f_box)
        rows = [f_box if d == self.box_dyn_slot else zero for d in range(D)]
        return pe.PointExtForces(robot=f_robot, dyn=torch.stack(rows, dim=-2))

    def compute(self, state: pe.PointEnvState, u, task, mode):
        """Task dispatch (cost_functions.py:19-36): only navigation adds the
        motion cost; push/pull return bare.  Reposition (id 8) runs the
        navigation cost.  Returns (cost [...], PointExtForces)."""
        goal = task.goal[..., :2]
        terms = self._dist_terms(state, goal)
        nav = self._navigation(state, goal)
        push = self._push(terms)
        pull, ext_pull = self._pull(state, goal, mode, terms)
        m0 = mode == 0
        push_pull = torch.where(m0, push, pull)

        tid = torch.where(task.task_id == 8, 0, torch.clamp(task.task_id, 0, 3))
        cost = torch.where(
            tid == 0, nav, torch.where(tid == 1, push, torch.where(tid == 2, pull, push_pull))
        )
        # ext: pull applies it to every sample (mode-gated inside `off` when
        # multi-modal); push_pull to the pull half only
        sel = (tid == 2) | ((tid == 3) & ~m0)
        ext = pe.PointExtForces(
            robot=torch.where(sel[..., None], ext_pull.robot, 0.0),
            dyn=torch.where(sel[..., None, None], ext_pull.dyn, 0.0),
        )
        return cost, ext


class PandaObjective:
    """reach / pick / place costs for the panda (``cost_functions.py:217``).

    Kept deviation of the JAX package: every rollout aims at its OWN cube
    state, where the reference indexes env 0's (all rollouts share the synced
    start state anyway).  ``compute`` returns (cost [...], zero ext forces).
    """

    tilt_cos_theta = 0.5
    cubeA_slot, cubeB_slot = 1, 2  # panda_env.DYN_NAMES order

    def __init__(self, params: pa.PandaEnvParams, pre_height_diff: float, multi_modal: bool):
        self.params = params
        self.pre_height_diff = float(pre_height_diff)
        self.multi_modal = bool(multi_modal)
        names = list(params.actor_names)
        self.table_actor = names.index("table")
        self.shelf_actor = names.index("shelf_stand")
        self.cubeB_actor = names.index("cubeB")

    @classmethod
    def from_cfg(cls, params: pa.PandaEnvParams, cfg) -> "PandaObjective":
        return cls(params, float(cfg.pre_height_diff), bool(cfg.multi_modal))

    def _motion_cost(self, state):
        """Binarized table / shelf (x4) / cubeB contact (cost_functions.py:244)."""
        cf = state.contact_force
        f = cf[..., self.table_actor, :] + 4.0 * cf[..., self.shelf_actor, :] + cf[..., self.cubeB_actor, :]
        coll = torch.sum(torch.abs(f[..., :2]), dim=-1)
        return torch.where(coll > 0.1, 1000.0, 0.0)

    def _reach(self, state, links, mode):
        ee_pos, ee_rot = links["ee"]
        cube_pos = state.body_pos[..., self.cubeA_slot, :]
        cube_quat = state.body_quat[..., self.cubeA_slot, :]
        phd = self.pre_height_diff
        top_goal = torch.cat([cube_pos[..., :2], cube_pos[..., 2:] + phd], dim=-1)
        tilt0 = general_ori_ee2cube_mat(ee_rot, cube_quat, tilt_value=0.0)
        if self.multi_modal:
            # both grasp modes: top grasp (mode 0), tilted side grasp (mode 1)
            tilt = self.tilt_cos_theta
            side_goal = torch.stack(
                [cube_pos[..., 0] + (-phd * tilt), cube_pos[..., 1], cube_pos[..., 2] + phd * (1 - tilt**2) ** 0.5],
                dim=-1,
            )
            m0 = mode == 0
            goal = torch.where(m0[..., None], top_goal, side_goal)
            tilt_cost = torch.where(m0, tilt0, general_ori_ee2cube_mat(ee_rot, cube_quat, tilt_value=tilt))
        else:
            goal, tilt_cost = top_goal, tilt0
        return 10.0 * vector_norm(ee_pos - goal, dim=-1) + 3.0 * tilt_cost

    def _zup_clearance(self, state):
        """Height deficit of the cube wedged beside (or dragging on) a static
        AABB: live only while the stall gate is on (cost_functions.py:308)."""
        cube = state.body_pos[..., self.cubeA_slot, None, :]  # [..., 1, 3]
        half = self.params.body_half[self.cubeA_slot]
        lo, hi = self.params.stat_min, self.params.stat_max
        overlap = (
            (cube[..., 0] > lo[:, 0] - half[0])
            & (cube[..., 0] < hi[:, 0] + half[0])
            & (cube[..., 1] > lo[:, 1] - half[1])
            & (cube[..., 1] < hi[:, 1] + half[1])
        )
        wedged = (cube[..., 2] - half[2] - 0.02) < hi[:, 2]
        needed = torch.clamp(hi[:, 2] + half[2] + 0.02 - cube[..., 2], min=0.0)
        return torch.amax(torch.where(overlap & wedged, needed, 0.0), dim=-1)

    def _pick(self, state, links, task):
        cube_pos = state.body_pos[..., self.cubeA_slot, :]
        cube_quat = state.body_quat[..., self.cubeA_slot, :]
        goal_cost = vector_norm(task.goal[..., :3] - cube_pos, dim=-1)
        ori_cost = general_ori_cube2goal(cube_quat, task.goal[..., 3:7])
        # re-grasp term, zero while the cube is held
        ee_pos = links["ee"][0]
        regrasp = 10.0 * vector_norm(ee_pos - cube_pos, dim=-1) * (1.0 - state.attached)
        return (
            10.0 * goal_cost
            + 15.0 * ori_cost
            + regrasp
            + self._motion_cost(state)
            + 30.0 * self._zup_clearance(state) * state.attached * task.zup_gate
        )

    def _place(self, links):
        gripper_dist = vector_norm(links["leftfinger"][0] - links["rightfinger"][0], dim=-1)
        return 2.0 * (1.0 - gripper_dist)

    def compute(self, state: pa.PandaEnvState, u, task, mode, links=None):
        """Task dispatch: ids 4/5/6 -> reach/pick/place (clipped); all three
        are evaluated and one is picked per the task id, with no host branch.
        ``links`` takes an FK of ``state.q`` already at hand."""
        if links is None:
            links = panda_fk.fk(state.q, self.params.base_pos)
        idx = torch.clamp(task.task_id - 4, 0, 2)
        cost = torch.where(
            idx == 0,
            self._reach(state, links, mode),
            torch.where(idx == 1, self._pick(state, links, task), self._place(links)),
        )
        return cost, pa.zero_ext(self.params, cost.shape)
