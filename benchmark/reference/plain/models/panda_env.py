"""Panda tabletop environment in torch: 9-DOF arm + graspable cube.

Port of ``m3p2i_aip_tpu/models/panda_env.py``: a velocity-driven Franka
Panda (first-order joint-velocity tracking with acceleration saturation, then
FK), a table, two stands, a shelf, a floating plate ("dyn-obs"), the
manipulated cubeA and the goal cubeB.  Grasping is an explicit attach
constraint: a closing gripper with its fingertip point within grasp range of
cubeA welds the cube to the hand until the opening fingers clear the cube.

``step(params, state, u, ext)`` is one function over arbitrary leading batch
dimensions: the K rollout states carry a leading K axis where the JAX package
used ``jax.vmap``, and the real system is the same function with none.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from benchmark.reference.plain.models import panda_fk
from benchmark.reference.plain.ops import quat as quat_ops
from benchmark.reference.plain.ops.norm import vector_norm
from benchmark.reference.plain.sim.sim_config import ActorCfg, SimConfig

GRAVITY = 9.8
GROUND_MU = 0.75  # friction of a resting body on its support
# the dynamic bodies, in slot order
DYN_NAMES = ("dyn-obs", "cubeA", "cubeB")


@dataclass
class PandaEnvState:
    """Simulation state; every field may carry leading batch dims."""

    q: torch.Tensor  # [..., 9]
    qd: torch.Tensor  # [..., 9]
    body_pos: torch.Tensor  # [..., 3, 3] rows in DYN_NAMES order
    body_quat: torch.Tensor  # [..., 3, 4]
    body_vel: torch.Tensor  # [..., 3, 3]
    body_om: torch.Tensor  # [..., 3, 3]
    attached: torch.Tensor  # [...] 1.0 while cubeA is welded to the hand
    attach_pos: torch.Tensor  # [..., 3] cube position in the hand frame
    attach_rot: torch.Tensor  # [..., 3, 3] cube orientation in the hand frame
    contact_force: torch.Tensor  # [..., A, 3] per-actor contact force


@dataclass
class PandaExtForces:
    body: torch.Tensor  # [..., 3, 3] world forces on the dynamic bodies


@dataclass
class PandaEnvParams:
    # static colliders as 3D AABBs (every panda_env static is axis-aligned)
    stat_min: torch.Tensor  # [S, 3]
    stat_max: torch.Tensor  # [S, 3]
    # support surfaces cubes can rest on: the statics' top faces + the ground
    sup_min: torch.Tensor  # [P, 2]
    sup_max: torch.Tensor  # [P, 2]
    sup_z: torch.Tensor  # [P]
    body_half: torch.Tensor  # [3, 3]
    body_mass: torch.Tensor  # [3]
    body_gravity: torch.Tensor  # [3] 1/0 flags
    init_body_pos: torch.Tensor  # [3, 3]
    init_q: torch.Tensor  # [9]
    base_pos: torch.Tensor  # [3]
    joint_lower: torch.Tensor  # [9]
    joint_upper: torch.Tensor  # [9]
    init_root: Optional[torch.Tensor] = None  # [A, 13]
    # the drive limits of panda_fk as tensors on the params' device (filled
    # in when absent, e.g. when the params come from the JAX package)
    joint_vel_limit: Optional[torch.Tensor] = None  # [9]
    joint_accel_limit: Optional[torch.Tensor] = None  # [9]
    dt: float = 0.01
    substeps: int = 2
    drive_rate: float = 200.0
    grasp_range: float = 0.05
    actor_names: tuple = ()
    dyn_actor_idx: tuple = ()
    stat_actor_idx: tuple = ()
    robot_actor_idx: int = 0
    num_actors: int = 0

    def __post_init__(self):
        kw = dict(dtype=torch.float32, device=self.stat_min.device)
        if self.joint_vel_limit is None:
            self.joint_vel_limit = torch.as_tensor(panda_fk.JOINT_VEL_LIMIT, **kw)
        if self.joint_accel_limit is None:
            self.joint_accel_limit = torch.as_tensor(panda_fk.JOINT_ACCEL_LIMIT, **kw)

    @property
    def device(self) -> torch.device:
        return self.stat_min.device


def build_params(actors: List[ActorCfg], sim_cfg: SimConfig, cube_on_shelf: bool = False, device="cpu") -> PandaEnvParams:
    """Pack the per-actor YAML configs into tensors on ``device``
    (``panda_env.py:83``): masses from PhysX's default density 1000 kg/m^3
    (the YAML ``mass`` is ignored, as upstream), supports from the statics'
    top faces plus the ground."""
    names, stat_min, stat_max, stat_idx = [], [], [], []
    dyn = {}
    robot_idx, robot_cfg = 0, None
    init_root = np.zeros((len(actors), 13), dtype=np.float32)
    init_root[:, 6] = 1.0
    for i, a in enumerate(actors):
        names.append(a.name)
        if a.name == "cubeA":
            pos = a.init_pos_on_shelf if cube_on_shelf else a.init_pos_on_table
        else:
            pos = a.init_pos
        init_root[i, 0:3] = pos
        init_root[i, 3:7] = a.init_ori
        if a.type == "robot":
            robot_idx, robot_cfg = i, a
        elif a.fixed and a.collision:
            h = np.asarray(a.size, dtype=np.float32) / 2
            stat_min.append(np.asarray(pos) - h)
            stat_max.append(np.asarray(pos) + h)
            stat_idx.append(i)
        elif a.name in DYN_NAMES:
            dyn[a.name] = (i, a, pos)

    half = np.stack([np.asarray(dyn[n][1].size, np.float32) / 2 for n in DYN_NAMES])
    mass = np.asarray([1000.0 * float(np.prod(np.asarray(dyn[n][1].size))) for n in DYN_NAMES], np.float32)
    grav = np.asarray([1.0 if dyn[n][1].gravity else 0.0 for n in DYN_NAMES], np.float32)
    ipos = np.stack([np.asarray(dyn[n][2], np.float32) for n in DYN_NAMES])
    sup_min = [m[:2] for m in stat_min] + [np.array([-10.0, -10.0], np.float32)]
    sup_max = [m[:2] for m in stat_max] + [np.array([10.0, 10.0], np.float32)]
    sup_z = [m[2] for m in stat_max] + [np.float32(0.0)]
    init_q = np.zeros(9, dtype=np.float32)
    if robot_cfg is not None and robot_cfg.init_joint_pose:
        # Isaac's dof state interleaves (pos, vel): take the positions
        init_q = np.asarray(robot_cfg.init_joint_pose, np.float32)[0::2]

    def t(x):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=torch.float32, device=device)

    return PandaEnvParams(
        stat_min=t(np.stack(stat_min)),
        stat_max=t(np.stack(stat_max)),
        sup_min=t(np.stack(sup_min)),
        sup_max=t(np.stack(sup_max)),
        sup_z=t(np.stack(sup_z)),
        body_half=t(half),
        body_mass=t(mass),
        body_gravity=t(grav),
        init_body_pos=t(ipos),
        init_q=t(init_q),
        base_pos=t(np.asarray(robot_cfg.init_pos, np.float32)),
        joint_lower=t(panda_fk.JOINT_LOWER),
        joint_upper=t(panda_fk.JOINT_UPPER),
        init_root=t(init_root),
        dt=sim_cfg.dt,
        substeps=sim_cfg.substeps,
        actor_names=tuple(names),
        dyn_actor_idx=tuple(dyn[n][0] for n in DYN_NAMES),
        stat_actor_idx=tuple(stat_idx),
        robot_actor_idx=robot_idx,
        num_actors=len(actors),
    )


def init_state(params: PandaEnvParams) -> PandaEnvState:
    z = dict(dtype=torch.float32, device=params.device)
    quat = torch.zeros(3, 4, **z)
    quat[:, 3] = 1.0
    return PandaEnvState(
        q=params.init_q.clone(),
        qd=torch.zeros(9, **z),
        body_pos=params.init_body_pos.clone(),
        body_quat=quat,
        body_vel=torch.zeros(3, 3, **z),
        body_om=torch.zeros(3, 3, **z),
        attached=torch.zeros((), **z),
        attach_pos=torch.zeros(3, **z),
        attach_rot=torch.eye(3, **z),
        contact_force=torch.zeros(params.num_actors, 3, **z),
    )


def zero_ext(params: PandaEnvParams, batch=()) -> PandaExtForces:
    return PandaExtForces(body=torch.zeros(*batch, 3, 3, dtype=torch.float32, device=params.device))


def sphere_vs_aabb(center, radius, bmin, bmax):
    """Penetration and outward normal of spheres against 3D AABBs
    (``panda_env.py:175``), broadcasting over leading dims.  A center inside
    the box is pushed out along the axis of least separation; tied axes
    share the push (one-hot divided by the tie count)."""
    closest = torch.minimum(torch.maximum(center, bmin), bmax)
    diff = center - closest
    dist = vector_norm(diff, dim=-1)
    inside = torch.all((center > bmin) & (center < bmax), dim=-1)
    sep_lo = center - bmin
    sep_hi = bmax - center
    sep = torch.minimum(sep_lo, sep_hi)
    min_sep = torch.amin(sep, dim=-1, keepdim=True)
    one_hot = (sep <= min_sep).to(center.dtype)
    one_hot = one_hot / torch.sum(one_hot, dim=-1, keepdim=True)
    sign = torch.where(sep_hi < sep_lo, 1.0, -1.0)
    normal = torch.where(inside[..., None], sign * one_hot, diff / torch.clamp(dist, min=1e-9)[..., None])
    pen = torch.where(inside, radius + min_sep[..., 0], radius - dist)
    return pen, normal


def _set_row(x: torch.Tensor, i: int, row: torch.Tensor) -> torch.Tensor:
    """``x.at[..., i, :].set(row)`` for the [..., 3, n] body arrays."""
    return torch.stack([row if j == i else x[..., j, :] for j in range(x.shape[-2])], dim=-2)


def step(params: PandaEnvParams, state: PandaEnvState, u_target: torch.Tensor, ext: PandaExtForces) -> PandaEnvState:
    """One control step = ``substeps`` substeps of: joint velocity drive with
    velocity / acceleration / position limits, FK, grasp attach and detach,
    body gravity and integration, support surfaces (cubeA also stacks on
    cubeB), contact settling, static AABB pushout, the held cube following the
    hand, arm-probe and cubeA-cubeB contacts.  ``contact_force`` is the
    per-actor force averaged over the substeps (``panda_env.py:204``)."""
    p = params
    h = p.dt / p.substeps
    decay = float(np.exp(-p.drive_rate * p.dt / p.substeps))
    q, qd = state.q, state.qd
    bpos, bquat, bvel, bom = state.body_pos, state.body_quat, state.body_vel, state.body_om
    attached, attach_pos, attach_rot = state.attached, state.attach_pos, state.attach_rot
    batch = q.shape[:-1]
    zeros3 = torch.zeros(*batch, 3, dtype=q.dtype, device=q.device)
    f_robot = zeros3
    f_dyn = [zeros3] * 3
    f_stat = torch.zeros(*batch, p.stat_min.shape[0], 3, dtype=q.dtype, device=q.device)

    gripper_closing = u_target[..., 7] < 0.0
    u_clamped = torch.minimum(torch.maximum(u_target, -p.joint_vel_limit), p.joint_vel_limit)
    acc_h = p.joint_accel_limit * h
    # finger-travel release: the grasp holds until the opening fingers have
    # cleared the cube width (panda_env.py:230-238)
    half_w = p.body_half[1, 0]
    release_gap = 2.0 * half_w + 0.005
    r_eff = torch.mean(p.body_half, dim=-1)
    r_ab = torch.mean(p.body_half[1])

    for _ in range(p.substeps):
        # --- joint velocity drive + integrate + limits ----------------------
        dv = (u_clamped - qd) * (1.0 - decay)
        qd = qd + torch.minimum(torch.maximum(dv, -acc_h), acc_h)
        q = torch.minimum(torch.maximum(q + qd * h, p.joint_lower), p.joint_upper)
        fingers = torch.where((attached > 0.5)[..., None], torch.maximum(q[..., 7:9], half_w * 0.96), q[..., 7:9])
        q = torch.cat([q[..., :7], fingers], dim=-1)

        links = panda_fk.fk(q, p.base_pos)
        hand_pos, hand_rot = links["hand"]
        tip_pos = links["fingertip"][0]

        # --- grasp attach / detach -----------------------------------------
        cube_pos = bpos[..., 1, :]  # the substep-start position (held velocity)
        near = vector_norm(tip_pos - cube_pos, dim=-1) < p.grasp_range
        do_attach = (attached < 0.5) & gripper_closing & near
        rel_pos = torch.matmul((cube_pos - hand_pos)[..., None, :], hand_rot)[..., 0, :]
        rel_rot = torch.matmul(hand_rot.transpose(-1, -2), quat_ops.quat_to_rotmat(bquat[..., 1, :]))
        attach_pos = torch.where(do_attach[..., None], rel_pos, attach_pos)
        attach_rot = torch.where(do_attach[..., None, None], rel_rot, attach_rot)
        attached = torch.where(do_attach, 1.0, attached)
        # only an OPENING gripper that has cleared the cube releases it
        attached = torch.where(~gripper_closing & (q[..., 7] + q[..., 8] > release_gap), 0.0, attached)

        # --- dynamic bodies: gravity, integrate -----------------------------
        acc = ext.body / p.body_mass[:, None]
        acc = torch.cat([acc[..., :2], (acc[..., 2] + (-GRAVITY * p.body_gravity))[..., None]], dim=-1)
        bvel = bvel + acc * h
        new_pos = bpos + bvel * h
        bquat = quat_ops.quat_integrate(bquat, bom, h)

        # support: the highest surface under each body's footprint
        xy = new_pos[..., :, None, :2]
        over = torch.all((xy >= p.sup_min) & (xy <= p.sup_max), dim=-1)  # [..., 3, P]
        below = p.sup_z <= (bpos[..., :, 2:3] - p.body_half[:, 2:3] + 1e-3)
        sup_height = torch.amax(torch.where(over & below, p.sup_z, -torch.inf), dim=-1)  # [..., 3]
        # cubeA also rests on cubeB's top face (the place target is ON cubeB)
        cb_top = bpos[..., 2, 2] + p.body_half[2, 2]
        over_b = torch.all(torch.abs(new_pos[..., 1, :2] - bpos[..., 2, :2]) <= p.body_half[2, :2], dim=-1)
        below_b = cb_top <= bpos[..., 1, 2] - p.body_half[1, 2] + 1e-3
        sup_a = torch.maximum(sup_height[..., 1], torch.where(over_b & below_b, cb_top, -torch.inf))
        sup_height = torch.stack([sup_height[..., 0], sup_a, sup_height[..., 2]], dim=-1)
        rest_z = sup_height + p.body_half[:, 2]
        landing = (new_pos[..., 2] <= rest_z) & (p.body_gravity > 0.5)
        new_pos = torch.cat([new_pos[..., :2], torch.where(landing, rest_z, new_pos[..., 2])[..., None]], dim=-1)
        vz = torch.where(landing, 0.0, bvel[..., 2])
        # support friction on xy while resting
        speed = vector_norm(bvel[..., :2], dim=-1)
        scale = torch.clamp(1.0 - GROUND_MU * GRAVITY * h / torch.clamp(speed, min=1e-9), min=0.0)
        vxy = torch.where(landing[..., None], bvel[..., :2] * scale[..., None], bvel[..., :2])
        bvel = torch.cat([vxy, vz[..., None]], dim=-1)
        # contact settling: a resting body's z-axis is turned toward world z
        up = quat_ops.quat_to_rotmat(bquat)[..., :, 2]  # [..., 3 bodies, 3]
        near_flat = (up[..., 2] > 0.5)[..., None]
        om_settle = 5.0 * torch.stack([up[..., 1], -up[..., 0], torch.zeros_like(up[..., 0])], dim=-1)
        bom = torch.where(landing[..., None], bom * 0.8 + torch.where(near_flat, om_settle, 0.0), bom)

        # lateral pushout of the bodies vs the static AABBs (body as a sphere)
        pen, normal = sphere_vs_aabb(new_pos[..., :, None, :], r_eff[:, None], p.stat_min, p.stat_max)
        active = (pen > 0) & (torch.abs(normal[..., 2]) < 0.9)  # upward pushes are the support's
        corr = torch.where(active[..., None], pen[..., None] * normal, 0.0)  # [..., 3, S, 3]
        new_pos = new_pos + corr.sum(-2)
        fs = corr / (h * h) * p.body_mass[:, None, None]
        fs_body = fs.sum(-2)
        f_dyn = [f_dyn[b] + fs_body[..., b, :] for b in range(3)]
        f_stat = f_stat - fs.sum(-3)
        bpos = new_pos

        # --- the attached cube follows the hand ------------------------------
        held_pos = hand_pos + torch.matmul(hand_rot, attach_pos[..., None])[..., 0]
        held_quat = quat_ops.mat_to_quat(torch.matmul(hand_rot, attach_rot))
        is_att = (attached > 0.5)[..., None]
        # velocity of the held cube: difference against the substep-start position
        new_vel = (held_pos - cube_pos) / h
        bpos = _set_row(bpos, 1, torch.where(is_att, held_pos, bpos[..., 1, :]))
        bquat = _set_row(bquat, 1, torch.where(is_att, held_quat, bquat[..., 1, :]))
        bvel = _set_row(bvel, 1, torch.where(is_att, new_vel, bvel[..., 1, :]))

        # --- arm collision sensing: probe spheres vs statics and cubeB --------
        cb_min = bpos[..., 2, :] - p.body_half[2]
        cb_max = bpos[..., 2, :] + p.body_half[2]
        probes = (
            links["link4"][0], links["link5"][0], links["link6"][0], hand_pos,
            links["leftfinger"][0], links["rightfinger"][0], tip_pos,
        )
        for pr in probes:
            pen_a, normal_a = sphere_vs_aabb(pr[..., None, :], 0.05, p.stat_min, p.stat_max)  # [..., S]
            f_arm = (torch.clamp(pen_a, min=0.0)[..., None] * normal_a) * 2000.0
            f_stat = f_stat - f_arm
            f_robot = f_robot + f_arm.sum(-2)
            pen_b, normal_b = sphere_vs_aabb(pr, 0.04, cb_min, cb_max)
            f_dyn[2] = f_dyn[2] - (torch.clamp(pen_b, min=0.0)[..., None] * normal_b) * 2000.0

        # held or free cubeA vs cubeB: pushes cubeB, records the force
        pen_ab, normal_ab = sphere_vs_aabb(bpos[..., 1, :], r_ab, cb_min, cb_max)
        hit_ab = torch.clamp(pen_ab, min=0.0)
        f_dyn[2] = f_dyn[2] - hit_ab[..., None] * normal_ab * 2000.0
        push = -torch.where(hit_ab > 0, 1.0, 0.0)[..., None] * normal_ab[..., :2] * hit_ab[..., None] * 0.5
        bpos = _set_row(bpos, 2, torch.cat([bpos[..., 2, :2] + push, bpos[..., 2, 2:]], dim=-1))

    rows = [zeros3] * p.num_actors
    rows[p.robot_actor_idx] = f_robot
    for b, a in enumerate(p.dyn_actor_idx):
        rows[a] = f_dyn[b]
    for s, a in enumerate(p.stat_actor_idx):
        rows[a] = f_stat[..., s, :]
    return dataclasses.replace(
        state,
        q=q,
        qd=qd,
        body_pos=bpos,
        body_quat=bquat,
        body_vel=bvel,
        body_om=bom,
        attached=attached,
        attach_pos=attach_pos,
        attach_rot=attach_rot,
        contact_force=torch.stack(rows, dim=-2) / p.substeps,
    )


def root_state_view(params: PandaEnvParams, state: PandaEnvState) -> torch.Tensor:
    """The Isaac-style root-state tensor [A, 13] of one state
    (``panda_env.py:423``): the dynamic bodies' position, orientation
    quaternion, linear and angular velocity; every other actor keeps its
    initial root."""
    moving = torch.cat([state.body_pos, state.body_quat, state.body_vel, state.body_om], dim=-1)
    # rows picked by Python index: no index tensor, so a CUDA graph can capture it
    slot = {a: k for k, a in enumerate(params.dyn_actor_idx)}
    return torch.stack([moving[slot[a]] if a in slot else params.init_root[a] for a in range(params.init_root.shape[0])])


def load_root_state(params: PandaEnvParams, state: PandaEnvState, root: torch.Tensor) -> PandaEnvState:
    """The dynamic bodies of ``state`` from a root-state tensor, the inverse
    of :func:`root_state_view` (``panda_env.py:433``)."""
    rows = root[list(params.dyn_actor_idx)]
    return dataclasses.replace(
        state, body_pos=rows[:, 0:3], body_quat=rows[:, 3:7], body_vel=rows[:, 7:10], body_om=rows[:, 10:13]
    )
