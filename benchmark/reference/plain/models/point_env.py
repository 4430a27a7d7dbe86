"""Point-robot environment: batched planar rigid-body simulation in torch.

Port of ``m3p2i_aip_tpu/models/point_env.py``: an omni point robot (or the
heijn omni / boxer diff-drive bases), four arena walls, one static obstacle,
a movable obstacle ("dyn-obs"), a pushable/pullable box, and non-colliding
goal and axis markers.

``step(params, state, u, ext)`` is one function over arbitrary leading batch
dimensions: the K MPPI rollouts carry a leading K axis where the JAX package
used ``jax.vmap``, and the real system is the same function with no batch
axis.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from benchmark.reference.plain.ops import quat
from benchmark.reference.plain.ops.norm import vector_norm
from benchmark.reference.plain.ops.quat_np import yaw_from_quat
from benchmark.reference.plain.sim import pbd2d
from benchmark.reference.plain.sim.sim_config import ActorCfg, SimConfig

GRAVITY = 9.8  # matches sim_params.gravity (isaacgym_wrapper.py:25)


@dataclass
class PointEnvState:
    """Simulation state; every field may carry leading batch dims.

    ``q``/``qd`` are [..., 2] (x, y) for the point robot and [..., 3]
    (x, y, yaw) for the heijn and boxer bases.
    """

    q: torch.Tensor  # [..., nq]
    qd: torch.Tensor  # [..., nq]
    dyn_pos: torch.Tensor  # [..., D, 2]
    dyn_yaw: torch.Tensor  # [..., D]
    dyn_vel: torch.Tensor  # [..., D, 2]
    dyn_om: torch.Tensor  # [..., D]
    contact_force: torch.Tensor  # [..., A, 3] net contact force per actor
    # per-state friction multiplier on the dynamic actors' material friction
    # (ones = nominal); the K rollout states may each carry their own draw
    fric_scale: torch.Tensor  # [..., D]


@dataclass
class PointExtForces:
    """External (suction) forces carried into the next step."""

    robot: torch.Tensor  # [..., 2]
    dyn: torch.Tensor  # [..., D, 2]


@dataclass
class PointEnvParams:
    # static geometry
    stat_pos: torch.Tensor  # [S, 2]
    stat_yaw: torch.Tensor  # [S]
    stat_half: torch.Tensor  # [S, 2]
    stat_friction: torch.Tensor  # [S]
    # dynamic boxes
    dyn_half: torch.Tensor  # [D, 2]
    dyn_mass: torch.Tensor  # [D]
    dyn_inv_mass: torch.Tensor  # [D]
    dyn_inv_inertia: torch.Tensor  # [D]
    dyn_mu_ground: torch.Tensor  # [D]
    dyn_friction: torch.Tensor  # [D]
    dyn_z: torch.Tensor  # [D] resting height of the root
    init_dyn_pos: torch.Tensor  # [D, 2]
    init_root: torch.Tensor  # [A, 13]
    dyn_fric_noise: torch.Tensor  # [D] per-actor noise_percentage_friction
    # robot
    robot_mass: float = 10.0
    robot_radius: float = 0.2
    # innermost wall-face coordinate of a closed axis-aligned arena (0 = none)
    arena_bound: float = 0.0
    drive_rate: float = 60.0
    robot_friction: float = 0.05
    robot_type: str = "point"  # "point" | "heijn" | "boxer"
    wheel_radius: float = 0.08
    wheel_base: float = 0.314
    # integration
    dt: float = 0.05
    substeps: int = 2
    pos_iters: int = 2
    max_dyn_speed: float = 20.0
    # bookkeeping (host-side)
    actor_names: tuple = ()
    dyn_actor_idx: tuple = ()
    stat_actor_idx: tuple = ()
    robot_actor_idx: int = 0
    num_actors: int = 0

    @property
    def device(self) -> torch.device:
        return self.dyn_half.device


def build_params(
    actors: List[ActorCfg],
    sim_cfg: SimConfig,
    rng: Optional[np.random.Generator] = None,
    device="cpu",
) -> PointEnvParams:
    """Pack the per-actor YAML configs into tensors on ``device``.

    Host-side numpy, as in ``m3p2i_aip_tpu/models/point_env.py:116``: ground
    friction combines as PhysX's average with the plane's 1.0, mass comes
    from PhysX's default density (the YAML ``mass`` is ignored, as upstream),
    and ``rng`` applies the friction/size domain randomization.
    """
    stat, dyn, dyn_idx, stat_idx = [], [], [], []
    dyn_fric_noise = []
    robot_idx, robot_cfg = 0, None
    init_root = np.zeros((len(actors), 13), dtype=np.float32)
    init_root[:, 6] = 1.0  # identity quat w
    names = []

    def rand_friction(a: ActorCfg) -> float:
        if rng is None or not a.noise_percentage_friction:
            return a.friction
        lim = a.noise_percentage_friction * a.friction
        return a.friction + float(rng.uniform(-lim, lim))

    def rand_size(a: ActorCfg) -> np.ndarray:
        size = np.asarray(a.size, dtype=np.float32)
        if rng is None or not a.noise_sigma_size:
            return size
        return size + rng.normal(0.0, np.asarray(a.noise_sigma_size)).astype(np.float32)

    for i, a in enumerate(actors):
        names.append(a.name)
        init_root[i, 0:3] = a.init_pos
        init_root[i, 3:7] = a.init_ori
        if a.type == "robot":
            robot_idx, robot_cfg = i, a
        elif a.type == "box" and a.collision:
            yaw = float(yaw_from_quat(a.init_ori))
            friction = rand_friction(a)
            size = rand_size(a)
            if a.fixed:
                stat.append((a.init_pos[0], a.init_pos[1], yaw, size[0] / 2, size[1] / 2, friction))
                stat_idx.append(i)
            else:
                dyn.append(
                    (a.init_pos[0], a.init_pos[1], size[0] / 2, size[1] / 2, a.mass, friction, size[2] / 2)
                )
                dyn_idx.append(i)
                dyn_fric_noise.append(float(a.noise_percentage_friction or 0.0))
    stat = np.asarray(stat, dtype=np.float32).reshape(-1, 6)
    dyn = np.asarray(dyn, dtype=np.float32).reshape(-1, 7)
    half = dyn[:, 2:4]
    masses = 1000.0 * (2 * half[:, 0]) * (2 * half[:, 1]) * (2 * dyn[:, 6])
    inertia = masses * ((2 * half[:, 0]) ** 2 + (2 * half[:, 1]) ** 2) / 12.0

    robot_type, robot_radius, robot_mass = "point", 0.2, 10.0
    wheel_radius, wheel_base = 0.08, 2 * 0.157  # boxer.urdf wheel geometry
    if robot_cfg is not None:
        urdf = (robot_cfg.urdf_file or "").lower()
        if robot_cfg.differential_drive or "boxer" in urdf or "albert" in urdf:
            robot_type, robot_radius, robot_mass = "boxer", 0.3, 40.0
            if robot_cfg.wheel_radius:
                wheel_radius = float(robot_cfg.wheel_radius)
            if robot_cfg.wheel_base:
                wheel_base = float(robot_cfg.wheel_base)
        elif "heijn" in urdf:
            robot_type, robot_radius, robot_mass = "heijn", 0.35, 30.0

    # closed-arena bound: innermost face of the axis-aligned boundary walls;
    # the robot is clamped inside it every substep
    arena_bound = 0.0
    for a in actors:
        if a.type == "box" and a.collision and a.fixed and "wall" in a.name:
            thickness = min(a.size[0], a.size[1]) / 2
            b = max(abs(a.init_pos[0]), abs(a.init_pos[1])) - thickness
            arena_bound = b if arena_bound == 0.0 else min(arena_bound, b)

    def t(x):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=torch.float32, device=device)

    return PointEnvParams(
        arena_bound=float(arena_bound),
        stat_pos=t(stat[:, 0:2]),
        stat_yaw=t(stat[:, 2]),
        stat_half=t(stat[:, 3:5]),
        stat_friction=t(stat[:, 5]),
        dyn_half=t(half),
        dyn_mass=t(masses),
        dyn_inv_mass=t(1.0 / masses),
        dyn_inv_inertia=t(1.0 / inertia),
        dyn_mu_ground=t((dyn[:, 5] + 1.0) / 2.0),
        dyn_friction=t(dyn[:, 5]),
        dyn_z=t(dyn[:, 6]),
        init_dyn_pos=t(dyn[:, 0:2]),
        init_root=t(init_root),
        dyn_fric_noise=t(np.asarray(dyn_fric_noise, np.float32)),
        robot_mass=robot_mass,
        robot_radius=robot_radius,
        drive_rate=sim_cfg.drive_damping / 10.0,
        robot_friction=robot_cfg.friction if robot_cfg else 0.05,
        robot_type=robot_type,
        wheel_radius=wheel_radius,
        wheel_base=wheel_base,
        dt=sim_cfg.dt,
        substeps=sim_cfg.substeps,
        actor_names=tuple(names),
        dyn_actor_idx=tuple(dyn_idx),
        stat_actor_idx=tuple(stat_idx),
        robot_actor_idx=robot_idx,
        num_actors=len(actors),
    )


def robot_nq(params: PointEnvParams) -> int:
    return 2 if params.robot_type == "point" else 3


def robot_nu(params: PointEnvParams) -> int:
    """Action dim: point (vx, vy); heijn (vx, vy, vyaw); boxer (vl, vr)."""
    return {"point": 2, "heijn": 3, "boxer": 2}[params.robot_type]


def init_state(params: PointEnvParams) -> PointEnvState:
    D = params.dyn_half.shape[0]
    nq = robot_nq(params)
    z = dict(dtype=torch.float32, device=params.device)
    return PointEnvState(
        q=torch.zeros(nq, **z),
        qd=torch.zeros(nq, **z),
        dyn_pos=params.init_dyn_pos.clone(),
        dyn_yaw=torch.zeros(D, **z),
        dyn_vel=torch.zeros(D, 2, **z),
        dyn_om=torch.zeros(D, **z),
        contact_force=torch.zeros(params.num_actors, 3, **z),
        fric_scale=torch.ones(D, **z),
    )


def zero_ext(params: PointEnvParams, batch=()) -> PointExtForces:
    D = params.dyn_half.shape[0]
    z = dict(dtype=torch.float32, device=params.device)
    return PointExtForces(
        robot=torch.zeros(*batch, 2, **z), dyn=torch.zeros(*batch, D, 2, **z)
    )


def _set_xy(q: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """``q.at[..., :2].set(xy)`` for 2- and 3-dof robots."""
    if q.shape[-1] == 2:
        return xy
    return torch.cat([xy, q[..., 2:]], dim=-1)


def _add_xy(q: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    return _set_xy(q, q[..., :2] + d)


def step(
    params: PointEnvParams,
    state: PointEnvState,
    u_target: torch.Tensor,
    ext: PointExtForces,
) -> PointEnvState:
    """One control step = ``substeps`` PBD substeps (``point_env.py:283``).

    Velocity drive, robot speed cap, ground friction (per-state
    ``fric_scale``), then per position iteration five Jacobi contact passes:
    robot vs dynamic boxes, dynamic vs dynamic, dynamic vs statics (full
    strength), robot vs statics, robot vs immovable dynamic boxes; the robot
    is clamped inside the arena after every substep.  ``contact_force`` is
    the per-actor contact force averaged over the substeps x iterations.
    """
    h = params.dt / params.substeps
    D = params.dyn_half.shape[0]
    rr = params.robot_radius

    q, qd = state.q, state.qd
    dpos, dyaw = state.dyn_pos, state.dyn_yaw
    dvel, dom = state.dyn_vel, state.dyn_om
    batch = q.shape[:-1]
    # planar force accumulators per category (the z component is always 0)
    f_rob = torch.zeros(*batch, 2, dtype=q.dtype, device=q.device)
    f_dyn = torch.zeros_like(dpos)
    f_stat = torch.zeros(*batch, params.stat_pos.shape[0], 2, dtype=q.dtype, device=q.device)

    wm_r = 1.0 / params.robot_mass
    decay = float(np.exp(-params.drive_rate * params.dt / params.substeps))
    fric = params.dyn_friction * state.fric_scale
    mu_ground = (fric + 1.0) * 0.5
    ang_radius = torch.mean(params.dyn_half, dim=-1)

    for _ in range(params.substeps):
        # --- velocity integration -------------------------------------------
        qd = _add_xy(qd, ext.robot * (wm_r * h))
        if params.robot_type == "boxer":
            # differential drive: wheel speeds (vl, vr) -> base twist
            v = params.wheel_radius * (u_target[..., 0] + u_target[..., 1]) / 2.0
            om = params.wheel_radius * (u_target[..., 1] - u_target[..., 0]) / params.wheel_base
            th = q[..., 2]
            qd_target = torch.stack([v * torch.cos(th), v * torch.sin(th), om], dim=-1)
        else:
            qd_target = u_target  # world-frame dof velocities (point/heijn)
        qd = qd_target + (qd - qd_target) * decay
        # robot speed cap: one substep can never out-run the contact envelope
        qspeed = vector_norm(qd[..., :2], dim=-1, keepdim=True)
        qcap = torch.clamp(6.0 / torch.clamp(qspeed, min=1e-9), max=1.0)
        qd = _set_xy(qd, qd[..., :2] * qcap)
        dvel = dvel + ext.dyn * (params.dyn_inv_mass[:, None] * h)
        dvel, dom = pbd2d.ground_friction(dvel, dom, mu_ground, GRAVITY, h, ang_radius)
        speed = vector_norm(dvel, dim=-1, keepdim=True)
        dvel = dvel * torch.clamp(params.max_dyn_speed / torch.clamp(speed, min=1e-9), max=1.0)

        # --- position integration --------------------------------------------
        q = q + qd * h
        dpos = dpos + dvel * h
        dyaw = dyaw + dom * h

        # The point kernel (csrc/point_rollout.cu) adds its contact
        # corrections in the order PyTorch's CUDA reductions add the sums
        # below at these layouts ([.., D, S, 4, 2], [.., D, S, 4], [.., S, 2],
        # [.., 4, 2], [.., 4]; its head note gives each order), and so
        # follows this step bit for bit on the card.  A new layout here keeps
        # the math and changes only the rounding;
        # tests/test_torch_cuda.py::test_point_kernel_equals_plain_bit_for_bit
        # shows it.
        for _ in range(params.pos_iters):
            # pass 1: robot circle vs every dynamic box, Jacobi from the
            # pre-pass robot pose
            q2 = q[..., None, :2]
            c = pbd2d.circle_vs_obb(q2, rr, dpos, dyaw, params.dyn_half)
            out = pbd2d.resolve_contact(
                c, q2, 0.0, qd[..., None, :2], 0.0, wm_r, 0.0,
                dpos, dyaw, dvel, dom, params.dyn_inv_mass, params.dyn_inv_inertia,
                h, friction=(params.robot_friction + fric) / 2, relax=1.0,
            )
            q = _add_xy(q, out[0].sum(-2))
            qd = _add_xy(qd, out[2].sum(-2))
            dpos, dyaw = dpos + out[4], dyaw + out[5]
            dvel, dom = dvel + out[6], dom + out[7]
            f_rob = f_rob + out[8].sum(-2)
            f_dyn = f_dyn - out[8]

            # pass 2: dynamic vs dynamic (corners of i inside j, both
            # orders), Jacobi from the pre-pass poses
            if D > 1:
                zero2 = torch.zeros_like(dpos[..., 0, :])
                zero1 = torch.zeros_like(dyaw[..., 0])
                ddpos, ddvel, dfd = [zero2] * D, [zero2] * D, [zero2] * D
                ddyaw, ddom = [zero1] * D, [zero1] * D
                for i in range(D):
                    for j in range(D):
                        if i == j:
                            continue
                        c = pbd2d.corners_vs_obb(
                            dpos[..., i, :], dyaw[..., i], params.dyn_half[i],
                            dpos[..., j, :], dyaw[..., j], params.dyn_half[j],
                        )
                        out = pbd2d.resolve_contact(
                            c,
                            dpos[..., i, None, :], dyaw[..., i, None],
                            dvel[..., i, None, :], dom[..., i, None],
                            params.dyn_inv_mass[i], params.dyn_inv_inertia[i],
                            dpos[..., j, None, :], dyaw[..., j, None],
                            dvel[..., j, None, :], dom[..., j, None],
                            params.dyn_inv_mass[j], params.dyn_inv_inertia[j],
                            h, friction=(fric[..., i, None] + fric[..., j, None]) / 2, relax=0.5,
                        )
                        ddpos[i] = ddpos[i] + out[0].sum(-2)
                        ddpos[j] = ddpos[j] + out[4].sum(-2)
                        ddyaw[i] = ddyaw[i] + out[1].sum(-1)
                        ddyaw[j] = ddyaw[j] + out[5].sum(-1)
                        ddvel[i] = ddvel[i] + out[2].sum(-2)
                        ddvel[j] = ddvel[j] + out[6].sum(-2)
                        ddom[i] = ddom[i] + out[3].sum(-1)
                        ddom[j] = ddom[j] + out[7].sum(-1)
                        f_p = out[8].sum(-2)
                        dfd[i] = dfd[i] + f_p
                        dfd[j] = dfd[j] - f_p
                dpos = dpos + torch.stack(ddpos, dim=-2)
                dyaw = dyaw + torch.stack(ddyaw, dim=-1)
                dvel = dvel + torch.stack(ddvel, dim=-2)
                dom = dom + torch.stack(ddom, dim=-1)
                f_dyn = f_dyn + torch.stack(dfd, dim=-2)

            # pass 3: dynamic boxes vs static boxes [D, S, 4], full strength:
            # per-corner corrections normalized by the active-corner count
            c = pbd2d.corners_vs_obb(
                dpos[..., :, None, :], dyaw[..., :, None], params.dyn_half[:, None, :],
                params.stat_pos, params.stat_yaw, params.stat_half,
            )
            n_active = torch.sum(c.pen > 0, dim=-1, keepdim=True)  # [..., D, S, 1]
            relax_ds = 1.0 / torch.clamp(n_active, min=1).to(c.pen.dtype)
            out = pbd2d.resolve_contact(
                c,
                dpos[..., :, None, None, :], dyaw[..., :, None, None],
                dvel[..., :, None, None, :], dom[..., :, None, None],
                params.dyn_inv_mass[:, None, None], params.dyn_inv_inertia[:, None, None],
                params.stat_pos[:, None, :], params.stat_yaw[:, None],
                0.0, 0.0, 0.0, 0.0,
                h,
                friction=(fric[..., :, None, None] + params.stat_friction[:, None]) / 2,
                relax=relax_ds,
            )
            dpos = dpos + out[0].sum((-3, -2))
            dyaw = dyaw + out[1].sum((-2, -1))
            dvel = dvel + out[2].sum((-3, -2))
            dom = dom + out[3].sum((-2, -1))
            f_dyn = f_dyn + out[8].sum((-3, -2))
            f_stat = f_stat - out[8].sum((-4, -2))

            # pass 4: robot circle vs static boxes, full strength
            q2 = q[..., None, :2]
            c = pbd2d.circle_vs_obb(q2, rr, params.stat_pos, params.stat_yaw, params.stat_half)
            out = pbd2d.resolve_contact(
                c, q2, 0.0, qd[..., None, :2], 0.0, wm_r, 0.0,
                params.stat_pos, params.stat_yaw, 0.0, 0.0, 0.0, 0.0,
                h, friction=(params.robot_friction + params.stat_friction) / 2, relax=1.0,
            )
            q = _add_xy(q, out[0].sum(-2))
            qd = _add_xy(qd, out[2].sum(-2))
            f_rob = f_rob + out[8].sum(-2)
            f_stat = f_stat - out[8]

            # pass 5: robot vs dynamic boxes held IMMOVABLE: closes the
            # robot -> box -> wall chain so the drive cannot squeeze a box
            # across a thin wall
            q2 = q[..., None, :2]
            c = pbd2d.circle_vs_obb(q2, rr, dpos, dyaw, params.dyn_half)
            out = pbd2d.resolve_contact(
                c, q2, 0.0, qd[..., None, :2], 0.0, wm_r, 0.0,
                dpos, dyaw, dvel, dom, 0.0, 0.0,
                h, friction=0.0, relax=1.0,
            )
            q = _add_xy(q, out[0].sum(-2))
            qd = _add_xy(qd, out[2].sum(-2))

        # closed-arena invariant: the robot never ends a substep outside
        if params.arena_bound > 0.0:
            lim = params.arena_bound - rr
            q = _set_xy(q, torch.clamp(q[..., :2], -lim, lim))

    n_norm = params.substeps * params.pos_iters
    # actor-indexed contact_force, stacked in actor order
    zero = torch.zeros_like(f_rob)
    rows = [zero] * params.num_actors
    rows[params.robot_actor_idx] = f_rob
    for k, a in enumerate(params.dyn_actor_idx):
        rows[a] = f_dyn[..., k, :]
    for k, a in enumerate(params.stat_actor_idx):
        rows[a] = f_stat[..., k, :]
    f_xy = torch.stack(rows, dim=-2)
    force_accum = torch.cat([f_xy, torch.zeros_like(f_xy[..., :1])], dim=-1)
    return dataclasses.replace(
        state,
        q=q,
        qd=qd,
        dyn_pos=dpos,
        dyn_yaw=dyaw,
        dyn_vel=dvel,
        dyn_om=dom,
        contact_force=force_accum / n_norm,
    )


def root_state_view(params: PointEnvParams, state: PointEnvState) -> torch.Tensor:
    """The Isaac-style root-state tensor [A, 13] of one state (position,
    quaternion, linear and angular velocity per actor;
    ``point_env.py:532``).  Fixed actors and the robot keep their initial
    root: the robot moves in its dofs."""
    zeros = torch.zeros_like(params.dyn_z)[:, None]
    moving = torch.cat([state.dyn_pos, params.dyn_z[:, None], quat.quat_from_yaw(state.dyn_yaw), state.dyn_vel, zeros,
                        zeros, zeros, state.dyn_om[:, None]], dim=-1)  # [D, 13]
    # rows picked by Python index: no index tensor, so a CUDA graph can capture it
    slot = {a: k for k, a in enumerate(params.dyn_actor_idx)}
    return torch.stack([moving[slot[a]] if a in slot else params.init_root[a] for a in range(params.init_root.shape[0])])


def load_root_state(params: PointEnvParams, state: PointEnvState, root: torch.Tensor) -> PointEnvState:
    """The dynamic bodies of ``state`` from a root-state tensor: the inverse
    of :func:`root_state_view` (``point_env.py:558``), up to the float32
    yaw -> quaternion -> yaw round trip."""
    rows = root[list(params.dyn_actor_idx)]
    return dataclasses.replace(
        state,
        dyn_pos=rows[:, 0:2],
        dyn_yaw=quat.yaw_from_quat(rows[:, 3:7]),
        dyn_vel=rows[:, 7:9],
        dyn_om=rows[:, 12],
    )
