"""Albert mobile manipulator in torch: a differential-drive base + Panda arm.

Port of ``m3p2i_aip_tpu/models/albert.py``.  The 13-channel control vector
follows the reference's albert channel convention:

  u[0:2]   castor joints (free-spinning, ignored)
  u[2:9]   panda arm joint velocity targets
  u[9:11]  finger velocity targets
  u[11:13] wheel speeds (left, right)

State q: [x, y, yaw, arm(7), fingers(2)] = 12.  A scene with a pushable box
couples the base and the box through a planar PBD contact (the base as a
circle, the box as an oriented box).  ``step`` and ``fk`` take any leading
batch dimensions: the K rollout states carry a leading K axis where the JAX
package used ``jax.vmap``, and the real system is the same function with none.
"""
from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from benchmark.reference.plain.models import panda_fk
from benchmark.reference.plain.sim import pbd2d
from benchmark.reference.plain.sim.sim_config import ActorCfg, SimConfig

WHEEL_RADIUS = 0.08  # skill_utils.apply_fk r
WHEEL_BASE = 2 * 0.157  # skill_utils.apply_fk L
ARM_MOUNT = np.array([0.0, 0.0, 0.4], dtype=np.float32)  # arm base on the torso
GRAVITY = 9.8

_REST_ARM = np.asarray([0, 0, 0, -2, 0, 1.8675, 0, 0.02, 0.02], np.float32)
_PARKED_BOX = (1e3, 1e3)  # where a boxless scene keeps its (inert) box


@dataclass
class AlbertState:
    """Simulation state; every field may carry leading batch dims."""

    q: torch.Tensor  # [..., 12] base pose (3) + arm (7) + fingers (2)
    qd: torch.Tensor  # [..., 12]
    box_pos: torch.Tensor  # [..., 2]
    box_yaw: torch.Tensor  # [...]
    box_vel: torch.Tensor  # [..., 2]
    box_om: torch.Tensor  # [...]


@dataclass
class AlbertParams:
    init_q: torch.Tensor  # [12]
    dt: float = 0.05
    substeps: int = 2
    drive_rate: float = 60.0
    actor_names: tuple = ("albert",)
    # scenes without a pushable box skip the contact solve entirely
    has_box: bool = False
    box_init: Optional[torch.Tensor] = None  # [3] x, y, yaw
    box_half: Optional[torch.Tensor] = None  # [2]
    box_inv_mass: Optional[torch.Tensor] = None  # []
    box_inv_inertia: Optional[torch.Tensor] = None  # []
    box_friction: Optional[torch.Tensor] = None  # [] material
    # base collision footprint + PBD mass (contact only; the drive itself is
    # velocity-kinematic)
    base_radius: float = 0.35
    base_mass: float = 100.0

    @property
    def device(self) -> torch.device:
        return self.init_q.device


def build_params(actors: List[ActorCfg], sim_cfg: SimConfig, device) -> AlbertParams:
    """Scene params from the albert_env actor YAMLs (``albert.py:71``).  The
    box mass and inertia come from PhysX's default density 1000 kg/m^3, not
    from the YAML mass, which the reference never applies."""
    init_q = np.zeros(12, dtype=np.float32)
    init_q[3:12] = _REST_ARM
    names = []
    box_kwargs = {}

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    for a in actors:
        names.append(a.name)
        if a.type == "robot":
            init_q[0:2] = np.asarray(a.init_pos[:2], np.float32)
            if a.init_joint_pose:
                # interleaved (pos, vel) 24-vector, like the panda convention
                init_q = np.asarray(a.init_joint_pose, np.float32)[0::2]
        elif a.type == "box" and a.collision and not a.fixed:
            half = np.asarray(a.size, np.float32) / 2.0
            mass = 1000.0 * float(8.0 * half[0] * half[1] * half[2])
            inertia = mass * float((2 * half[0]) ** 2 + (2 * half[1]) ** 2) / 12.0
            box_kwargs = dict(
                has_box=True,
                box_init=t([a.init_pos[0], a.init_pos[1], 0.0]),
                box_half=t(half[:2]),
                box_inv_mass=t(1.0 / mass),
                box_inv_inertia=t(1.0 / inertia),
                box_friction=t(float(a.friction)),
            )
    return AlbertParams(
        init_q=t(init_q), dt=sim_cfg.dt, substeps=sim_cfg.substeps, actor_names=tuple(names), **box_kwargs
    )


def init_state(params: AlbertParams) -> AlbertState:
    dev = params.device
    if params.has_box:
        box_pos, box_yaw = params.box_init[:2], params.box_init[2]
    else:
        box_pos = torch.tensor(_PARKED_BOX, dtype=torch.float32, device=dev)
        box_yaw = torch.zeros((), device=dev)
    return AlbertState(
        q=params.init_q,
        qd=torch.zeros(12, device=dev),
        box_pos=box_pos,
        box_yaw=box_yaw,
        box_vel=torch.zeros(2, device=dev),
        box_om=torch.zeros((), device=dev),
    )


def zero_ext(batch=(), device=None) -> torch.Tensor:
    """The albert takes no external forces: an empty [..., 0] tensor."""
    return torch.zeros(*batch, 0, device=device)


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device) -> dict:
    """The joint limits and the arm mount on ``device``, made once per
    device: a host->device copy inside the loop would synchronize the stream."""
    return {
        "lower": torch.as_tensor(panda_fk.JOINT_LOWER, device=device),
        "upper": torch.as_tensor(panda_fk.JOINT_UPPER, device=device),
        "mount": torch.as_tensor(ARM_MOUNT, device=device),
    }


def step(params: AlbertParams, state: AlbertState, u: torch.Tensor) -> AlbertState:
    """One control step (``albert.py:139``): per substep the diff-drive base
    and the 9-channel arm velocity drive, the arm clip, and with a box its
    ground friction, integration and two Jacobi base-vs-box contact passes."""
    h = params.dt / params.substeps
    decay = float(np.exp(-params.drive_rate * params.dt / params.substeps))
    q, qd = state.q, state.qd
    bpos, byaw, bvel, bom = state.box_pos, state.box_yaw, state.box_vel, state.box_om
    tb = _tables(q.device)
    wm_base = 1.0 / params.base_mass
    if params.has_box:
        mu_g = (params.box_friction + 1.0) * 0.5  # PhysX combine vs the plane
        ang_radius = torch.mean(params.box_half)
        friction = (0.05 + params.box_friction) / 2

    for _ in range(params.substeps):
        v = WHEEL_RADIUS * (u[..., 11] + u[..., 12]) / 2.0
        om = WHEEL_RADIUS * (u[..., 12] - u[..., 11]) / WHEEL_BASE
        th = q[..., 2]
        base_target = torch.stack([v * torch.cos(th), v * torch.sin(th), om], dim=-1)
        qd_target = torch.cat([base_target, u[..., 2:11]], dim=-1)
        qd = qd_target + (qd - qd_target) * decay
        q = q + qd * h
        q = torch.cat([q[..., :3], torch.minimum(torch.maximum(q[..., 3:12], tb["lower"]), tb["upper"])], dim=-1)

        if params.has_box:
            bvel, bom = pbd2d.ground_friction(bvel, bom, mu_g, GRAVITY, h, ang_radius)
            bpos = bpos + bvel * h
            byaw = byaw + bom * h
            for _ in range(2):  # Jacobi passes, point_env-style
                c = pbd2d.circle_vs_obb(q[..., :2], params.base_radius, bpos, byaw, params.box_half)
                out = pbd2d.resolve_contact(
                    c, q[..., :2], q[..., 2], qd[..., :2], 0.0, wm_base, 0.0,
                    bpos, byaw, bvel, bom, params.box_inv_mass, params.box_inv_inertia,
                    h, friction=friction, relax=1.0,
                )
                q = torch.cat([q[..., :2] + out[0], q[..., 2:]], dim=-1)
                qd = torch.cat([qd[..., :2] + out[2], qd[..., 2:]], dim=-1)
                bpos = bpos + out[4]
                byaw = byaw + out[5]
                bvel = bvel + out[6]
                bom = bom + out[7]
    return dataclasses.replace(state, q=q, qd=qd, box_pos=bpos, box_yaw=byaw, box_vel=bvel, box_om=bom)


def fk(state: AlbertState) -> dict:
    """Arm link poses in the world frame (``albert.py:211``): the panda chain
    starts at the base pose with the arm mount composed in.  Returns the link
    dict of :func:`panda_fk.fk`."""
    q = state.q
    base_rot = panda_fk._rot_z(q[..., 2])
    xy0 = torch.cat([q[..., :2], torch.zeros_like(q[..., :1])], dim=-1)
    base_pos = xy0 + torch.matmul(base_rot, _tables(q.device)["mount"])
    return panda_fk.fk(q[..., 3:12], base_pos, base_rot=base_rot)
