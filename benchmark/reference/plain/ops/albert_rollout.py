"""The albert MPPI rollout: the plain PyTorch version (frozen copy of the
port's ``ops/albert_rollout.py`` with the launch code, the launch counts,
the seed-batched call, the gradient chain and the parity starts left out).

Port of ``m3p2i_aip_tpu/ops/pallas_albert_rollout.py`` (``_albert_kernel``
:55 and its factory ``make_albert_rollout`` :290).  One call rolls K
13-channel action sequences through T steps of ``models/albert.step`` from
ONE start state, scoring each step with ``AlbertObjective.compute`` and
recording the base's xy.

``make_albert_rollout`` returns ``rollout(sim_state_k, acts, task, k0=None)
-> (cost_horizon [K, T], traj_points [K, T, 2])``: ``acts`` arrive already
``u_scale``-scaled and all K states are the broadcast start state.  The
albert is single-mode, so ``k0`` only rides along in the task vector.  The
spec keeps the kernel's constant buffer (``params_buf``): the yardstick
counts its bytes.
"""
from __future__ import annotations

from dataclasses import dataclass
from types import SimpleNamespace

import numpy as np
import torch

from benchmark.reference.plain.models import albert
from benchmark.reference.plain.planners.motion_planner.albert_objective import AlbertObjective
from benchmark.reference.plain.utils.tree import tree_map

STATE_LEN = 30  # q(12), qd(12), box x, y, yaw, vx, vy, om
TASK_LEN = 5  # task_id, goal x, y, z, k0
N_U = 13
_N_SCALARS = 16  # csrc/albert_rollout.cu N_SCALARS


@dataclass
class AlbertRolloutSpec:
    """Everything one scene's rollout needs, built once per scene."""

    env_params: albert.AlbertParams
    objective: AlbertObjective
    K: int
    T: int
    params_buf: torch.Tensor  # [_N_SCALARS] kernel constants, see _param_buffer


def _param_buffer(p: albert.AlbertParams, objective: AlbertObjective) -> np.ndarray:
    """The kernel's constant buffer (layout: ``enum Scalar`` of
    ``csrc/albert_rollout.cu``).  Python scalars (h, the drive decay, the
    wheel geometry, the cost radii) are formed in double and rounded once, as
    the plain version's python-scalar arithmetic is; the box constants are
    formed in float32 by the same tensor expressions ``albert.step`` uses."""
    scalars = np.zeros(_N_SCALARS, np.float32)
    scalars[:6] = [
        p.dt / p.substeps,
        np.exp(-p.drive_rate * p.dt / p.substeps),
        albert.WHEEL_RADIUS,
        albert.WHEEL_BASE,
        1.0 / p.base_mass,
        p.base_radius,
    ]
    if p.has_box:
        half = p.box_half.cpu()
        fric = p.box_friction.cpu()
        scalars[6:13] = [
            float((fric + 1.0) * 0.5),
            float(torch.mean(half)),
            float((0.05 + fric) / 2),
            float(half[0]),
            float(half[1]),
            float(p.box_inv_mass),
            float(p.box_inv_inertia),
        ]
    scalars[13:16] = [objective.approach_r, objective.hover_gate_r, objective.clearance_r]
    return scalars


def pack_state(state: albert.AlbertState) -> torch.Tensor:
    """A start state as the kernel's flat [30] row (``pallas_albert_rollout
    .py:365-389``): q(12), qd(12), box x, y, yaw, vx, vy, om."""
    return torch.cat(
        [state.q, state.qd, state.box_pos, state.box_yaw[..., None], state.box_vel, state.box_om[..., None]],
        dim=-1,
    )


def unpack_state(state0: torch.Tensor, K: int) -> albert.AlbertState:
    """The K broadcast states of a packed row [30], or the K states of K
    packed rows [K, 30]."""
    lead = state0.shape[:-1]

    def rows(a: int, b: int, shape=()):
        return state0[..., a:b].reshape(lead + shape).expand((K,) + shape)

    return albert.AlbertState(
        q=rows(0, 12, (12,)),
        qd=rows(12, 24, (12,)),
        box_pos=rows(24, 26, (2,)),
        box_yaw=rows(26, 27),
        box_vel=rows(27, 29, (2,)),
        box_om=rows(29, 30),
    )


def rollout_inputs(sim_state_k, task, k0=None):
    """(task_vec [5], state0 [30]) of the kernel from the broadcast rollout
    states, the TaskParams and the global sample offset ``k0``.
    task_vec = [task_id, goal x, y, z, k0]."""
    nb = sim_state_k.q.dim() - 2  # the seed dims in front of the K axis
    state0 = pack_state(tree_map(lambda x: x.select(nb, 0), sim_state_k))
    lead = state0.shape[:-1]
    k0v = torch.full(lead + (1,), 0.0 if k0 is None else float(k0), dtype=torch.float32, device=state0.device)
    task_vec = torch.cat(
        [task.task_id.to(torch.float32)[..., None], task.goal[..., :3].to(torch.float32), k0v], dim=-1
    )
    return task_vec, state0


def albert_rollout_plain(spec: AlbertRolloutSpec, task_vec, state0, acts):
    """The rollout as plain tensor code: a loop over T of the batched
    ``albert.step`` and ``AlbertObjective.compute`` (the EE from
    ``albert.fk``).  ``task_vec`` [5] and ``state0`` [30] as
    :func:`rollout_inputs` makes them; ``acts`` [K, T, 13]."""
    p = spec.env_params
    state = unpack_state(state0, acts.shape[0])
    task = SimpleNamespace(task_id=task_vec[..., 0], goal=task_vec[..., 1:4])
    costs, points = [], []
    for t in range(spec.T):
        u_t = acts[:, t]
        state = albert.step(p, state, u_t)
        ee = albert.fk(state)["ee"][0]
        cost, _ = spec.objective.compute(state, u_t, task, None, ee_pos=ee)
        costs.append(cost)
        points.append(state.q[:, :2])
    return torch.stack(costs, dim=1), torch.stack(points, dim=1)


def make_albert_rollout(env_params: albert.AlbertParams, objective: AlbertObjective, K: int, T: int):
    """The rollout callable of an albert scene (see module docstring): the
    plain version on the device of ``acts``."""
    spec = AlbertRolloutSpec(
        env_params=env_params,
        objective=objective,
        K=int(K),
        T=int(T),
        params_buf=torch.as_tensor(_param_buffer(env_params, objective), device=env_params.device),
    )

    def rollout(sim_state_k, acts, task, k0=None):
        return albert_rollout_plain(spec, *rollout_inputs(sim_state_k, task, k0), acts.contiguous())

    rollout.spec = spec
    return rollout
