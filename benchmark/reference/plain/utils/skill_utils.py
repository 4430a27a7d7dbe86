"""Suction force model, its real-env gate and the real-time pacing, in torch.

Port of ``m3p2i_aip_tpu/utils/skill_utils.py:14-60, :88`` (the reference's
``skill_utils.calculate_suction:59-94``, ``check_suction_condition:47-56``
and ``time_tracking:25-33``).
"""
from __future__ import annotations

import time

import torch


def calculate_suction(
    box_pos: torch.Tensor,
    robot_pos: torch.Tensor,
    kp_suction: float,
    threshold: float,
    clamp: float = 500.0,
):
    """Suction pull-force pair between box and robot, batched over [..., 2].

    Magnitude kp/dist along the box->robot line, gated on 1/dist > threshold
    (1.5 for the real env, 1.8 for rollouts — the reference's intentional
    difference, mirrored), clamped to +-500, equal and opposite on the robot.
    Returns (force_on_box, force_on_robot).
    """
    dir_vec = box_pos - robot_pos
    dist = torch.linalg.vector_norm(dir_vec, dim=-1, keepdim=True)
    magnitude = 1.0 / torch.clamp(dist, min=1e-6)
    unit_force = dir_vec * magnitude
    mask = (magnitude > threshold).to(unit_force.dtype)
    f_box = torch.clamp(-kp_suction * unit_force * mask, -clamp, clamp)
    f_robot = torch.clamp(kp_suction * unit_force * mask, -clamp, clamp)
    return f_box, f_robot


def check_suction_condition(task: str, suction_active: bool, robot_pos, box_pos, action) -> bool:
    """Host-side gate for suction in the real-system loop (syncs: not for the
    chunked path, which uses ``ReactiveTAMP._suction_ext_device``): a
    pull-family task, suction enabled, robot within 0.6 m of the box, and the
    action pointing away from the box."""
    if task not in ("pull", "push_pull") or not suction_active:
        return False
    dir_rb = robot_pos - box_pos
    align = float(torch.sum(action[..., :2] * dir_rb))
    dist = float(torch.linalg.vector_norm(dir_rb))
    return dist < 0.6 and align > 0


def apply_fk(robot: str, u: torch.Tensor) -> torch.Tensor:
    """Wheel speeds from (v, omega) for the differential drives
    (skill_utils.py:62; r = 0.08, L = 2 * 0.157): the boxer's channels 0, 1,
    the albert's 11, 12; other robots' actions pass through.  Returns a new
    tensor."""
    r, L = 0.08, 2 * 0.157
    cols = {"boxer": (0, 1), "albert": (11, 12)}.get(robot)
    if cols is None:
        return u
    v, w = u[..., cols[0]], u[..., cols[1]]
    out = u.clone()
    out[..., cols[0]] = (v / r) - (L * w) / (2 * r)
    out[..., cols[1]] = (v / r) + (L * w) / (2 * r)
    return out


def apply_ik(robot: str, u: torch.Tensor) -> torch.Tensor:
    """The batched variant ([num_envs, dofs], skill_utils.py:79): the same
    (v, omega) -> wheel-speed map."""
    return apply_fk(robot, u)


def time_tracking(t: float, dt: float, verbose: bool = True) -> float:
    """Soft real-time pacing of an interactive loop (skill_utils.py:88):
    sleep off what is left of the control period ``dt`` since ``t``, print
    the achieved rate and real-time factor, and return the new tick start."""
    actual_dt = time.time() - t
    rt = dt / max(actual_dt, 1e-9)
    if rt > 1.0:
        time.sleep(max(0.0, dt - actual_dt))
        actual_dt = time.time() - t
        rt = dt / max(actual_dt, 1e-9)
    if verbose:
        print("FPS: {:.3f}".format(1 / max(actual_dt, 1e-9)), "RT: {:.3f}".format(rt))
    return time.time()
