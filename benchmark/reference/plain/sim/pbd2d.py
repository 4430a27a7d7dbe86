"""Planar position-based (PBD) rigid contact primitives, in torch.

Port of ``m3p2i_aip_tpu/sim/pbd2d.py`` (the replacement for the PhysX contact
solver the reference drives through Isaac Gym).  Every function is
branch-free mask arithmetic over arbitrary leading dimensions, so one call
covers K rollout samples, D dynamic boxes or S statics at once.

Conventions: 2D world; a "body" is (pos [..., 2], yaw, inv_mass, inv_inertia).
Contacts are (penetration, normal, point) with the normal pointing from the
*other* object toward body A (the direction to push A).  Scalars (inverse
masses, angular velocities of statics) may be python floats.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from benchmark.reference.plain.ops.norm import vector_norm


class Contact(NamedTuple):
    pen: torch.Tensor  # [...]: penetration depth, <= 0 means no contact
    normal: torch.Tensor  # [..., 2]: unit, push direction for body A
    point: torch.Tensor  # [..., 2]: world contact point


def _xy(*comps) -> torch.Tensor:
    return torch.stack(comps, dim=-1)


def world_to_local(p, center, yaw):
    d = p - center
    c, s = torch.cos(yaw), torch.sin(yaw)
    return _xy(c * d[..., 0] + s * d[..., 1], -s * d[..., 0] + c * d[..., 1])


def local_to_world_dir(v, yaw):
    c, s = torch.cos(yaw), torch.sin(yaw)
    return _xy(c * v[..., 0] - s * v[..., 1], s * v[..., 0] + c * v[..., 1])


def _face(use_x, sign):
    """Unit local normal (sign, 0) on the x face, (0, sign) on the y face."""
    zero = torch.zeros_like(sign)
    return _xy(torch.where(use_x, sign, zero), torch.where(use_x, zero, sign))


def _dominant_axis(local, half):
    """(use_x, sign) of the dominant normalized coordinate; ties pick x, as
    ``jnp.argmax`` picks the first maximum, and a zero coordinate reads +1."""
    use_x = (torch.abs(local[..., 0]) / half[..., 0]) >= (
        torch.abs(local[..., 1]) / half[..., 1]
    )
    sign = torch.sign(torch.where(use_x, local[..., 0], local[..., 1]))
    return use_x, torch.where(sign == 0, torch.ones_like(sign), sign)


def circle_vs_obb(center, radius, box_pos, box_yaw, box_half) -> Contact:
    """Circle against an oriented box; the normal pushes the circle out.

    Inside the box, the push face is chosen by the center's dominant
    normalized coordinate (the side it entered from), not by minimum
    separation, so a body more than half-way into a thin wall is never
    resolved through it.
    """
    local = world_to_local(center, box_pos, box_yaw)
    clamped = torch.maximum(torch.minimum(local, box_half), -box_half)
    inside = torch.all(torch.abs(local) < box_half, dim=-1)
    use_x, sign = _dominant_axis(local, box_half)
    face_pt = torch.where(
        use_x[..., None],
        _xy(sign * box_half[..., 0], local[..., 1]),
        _xy(local[..., 0], sign * box_half[..., 1]),
    )
    surf_local = torch.where(inside[..., None], face_pt, clamped)

    diff = local - surf_local
    dist = vector_norm(diff, dim=-1)
    n_local_out = torch.where(
        inside[..., None],
        _face(use_x, sign),
        diff / torch.clamp(dist, min=1e-9)[..., None],
    )
    pen = torch.where(inside, radius + dist, radius - dist)
    normal = local_to_world_dir(n_local_out, box_yaw)
    point = box_pos + local_to_world_dir(surf_local, box_yaw)
    return Contact(pen, normal, point)


def _corners(pos, yaw, half):
    """[..., 4, 2] world corners of an oriented box, in the corner order
    (+,+), (+,-), (-,+), (-,-) of the JAX package."""
    hx, hy = half[..., 0], half[..., 1]
    local = _xy(torch.stack([hx, hx, -hx, -hx], -1), torch.stack([hy, -hy, hy, -hy], -1))
    return pos[..., None, :] + local_to_world_dir(local, yaw[..., None])


def corners_vs_obb(pos_a, yaw_a, half_a, pos_b, yaw_b, half_b) -> Contact:
    """Contacts of A's 4 corners inside box B; the normal pushes A out of B.

    The push face is chosen once per body pair from A's *center* relative to
    B, so a body squeezed into a thin wall is always corrected back toward
    the side its center is on.  Penetration is one-sided against that face
    (a corner past B's far face still counts) and gated on the lateral axis.
    Returns a Contact with a trailing corner axis of 4.
    """
    corners = _corners(pos_a, yaw_a, half_a)  # [..., 4, 2]
    local = world_to_local(corners, pos_b[..., None, :], yaw_b[..., None])
    sep = half_b[..., None, :] - torch.abs(local)  # [..., 4, 2]

    center_local = world_to_local(pos_a, pos_b, yaw_b)
    use_x, sign = _dominant_axis(center_local, half_b)
    local_a = torch.where(use_x[..., None], local[..., 0], local[..., 1])
    half_b_a = torch.where(use_x, half_b[..., 0], half_b[..., 1])
    pen_val = half_b_a[..., None] - sign[..., None] * local_a  # [..., 4]
    sep_other = torch.where(use_x[..., None], sep[..., 1], sep[..., 0])
    pen = torch.where((pen_val > 0) & (sep_other > 0), pen_val, -torch.ones_like(pen_val))
    normal = local_to_world_dir(_face(use_x, sign), yaw_b)[..., None, :].expand(
        pen.shape + (2,)
    )
    return Contact(pen, normal, corners)


def cross2(a, b):
    return a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]


def _col(x):
    """Broadcast a per-body scalar against a [..., 2] vector."""
    return x[..., None] if torch.is_tensor(x) else x


def _point_vel(vel, om, r):
    """Velocity of the body point at offset ``r``: v + om x r."""
    return vel + _col(om) * _xy(-r[..., 1], r[..., 0])


def resolve_contact(
    contact: Contact,
    pos_a,
    yaw_a,
    vel_a,
    om_a,
    wm_a,
    wi_a,
    pos_b,
    yaw_b,
    vel_b,
    om_b,
    wm_b,
    wi_b,
    dt: float,
    friction=0.5,
    relax=1.0,
):
    """One Jacobi projection of a single contact (masked when pen <= 0).

    Returns (dpos_a, dyaw_a, dvel_a, dom_a, dpos_b, dyaw_b, dvel_b, dom_b,
    force_on_a).  ``wm_* / wi_*`` are inverse mass / inverse inertia (0 for
    statics).  The yaws are unused (the contact point carries the geometry)
    and kept for signature parity with the JAX package.
    """
    pen, n, p = contact
    active = pen > 0.0
    d = torch.where(active, pen, torch.zeros_like(pen))

    ra = p - pos_a
    rb = p - pos_b
    ca = cross2(ra, n)
    cb = cross2(rb, n)
    w_sum = wm_a + wi_a * ca**2 + wm_b + wi_b * cb**2
    lam = relax * d / torch.clamp(w_sum, min=1e-9)

    dpos_a = _col(wm_a * lam) * n
    dyaw_a = wi_a * lam * ca
    dpos_b = -_col(wm_b * lam) * n
    dyaw_b = -wi_b * lam * cb

    # velocity solve: kill the approaching normal velocity (restitution 0)
    # plus Coulomb friction on the tangential relative velocity
    vrel = _point_vel(vel_a, om_a, ra) - _point_vel(vel_b, om_b, rb)
    vn = torch.sum(vrel * n, dim=-1)
    zero = torch.zeros_like(vn)
    jn = torch.where(active & (vn < 0), -vn / torch.clamp(w_sum, min=1e-9), zero)

    t = _xy(-n[..., 1], n[..., 0])
    ta = cross2(ra, t)
    tb = cross2(rb, t)
    wt_sum = wm_a + wi_a * ta**2 + wm_b + wi_b * tb**2
    vt = torch.sum(vrel * t, dim=-1)
    jt_unclamped = -vt / torch.clamp(wt_sum, min=1e-9)
    jt_max = friction * (jn + lam / dt)
    jt = torch.where(
        active, torch.minimum(torch.maximum(jt_unclamped, -jt_max), jt_max), zero
    )

    dvel_a = _col(wm_a * jn) * n + _col(wm_a * jt) * t
    dom_a = wi_a * jn * ca + wi_a * jt * ta
    dvel_b = -_col(wm_b * jn) * n - _col(wm_b * jt) * t
    dom_b = -wi_b * jn * cb - wi_b * jt * tb

    # equivalent force on A (reaction on B): impulse + position correction
    force = _col((jn + lam / dt) / dt) * n
    return dpos_a, dyaw_a, dvel_a, dom_a, dpos_b, dyaw_b, dvel_b, dom_b, force


def ground_friction(vel, omega, mu, g: float, dt: float, ang_radius):
    """Coulomb ground friction for planar bodies resting on the floor:
    decelerates linear and angular velocity without sign flips."""
    speed = vector_norm(vel, dim=-1)
    scale = torch.clamp(1.0 - mu * g * dt / torch.clamp(speed, min=1e-9), min=0.0)
    om_scale = torch.clamp(
        1.0 - mu * g * dt / torch.clamp(torch.abs(omega) * ang_radius, min=1e-9),
        min=0.0,
    )
    return vel * scale[..., None], omega * om_scale
