"""Quaternion / orientation math in the (x, y, z, w) scalar-last convention,
in torch.

Port of ``m3p2i_aip_tpu/ops/quat.py``: every function takes tensors shaped
``[..., 4]`` (quaternions) or ``[..., 3, 3]`` (rotation matrices) and
broadcasts over the leading batch dims, so the K rollout samples and the one
real state go through the same code.  The numpy twin ``ops/quat_np.py``
serves the host-side task planner.
"""
from __future__ import annotations

import torch

from benchmark.reference.plain.ops.norm import vector_norm


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """Rotation matrix [..., 3, 3] (local -> global) of an (x, y, z, w)
    quaternion (``quat.py:16``)."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    rows = [
        [2 * (w * w + x * x) - 1, 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 2 * (w * w + y * y) - 1, 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 2 * (w * w + z * z) - 1],
    ]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a*b of (x, y, z, w) quaternions, broadcasting."""
    ax, ay, az, aw = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bx, by, bz, bw = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack(
        [
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
            aw * bw - ax * bx - ay * by - az * bz,
        ],
        dim=-1,
    )


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([-q[..., :3], q[..., 3:4]], dim=-1)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vector(s) v [..., 3] by quaternion(s) q [..., 4]."""
    qv = q[..., :3]
    w = q[..., 3:4]
    qv, v = torch.broadcast_tensors(qv, v)
    t = 2.0 * torch.linalg.cross(qv, v, dim=-1)
    return v + w * t + torch.linalg.cross(qv, t, dim=-1)


def quat_inv_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return quat_rotate(quat_conj(q), v)


def quat_from_yaw(yaw: torch.Tensor) -> torch.Tensor:
    """(x, y, z, w) quaternion of a rotation by ``yaw`` about +z
    (``quat.py:75``).  yaw [...] -> [..., 4]."""
    half = 0.5 * yaw
    z = torch.sin(half)
    zero = torch.zeros_like(z)
    return torch.stack([zero, zero, z, torch.cos(half)], dim=-1)


def yaw_from_quat(q: torch.Tensor) -> torch.Tensor:
    """Yaw (rotation about z) of an (x, y, z, w) quaternion (``quat.py:84``).
    The yaw -> quaternion -> yaw round trip is not exact in float32."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.atan2(2.0 * (w * z + x * y), 1.0 - 2.0 * (y * y + z * z))


def quat_normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return q / torch.clamp(vector_norm(q, dim=-1, keepdim=True), min=eps)


def quat_integrate(q: torch.Tensor, omega: torch.Tensor, dt: float) -> torch.Tensor:
    """First-order integration with world-frame angular velocity
    (``quat.py:94``): normalize(q + 0.5 (omega, 0) * q * dt)."""
    ow = torch.cat([omega, torch.zeros_like(omega[..., :1])], dim=-1)
    dq = 0.5 * quat_mul(ow, q) * dt
    return quat_normalize(q + dq)


def mat_to_quat(m: torch.Tensor) -> torch.Tensor:
    """(x, y, z, w) quaternion of a rotation matrix [..., 3, 3]: branch-free
    Shepperd selection over the four candidate formulations (``quat.py:101``)."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22

    def mk(x, y, z, w):
        return torch.stack([x, y, z, w], dim=-1)

    def root(v):
        return torch.sqrt(torch.clamp(v, min=1e-12)) * 2.0

    s0 = root(1.0 + tr)
    c0 = mk((m21 - m12) / s0, (m02 - m20) / s0, (m10 - m01) / s0, 0.25 * s0)
    s1 = root(1.0 + m00 - m11 - m22)
    c1 = mk(0.25 * s1, (m01 + m10) / s1, (m02 + m20) / s1, (m21 - m12) / s1)
    s2 = root(1.0 - m00 + m11 - m22)
    c2 = mk((m01 + m10) / s2, 0.25 * s2, (m12 + m21) / s2, (m02 - m20) / s2)
    s3 = root(1.0 - m00 - m11 + m22)
    c3 = mk((m02 + m20) / s3, (m12 + m21) / s3, 0.25 * s3, (m10 - m01) / s3)

    use0 = (tr > 0.0)[..., None]
    use1 = ((m00 >= m11) & (m00 >= m22))[..., None]
    use2 = (m11 >= m22)[..., None]
    q = torch.where(use0, c0, torch.where(use1, c1, torch.where(use2, c2, c3)))
    return quat_normalize(q)


# ---------------------------------------------------------------------------
# orientation costs (skill_utils.py:183-290 of the reference)
# ---------------------------------------------------------------------------


def _col_dots(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """dots[..., i, j] = <column i of a, column j of b>."""
    return torch.einsum("...ki,...kj->...ij", a, b)


def ori_cost_cube2goal(cube_q: torch.Tensor, goal_q: torch.Tensor) -> torch.Tensor:
    """(1-cos a)+(1-cos b)+(1-cos g) over the three paired body axes."""
    cos = torch.sum(quat_to_rotmat(cube_q) * quat_to_rotmat(goal_q), dim=-2)
    return torch.sum(1.0 - cos, dim=-1)


def ori_cost_ee2cube(ee_q: torch.Tensor, cube_q: torch.Tensor) -> torch.Tensor:
    """ee axes anti-aligned with the cube's: (1+cos a)+(1+cos t)+(1+cos w)."""
    cos = torch.sum(quat_to_rotmat(ee_q) * quat_to_rotmat(cube_q), dim=-2)
    return torch.sum(1.0 + cos, dim=-1)


def general_ori_cube2goal(cube_q: torch.Tensor, goal_q: torch.Tensor) -> torch.Tensor:
    """Flip-invariant cube-vs-goal cost: for the goal's x and y axes, the best
    |cos| over all three cube axes (``quat.py:158``)."""
    dots = _col_dots(quat_to_rotmat(goal_q), quat_to_rotmat(cube_q))
    best = 1.0 - torch.amax(torch.abs(dots), dim=-1)
    return best[..., 0] + best[..., 1]


def general_ori_ee2cube(ee_q: torch.Tensor, cube_q: torch.Tensor, tilt_value: float = 0.0) -> torch.Tensor:
    return general_ori_ee2cube_mat(quat_to_rotmat(ee_q), cube_q, tilt_value)


def general_ori_ee2cube_mat(er: torch.Tensor, cube_q: torch.Tensor, tilt_value: float = 0.0) -> torch.Tensor:
    """Flip-invariant grasp-orientation cost with the ee orientation as a
    rotation matrix (``quat.py:188``).  ``tilt_value == 0``: the ee z-axis
    parallel (up to sign) to some cube axis; otherwise the cube axis most
    aligned with world x (first maximum, per sample) at cos = ``tilt_value``
    to the ee z-axis.  Plus, either way, the ee y-axis parallel to some cube
    axis."""
    cube_axes = quat_to_rotmat(cube_q).transpose(-1, -2)  # [..., 3 (axis), 3 (xyz)]
    ee_y = er[..., :, 1]
    ee_z = er[..., :, 2]
    if tilt_value == 0.0:
        cos_z = torch.abs(torch.einsum("...j,...aj->...a", ee_z, cube_axes))
        cost_z = torch.amin(1.0 - cos_z, dim=-1)
    else:
        idx = torch.argmax(torch.abs(cube_axes[..., 0]), dim=-1)
        sel = torch.take_along_dim(cube_axes, idx[..., None, None], dim=-2)[..., 0, :]
        cost_z = torch.abs(tilt_value - torch.sum(ee_z * sel, dim=-1))
    cos_y = torch.abs(torch.einsum("...j,...aj->...a", ee_y, cube_axes))
    return cost_z + torch.amin(1.0 - cos_y, dim=-1)
