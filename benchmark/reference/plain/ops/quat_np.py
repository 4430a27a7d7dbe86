"""Host-side numpy twins of the few ``m3p2i_aip_tpu/ops/quat.py`` helpers the
port's host code needs (scene building and the panda task planner).

Quaternions are (x, y, z, w), scalar last, as in the JAX package.
"""
from __future__ import annotations

import numpy as np


def yaw_from_quat(q) -> np.ndarray:
    """Yaw (rotation about z) of an (x, y, z, w) quaternion, in float32."""
    q = np.asarray(q, dtype=np.float32)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    two = np.float32(2.0)
    return np.arctan2(two * (w * z + x * y), np.float32(1.0) - two * (y * y + z * z))


def quat_to_rotmat(q) -> np.ndarray:
    """[..., 3, 3] rotation matrix (local -> global) of an (x, y, z, w) quaternion."""
    q = np.asarray(q, dtype=np.float64)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    rows = [
        [2 * (w * w + x * x) - 1, 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 2 * (w * w + y * y) - 1, 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 2 * (w * w + z * z) - 1],
    ]
    return np.stack([np.stack(r, axis=-1) for r in rows], axis=-2)


def general_ori_cube2goal(cube_q, goal_q) -> np.ndarray:
    """Flip-invariant orientation cost between cube and goal
    (``m3p2i_aip_tpu/ops/quat.py:158``): for the goal's x and y axes, the best
    |cos| match over all three cube axes."""
    cr = quat_to_rotmat(cube_q)
    gr = quat_to_rotmat(goal_q)
    dots = np.einsum("...ki,...kj->...ij", gr, cr)
    best = 1.0 - np.max(np.abs(dots), axis=-1)
    return best[..., 0] + best[..., 1]
