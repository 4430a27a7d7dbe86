"""Franka Panda forward kinematics in torch (batched over leading dims).

Port of ``m3p2i_aip_tpu/models/panda_fk.py``: 7 revolute joints about local z
with the URDF's fixed offsets and roll twists, a fixed hand with a -45 deg
twist, and two prismatic fingers along the hand's local +/-y.  The constant
tables are numpy float32 copies of the JAX module's, so this module imports
no jax.  Link orientations are rotation matrices composed by float32
matmuls; the caller keeps TF32 off (``ReactiveTAMP`` does on the GPU), as
the JAX side pins ``Precision.HIGHEST``.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

_JOINT_XYZ = np.array(
    [
        [0.0, 0.0, 0.333],
        [0.0, 0.0, 0.0],
        [0.0, -0.316, 0.0],
        [0.0825, 0.0, 0.0],
        [-0.0825, 0.384, 0.0],
        [0.0, 0.0, 0.0],
        [0.088, 0.0, 0.0],
    ],
    dtype=np.float32,
)
_HALF_PI = float(np.pi / 2)
_JOINT_ROLL = np.array(
    [0.0, -_HALF_PI, _HALF_PI, _HALF_PI, -_HALF_PI, _HALF_PI, _HALF_PI], dtype=np.float32
)
HAND_XYZ = np.array([0.0, 0.0, 0.107], dtype=np.float32)
HAND_YAW = float(-np.pi / 4)
FINGER_XYZ = np.array([0.0, 0.0, 0.0584], dtype=np.float32)
FINGERTIP_Z = 0.045  # fingertip reach below the finger-link origin

# joint limits (7 revolute + 2 fingers) from the URDF <limit> tags
JOINT_LOWER = np.array([-2.8973, -1.7628, -2.8973, -3.0718, -2.8973, -0.0175, -2.8973, 0.0, 0.0], dtype=np.float32)
JOINT_UPPER = np.array([2.8973, 1.7628, 2.8973, -0.0698, 2.8973, 3.7525, 2.8973, 0.04, 0.04], dtype=np.float32)
JOINT_VEL_LIMIT = np.array([2.175, 2.175, 2.175, 2.175, 2.61, 2.61, 2.61, 0.2, 0.2], dtype=np.float32)
# drive-force saturation as a joint acceleration limit (panda_fk.py:71-79)
JOINT_ACCEL_LIMIT = np.array([50.0, 50.0, 50.0, 50.0, 80.0, 80.0, 80.0, 10.0, 10.0], dtype=np.float32)


def _rot_x_static(angle: float) -> np.ndarray:
    c, s = np.cos(angle), np.sin(angle)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]], dtype=np.float32)


def _rot_z_static(angle: float) -> np.ndarray:
    c, s = np.cos(angle), np.sin(angle)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], dtype=np.float32)


# fixed per-joint frame rotations (None for joints without a roll)
_ROLL_MATS = [_rot_x_static(a) if a != 0.0 else None for a in _JOINT_ROLL]
_HAND_MAT = _rot_z_static(HAND_YAW)


def _rot_z(theta: torch.Tensor) -> torch.Tensor:
    c, s = torch.cos(theta), torch.sin(theta)
    o, z = torch.ones_like(c), torch.zeros_like(c)
    return torch.stack(
        [torch.stack([c, -s, z], dim=-1), torch.stack([s, c, z], dim=-1), torch.stack([z, z, o], dim=-1)],
        dim=-2,
    )


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device, dtype: torch.dtype) -> dict:
    """The constant tables as tensors on ``device``, made once per device: a
    host->device copy inside the loop would synchronize the stream."""

    def t(x):
        return torch.as_tensor(x, dtype=dtype, device=device)

    return {
        "joint_xyz": [t(v) for v in _JOINT_XYZ],
        "roll": [None if m is None else t(m) for m in _ROLL_MATS],
        "hand_xyz": t(HAND_XYZ),
        "hand_mat": t(_HAND_MAT),
        "finger_xyz": t(FINGER_XYZ),
        "eye": t(np.eye(3, dtype=np.float32)),
    }


def fk(q: torch.Tensor, base_pos: torch.Tensor, base_rot: torch.Tensor | None = None) -> dict:
    """Forward kinematics of joint positions q [..., 9] (``panda_fk.py:113``).

    The chain starts at ``base_pos`` [..., 3] with the rotation ``base_rot``
    [..., 3, 3] (identity when None; the albert passes its base yaw).
    Returns a dict of (pos [..., 3], rot [..., 3, 3]) for 'link1'..'link7',
    'hand', 'leftfinger', 'rightfinger', 'ee' (the finger midpoint) and
    'fingertip' (the grasp point between the fingertips).
    """
    tb = _tables(q.device, q.dtype)
    batch = q.shape[:-1]
    pos = base_pos.to(q.dtype).expand(batch + (3,))
    rot = tb["eye"].expand(batch + (3, 3)) if base_rot is None else base_rot
    links = {}
    for j in range(7):
        pos = pos + torch.matmul(rot, tb["joint_xyz"][j])
        if tb["roll"][j] is not None:
            rot = torch.matmul(rot, tb["roll"][j])
        rot = torch.matmul(rot, _rot_z(q[..., j]))
        links[f"link{j + 1}"] = (pos, rot)
    hand_pos = pos + torch.matmul(rot, tb["hand_xyz"])
    hand_rot = torch.matmul(rot, tb["hand_mat"])
    links["hand"] = (hand_pos, hand_rot)
    f_base = hand_pos + torch.matmul(hand_rot, tb["finger_xyz"])
    y_axis = hand_rot[..., :, 1]
    left_pos = f_base + y_axis * q[..., 7:8]
    right_pos = f_base - y_axis * q[..., 8:9]
    links["leftfinger"] = (left_pos, hand_rot)
    links["rightfinger"] = (right_pos, hand_rot)
    ee = (left_pos + right_pos) / 2.0
    links["ee"] = (ee, hand_rot)
    links["fingertip"] = (ee + hand_rot[..., :, 2] * FINGERTIP_Z, hand_rot)
    return links
