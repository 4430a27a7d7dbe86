"""Procedural URDF emitters for the vendored robot assets.

Port of ``m3p2i_aip_tpu/assets/urdf_gen.py``, built on the port's
``models/panda_fk.py`` and ``models/albert.py``: each emitter's text is the
JAX package's byte for byte (the same constants, the same formatting).
``ensure_assets(root)`` writes them under the ``root`` it is given; the
vendored copies under ``m3p2i_aip_tpu/assets/urdf/`` are read in place,
never rewritten from here.

Each emitter returns a URDF XML string encoding the kinematic structure
(joints / origins / axes / limits) that the framework's native models
implement directly:

  * franka_panda  — from models/panda_fk.py's transcribed constants
                    (reference asset: franka_description/robots/franka_panda.urdf)
  * pointRobot    — 2 prismatic world-axis DOF (reference: pointRobot.urdf)
  * heijn         — 3-DOF omni base: x, y prismatic + yaw revolute
                    (reference: heijn.urdf)
  * boxer         — 2-wheel differential drive (reference: boxer/boxer.urdf)
  * albert        — boxer base + the full panda arm on a torso mount
                    (reference: albert/albert.urdf, 13 DOF)

Only the kinematic subset needed by utils/urdf.py is emitted (no meshes /
inertials) — the same subset the parser reads.
"""
from __future__ import annotations

import pathlib

import numpy as np

from m3p2i_aip_tpu_torch.models import panda_fk

# URDF <limit effort> values (documented with JOINT_ACCEL_LIMIT in panda_fk.py)
_PANDA_EFFORT = [87.0, 87.0, 87.0, 87.0, 12.0, 12.0, 12.0]


def _joint(name, jtype, parent, child, xyz, rpy, axis=None, limit=None) -> str:
    lines = [f'  <joint name="{name}" type="{jtype}">']
    lines.append(f'    <parent link="{parent}"/><child link="{child}"/>')
    x = " ".join(f"{v:.6g}" for v in xyz)
    r = " ".join(f"{v:.9g}" for v in rpy)
    lines.append(f'    <origin xyz="{x}" rpy="{r}"/>')
    if axis is not None:
        a = " ".join(f"{v:.6g}" for v in axis)
        lines.append(f'    <axis xyz="{a}"/>')
    if limit is not None:
        lo, hi, eff, vel = limit
        lines.append(
            f'    <limit lower="{lo:.6g}" upper="{hi:.6g}" '
            f'effort="{eff:.6g}" velocity="{vel:.6g}"/>'
        )
    lines.append("  </joint>")
    return "\n".join(lines)


def _robot(name: str, joints: list, links: list) -> str:
    body = "\n".join(f'  <link name="{l}"/>' for l in links)
    return (
        f'<?xml version="1.0"?>\n<robot name="{name}">\n'
        + body + "\n" + "\n".join(joints) + "\n</robot>\n"
    )


def _panda_arm_joints(parent: str, mount_xyz, prefix: str = "panda_") -> tuple:
    """The 7 revolute arm joints + hand + fingers, rooted at ``parent``."""
    joints, links = [], []
    xyz = np.asarray(panda_fk._JOINT_XYZ, dtype=np.float64)
    roll = np.asarray(panda_fk._JOINT_ROLL, dtype=np.float64)
    lo = panda_fk.JOINT_LOWER
    hi = panda_fk.JOINT_UPPER
    vel = panda_fk.JOINT_VEL_LIMIT
    prev = parent
    for j in range(7):
        link = f"{prefix}link{j+1}"
        origin = np.asarray(mount_xyz, dtype=np.float64) if j == 0 else xyz[j]
        if j == 0:
            origin = origin + xyz[0]
        joints.append(
            _joint(
                f"{prefix}joint{j+1}", "revolute", prev, link,
                origin, [roll[j], 0.0, 0.0], [0.0, 0.0, 1.0],
                (float(lo[j]), float(hi[j]), _PANDA_EFFORT[j], float(vel[j])),
            )
        )
        links.append(link)
        prev = link
    joints.append(
        _joint(
            f"{prefix}hand_joint", "fixed", prev, f"{prefix}hand",
            panda_fk.HAND_XYZ, [0.0, 0.0, panda_fk.HAND_YAW],
        )
    )
    links.append(f"{prefix}hand")
    for i, (fname, sign) in enumerate((("leftfinger", 1.0), ("rightfinger", -1.0))):
        joints.append(
            _joint(
                f"{prefix}finger_joint{i+1}", "prismatic",
                f"{prefix}hand", f"{prefix}{fname}",
                panda_fk.FINGER_XYZ, [0.0, 0.0, 0.0], [0.0, sign, 0.0],
                (float(lo[7 + i]), float(hi[7 + i]), 20.0, float(vel[7 + i])),
            )
        )
        links.append(f"{prefix}{fname}")
    return joints, links


def emit_franka_urdf() -> str:
    joints, links = _panda_arm_joints("panda_link0", [0.0, 0.0, 0.0])
    return _robot("panda", joints, ["panda_link0"] + links)


def emit_point_urdf() -> str:
    joints = [
        _joint("x_joint", "prismatic", "world", "x_slider",
               [0, 0, 0], [0, 0, 0], [1, 0, 0], (-10, 10, 100, 6)),
        _joint("y_joint", "prismatic", "x_slider", "base_link",
               [0, 0, 0], [0, 0, 0], [0, 1, 0], (-10, 10, 100, 6)),
    ]
    return _robot("pointRobot", joints, ["world", "x_slider", "base_link"])


def emit_heijn_urdf() -> str:
    joints = [
        _joint("x_joint", "prismatic", "world", "x_slider",
               [0, 0, 0], [0, 0, 0], [1, 0, 0], (-10, 10, 200, 3)),
        _joint("y_joint", "prismatic", "x_slider", "y_slider",
               [0, 0, 0], [0, 0, 0], [0, 1, 0], (-10, 10, 200, 3)),
        _joint("theta_joint", "revolute", "y_slider", "base_link",
               [0, 0, 0], [0, 0, 0], [0, 0, 1], (-31.4, 31.4, 100, 3)),
    ]
    return _robot("heijn", joints, ["world", "x_slider", "y_slider", "base_link"])


def _boxer_base_joints(wheel_radius: float, wheel_base: float) -> tuple:
    half = wheel_base / 2.0
    joints = [
        _joint("wheel_left_joint", "continuous", "base_link", "wheel_left",
               [0.0, half, wheel_radius], [-np.pi / 2, 0, 0], [0, 0, 1],
               (-1e9, 1e9, 20, 20)),
        _joint("wheel_right_joint", "continuous", "base_link", "wheel_right",
               [0.0, -half, wheel_radius], [-np.pi / 2, 0, 0], [0, 0, 1],
               (-1e9, 1e9, 20, 20)),
        _joint("castor_left_joint", "continuous", "base_link", "castor_left",
               [-0.3, 0.15, 0.05], [-np.pi / 2, 0, 0], [0, 0, 1],
               (-1e9, 1e9, 5, 20)),
        _joint("castor_right_joint", "continuous", "base_link", "castor_right",
               [-0.3, -0.15, 0.05], [-np.pi / 2, 0, 0], [0, 0, 1],
               (-1e9, 1e9, 5, 20)),
    ]
    links = ["base_link", "wheel_left", "wheel_right", "castor_left", "castor_right"]
    return joints, links


def emit_boxer_urdf(wheel_radius: float = 0.08, wheel_base: float = 0.314) -> str:
    joints, links = _boxer_base_joints(wheel_radius, wheel_base)
    return _robot("boxer", joints, links)


def emit_husky_urdf() -> str:
    """Clearpath Husky A200 skid-steer base — the reference's unused spare
    asset (``assets/urdf/husky_description/``; no reference code ever loads
    it).  Emitted from the PUBLIC Husky datasheet dimensions (wheelbase
    0.512 m, track 0.555 m, wheel radius 0.1651 m) so the asset inventory
    matches 1:1; like upstream, no env/task consumes it.
    """
    wb_half, track_half, wr = 0.512 / 2.0, 0.555 / 2.0, 0.1651
    joints = []
    links = ["base_link"]
    for name, x, y in (
        ("front_left", wb_half, track_half),
        ("front_right", wb_half, -track_half),
        ("rear_left", -wb_half, track_half),
        ("rear_right", -wb_half, -track_half),
    ):
        joints.append(
            _joint(f"{name}_wheel_joint", "continuous", "base_link",
                   f"{name}_wheel", [x, y, wr], [-np.pi / 2, 0, 0],
                   [0, 0, 1], (-1e9, 1e9, 40, 20))
        )
        links.append(f"{name}_wheel")
    return _robot("husky", joints, links)


def emit_albert_urdf() -> str:
    from m3p2i_aip_tpu_torch.models import albert

    base_joints, base_links = _boxer_base_joints(
        albert.WHEEL_RADIUS, albert.WHEEL_BASE
    )
    arm_joints, arm_links = _panda_arm_joints(
        "base_link", [float(x) for x in albert.ARM_MOUNT]
    )
    return _robot("albert", base_joints + arm_joints, base_links + arm_links)


_EMITTERS = {
    "pointRobot.urdf": emit_point_urdf,
    "heijn.urdf": emit_heijn_urdf,
    "boxer/boxer.urdf": emit_boxer_urdf,
    "albert/albert.urdf": emit_albert_urdf,
    "franka_description/robots/franka_panda.urdf": emit_franka_urdf,
    "husky_description/husky.urdf": emit_husky_urdf,
}


def ensure_assets(root) -> pathlib.Path:
    """Write every vendored URDF under ``root`` (idempotent), in the
    reference's asset layout, so ``urdf_file`` entries of the actor YAMLs
    resolve the same relative paths.  ``root`` is required: the port never
    writes into the JAX package's tree."""
    root = pathlib.Path(root)
    for rel, emit in _EMITTERS.items():
        path = root / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        text = emit()
        if not path.exists() or path.read_text() != text:
            path.write_text(text)
    return root
