"""Minimal URDF kinematics loader: batched torch FK chains.

Port of ``m3p2i_aip_tpu/utils/urdf.py``.  The robots are modelled natively
(``models/panda_fk.py``'s matrix FK, ``models/albert.py``); this parser closes
the asset loop: point it at a URDF (the vendored ones under
``m3p2i_aip_tpu/assets/urdf/``, read by path through
``path_utils.get_assets_path()``) and get back a :class:`KinematicChain`
whose ``fk(q)`` cross-checks the native models.

Only the kinematic subset of URDF is read: joint type / origin / axis /
limits and the parent-child link tree.  Rotations compose as 3x3 matrices,
over any leading batch dims of ``q``, on ``q``'s device, in float32.
"""
from __future__ import annotations

import xml.etree.ElementTree as ET
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch


@dataclass
class Joint:
    name: str
    type: str  # revolute | continuous | prismatic | fixed
    parent: str
    child: str
    xyz: np.ndarray  # [3] origin translation
    rpy: np.ndarray  # [3] origin rotation (fixed)
    axis: np.ndarray  # [3]
    lower: float = 0.0
    upper: float = 0.0
    effort: float = 0.0
    velocity: float = 0.0


def _rpy_matrix(rpy: np.ndarray) -> np.ndarray:
    r, p, y = float(rpy[0]), float(rpy[1]), float(rpy[2])
    cr, sr = np.cos(r), np.sin(r)
    cp, sp = np.cos(p), np.sin(p)
    cy, sy = np.cos(y), np.sin(y)
    Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    return (Rz @ Ry @ Rx).astype(np.float32)


def _axis_rotation(axis: np.ndarray, theta: torch.Tensor) -> torch.Tensor:
    """Rodrigues rotation about a (unit) axis by ``theta`` [...]: [..., 3, 3]."""
    ax = torch.as_tensor(np.asarray(axis, dtype=np.float32), device=theta.device)
    x, y, z = (float(v) for v in np.asarray(axis, dtype=np.float32))
    K = torch.tensor([[0.0, -z, y], [z, 0.0, -x], [-y, x, 0.0]], dtype=torch.float32, device=theta.device)
    c, s = torch.cos(theta)[..., None, None], torch.sin(theta)[..., None, None]
    eye = torch.eye(3, dtype=torch.float32, device=theta.device)
    return eye * c + s * K + (1.0 - c) * torch.outer(ax, ax)


@dataclass
class KinematicChain:
    """An ordered root->tip joint chain with batched matrix FK."""

    joints: List[Joint]
    dof_joints: List[Joint] = field(init=False)

    def __post_init__(self):
        self.dof_joints = [j for j in self.joints if j.type != "fixed"]

    @property
    def ndof(self) -> int:
        return len(self.dof_joints)

    @property
    def joint_limits(self) -> Tuple[np.ndarray, np.ndarray]:
        lo = np.asarray([j.lower for j in self.dof_joints], dtype=np.float32)
        hi = np.asarray([j.upper for j in self.dof_joints], dtype=np.float32)
        return lo, hi

    def fk(self, q: torch.Tensor, base_pos=None, base_rot=None) -> Dict[str, tuple]:
        """Link poses (pos [..., 3], rot [..., 3, 3]) of every child link in
        the chain, for joint values ``q`` [..., ndof]."""
        dev, batch = q.device, q.shape[:-1]
        f32 = dict(dtype=torch.float32, device=dev)
        pos = torch.zeros(batch + (3,), **f32) if base_pos is None else torch.as_tensor(base_pos, **f32).expand(batch + (3,))
        rot = (
            torch.eye(3, **f32).expand(batch + (3, 3))
            if base_rot is None
            else torch.as_tensor(base_rot, **f32).expand(batch + (3, 3))
        )
        out: Dict[str, tuple] = {}
        qi = 0
        for j in self.joints:
            pos = pos + torch.matmul(rot, torch.as_tensor(j.xyz, **f32))
            rot = torch.matmul(rot, torch.as_tensor(_rpy_matrix(j.rpy), **f32))
            if j.type in ("revolute", "continuous"):
                rot = torch.matmul(rot, _axis_rotation(j.axis, q[..., qi]))
                qi += 1
            elif j.type == "prismatic":
                pos = pos + torch.matmul(rot, torch.as_tensor(j.axis, **f32)) * q[..., qi : qi + 1]
                qi += 1
            out[j.child] = (pos, rot)
        return out


def parse_urdf(path_or_string: str) -> Dict[str, Joint]:
    """All joints of a URDF (a path, or the XML itself), keyed by name."""
    if path_or_string.lstrip().startswith("<"):
        root = ET.fromstring(path_or_string)
    else:
        root = ET.parse(path_or_string).getroot()

    def vec(el, attr: str, default: str) -> np.ndarray:
        return np.array((el.get(attr, default) if el is not None else default).split(), dtype=np.float32)

    joints: Dict[str, Joint] = {}
    for je in root.findall("joint"):
        origin, axis_el, limit = je.find("origin"), je.find("axis"), je.find("limit")
        axis = vec(axis_el, "xyz", "1 0 0")
        joints[je.get("name")] = Joint(
            name=je.get("name"),
            type=je.get("type", "fixed"),
            parent=je.find("parent").get("link"),
            child=je.find("child").get("link"),
            xyz=vec(origin, "xyz", "0 0 0"),
            rpy=vec(origin, "rpy", "0 0 0"),
            axis=axis / max(np.linalg.norm(axis), 1e-9),
            lower=float(limit.get("lower", 0)) if limit is not None else 0.0,
            upper=float(limit.get("upper", 0)) if limit is not None else 0.0,
            effort=float(limit.get("effort", 0)) if limit is not None else 0.0,
            velocity=float(limit.get("velocity", 0)) if limit is not None else 0.0,
        )
    return joints


def chain_to(joints: Dict[str, Joint], tip_link: str, root_link: Optional[str] = None) -> KinematicChain:
    """The root->tip joint chain ending at ``tip_link``."""
    by_child = {j.child: j for j in joints.values()}
    chain: List[Joint] = []
    link = tip_link
    while link in by_child:
        j = by_child[link]
        chain.append(j)
        link = j.parent
        if root_link is not None and link == root_link:
            break
    chain.reverse()
    return KinematicChain(chain)


def load_chain(urdf_path: str, tip_link: str, root_link: Optional[str] = None) -> KinematicChain:
    return chain_to(parse_urdf(urdf_path), tip_link, root_link)
