"""Simulator + per-actor configuration schemas.

Parity targets:
  * ``IsaacGymConfig`` (isaacgym_wrapper.py:7-16) -> :class:`SimConfig`
  * ``ActorWrapper``   (actor_utils.py:16-46)     -> :class:`ActorCfg`

The PhysX solver knobs (solver iterations, contact offsets —
isaacgym_wrapper.py:18-37) are replaced by the penalty-contact parameters of
the JAX engine (stiffness/damping), which play the same role: shaping contact
response within a dt/substep budget.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional


@dataclass
class SimConfig:
    dt: float = 0.05
    substeps: int = 2
    use_gpu_pipeline: bool = True  # accepted for config-compat; ignored on TPU
    num_threads: int = 8  # ignored (XLA manages parallelism)
    viewer: bool = False
    spacing: float = 10.0
    camera_pos: List[float] = field(default_factory=lambda: [1.5, 6, 8])
    camera_target: List[float] = field(default_factory=lambda: [1.5, 0, 0])
    # Penalty-contact model parameters (new; no Isaac equivalent).
    contact_stiffness: float = 1e4
    contact_damping: float = 2e2
    gravity: float = 9.8
    # DOF velocity-drive damping (Isaac sets 600 for velocity mode,
    # isaacgym_wrapper.py:341-344).
    drive_damping: float = 600.0


@dataclass
class ActorCfg:
    """One actor (robot / box / sphere) in an env. Parity: ActorWrapper:16-46."""

    type: str = "box"
    name: str = ""
    dof_mode: str = "velocity"
    init_pos: List[float] = field(default_factory=lambda: [0.0, 0.0, 0.0])
    init_pos_on_table: List[float] = field(default_factory=lambda: [0.0, 0.0, 0.0])
    init_pos_on_shelf: List[float] = field(default_factory=lambda: [0.0, 0.0, 0.0])
    init_ori: List[float] = field(default_factory=lambda: [0.0, 0.0, 0.0, 1.0])
    size: List[float] = field(default_factory=lambda: [0.1, 0.1, 0.1])
    mass: float = 1.0
    color: List[float] = field(default_factory=lambda: [1.0, 1.0, 1.0])
    fixed: bool = False
    collision: bool = True
    friction: float = 1.0
    handle: Optional[int] = None
    flip_visual: bool = False
    urdf_file: Optional[str] = None
    visualize_link: Optional[str] = None
    gravity: bool = True
    differential_drive: bool = False
    init_joint_pose: Optional[List[float]] = None
    wheel_radius: Optional[float] = None
    wheel_base: Optional[float] = None
    wheel_count: Optional[float] = None
    left_wheel_joints: Optional[List[str]] = None
    right_wheel_joints: Optional[List[str]] = None
    caster_links: Optional[List[str]] = None
    noise_sigma_size: Optional[List[float]] = None
    noise_percentage_mass: float = 0.0
    noise_percentage_friction: float = 0.0


def load_env_cfgs(env_type: str) -> List[ActorCfg]:
    """Load every per-actor YAML under ``config/<env_type>/``.

    Parity: actor_utils.load_env_cfgs:94-101.  The reference iterates the
    directory unsorted and relies on 0_,1_,... filename prefixes for actor
    order; here the files are sorted by their numeric prefix explicitly so the
    actor indexing is deterministic on any filesystem.
    """
    import yaml

    from benchmark.reference.plain.utils import path_utils

    env_path = path_utils.get_config_path() / env_type

    def order_key(p):
        stem = p.stem
        head = stem.split("_", 1)[0]
        return (0, int(head)) if head.isdigit() else (1, stem)

    cfgs = []
    for f in sorted(env_path.glob("*.yaml"), key=order_key):
        with open(f) as fh:
            cfgs.append(ActorCfg(**(yaml.safe_load(fh) or {})))
    return cfgs
