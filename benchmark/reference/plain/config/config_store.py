"""Structured configs + a minimal hydra-compatible composition engine.

The reference registers dataclass schemas in a hydra ConfigStore
(``src/m3p2i_aip/config/config_store.py:25-29``) and composes YAML defaults
lists with CLI overrides (``config_point.yaml:1-3``, README.md:74-143 grammar
like ``task=push_pull multi_modal=True goal="[-3.75,-3.75]"`` and
``-cn config_panda``).  hydra is not a dependency here; this module implements
the same schema + defaults-list + dotted-override grammar in ~150 lines so the
README commands work unchanged.

Port note: a copy of ``m3p2i_aip_tpu/config/config_store.py`` with
``MPPIConfig`` (``m3p2i_aip_tpu/planners/motion_planner/mppi.py:47-140``)
copied in as a plain dataclass, so composing a config imports no jax.  The
YAMLs are read from ``m3p2i_aip_tpu/config`` by path.
"""
from __future__ import annotations

import ast
import dataclasses
from dataclasses import dataclass, field
from typing import List, Optional

import yaml

from benchmark.reference.plain.sim.sim_config import SimConfig
from benchmark.reference.plain.utils import path_utils


@dataclass
class MPPIConfig:
    """Planner hyper-parameters. Parity: MPPIConfig (mppi.py:9-59)."""

    num_samples: int = 200
    horizon: int = 12
    nx: int = 4
    mppi_mode: str = "halton-spline"
    sampling_method: str = "halton"
    noise_sigma: Optional[List[List[float]]] = None
    noise_mu: Optional[List[float]] = None
    # accepted for YAML schema parity and ignored: the port takes an explicit
    # ``device`` argument everywhere instead
    device: str = "tpu"
    lambda_: float = 1.0
    # Accepted for YAML schema parity but intentionally ignored: the
    # reference declares it and never reads it either (its lambda adaptation
    # was never implemented — mppi.py:42 and the orphaned lambda_mult at
    # :198 are dead upstream).
    update_lambda: bool = False
    update_cov: bool = False
    # Per-mode diagonal covariance adaptation for the multi-modal path
    # (extension; the reference's update_cov lives only in the single-mode
    # update, mppi.py:508-516).  Each mode's sampling scale tracks its own
    # weighted second moment, so e.g. the losing mode keeps exploring wide
    # while the winning mode sharpens.
    update_cov_per_mode: bool = False
    u_min: Optional[List[float]] = None
    u_max: Optional[List[float]] = None
    u_init: float = 0.0
    U_init: Optional[List[List[float]]] = None
    u_scale: float = 1.0
    u_per_command: int = 1
    rollout_var_discount: float = 0.95
    sample_null_action: bool = False
    sample_previous_plan: bool = True
    sample_other_priors: bool = False
    # Single-mode elite injection (extension): keep the best-weighted action
    # sequence alive verbatim at sample slot 0, like the multi-modal path's
    # per-mode elites at slots 0 and K/2 (mppi.py:407-409).  Rescues
    # nonholonomic bases whose left/right-arc samples otherwise average to a
    # straight-at-obstacle mean (observed: boxer push parks beside the box).
    sample_best_traj: bool = False
    noise_abs_cost: bool = False
    filter_u: bool = False
    use_priors: bool = False
    fine_noise_scale: float = 0.05  # scale of the fine-sampling quartile (extension)
    # accepted for YAML schema parity and ignored: the port launches its CUDA
    # kernels for CUDA tensors and their plain versions for CPU tensors
    use_pallas: bool = True
    # Gradient refinement of the mean plan (extension): the JAX physics
    # rollout is differentiable end-to-end, so after the importance-weighted
    # update the mean action sequence can take a few first-order steps on the
    # true discounted cost.  Closes the last centimetres on narrow kinematic
    # manifolds (e.g. shelf-side grasps at full arm extension) where random
    # sampling stalls.  0 = off (pure sampling, reference behavior).
    grad_refine_steps: int = 0
    grad_refine_lr: float = 0.02
    # Annealed resampling refinement (extension; the TPU-shaped alternative
    # to grad_refine): after the importance-weighted update, re-run the
    # FUSED K-lane rollout ``refine_iters`` more times with the cached
    # Halton deltas shrunk to refine_scale * refine_decay^i around the
    # updated means, re-applying the importance update each time.  Same
    # goal as grad_refine (millimetre convergence on narrow manifolds) but
    # each iteration is one full-width Pallas kernel pass (~0.6 ms at
    # K=200) instead of a 3-lane differentiable rollout chain (measured
    # 10.3 ms of the 16.5 ms panda tick — UTILIZATION.json panda row).
    refine_iters: int = 0
    refine_scale: float = 0.1
    refine_decay: float = 0.5
    # Final refine iteration picks the argmin sample per mode instead of the
    # softmax-weighted mean.  The weighted mean's effective-sample-size floor
    # (eta in [eta_l, eta_u]) leaves a ~sigma-sized bias off the cost
    # optimum — measured: the shelf reach equilibrates at 0.0555 m from the
    # cube against a 0.055 m stage latch.  Greedy is monotone by
    # construction: the pure per-mode means ride in the refine batch, so the
    # argmin can never rank the incumbent plan out.
    refine_greedy: bool = True
    # the JAX package's XLA hint to unroll the refinement's T-step scan; the
    # port's chain is an eager loop, so it is accepted and has no effect
    grad_refine_unroll: bool = False
    # per-tick jitter on the cached Halton deltas (extension; breaks
    # deterministic replanning fixed points — see _command_halton)
    exploration_noise: float = 0.05
    seed_val: int = 0
    eta_u_bound: float = 10.0  # multi-modal eta upper bound (m3p2i.py:58-60)
    eta_l_bound: float = 3.0  # multi-modal eta lower bound
    # Single-mode beta adaptation gate (parity-ablation knob).  None = auto:
    # on for the panda (the reference's panda-only gate, mppi.py:446-454)
    # AND the boxer (extension — the reference ships no boxer tasks; with
    # fixed beta=1 the near-goal weights collapse to argmax and the
    # nonholonomic base parks ~0.2 m out).  ``mppi=boxer_parity`` sets False
    # to measure that divergence.
    beta_adapt: Optional[bool] = None
    # Continuous side-alignment push cost for the diff-drive base
    # (extension over the reference's one-sided max(cos, 0) penalty,
    # cost_functions.py:57-58 — see PointObjective._push).  False restores
    # the reference formula for ablation; no effect on non-boxer robots.
    boxer_continuous_align: bool = True


@dataclass
class ExampleConfig:
    """Top-level run config. Parity: config_store.ExampleConfig (:7-23)."""

    render: bool = False
    n_steps: int = 1000
    mppi: MPPIConfig = field(default_factory=MPPIConfig)
    isaacgym: SimConfig = field(default_factory=SimConfig)  # name kept for CLI parity
    env_type: str = "point_env"
    task: str = "navigation"
    goal: List[float] = field(default_factory=lambda: [0.0, 0.0])
    nx: int = 4
    actors: List[str] = field(default_factory=list)
    initial_actor_positions: List[List[float]] = field(default_factory=list)
    kp_suction: int = 0
    suction_active: bool = False
    multi_modal: bool = False
    pre_height_diff: float = 0.0
    cube_on_shelf: bool = False
    # CLI shorthand for domain randomization: > 0 sets
    # noise_percentage_friction on every movable (non-fixed, non-robot)
    # actor without forking the per-actor YAML scene.  The real env then
    # draws a per-seed friction at build time and the planner draws K
    # per-rollout friction scales per reseed — the reference's per-env
    # creation-time noise (isaacgym_wrapper.py:313-319).
    fric_noise: float = 0.0

    @property
    def sim(self) -> SimConfig:
        return self.isaacgym


_GROUP_SCHEMAS = {"mppi": MPPIConfig, "isaacgym": SimConfig}


def _coerce(value: str):
    """Parse a CLI override value the way hydra/omegaconf would."""
    try:
        return ast.literal_eval(value)
    except (ValueError, SyntaxError):
        lowered = value.lower()
        if lowered == "true":
            return True
        if lowered == "false":
            return False
        if lowered in ("null", "none"):
            return None
        return value


def _apply_dict(obj, data: dict):
    """Recursively set dataclass fields from a dict (unknown keys rejected)."""
    names = {f.name for f in dataclasses.fields(obj)}
    for key, val in data.items():
        if key == "defaults":
            continue
        if key not in names:
            raise KeyError(f"unknown config key {key!r} for {type(obj).__name__}")
        cur = getattr(obj, key)
        if dataclasses.is_dataclass(cur) and isinstance(val, dict):
            _apply_dict(cur, val)
        else:
            setattr(obj, key, val)


def _set_dotted(cfg, dotted: str, value):
    parts = dotted.split(".")
    obj = cfg
    for p in parts[:-1]:
        obj = getattr(obj, p)
    names = {f.name for f in dataclasses.fields(obj)}
    if parts[-1] not in names:
        raise KeyError(f"unknown override key {dotted!r}")
    setattr(obj, parts[-1], value)


def _load_group_yaml(group: str, name: str) -> dict:
    path = path_utils.get_config_path() / group / f"{name}.yaml"
    with open(path) as f:
        return yaml.safe_load(f) or {}


def load_config(config_name: str = "config_point", overrides=None) -> ExampleConfig:
    """Compose ``<config_name>.yaml`` + defaults groups + CLI-style overrides.

    ``overrides`` is a list of strings like ``["task=push", "goal=[-1,-1]",
    "mppi.num_samples=512"]`` — the README's override grammar.
    """
    cfg = ExampleConfig()
    path = path_utils.get_config_path() / f"{config_name}.yaml"
    with open(path) as f:
        top = yaml.safe_load(f) or {}

    for entry in top.get("defaults", []):
        if isinstance(entry, dict):
            for group, name in entry.items():
                group = str(group)
                if group.startswith("_"):
                    continue
                data = _load_group_yaml(group, str(name))
                data.pop("defaults", None)
                _apply_dict(getattr(cfg, group), data)
    _apply_dict(cfg, top)

    for ov in overrides or []:
        if ov.startswith("-"):
            continue
        key, _, raw = ov.partition("=")
        key, raw = key.strip(), raw.strip()
        if key in _GROUP_SCHEMAS:
            # hydra group selection (e.g. ``mppi=panda_parity`` picks
            # config/mppi/panda_parity.yaml), same grammar as the defaults list
            data = _load_group_yaml(key, raw)
            data.pop("defaults", None)
            _apply_dict(getattr(cfg, key), data)
        else:
            _set_dotted(cfg, key, _coerce(raw))
    return cfg


def load_config_from_argv(argv, default_config: str = "config_point") -> ExampleConfig:
    """Parse ``[-cn NAME] key=value ...`` exactly like the reference's CLIs."""
    argv = list(argv)
    config_name = default_config
    overrides = []
    i = 0
    while i < len(argv):
        a = argv[i]
        if a in ("-cn", "--config-name"):
            config_name = argv[i + 1]
            i += 2
        elif a.startswith("--config-name="):
            config_name = a.split("=", 1)[1]
            i += 1
        elif "=" in a and not a.startswith("-"):
            overrides.append(a)
            i += 1
        else:
            i += 1
    return load_config(config_name, overrides)
