"""The plain reference of one closed-loop albert tick.

The albert mobile manipulator (a differential-drive base with a Franka arm,
13 control channels) built from the repository's YAML data files by the
frozen plain modules under ``benchmark/reference/plain``: its model
(``models/albert.py``), its costs (``planners/motion_planner/
albert_objective.py``), its rollout's plain version (``ops/
albert_rollout.py``), and the planner, the FK and the contact solve that it
shares unchanged with the point family and the panda.  A configuration file
names it as ``"albert"``.

Departures from the port's plain modules: none in the arithmetic.  The
rollout module keeps the plain version alone (no launch code, no launch
counts, no seed-batched call, no gradient chain, no parity starts); the
scene is built here, as ``make_env`` builds the port's albert scene, and
refuses the actor overrides and friction noise that no albert
configuration sets.

:meth:`Scene.tick` computes one tick from a checkpoint, as the port's
``ReactiveTAMP._tick`` does on the albert: no dyn-obs motion (the scene has
none), the planner's command with the softmax-only refine ladder (K4's
plain version at each of its ``1 + refine_iters`` rollouts), and the
real-env step with the first action (the albert takes no external forces).
The task the host planner handed the tick, its push_reach stall latch and
reposition decisions included, is an input from the checkpoint.  It
returns the observation row after the step, [base pose (3), base velocity
(3), end effector (3), box (2)].  ``precision`` selects the control as in
``tick.py``; each rollout is recorded in :attr:`Scene.calls`, and
:func:`bounds` gives K4's bound of each.
"""
from __future__ import annotations

from types import SimpleNamespace
from typing import Optional

import torch

from benchmark.reference import tick as ref_tick
from benchmark.reference.plain.models import albert
from benchmark.reference.plain.ops import albert_rollout
from benchmark.reference.plain.planners.motion_planner.albert_objective import AlbertObjective
from benchmark.reference.plain.planners.motion_planner.m3p2i import M3P2I
from benchmark.reference.plain.planners.motion_planner.mppi import TaskParams
from benchmark.reference.plain.sim.sim_config import load_env_cfgs
from benchmark.yardstick.albert import albert_rollout_bound_ms

bf16 = ref_tick.bf16


def make_scene(cfg, device) -> SimpleNamespace:
    """The albert scene of ``cfg`` on ``device`` (the port's
    ``envs._make_albert_env``): the params from the actor YAMLs, the step,
    the zero action's settle and the observation row."""
    if cfg.env_type != "albert_env":
        raise ValueError(f"the albert reference serves albert_env, not {cfg.env_type!r}")
    if list(cfg.actors) or float(getattr(cfg, "fric_noise", 0.0)) > 0.0:
        raise ValueError("the albert reference builds the scene its YAMLs state: no actor overrides, no friction noise")
    params = albert.build_params(load_env_cfgs(cfg.env_type), cfg.sim, device=device)

    def view_vec(state):
        ee_pos = albert.fk(state)["ee"][0]
        return torch.cat([state.q[..., :3], state.qd[..., :3], ee_pos, state.box_pos], dim=-1)

    return SimpleNamespace(
        env_type=cfg.env_type,
        params=params,
        nu=13,
        step=lambda s, u, e: albert.step(params, s, u),
        init_state=lambda: albert.init_state(params),
        zero_ext=lambda batch=(): albert.zero_ext(batch, params.device),
        view_vec=view_vec,
    )


class Scene(ref_tick.Scene):
    """The reference's albert scene and planner for one configuration file;
    the recording, the precision stages, the settle and the planner's
    start are ``tick.Scene``'s."""

    def __init__(self, cfg_file: dict, device, precision: Optional[str] = None, count_live: bool = False) -> None:
        self.device = torch.device(device)
        self.precision = precision
        self.count_live = count_live  # recorded with each call; K4's count takes every contact (bounds)
        self._live: Optional[list] = None
        self.cfg = cfg = ref_tick.config_of(cfg_file)
        self.env = make_scene(cfg, self.device)
        self.is_panda = False
        rollout = albert_rollout.make_albert_rollout(self.env.params, AlbertObjective(self.env.params),
                                                     cfg.mppi.num_samples, cfg.mppi.horizon)
        self.rollout_spec = rollout.spec
        self.calls: list = []  # (kind, inputs, live contacts) of every K4 call of the last tick
        self.planner = M3P2I(cfg, self._recorded(rollout), device=self.device)
        self.settle_steps = int(cfg_file["settle_steps"])
        self._settled = None

    def tick(self, ck: dict) -> torch.Tensor:
        """The observation row [11] after one tick from checkpoint ``ck``."""
        self.calls = []
        ms = self._planner_state(ck)
        rs = self.settled_state() if ck["start"] else ck["real_state"]
        lowp = self.precision == "bf16"
        with self._stages():
            if lowp:
                ms, rs = bf16(ms), bf16(rs)
            task = TaskParams(**{k: v.to(self.device) for k, v in ck["task"].items()})
            action_seq, _, _ = self.planner._command_impl(ms, rs, task)
            action = action_seq[..., 0, :]
            if lowp:
                action = bf16(action)
            rs = self.env.step(rs, action, self.env.zero_ext())
            if lowp:
                rs = bf16(rs)
            return self.env.view_vec(rs)


def bounds(scene: Scene, seeds_per_tick: int) -> dict:
    """The yardstick's bounds of the last reference tick's K4 calls:
    {"rollout": [ms, ...]}, each times the seeds a batched launch carries.
    K4's count takes every contact as projected, live or not
    (``yardstick/albert.py``)."""
    out = {"rollout": []}
    for _, (sim_state_k, acts, task), _ in scene.calls:
        inputs = (*albert_rollout.rollout_inputs(sim_state_k, task), acts)
        out["rollout"].append(seeds_per_tick * albert_rollout_bound_ms(scene.rollout_spec, inputs, acts.shape[-3]))
    return out
