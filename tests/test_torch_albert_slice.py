"""Slice 3 as a whole: the port's albert planner tick, chunked loop, device
success gate, task-planner latch and reactive-scenario helper against the
JAX package's, on the CPU.

The planner is built from ``config_albert`` at K=16, T=8 with the shipped
softmax-only refine ladder (``refine_iters=3``, ``refine_greedy=False``),
``beta_adapt`` on and ``mppi.exploration_noise=0`` (the jitter is the one
random draw the two packages cannot share; without it a tick is
deterministic).  The JAX planner state (Halton deltas included) and env state
are carried into the port with ``utils/convert.py``.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from m3p2i_aip_tpu.config.config_store import load_config as jax_load_config
from m3p2i_aip_tpu.planners.motion_planner.mppi import make_task_params as jax_task
from m3p2i_aip_tpu.tamp.sim_loop import SimLoop as JaxSimLoop
from m3p2i_aip_tpu_torch.config.config_store import load_config
from m3p2i_aip_tpu_torch.ops import albert_rollout as ar
from m3p2i_aip_tpu_torch.planners.motion_planner.mppi import make_task_params
from m3p2i_aip_tpu_torch.tamp.sim_loop import SimLoop
from m3p2i_aip_tpu_torch.utils import convert

COMMON = ["mppi.num_samples=16", "mppi.horizon=8", "mppi.exploration_noise=0"]
VARIANTS = {
    "ee_reach": COMMON,  # the main path: config_albert's defaults
    "push_reach": ["task=push_reach", "goal=[3.0,0.0,0.6]", *COMMON],
}
# One tick is four K-sample rollouts and four weight updates of f32 work in
# another summation order: costs agree to ~1e-6, and the weights' exp() and
# the K-sample means carry that into the actions well below 1e-4.
ATOL = 1e-4
# Six closed-loop ticks compound it (as tests/test_torch_slice.py's loop bar).
LOOP_ATOL = 1e-3


def _leaves(x) -> dict:
    return {
        f.name: np.asarray(getattr(x, f.name))
        for f in dataclasses.fields(x)
        if f.metadata.get("pytree_node", True) and getattr(x, f.name) is not None
    }


@functools.lru_cache(maxsize=None)
def _loops(variant: str):
    overrides = VARIANTS[variant]
    jloop = JaxSimLoop(jax_load_config("config_albert", overrides))
    ploop = SimLoop(load_config("config_albert", overrides), device="cpu")
    return jloop, ploop


def _reset(jloop, ploop, jstate=None):
    """Both loops at the same start state and planner state."""
    jloop.reset()
    ploop.reset()
    if jstate is not None:
        jloop.state = jstate
    jloop._view = jloop.env.view(jloop.state)
    ploop.state = convert.albert_state_from_numpy(_leaves(jloop.state))
    ploop._view = ploop.env.view(ploop.state)
    ploop.tamp.mppi_state = convert.mppi_state_from_numpy(_leaves(jloop.tamp.mppi_state))


def _contact_start(jloop):
    base = jloop.env.init_state()
    p = jloop.env.params
    over = ar.parity_overrides("contact", np.asarray(base.q), np.asarray(base.qd), np.asarray(p.box_init))
    return base.replace(**{k: jnp.asarray(v) for k, v in over.items()})


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_command_tick_matches_jax_package(variant):
    """One ``_command_impl`` tick through the softmax-only refine ladder:
    action sequence, mean, beta and weights; beta adapts once per rung."""
    jloop, ploop = _loops(variant)
    _reset(jloop, ploop, _contact_start(jloop) if variant == "push_reach" else None)
    jtask = jloop.tamp.tamp_interface_view(jloop._view)
    ptask = ploop.tamp.tamp_interface_view(ploop._view)
    for name, ref in _leaves(jtask).items():
        assert np.array_equal(getattr(ptask, name).numpy(), ref), name

    mp = ploop.tamp.motion_planner
    assert mp.beta_adapt and mp.refine_iters == 3 and not mp.refine_greedy
    betas = []
    exp_util = mp._exp_util

    def recording(cost_horizon, beta):
        w, new_beta = exp_util(cost_horizon, beta)
        betas.append((float(beta), float(new_beta)))
        return w, new_beta

    mp._exp_util = recording
    try:
        pact, pms, _ = mp._command_impl(ploop.tamp.mppi_state, ploop.state, ptask)
    finally:
        mp._exp_util = exp_util
    jact, jms, _ = jloop.tamp.motion_planner.command(jloop.tamp.mppi_state, jloop.state, jtask)

    np.testing.assert_allclose(pact.numpy(), np.asarray(jact), atol=ATOL, rtol=0)
    for name in ("mean_action", "weights", "beta", "best_traj"):
        np.testing.assert_allclose(
            getattr(pms, name).numpy(), np.asarray(getattr(jms, name)), atol=ATOL, rtol=0, err_msg=name
        )
    # one adaptive step per update: the first and each of the three rungs,
    # chained, each a x0.9 / x1.2 / x1 step
    assert len(betas) == 1 + mp.refine_iters
    assert betas[0][0] == 1.0
    for (_, after), (before, _) in zip(betas, betas[1:]):
        assert before == after
    for before, after in betas:
        assert any(np.isclose(after, before * f, rtol=1e-6) for f in (0.9, 1.2, 1.0))
    assert np.isclose(betas[-1][1], float(pms.beta))


def test_run_chunked_matches_jax_package():
    """``run_chunked(6, chunk=3)`` on push_reach with the device gate on:
    every tick's view (base pose and velocity, EE, box) as the JAX loop's."""
    jloop, ploop = _loops("push_reach")
    _reset(jloop, ploop, _contact_start(jloop))
    views = {"jax": [], "port": []}

    def recording(tamp, key):
        run_chunk = tamp.run_chunk

        def run(*args):
            out = run_chunk(*args)
            views[key].append(np.asarray(out[2]) if key == "jax" else out[2].numpy())
            return out

        return run

    jloop.tamp.run_chunk = recording(jloop.tamp, "jax")
    ploop.tamp.run_chunk = recording(ploop.tamp, "port")
    try:
        jlog = jloop.run_chunked(6, chunk=3)
        plog = ploop.run_chunked(6, chunk=3)
    finally:
        del jloop.tamp.run_chunk, ploop.tamp.run_chunk
    assert plog.steps == jlog.steps == 6 and plog.success_step == jlog.success_step is None
    assert plog.task == jlog.task == ["push_reach"] * 6
    got, ref = np.concatenate(views["port"]), np.concatenate(views["jax"])
    assert got.shape == ref.shape == (6, 11)
    np.testing.assert_allclose(got, ref, atol=LOOP_ATOL, rtol=0)
    for key, r in jloop._view.items():
        np.testing.assert_allclose(np.asarray(ploop._view[key]), np.asarray(r), atol=LOOP_ATOL, rtol=0, err_msg=key)
    # the base pushed the box: the comparison is not of two parked scenes
    assert np.linalg.norm(got[-1, 9:11] - got[0, 9:11]) > 1e-3


# the four task branches of the albert device gate, each with the state
# (base xy, box xy) on both sides of its threshold
GATE_CASES = [
    ("navigation", [1.5, 1.0], [1.45, 1.0], [1.2, 0.0], True),
    ("navigation", [1.5, 1.0], [1.3, 1.0], [1.2, 0.0], False),
    ("push_reach", [3.0, 0.0, 0.6], [0.0, 0.0], [2.9, 0.0], True),  # 0.1 m inclusive
    ("push_reach", [3.0, 0.0, 0.6], [0.0, 0.0], [2.85, 0.0], False),
    ("ee_reach", [2.0, 2.0, 0.8], [2.0, 2.0], [1.2, 0.0], False),  # never latches on the device
    ("reposition", [0.5, -0.5], [0.5, -0.5], [1.2, 0.0], False),
]


@pytest.mark.parametrize("task,goal,base_xy,box_xy,expect", GATE_CASES)
def test_success_gate_matches_jax_package(task, goal, base_xy, box_xy, expect):
    jloop, ploop = _loops("ee_reach")
    base = jloop.env.init_state()
    jstate = base.replace(q=base.q.at[0:2].set(jnp.asarray(base_xy, jnp.float32)), box_pos=jnp.asarray(box_xy, jnp.float32))
    ref = jax.jit(jloop.tamp._point_success_device)(jstate, jax_task(task, goal))
    got = ploop.tamp._point_success_device(convert.albert_state_from_numpy(_leaves(jstate)), make_task_params(task, goal))
    assert bool(got) == bool(ref) == expect


def test_task_planner_arms_the_albert_stall_latch():
    """``build_task_planner`` arms only the stall latch on the albert's open
    floor, with the reposition standoff outside the keep-out radius."""
    jloop, ploop = _loops("push_reach")
    jtp, ptp = jloop.tamp.task_planner, ploop.tamp.task_planner
    assert ptp._pocket_lim == jtp._pocket_lim == 10.0
    assert ptp._prox_latch is jtp._prox_latch is False
    assert ptp._min_clearance == jtp._min_clearance == ploop.tamp.objective.clearance_r


def test_perturb_body_matches_jax_package():
    """``perturb_body`` moves the albert's box by the shove, leaves every
    other field alone, and refreshes the view."""
    jloop, ploop = _loops("push_reach")
    _reset(jloop, ploop)
    before = {f: getattr(ploop.state, f).clone() for f in _leaves(ploop.state)}
    dpos = [0.3, -0.2, 0.0]
    jloop.perturb_body("box", dpos)
    ploop.perturb_body("box", dpos)
    for f, ref in _leaves(jloop.state).items():
        got = getattr(ploop.state, f).numpy()
        np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0, err_msg=f)
        assert np.array_equal(got, before[f].numpy()) == (f != "box_pos"), f
    assert set(ploop._view) == set(jloop._view)
    for key, ref in jloop._view.items():
        np.testing.assert_allclose(np.asarray(ploop._view[key]), np.asarray(ref), atol=1e-5, rtol=0, err_msg=key)


def test_warmup_and_traj_point_match_jax_package():
    """Ten zero-action warm-up steps from the contact start, and the
    trajectory-view point (the base's xy)."""
    jloop, ploop = _loops("push_reach")
    _reset(jloop, ploop, _contact_start(jloop))
    x0 = float(ploop.state.q[0])
    jloop.warmup(10)
    ploop.warmup(10)
    for f, ref in _leaves(jloop.state).items():
        np.testing.assert_allclose(getattr(ploop.state, f).numpy(), ref, atol=1e-5, rtol=0, err_msg=f)
    np.testing.assert_array_equal(ploop.env.traj_point(ploop.state).numpy(), np.asarray(jloop.env.traj_point(jloop.state)))
    # the start's base velocity carried it on before the drive decayed it
    assert float(ploop.state.q[0]) > x0 + 1e-3 and abs(float(ploop.state.qd[0])) < 1e-3
