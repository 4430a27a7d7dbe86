"""Slice 1 as a whole: the port's M3P2I tick and chunked loop against the
JAX package's, on the CPU.

Both packages are built from ``config_point`` with push_pull, multi-modal,
K=16 and ``mppi.exploration_noise=0`` (the jitter is the one random draw the
two cannot share; without it a tick is deterministic).  The JAX planner
state and env state are carried into the port with ``utils/convert.py``.
The robot starts next to the box, so contact and suction are in play.
"""
import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest

from m3p2i_aip_tpu.config.config_store import load_config as jax_load_config
from m3p2i_aip_tpu.tamp.sim_loop import SimLoop as JaxSimLoop
from m3p2i_aip_tpu_torch.config.config_store import load_config
from m3p2i_aip_tpu_torch.tamp.sim_loop import SimLoop
from m3p2i_aip_tpu_torch.utils import convert

COMMON = ["goal=[-3.75,-3.75]", "mppi.num_samples=16", "mppi.exploration_noise=0"]
OVERRIDES = ["task=push_pull", "multi_modal=True", *COMMON]
# the main path, the single-mode planner (its own weights and beta), and
# per-sample friction randomization (the planner injects [K, D] scales)
TICK_VARIANTS = {
    "push_pull_multi_modal": OVERRIDES,
    "push_single_mode": ["task=push", "multi_modal=False", *COMMON],
    "friction_noise": [*OVERRIDES, "fric_noise=0.4"],
}
# One tick and six ticks of f32 work in another summation order: costs agree
# to ~1e-5 relative, the weights' exp() and the K-sample means carry that
# into the actions at ~1e-5, and the closed loop compounds it over six
# ticks; 1e-3 bounds all of it while still failing on any formula drift
# (a wrong contact pass or cost term moves these by centimetres).
ATOL = 1e-3
START_Q, START_QD = [0.0, 1.5], [0.0, -1.0]


def _leaves(x) -> dict:
    return {
        f.name: np.asarray(getattr(x, f.name))
        for f in dataclasses.fields(x)
        if f.metadata.get("pytree_node", True) and getattr(x, f.name) is not None
    }


@functools.lru_cache(maxsize=None)
def _loops(variant: str):
    overrides = TICK_VARIANTS[variant]
    jloop = JaxSimLoop(jax_load_config("config_point", overrides))
    ploop = SimLoop(load_config("config_point", overrides), device="cpu")
    return jloop, ploop


def _reset(jloop, ploop):
    """Both loops at the same start state and planner state."""
    jloop.reset()
    ploop.reset()
    jloop.state = jloop.env.init_state().replace(
        q=jnp.asarray(START_Q, jnp.float32), qd=jnp.asarray(START_QD, jnp.float32)
    )
    jloop._view = jloop.env.view(jloop.state)
    ploop.state = convert.point_env_state_from_numpy(_leaves(jloop.state))
    ploop._view = ploop.env.view(ploop.state)
    ploop.tamp.mppi_state = convert.mppi_state_from_numpy(_leaves(jloop.tamp.mppi_state))


@pytest.mark.parametrize("variant", list(TICK_VARIANTS))
def test_command_tick_matches_jax_package(variant):
    """One ``_command_impl`` tick: action sequence, means, elites, weights."""
    jloop, ploop = _loops(variant)
    _reset(jloop, ploop)
    if variant == "friction_noise":
        assert ploop.tamp.motion_planner.fric_inject
        assert np.ptp(ploop.tamp.mppi_state.fric_scale_k.numpy()) > 0.1
    jtask = jloop.tamp.tamp_interface_view(jloop._view)
    ptask = ploop.tamp.tamp_interface_view(ploop._view)
    for name, ref in _leaves(jtask).items():
        assert np.array_equal(getattr(ptask, name).numpy(), ref), name
    jact, jms, jaux = jloop.tamp.motion_planner.command(jloop.tamp.mppi_state, jloop.state, jtask)
    pact, pms, paux = ploop.tamp.motion_planner.command(ploop.tamp.mppi_state, ploop.state, ptask)
    np.testing.assert_allclose(pact.numpy(), np.asarray(jact), atol=ATOL, rtol=0)
    names = ("mean_action", "weights") + (
        ("mean_action_1", "mean_action_2", "best_traj_1", "best_traj_2") if ploop.tamp.motion_planner.multi_modal
        else ("best_traj", "beta")
    )
    for name in names:
        np.testing.assert_allclose(getattr(pms, name).numpy(), np.asarray(getattr(jms, name)), atol=ATOL, rtol=0, err_msg=name)
    np.testing.assert_allclose(paux["top_values"].numpy(), np.asarray(jaux["top_values"]), atol=ATOL, rtol=0)
    # the pull half wins near the box in both packages
    assert ploop.tamp.motion_planner.get_pull_preference(pms) == jloop.tamp.motion_planner.get_pull_preference(jms)


def test_run_chunked_matches_jax_package():
    """``run_chunked(6, chunk=3)`` with the device gate on: per-tick views."""
    jloop, ploop = _loops("push_pull_multi_modal")
    _reset(jloop, ploop)
    jlog = jloop.run_chunked(6, chunk=3)
    plog = ploop.run_chunked(6, chunk=3)
    assert plog.steps == jlog.steps == 6
    assert plog.task == jlog.task
    assert plog.success_step == jlog.success_step
    for name in ("robot_pos", "robot_vel", "box_pos"):
        np.testing.assert_allclose(
            np.asarray(getattr(plog, name)), np.asarray(getattr(jlog, name)), atol=ATOL, rtol=0, err_msg=name
        )
    # the robot moved: the comparison is not of two parked states
    assert np.linalg.norm(np.asarray(plog.robot_pos[-1]) - START_Q) > 0.05


def test_per_tick_loop_equals_chunked_loop():
    """``SimLoop.tick`` six times and ``run_chunked(6, chunk=3)`` run the same
    ticks: the done latch's freeze is the identity while the gate is open,
    so the logs agree exactly (ROADMAP M5: chunked task time equals
    per-tick task time)."""
    jloop, ploop = _loops("push_pull_multi_modal")
    _reset(jloop, ploop)
    for i in range(6):
        ploop.tick(i)
    ticked = ploop.log
    _reset(jloop, ploop)
    chunked = ploop.run_chunked(6, chunk=3)
    assert ticked.steps == chunked.steps == 6
    for name in ("robot_pos", "robot_vel", "box_pos"):
        assert np.array_equal(np.asarray(getattr(ticked, name)), np.asarray(getattr(chunked, name))), name
