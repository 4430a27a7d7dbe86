"""Pipelined chunks (``SimLoop.run_chunked(pipelined=True)``, one chunk in
flight) in the port, against the port's serial chunks and against the JAX
package's pipelined loop (sim_loop.py:344-384), on the CPU; and F3, the
per-tick panda run's late stage switch, in both packages.

- On a fixed plan (K=64 as the JAX package's slow test,
  tests/test_tamp_integration.py:637-660, chunks of 5) the pipelined run
  lands the serial run's success tick with bit-equal logs: the task is
  constant, so enqueueing chunk N+1 before chunk N is drained cannot change
  a tick.  The plan is a navigation: with the port's draws the slow test's
  push to [-1, -1] stalls and switches to ``reposition`` at a chunk
  boundary (the JAX package's draws do not stall there), and a plan that
  changes at a boundary reacts a chunk later when pipelined.
- ``run_chunked(9, chunk=3, pipelined=True)`` with tests/test_torch_slice.py's
  overrides (push_pull multi-modal, K=16, ``exploration_noise=0``) against
  the JAX package's, within that file's ATOL 1e-3.
- After success the in-flight chunk is discarded unfetched but its carry is
  kept, and it starts with the done latch open (``run_chunk`` takes no
  ``done0``), so it steps the latched state once more before it latches
  again: the final state is one tick past the latch in both packages.
- The panda takes its own chunk loop whether or not ``pipelined`` is set.
- F3: the host active-inference planner selects ``pick`` one observation
  after the EE comes within the grasp threshold, while the device gate
  (``_panda_gate_device``) switches on that observation; the JAX package's
  host planner lags the same way.  So a per-tick panda run and a chunked
  one part at the reach -> pick switch.
"""
import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from m3p2i_aip_tpu.config.config_store import load_config as jax_load_config
from m3p2i_aip_tpu.planners.task_planner.task_planner import set_task_planner as jax_set_task_planner
from m3p2i_aip_tpu.tamp.sim_loop import SimLoop as JaxSimLoop
from m3p2i_aip_tpu_torch.config.config_store import load_config
from m3p2i_aip_tpu_torch.planners.task_planner.task_planner import set_task_planner
from m3p2i_aip_tpu_torch.tamp.sim_loop import SimLoop
from m3p2i_aip_tpu_torch.utils import convert

# a navigation: PLANNER_SIMPLE keeps its one task for the whole run
FIXED_PLAN = ["task=navigation", "goal=[1.5,-1.0]", "mppi.num_samples=64"]
SLICE = ["task=push_pull", "multi_modal=True", "goal=[-3.75,-3.75]", "mppi.num_samples=16", "mppi.exploration_noise=0"]
# a navigation goal 0.4 m from the robot at rest: the gate latches within
# the first few chunks of 3
LATCH = ["task=navigation", "goal=[0.4,0.0]", "mppi.num_samples=64", "mppi.exploration_noise=0"]
# tests/test_torch_slice.py's bar: f32 work in another summation order
# compounded over the closed-loop ticks
ATOL = 1e-3
START_Q, START_QD = [0.0, 1.5], [0.0, -1.0]
LOG_FIELDS = ("robot_pos", "robot_vel", "box_pos")


def _leaves(x) -> dict:
    return {
        f.name: np.asarray(getattr(x, f.name))
        for f in dataclasses.fields(x)
        if f.metadata.get("pytree_node", True) and getattr(x, f.name) is not None
    }


def _port_loop(overrides, warmup: int = 0):
    loop = SimLoop(load_config("config_point", overrides), device="cpu")
    loop.warmup(warmup)
    return loop


@functools.lru_cache(maxsize=None)
def _jax_loop(key: str):
    return JaxSimLoop(jax_load_config("config_point", {"slice": SLICE, "latch": LATCH}[key]))


def _paired(key: str):
    """The JAX loop and a port loop at the same start and planner state (the
    slice's start beside the box, or the scene's initial state)."""
    jloop = _jax_loop(key)
    jloop.reset()
    jloop.state = jloop.env.init_state()
    if key == "slice":
        jloop.state = jloop.state.replace(q=jnp.asarray(START_Q, jnp.float32), qd=jnp.asarray(START_QD, jnp.float32))
    jloop._view = jloop.env.view(jloop.state)
    ploop = _port_loop({"slice": SLICE, "latch": LATCH}[key])
    ploop.state = convert.point_env_state_from_numpy(_leaves(jloop.state))
    ploop._view = ploop.env.view(ploop.state)
    ploop.tamp.mppi_state = convert.mppi_state_from_numpy(_leaves(jloop.tamp.mppi_state))
    return jloop, ploop


def test_pipelined_equals_serial_on_a_fixed_plan():
    """The JAX slow test's protocol on a navigation, in the port: the same
    success tick and the same logs, bit for bit."""
    serial = _port_loop(FIXED_PLAN, warmup=10)
    log_s = serial.run_chunked(300, chunk=5)
    pipelined = _port_loop(FIXED_PLAN, warmup=10)
    log_p = pipelined.run_chunked(300, chunk=5, pipelined=True)
    assert log_s.success_step is not None
    assert log_p.success_step == log_s.success_step and log_p.steps == log_s.steps
    assert log_p.task == log_s.task and set(log_s.task) == {"navigation"}
    for name in LOG_FIELDS:
        assert np.array_equal(np.asarray(getattr(log_p, name)), np.asarray(getattr(log_s, name))), name


def test_pipelined_matches_jax_pipelined():
    """``run_chunked(9, chunk=3, pipelined=True)`` from one start and
    planner state in both packages: per-tick views within ATOL."""
    jloop, ploop = _paired("slice")
    jlog = jloop.run_chunked(9, chunk=3, pipelined=True)
    plog = ploop.run_chunked(9, chunk=3, pipelined=True)
    assert plog.steps == jlog.steps == 9
    assert plog.task == jlog.task and plog.success_step == jlog.success_step
    for name in LOG_FIELDS:
        np.testing.assert_allclose(
            np.asarray(getattr(plog, name)), np.asarray(getattr(jlog, name)), atol=ATOL, rtol=0, err_msg=name
        )
    assert np.linalg.norm(np.asarray(plog.robot_pos[-1]) - START_Q) > 0.05  # the robot moved
    np.testing.assert_allclose(ploop.state.q.numpy(), np.asarray(jloop.state.q), atol=ATOL, rtol=0)


def test_final_state_after_success_matches_jax_package():
    """A run that latches in its first chunk: the log stops at the success
    tick, and the final state is the in-flight chunk's, one tick past the
    latch, in both packages."""
    jloop, ploop = _paired("latch")
    jlog = jloop.run_chunked(30, chunk=3, pipelined=True)
    plog = ploop.run_chunked(30, chunk=3, pipelined=True)
    assert plog.success_step is not None and plog.success_step == jlog.success_step
    assert plog.steps == jlog.steps == plog.success_step + 1
    for name in ("q", "qd", "dyn_pos", "dyn_vel"):
        np.testing.assert_allclose(
            getattr(ploop.state, name).numpy(), np.asarray(getattr(jloop.state, name)), atol=ATOL, rtol=0, err_msg=name
        )
    # the serial loop stops at the latched state: the pipelined one is a tick past it
    _, serial = _paired("latch")
    slog = serial.run_chunked(30, chunk=3)
    assert slog.success_step == plog.success_step
    assert np.array_equal(np.asarray(slog.robot_pos), np.asarray(plog.robot_pos))
    assert not torch.equal(serial.state.q, ploop.state.q)
    assert np.allclose(serial.state.q.numpy(), np.asarray(slog.robot_pos[-1]))


def test_panda_pipelined_takes_the_panda_chunk_loop():
    """``pipelined=True`` on the panda runs ``_run_chunked_panda``: the same
    log and state as without it (K=8, T=4, two chunks of 2)."""
    overrides = ["mppi.num_samples=8", "mppi.horizon=4"]
    runs = []
    for pipelined in (False, True):
        loop = SimLoop(load_config("config_panda", overrides), device="cpu")
        loop.warmup(5)
        log = loop.run_chunked(4, chunk=2, pipelined=pipelined)
        runs.append((log, loop.state))
    (log_a, state_a), (log_b, state_b) = runs
    assert log_a.steps == log_b.steps == 4 and log_a.task == log_b.task
    assert torch.equal(state_a.q, state_b.q) and torch.equal(state_a.body_pos, state_b.body_pos)


# ------------------------------------------------------------------------ F3
def _views():
    """Panda observations: the EE 35 cm above the cube (reach), then 1 cm
    above it, inside the pre-grasp threshold (pre_height_diff + 0.005)."""
    far = {
        "cube_state": np.array([0.5, 0.0, 1.05, 0.0, 0.0, 0.0, 1.0], np.float32),
        "cube_goal": np.array([0.5, 0.3, 1.05, 0.0, 0.0, 0.0, 1.0], np.float32),
        "ee_state": np.array([0.5, 0.0, 1.40, 0.0, 0.0, 0.0, 1.0], np.float32),
        "attached": 0.0,
    }
    near = dict(far, ee_state=np.array([0.5, 0.0, 1.06, 0.0, 0.0, 0.0, 1.0], np.float32))
    return [far, far, far, near, near, near]


def test_host_planner_switches_to_pick_one_observation_after_the_device_gate():
    """F3's cause: on the same observations the port's and the JAX
    package's host planners select pick at the second near view, and the
    port's device gate at the first."""
    views = _views()
    hosts = []
    for tp in (set_task_planner(load_config("config_panda")), jax_set_task_planner(jax_load_config("config_panda"))):
        tasks = []
        for v in views:
            tp.update_plan(v)
            tasks.append(tp.task)
        hosts.append(tasks)
    assert hosts[0] == hosts[1] == ["reach", "reach", "reach", "reach", "pick", "pick"]

    loop = SimLoop(load_config("config_panda", ["mppi.num_samples=8", "mppi.horizon=4"]), device="cpu")
    tamp, base = loop.tamp, loop.state
    stage, zs, stages = torch.zeros((), dtype=torch.int32), tamp.zup_zs0(), []
    for v in views:
        # the device gate reads the state: the cube and the EE's distance to it as in the view
        ee = tamp.env.view(base)["ee_state"][:3]
        cube = torch.as_tensor(ee - (v["ee_state"][:3] - v["cube_state"][:3]), dtype=torch.float32)
        pos = base.body_pos.clone()
        pos[1] = cube
        _, stage, _, zs = tamp._panda_gate_device(dataclasses.replace(base, body_pos=pos), stage, zs)
        stages.append(int(stage))
    assert stages == [0, 0, 0, 1, 1, 1]
