"""The per-tick loop and the reference's per-tick API against the JAX package.

``SimLoop.run`` ticks one replan+step at a time with the host task planner
on every tick (the panda's active-inference planner included), and
``ReactiveTAMP.run_tamp`` / ``run_tamp_sequence`` are the reference's per-
tick calls.  Each case starts both packages from the same state and planner
state (carried into the port with ``utils/convert.py``) with
``mppi.exploration_noise=0``, the one random draw the two cannot share, and
holds six ticks to the JAX package at ``ATOL``.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from m3p2i_aip_tpu.config.config_store import load_config as jax_load_config
from m3p2i_aip_tpu.envs import update_dyn_obs as jax_update_dyn_obs
from m3p2i_aip_tpu.tamp.sim_loop import SimLoop as JaxSimLoop
from m3p2i_aip_tpu.tamp.sim_loop import real_suction_ext as jax_real_suction_ext
from m3p2i_aip_tpu_torch.config.config_store import load_config
from m3p2i_aip_tpu_torch.envs import update_dyn_obs
from m3p2i_aip_tpu_torch.tamp.sim_loop import SimLoop, real_suction_ext, run_sim
from m3p2i_aip_tpu_torch.utils import convert

NOISE_OFF = "mppi.exploration_noise=0"
# K=32 so that the top-20 trajectories are a proper subset of the samples
CASES = {
    "point_push_pull_multi_modal": (
        "config_point", ["task=push_pull", "multi_modal=True", "goal=[-3.75,-3.75]", "mppi.num_samples=32", NOISE_OFF]
    ),
    "heijn_push": ("config_heijn", ["task=push", "goal=[-1,-1]", "mppi.num_samples=16", NOISE_OFF]),
    "panda": ("config_panda", ["mppi.num_samples=16", "mppi.refine_iters=1", NOISE_OFF]),
}
# the bar and reasoning of tests/test_torch_slice.py:31-36: f32 work in
# another summation order, compounded over six closed-loop ticks
ATOL = 1e-3
TICKS = 6
# the point robot next to the box, so contact and suction are in play
POINT_START = {"q": [0.0, 1.5], "qd": [0.0, -1.0]}


def _leaves(x) -> dict:
    return {
        f.name: np.asarray(getattr(x, f.name))
        for f in dataclasses.fields(x)
        if f.metadata.get("pytree_node", True) and getattr(x, f.name) is not None
    }


@functools.lru_cache(maxsize=None)
def _loops(case: str):
    config_name, overrides = CASES[case]
    return JaxSimLoop(jax_load_config(config_name, overrides)), SimLoop(load_config(config_name, overrides), device="cpu")


def _carry_state(ploop, jstate):
    from_numpy = {
        "point_env": convert.point_env_state_from_numpy,
        "panda_env": convert.panda_env_state_from_numpy,
        "albert_env": convert.albert_state_from_numpy,
    }[ploop.env.env_type]
    return from_numpy(_leaves(jstate))


def _reset(case: str):
    """Both loops at the same start state and planner state, views fresh."""
    jloop, ploop = _loops(case)
    jloop.reset()
    ploop.reset()
    jstate = jloop.env.init_state()
    if case.startswith("point"):
        jstate = jstate.replace(**{k: jnp.asarray(v, jnp.float32) for k, v in POINT_START.items()})
    jloop.state = jstate
    jloop._view = jloop.env.view(jstate)
    ploop.state = _carry_state(ploop, jstate)
    ploop._view = ploop.env.view(ploop.state)
    ploop.tamp.mppi_state = convert.mppi_state_from_numpy(_leaves(jloop.tamp.mppi_state))
    return jloop, ploop


def _views_close(pview: dict, jview: dict) -> None:
    for name, ref in jview.items():
        np.testing.assert_allclose(np.asarray(pview[name]), np.asarray(ref), atol=ATOL, rtol=0, err_msg=name)


@pytest.mark.parametrize("case", list(CASES))
def test_run_matches_jax_package(case):
    """``SimLoop.run(6)`` tick by tick: the logged positions and tasks, the
    success tick, and the last view (the panda's cube and hand)."""
    jloop, ploop = _reset(case)
    jlog = jloop.run(TICKS)
    plog = ploop.run(TICKS)
    assert plog.steps == jlog.steps == TICKS
    assert plog.task == jlog.task
    assert plog.success_step == jlog.success_step
    for name in ("robot_pos", "robot_vel", "box_pos"):
        assert len(getattr(plog, name)) == len(getattr(jlog, name))
        if getattr(jlog, name):
            np.testing.assert_allclose(
                np.asarray(getattr(plog, name)), np.asarray(getattr(jlog, name)), atol=ATOL, rtol=0, err_msg=name
            )
    _views_close(ploop._view, jloop._view)
    if case == "panda":  # the arm moved: not a comparison of two parked hands
        assert np.linalg.norm(ploop._view["ee_state"][:3] - np.asarray(jloop.env.view(jloop.env.init_state())["ee_state"][:3])) > 1e-3
    else:
        assert np.linalg.norm(np.asarray(plog.robot_pos[-1]) - np.asarray(plog.robot_pos[0])) > 0.01


def test_run_equals_run_chunked():
    """``run(6)`` and ``run_chunked(6, chunk=3)`` run the same ticks: the
    logs agree exactly (tests/test_torch_slice.py:113 for ``tick``)."""
    _, ploop = _reset("point_push_pull_multi_modal")
    ticked = ploop.run(TICKS)
    _, ploop = _reset("point_push_pull_multi_modal")
    chunked = ploop.run_chunked(TICKS, chunk=3)
    assert ticked.steps == chunked.steps == TICKS
    assert ticked.task == chunked.task
    for name in ("robot_pos", "robot_vel", "box_pos"):
        assert np.array_equal(np.asarray(getattr(ticked, name)), np.asarray(getattr(chunked, name))), name


def test_run_tamp_matches_jax_package():
    """``run_tamp`` twice, then ``run_tamp_sequence``, from the same states:
    the JAX package's actions, and the pull preference read after each."""
    jloop, ploop = _reset("point_push_pull_multi_modal")
    jstate, pstate = jloop.state, ploop.state
    for call in ("run_tamp", "run_tamp", "run_tamp_sequence"):
        jact = getattr(jloop.tamp, call)(jstate)
        pact = getattr(ploop.tamp, call)(pstate)
        assert tuple(pact.shape) == tuple(jact.shape), call
        np.testing.assert_allclose(pact.numpy(), np.asarray(jact), atol=ATOL, rtol=0, err_msg=call)
        assert ploop.tamp.get_suction() == jloop.tamp.get_suction()
        assert ploop.tamp.get_trajs() is not None
    assert jloop.tamp.get_suction() == 1  # next to the box, the pull half wins in both packages


def test_run_tamp_returns_zeros_after_success():
    """Once the host planner reports success, ``run_tamp`` replans no more
    and returns zeros, as the JAX package does."""
    jloop, ploop = _reset("point_push_pull_multi_modal")
    goal = np.asarray(ploop.cfg.goal, np.float32)
    jstate = jloop.state.replace(dyn_pos=jloop.state.dyn_pos.at[jloop.env.params.dyn_actor_idx.index(
        list(jloop.env.params.actor_names).index("box"))].set(jnp.asarray(goal)))
    pstate = _carry_state(ploop, jstate)
    before = ploop.tamp.mppi_state
    pact = ploop.tamp.run_tamp(pstate)
    jact = jloop.tamp.run_tamp(jstate)
    assert ploop.tamp.task_success and jloop.tamp.task_success
    assert pact.tolist() == np.asarray(jact).tolist() == [0.0, 0.0]
    assert ploop.tamp.mppi_state is before
    assert ploop.tamp.run_tamp_sequence(pstate).shape == (ploop.cfg.mppi.u_per_command, 2)


def test_get_trajs_after_a_fused_tick():
    """The per-tick loop keeps the replan's top-20 trajectories on the
    device: [20, T, 2], the JAX package's rows up to the order of exactly
    tied weights (``torch.topk`` and ``lax.top_k`` may order a tie
    differently, ROADMAP Queue 3)."""
    jloop, ploop = _reset("point_push_pull_multi_modal")
    jloop.tick(0)
    ploop.tick(0)
    ptraj, jtraj = ploop.tamp.get_trajs(), np.asarray(jloop.tamp.get_trajs())
    T = ploop.tamp.motion_planner.T
    assert tuple(ptraj.shape) == jtraj.shape == (20, T, 2)
    assert ptraj.device == ploop.tamp.device
    pw, jw = ploop.tamp.mppi_state.weights, jloop.tamp.mppi_state.weights
    pval, pidx = torch.topk(pw, 20)
    jval, jidx = jax.lax.top_k(jw, 20)
    np.testing.assert_allclose(pval.numpy(), np.asarray(jval), atol=ATOL, rtol=0)
    pos = {int(k): r for r, k in enumerate(np.asarray(jidx))}
    w = np.asarray(jw)
    matched = 0
    for r, k in enumerate(pidx.tolist()):
        tied = np.sum(np.abs(w - w[k]) <= 1e-6) > 1
        if not tied:  # a weight of its own: the same sample at the same rank
            assert pos.get(k) == r, f"sample {k}: port rank {r}, JAX rank {pos.get(k)}"
        if k in pos:
            np.testing.assert_allclose(ptraj[r].numpy(), jtraj[pos[k]], atol=ATOL, rtol=0, err_msg=f"sample {k}")
            matched += 1
    assert matched >= 10


def test_interactive_run_off_a_tty_is_a_plain_run():
    """``run(interactive=True)`` with no tty (pytest's stdin) equals a plain
    run exactly (twin of tests/test_utils.py:144)."""
    _, ploop = _reset("heijn_push")
    plain = ploop.run(3)
    _, ploop = _reset("heijn_push")
    interactive = ploop.run(3, interactive=True)
    assert interactive.steps == plain.steps == 3
    for name in ("robot_pos", "robot_vel", "box_pos"):
        assert np.array_equal(np.asarray(getattr(interactive, name)), np.asarray(getattr(plain, name))), name


def test_run_sim_builds_settles_and_runs():
    log = run_sim(load_config("config_point", ["task=navigation", "goal=[-3,3]", "mppi.num_samples=16"]),
                  n_steps=2, warmup=3, device="cpu", realtime=True)
    assert log.steps == 2 and np.isfinite(np.asarray(log.robot_pos)).all()


@pytest.mark.parametrize("task", ["pull", "push", "push_pull"])
@pytest.mark.parametrize("suction_active", [True, False])
def test_real_suction_ext_matches_jax_package(task, suction_active):
    """The host suction of the real env (threshold 1.5): the robot 0.4 m
    from the box, the action away from it (on for a pull-family task with
    suction granted) and toward it (never on)."""
    jloop, ploop = _loops("heijn_push")
    jcfg = jax_load_config("config_heijn", [f"task={task}", f"suction_active={suction_active}"])
    pcfg = load_config("config_heijn", [f"task={task}", f"suction_active={suction_active}"])
    jstate = jloop.env.init_state()
    box = np.asarray(jstate.dyn_pos)[ploop.env.box_slot]
    jstate = jstate.replace(q=jnp.asarray([box[0] + 0.4, box[1], 0.3], jnp.float32))
    pstate = _carry_state(ploop, jstate)
    on = []
    for vx in (1.0, -1.0):
        action = np.asarray([vx, 0.0, 0.0], np.float32)
        jext = jax_real_suction_ext(jcfg, jloop.env, jstate, jnp.asarray(action))
        pext = real_suction_ext(pcfg, ploop.env, pstate, torch.as_tensor(action))
        np.testing.assert_allclose(pext.robot.numpy(), np.asarray(jext.robot), atol=1e-5, rtol=0)
        np.testing.assert_allclose(pext.dyn.numpy(), np.asarray(jext.dyn), atol=1e-5, rtol=0)
        on.append(bool(torch.any(pext.robot != 0)))
    assert on == [task in ("pull", "push_pull") and suction_active, False]


def test_host_update_dyn_obs_matches_jax_package():
    """The sim client's host dyn-obs square wave over a whole period."""
    jloop, ploop = _loops("point_push_pull_multi_modal")
    jstate = jloop.env.init_state()
    pstate = _carry_state(ploop, jstate)
    for i in range(100):
        jstate = jax_update_dyn_obs(jloop.env, jstate, i)
        pstate = update_dyn_obs(ploop.env, pstate, i)
    np.testing.assert_allclose(pstate.dyn_pos.numpy(), np.asarray(jstate.dyn_pos), atol=1e-5, rtol=0)
    assert not np.allclose(pstate.dyn_pos.numpy(), ploop.env.init_state().dyn_pos.numpy())
