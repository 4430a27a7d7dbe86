"""Slice 2 as a whole: the port's panda planner tick, its on-device AIF gate,
its chunked loop and the loop's reactive-scenario helpers against the JAX
package's, on the CPU.

The planner is built from ``config_panda`` at K=16, T=8 with the shipped
refine ladder (``refine_iters=3``, greedy last rung) and
``mppi.exploration_noise=0`` (the jitter is the one random draw the two
packages cannot share; without it a tick is deterministic).  The JAX planner
state (Halton deltas included) and env state are carried into the port with
``utils/convert.py``.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from m3p2i_aip_tpu.config.config_store import load_config as jax_load_config
from m3p2i_aip_tpu.models import panda_fk as jfk
from m3p2i_aip_tpu.planners.motion_planner.mppi import make_task_params as jax_task
from m3p2i_aip_tpu.tamp.sim_loop import SimLoop as JaxSimLoop
from m3p2i_aip_tpu_torch.config.config_store import load_config
from m3p2i_aip_tpu_torch.ops.control import discounted_traj_cost
from m3p2i_aip_tpu_torch.planners.motion_planner.mppi import make_task_params
from m3p2i_aip_tpu_torch.tamp.sim_loop import SimLoop
from m3p2i_aip_tpu_torch.utils import convert

COMMON = ["mppi.num_samples=16", "mppi.horizon=8", "mppi.exploration_noise=0"]
# the main path's single-mode table reach, and the multi-modal shelf pick
# with the cube held and the zup gate on (both grasp modes, the K2 weights,
# the close-gripper override)
TICK_VARIANTS = {
    "table_reach": ([*COMMON], "reach"),
    "shelf_pick_multi_modal": ([*COMMON, "multi_modal=True", "cube_on_shelf=True"], "pick"),
}
# One tick is four K-sample rollouts and three weight updates of f32 work in
# another summation order: costs agree to ~1e-6, the weights' exp() and the
# K-sample means carry that into the actions well below 1e-4, while any
# formula drift (a wrong rung scale, elite slot or override) moves them by
# 1e-2 or more.
ATOL = 1e-4
GOAL_ATOL = 1e-6
PICK_GOAL = [0.2, 0.2, 1.105, 0.0, 0.0, 0.0, 1.0]


def _leaves(x) -> dict:
    return {
        f.name: np.asarray(getattr(x, f.name))
        for f in dataclasses.fields(x)
        if f.metadata.get("pytree_node", True) and getattr(x, f.name) is not None
    }


@functools.lru_cache(maxsize=None)
def _loops(variant: str):
    overrides = TICK_VARIANTS[variant][0]
    jloop = JaxSimLoop(jax_load_config("config_panda", overrides))
    ploop = SimLoop(load_config("config_panda", overrides), device="cpu")
    return jloop, ploop


def _held(jloop, jstate):
    """The cube welded 8 cm below the hand, where the hand is."""
    hand_pos, hand_rot = jfk.fk(jstate.q, jloop.env.params.base_pos)["hand"]
    attach_pos = jnp.asarray([0.0, 0.0, 0.08])
    return jstate.replace(
        attached=jnp.asarray(1.0),
        attach_pos=attach_pos,
        attach_rot=jnp.eye(3),
        body_pos=jstate.body_pos.at[1].set(hand_pos + hand_rot @ attach_pos),
    )


@pytest.mark.parametrize("variant", list(TICK_VARIANTS))
def test_command_tick_matches_jax_package(variant):
    """One ``_command_impl`` tick through the refine ladder: action
    sequence, means, beta and weights."""
    jloop, ploop = _loops(variant)
    task_name = TICK_VARIANTS[variant][1]
    jloop.reset()
    ploop.reset()
    jstate = jloop.env.init_state()
    if task_name == "pick":
        jstate = _held(jloop, jstate)
    pstate = convert.panda_env_state_from_numpy(_leaves(jstate))
    pms = convert.mppi_state_from_numpy(_leaves(jloop.tamp.mppi_state))
    grip, zup = ("close", 1.0) if task_name == "pick" else ("open", 0.0)
    goal = PICK_GOAL if task_name == "pick" else np.zeros(7)
    jtask = jax_task(task_name, goal, grip, zup)
    ptask = make_task_params(task_name, goal, grip, zup)

    mp = ploop.tamp.motion_planner
    costs = []
    rollout = mp.rollout

    def recording(*args):
        out = rollout(*args)
        costs.append(out[0])
        return out

    mp.rollout = recording
    try:
        pact, pms, _ = mp._command_impl(pms, pstate, ptask)
    finally:
        mp.rollout = rollout
    jact, jms, _ = jloop.tamp.motion_planner.command(jloop.tamp.mppi_state, jstate, jtask)

    assert len(costs) == 1 + mp.refine_iters == 4
    np.testing.assert_allclose(pact.numpy(), np.asarray(jact), atol=ATOL, rtol=0)
    names = ["mean_action", "weights"] + (["mean_action_1", "mean_action_2"] if mp.multi_modal else ["beta"])
    for name in names:
        np.testing.assert_allclose(
            getattr(pms, name).numpy(), np.asarray(getattr(jms, name)), atol=ATOL, rtol=0, err_msg=name
        )
    # the greedy last rung is an argmin: its best two costs (per mode when
    # multi-modal) are far enough apart that rounding cannot flip the pick
    tc = discounted_traj_cost(costs[-1], mp.gamma_seq)
    groups = [tc, tc[: mp.half_K], tc[mp.half_K :]] if mp.multi_modal else [tc]
    for g in groups:
        best2 = torch.sort(g).values[:2]
        assert float(best2[1] - best2[0]) > ATOL, best2
    # the gripper override reached the rollouts: the plan's gripper channels
    # are the commanded +-1.5
    assert np.allclose(pms.mean_action[:, 7:9].numpy(), -1.5 if grip == "close" else 1.5)


# ------------------------------------------------------------- the AIF gate

def _gate_states(jloop):
    """Crafted (state, stage) pairs: rest (reach), cube at the EE (pick),
    cube at the pre-place pose (place + success), a far cube behind each
    hysteresis latch, and a placed cube that is not yet within 4 cm."""
    base = jloop.env.init_state()
    ee = jfk.fk(base.q, jloop.env.params.base_pos)["ee"][0]
    goal = base.body_pos[2]
    pre_place = goal.at[2].add(0.055)
    at = lambda p: base.replace(body_pos=base.body_pos.at[1].set(p))  # noqa: E731
    return [
        (base, 0),
        (at(ee + jnp.asarray([0.0, 0.0, 0.02])), 0),
        (at(pre_place + jnp.asarray([0.01, 0.0, 0.0])), 1),
        (base, 1),
        (base, 2),
        (at(pre_place + jnp.asarray([0.04, 0.03, 0.0])), 2),
    ]


def _stall_states(jloop):
    """35 ticks of a held cube in pick: 31 without progress toward the
    place goal (the first sets the best distance, then 30 stalled ticks
    turn the gate on), then 4 ticks 6 cm closer (it releases)."""
    held = _held(jloop, jloop.env.init_state())
    to_goal = held.body_pos[2].at[2].add(0.055) - held.body_pos[1]
    closer = held.replace(body_pos=held.body_pos.at[1].add(0.06 * to_goal / jnp.linalg.norm(to_goal)))
    return [held] * 31 + [closer] * 4


def test_panda_gate_matches_jax_package():
    jloop, ploop = _loops("table_reach")
    jgate = jax.jit(jloop.tamp._panda_gate_device)
    pgate = ploop.tamp._panda_gate_device

    def compare(jstate, stage, jzs, pzs):
        jt, jst, jsucc, jzs = jgate(jstate, jnp.asarray(stage, jnp.int32), jzs)
        pt, pst, psucc, pzs = pgate(
            convert.panda_env_state_from_numpy(_leaves(jstate)), torch.tensor(stage, dtype=torch.int32), pzs
        )
        assert int(pst) == int(jst) and bool(psucc) == bool(jsucc)
        for name in ("task_id", "gripper", "zup_gate"):
            assert getattr(pt, name).item() == np.asarray(getattr(jt, name)).item(), name
        np.testing.assert_allclose(pt.goal.numpy(), np.asarray(jt.goal), atol=GOAL_ATOL, rtol=0)
        np.testing.assert_array_equal(pzs.numpy(), np.asarray(jzs))
        return int(pst), bool(psucc), jzs, pzs

    seen = []
    for jstate, stage in _gate_states(jloop):
        st, succ, _, _ = compare(jstate, stage, jloop.tamp.zup_zs0(), ploop.tamp.zup_zs0())
        seen.append((st, succ))
    assert seen == [(0, False), (1, False), (2, True), (1, False), (2, False), (2, False)], seen

    jzs, pzs, gates = jloop.tamp.zup_zs0(), ploop.tamp.zup_zs0(), []
    for jstate in _stall_states(jloop):
        _, _, jzs, pzs = compare(jstate, 1, jzs, pzs)
        gates.append(float(pzs[2]))
    assert gates == [0.0] * 30 + [1.0] + [0.0] * 4, gates


# --------------------------------------------------------- the chunked loop

def test_run_chunked_panda_runs_the_gated_loop():
    """``run_chunked(6, chunk=3)`` on the panda at K=16: finite views, a
    stage that never decreases, every tick logged."""
    _, ploop = _loops("table_reach")
    ploop.reset()
    ploop.warmup(5)
    record = []
    run_chunk = ploop.tamp.run_chunk_panda

    def recording(*args):
        record.append(run_chunk(*args))
        return record[-1]

    ploop.tamp.run_chunk_panda = recording
    try:
        log = ploop.run_chunked(6, chunk=3)
    finally:
        ploop.tamp.run_chunk_panda = run_chunk
    assert log.steps == 6 and len(record) == 2
    views = torch.cat([r[5] for r in record])
    stages = torch.cat([r[6] for r in record])
    assert views.shape == (6, 22) and torch.isfinite(views).all()
    assert torch.all(stages[1:] >= stages[:-1])
    assert log.task == ["reach"] * 6
    # the arm moved toward the cube's pre-grasp pose
    ee0 = ploop.env.view(ploop.env.init_state())["ee_state"][:3]
    assert np.linalg.norm(views[-1, 14:17].numpy() - ee0) > 1e-3


# ------------------------------------------- reactive-scenario helpers

# config, overrides, the body to shove, the shove (the point keeps its xy)
SCENES = {
    "panda": ("config_panda", COMMON, "cubeA", [0.05, -0.03, 0.02]),
    "point": ("config_point", ["task=push_pull", *COMMON], "box", [0.3, -0.2, 0.0]),
}


@functools.lru_cache(maxsize=None)
def _scene_loops(scene: str):
    config, overrides = SCENES[scene][:2]
    return JaxSimLoop(jax_load_config(config, overrides)), SimLoop(load_config(config, overrides), device="cpu")


@pytest.mark.parametrize("scene", list(SCENES))
def test_perturb_body_matches_jax_package(scene):
    """``perturb_body`` moves the named body of the real env by the same
    shove, leaves every other field alone, and refreshes the view."""
    jloop, ploop = _scene_loops(scene)
    _, _, name, dpos = SCENES[scene]
    jloop.reset()
    ploop.reset()
    before = {f: getattr(ploop.state, f).clone() for f in _leaves(ploop.state)}
    jloop.perturb_body(name, dpos)
    ploop.perturb_body(name, dpos)
    jleaves = _leaves(jloop.state)
    moved = "body_pos" if scene == "panda" else "dyn_pos"
    for f in before:
        got = getattr(ploop.state, f).numpy()
        np.testing.assert_allclose(got, jleaves[f], atol=1e-6, rtol=0, err_msg=f)
        assert np.array_equal(got, before[f].numpy()) == (f != moved), f
    assert set(ploop._view) == set(jloop._view)
    for key, ref in jloop._view.items():
        np.testing.assert_allclose(np.asarray(ploop._view[key]), np.asarray(ref), atol=1e-5, rtol=0, err_msg=key)


@pytest.mark.parametrize("scene", list(SCENES))
def test_traj_point_matches_jax_package(scene):
    """The trajectory-view point of 16 seeded joint states (the panda EE's
    xy through FK; the point base's xy), one state at a time in JAX and as
    one batch in the port."""
    jloop, ploop = _scene_loops(scene)
    jbase, pbase = jloop.env.init_state(), ploop.env.init_state()
    n_q = pbase.q.shape[-1]
    if scene == "panda":
        q = np.random.default_rng(6).uniform(jfk.JOINT_LOWER, jfk.JOINT_UPPER, size=(16, n_q))
    else:
        q = np.random.default_rng(6).uniform(-3.5, 3.5, size=(16, n_q))
    q = q.astype(np.float32)
    ref = jax.vmap(lambda qi: jloop.env.traj_point(jbase.replace(q=qi)))(jnp.asarray(q))
    got = ploop.env.traj_point(dataclasses.replace(pbase, q=torch.as_tensor(q)))
    assert got.shape == (16, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=0)
