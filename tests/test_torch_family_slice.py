"""The heijn (3-dof omni) and boxer (differential drive) families in the
port, against the JAX package on the CPU.

* One ``command`` tick and a gated ``run_chunked(6, chunk=3)`` of
  ``config_heijn`` and ``config_boxer`` from the same start (the robot beside
  the box, so contact and suction are in play), with K=16 and
  ``mppi.exploration_noise=0``: the push_pull multi-modal planner of both
  bases, the boxer's single-mode push with its beta adaptation (on by default
  for ``boxer_env``), and the boxer's ``mppi=boxer_parity`` ablation (beta
  adaptation and the continuous push-align off).  The JAX planner and env
  states are carried into the port with ``utils/convert.py``.
* The staged pocket endgame: the port's symbolic planners are armed as the
  JAX package's (pocket limit, the boxer's proximity latch, the standoff's
  clearance), and a scripted stall drives both through the same
  reposition latch.
* The two-corner spawn (``actors=["box"]
  initial_actor_positions=[[3.75,3.75]]``): the port's initial state is the
  JAX package's.
* The boxer two-corner hybrid's failing seed (seed 17 of its n=20 row,
  traced on the card by ``scripts/trace_tick_paths.py seed=17``, the record
  in ``results_h100/trace/``): the views the port's host planner was given,
  replayed through the port's and the JAX package's planners at the run's
  cadence, give the plans the run made, in both.
"""
import dataclasses
import functools
import json
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest

from m3p2i_aip_tpu.config.config_store import load_config as jax_load_config
from m3p2i_aip_tpu.envs import make_env as jax_make_env
from m3p2i_aip_tpu.tamp.sim_loop import SimLoop as JaxSimLoop
from m3p2i_aip_tpu_torch.config.config_store import load_config
from m3p2i_aip_tpu_torch.envs import make_env
from m3p2i_aip_tpu_torch.scripts import trace_tick_paths
from m3p2i_aip_tpu_torch.scripts.trace_tick_paths import _plan
from m3p2i_aip_tpu_torch.tamp.sim_loop import SimLoop
from m3p2i_aip_tpu_torch.utils import convert

COMMON = ["mppi.num_samples=16", "mppi.exploration_noise=0"]
HYBRID = ["task=push_pull", "multi_modal=True", "goal=[-3.75,-3.75]"]
PUSH = ["task=push", "goal=[-1,-1]"]
VARIANTS = {
    "heijn_push_pull": ("config_heijn", [*HYBRID, *COMMON]),
    "boxer_push_pull": ("config_boxer", [*HYBRID, *COMMON]),
    "boxer_push_beta_adapt": ("config_boxer", [*PUSH, *COMMON]),
    "boxer_parity_push": ("config_boxer", [*PUSH, "mppi=boxer_parity", *COMMON]),
    "boxer_parity_push_pull": ("config_boxer", [*HYBRID, "mppi=boxer_parity", *COMMON]),
}
# test_torch_slice.py's bar and reason: f32 work in another summation order
# (the port's K-sample sums are float64) moves actions by ~1e-5 a tick; 1e-3
# bounds six closed-loop ticks of it and still fails on any formula drift.
ATOL = 1e-3
# the robot just north of the box (at [0, 2]), heading south and moving
# toward it; from here the boxer's eta sits far below 10 at the first tick
# (about 2.1), so its beta adaptation branches clear of both bounds
START_Q, START_QD = [0.0, 2.55, -1.57], [0.0, -0.5, 0.0]
TWO_CORNER = ['actors=["box"]', "initial_actor_positions=[[3.75,3.75]]"]


def _leaves(x) -> dict:
    return {
        f.name: np.asarray(getattr(x, f.name))
        for f in dataclasses.fields(x)
        if f.metadata.get("pytree_node", True) and getattr(x, f.name) is not None
    }


@functools.lru_cache(maxsize=None)
def _loops(variant: str):
    name, overrides = VARIANTS[variant]
    return JaxSimLoop(jax_load_config(name, overrides)), SimLoop(load_config(name, overrides), device="cpu")


def _reset(jloop, ploop):
    """Both loops at the same start state and planner state."""
    jloop.reset()
    ploop.reset()
    s = jloop.env.init_state()
    n = s.q.shape[0]
    jloop.state = s.replace(q=jnp.asarray(START_Q[:n], jnp.float32), qd=jnp.asarray(START_QD[:n], jnp.float32))
    jloop._view = jloop.env.view(jloop.state)
    ploop.state = convert.point_env_state_from_numpy(_leaves(jloop.state))
    ploop._view = ploop.env.view(ploop.state)
    ploop.tamp.mppi_state = convert.mppi_state_from_numpy(_leaves(jloop.tamp.mppi_state))


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_command_tick_matches_jax_package(variant):
    """One ``_command_impl`` tick: action sequence, means, elites, weights
    (and beta for the single-mode planners)."""
    jloop, ploop = _loops(variant)
    _reset(jloop, ploop)
    jmp, pmp = jloop.tamp.motion_planner, ploop.tamp.motion_planner
    # auto-on for boxer_env, off in the parity ablation (single mode reads it)
    assert pmp.beta_adapt == jmp.beta_adapt == (variant.startswith("boxer") and "parity" not in variant)
    assert ploop.tamp.objective.boxer_continuous_align == jloop.tamp.objective.boxer_continuous_align
    assert pmp.nu == jmp.nu == {"heijn": 3, "boxer": 2}[variant.split("_")[0]]
    jtask = jloop.tamp.tamp_interface_view(jloop._view)
    ptask = ploop.tamp.tamp_interface_view(ploop._view)
    for name, ref in _leaves(jtask).items():
        assert np.array_equal(getattr(ptask, name).numpy(), ref), name
    jact, jms, _ = jmp.command(jloop.tamp.mppi_state, jloop.state, jtask)
    pact, pms, _ = pmp.command(ploop.tamp.mppi_state, ploop.state, ptask)
    np.testing.assert_allclose(pact.numpy(), np.asarray(jact), atol=ATOL, rtol=0)
    names = ("mean_action", "weights") + (
        ("mean_action_1", "mean_action_2", "best_traj_1", "best_traj_2") if pmp.multi_modal else ("best_traj", "beta")
    )
    for name in names:
        np.testing.assert_allclose(
            getattr(pms, name).numpy(), np.asarray(getattr(jms, name)), atol=ATOL, rtol=0, err_msg=name
        )
    if pmp.beta_adapt and not pmp.multi_modal:
        # the adaptation branches on eta = 1 / max weight against 20 and 10: a
        # one-ulp eta across a bound would move beta by 10-20%, so this start
        # keeps eta well clear of both, and beta did move
        eta = 1.0 / float(np.max(np.asarray(jms.weights)))
        assert min(abs(eta - 20.0), abs(eta - 10.0)) > 1e-2, eta
        assert float(pms.beta) == float(jms.beta) != 1.0


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_run_chunked_matches_jax_package(variant):
    """``run_chunked(6, chunk=3)`` with the device gate on: per-tick views,
    tasks, and the robot's heading."""
    jloop, ploop = _loops(variant)
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
    np.testing.assert_allclose(ploop.state.q.numpy(), np.asarray(jloop.state.q), atol=ATOL, rtol=0)
    if not ploop.tamp.motion_planner.multi_modal:
        np.testing.assert_allclose(
            float(ploop.tamp.mppi_state.beta), float(jloop.tamp.mppi_state.beta), rtol=1e-6
        )
    # the robot moved (a diff drive covers little ground in six ticks from
    # rest): not a comparison of two parked states
    assert np.linalg.norm(ploop.state.q.numpy() - START_Q[: ploop.state.q.shape[0]]) > 0.01


@pytest.mark.parametrize("config_name", ["config_heijn", "config_boxer"])
@pytest.mark.parametrize("task", [PUSH, HYBRID, ["task=pull", "goal=[0,0]"]])
def test_pocket_endgame_is_armed_as_in_the_jax_package(config_name, task):
    """The symbolic planner's pocket-endgame latches, armed from the
    scene's arena (port ``build_task_planner``), equal the JAX package's;
    then a box that stops beside the robot for long enough latches the
    staged reposition in both, to the same standoff."""
    overrides = [*task, "mppi.num_samples=16"]
    jloop = JaxSimLoop(jax_load_config(config_name, overrides))
    ploop = SimLoop(load_config(config_name, overrides), device="cpu")
    jtp, ptp = jloop.tamp.task_planner, ploop.tamp.task_planner
    for name in ("_pocket_lim", "_prox_latch", "_min_clearance"):
        assert getattr(ptp, name, None) == getattr(jtp, name, None), name
    box = np.asarray([-0.8, -0.5], np.float32)
    view = {"robot_pos": box + np.asarray([0.0, 0.45], np.float32), "robot_vel": np.zeros(2, np.float32),
            "box_pos": box, "box_quat": np.asarray([0, 0, 0, 1], np.float32), "dynobs_contact": 0.0}
    tasks = []
    for _ in range(40):
        for tp in (jtp, ptp):
            if hasattr(tp, "observe"):
                tp.observe(view)
            tp.update_plan(view)
        assert ptp.task == jtp.task
        np.testing.assert_array_equal(np.asarray(ptp.curr_goal), np.asarray(jtp.curr_goal))
        tasks.append(ptp.task)
    if "task=push" in task:  # pure push is armed on both bases: the stall latches the reposition
        assert "reposition" in tasks, tasks


@pytest.mark.parametrize("config_name", ["config_point", "config_heijn", "config_boxer"])
def test_two_corner_spawn_matches_jax_package(config_name):
    """The box spawned in the far corner: every leaf of the port's initial
    state is the JAX package's, and the box sits at [3.75, 3.75]."""
    overrides = [*HYBRID, *TWO_CORNER]
    jenv = jax_make_env(jax_load_config(config_name, overrides))
    penv = make_env(load_config(config_name, overrides), device="cpu")
    js, ps = jenv.init_state(), penv.init_state()
    for name, ref in _leaves(js).items():
        np.testing.assert_array_equal(getattr(ps, name).numpy(), ref, err_msg=name)
    np.testing.assert_allclose(ps.dyn_pos[penv.box_slot].numpy(), [3.75, 3.75])


SEED17 = pathlib.Path(__file__).resolve().parents[1] / "results_h100" / "trace" / "boxer_corner2_hybrid_seed17.npz"


def test_boxer_two_corner_seed17_plans_as_the_jax_package():
    """Seed 17's record, replayed as ``run_chunked`` feeds the host planner
    (``update_plan`` on the last view at each chunk boundary, ``observe`` on
    every tick's view): the port's and the JAX package's planners make the
    plans the run made at all 250 boundaries, through the stall latch at
    tick 144, six repositions to the standoff the corner clips to the
    box's goal side, and the exhausted budget (ROADMAP.md, recorded
    divergences)."""
    rec = np.load(SEED17)
    overrides = [*HYBRID, *TWO_CORNER, "mppi.num_samples=16"]
    jtp = JaxSimLoop(jax_load_config("config_boxer", overrides)).tamp.task_planner
    ptp = SimLoop(load_config("config_boxer", overrides), device="cpu").tamp.task_planner
    views = [{"robot_pos": r, "box_pos": b} for r, b in zip(
        [rec["robot_pos0"], *rec["robot_pos"]], [rec["box_pos0"], *rec["box_pos"]])]
    seen = 0
    plans = [json.loads(p) for p in rec["plan"]]
    for tick, want in zip(rec["plan_tick"], plans):
        for tp in (jtp, ptp):
            for view in views[seen + 1: tick + 1]:
                tp.observe(view)
            tp.update_plan(views[tick])
        seen = tick
        assert _plan(ptp) == want, f"tick {tick}: the port plans {_plan(ptp)}, the run planned {want}"
        assert _plan(jtp) == want, f"tick {tick}: the JAX package plans {_plan(jtp)}, the run planned {want}"
    tasks = [p["task"] for p in plans]
    assert tasks.count("reposition") and plans[-1]["relatch_left"] == 0 and plans[-1]["pocket_stage"] == 2
    assert np.allclose(rec["box_pos"][-1], rec["box_pos0"], atol=0.01), "the box left its corner"


def test_seed_trace_records_the_views_and_plans(tmp_path):
    """``trace_tick_paths seed=N`` on the CPU, 8 ticks of the boxer
    two-corner hybrid at K=16 x T=4: a plan at each chunk boundary (ticks 0
    and 4), the views of every tick, and the box still in its corner."""
    out = tmp_path / "trace.npz"
    result = trace_tick_paths.main(["seed=17", "n_ticks=8", "device=cpu", f"out={out}", "-cn", "config_boxer", *HYBRID,
                                    *TWO_CORNER, "mppi.num_samples=16", "mppi.horizon=4"])
    rec = np.load(out)
    assert list(rec["plan_tick"]) == [0, 4] and rec["robot_pos"].shape == rec["box_pos"].shape == (8, 2)
    assert json.loads(rec["plan"][0])["task"] == "push_pull" and result["ticks"] == 8
    np.testing.assert_array_equal(rec["box_pos0"], [3.75, 3.75])
    assert result["last_plan"] == json.loads(rec["plan"][-1])
