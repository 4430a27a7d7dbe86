"""The port's batched seed evaluation (``tamp/batch_loop.py``) on the CPU.

* ``BatchSimLoop`` equals B serial ``SimLoop.run_chunked`` runs of the port
  (point push_pull multi-modal, panda multi-modal pick-place, albert
  push_reach; 12 ticks in chunks of 4, exploration noise on): equal tick
  counts, success ticks and task sequences, positions within 1e-5, and the
  seeds genuinely different runs.  Both sides run the same plain versions
  and each seed draws its noise from a generator seeded as its serial run's,
  so only the summation order of batched and single tensor ops separates
  them (measured ~1e-7, in the panda's and albert's FK; the point family is
  held bit for bit).  Three-seed batches of 8 ticks do the same, bit for
  bit, for the heijn and boxer bases (the boxer's beta adaptation and its
  parity ablation) and for the point planner's simple mode, random
  sampling, update_cov and update_cov_per_mode, whose draws come from the
  per-seed generators too.
* A seed that finishes early freezes: its log stops at the crossing tick,
  and a chunk entered with its ``done0`` pre-latch set leaves its state
  untouched while the other seeds run on (point); a pre-latched panda seed
  keeps its latch and its zero action.
* One batched chunk of the port against the JAX package's ``BatchSimLoop``
  chunk (the vmapped ``_run_chunk_impl``), with ``mppi.exploration_noise=0``
  and the JAX batched planner and env states carried into the port with
  ``utils/convert.py``: per-tick positions within 1e-4.  The whole JAX
  chunk is compared, not one planner tick: it compiles in about 30 s here.

Sizes: K=16, T=8 (panda T=4), B=2-3.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from m3p2i_aip_tpu.config.config_store import load_config as jax_load_config
from m3p2i_aip_tpu.tamp.batch_loop import BatchSimLoop as JaxBatchSimLoop
from m3p2i_aip_tpu_torch.config.config_store import load_config
from m3p2i_aip_tpu_torch.tamp.batch_loop import BatchSimLoop
from m3p2i_aip_tpu_torch.tamp.sim_loop import SimLoop
from m3p2i_aip_tpu_torch.utils import convert
from m3p2i_aip_tpu_torch.utils.tree import tree_map

SMALL = ["mppi.num_samples=16", "mppi.horizon=8"]
HYBRID = ["task=push_pull", "multi_modal=True", "goal=[-3.75,-3.75]"]
NAV = ["task=navigation", "goal=[-3,3]"]
FAMILIES = {
    "point_push_pull": ("config_point", [*HYBRID, *SMALL]),
    "panda_multi_modal": ("config_panda", ["multi_modal=True", "mppi.num_samples=16", "mppi.horizon=4"]),
    "albert_push_reach": ("config_albert", ["task=push_reach", "goal=[3.0,0.0,0.6]", *SMALL]),
    # the heijn and boxer bases, and the planner modes beyond the default
    "heijn_push_pull": ("config_heijn", [*HYBRID, *SMALL]),
    "boxer_push_beta_adapt": ("config_boxer", ["task=push", "goal=[-1,-1]", *SMALL]),
    "boxer_parity_push_pull": ("config_boxer", [*HYBRID, "mppi=boxer_parity", *SMALL]),
    "point_simple": ("config_point", [*NAV, "mppi.mppi_mode=simple", *SMALL]),
    "point_random": ("config_point", [*NAV, "mppi.sampling_method=random", *SMALL]),
    "point_update_cov": ("config_point", [*NAV, "mppi.update_cov=True", *SMALL]),
    "point_update_cov_per_mode": ("config_point", [*HYBRID, "mppi.update_cov_per_mode=True", *SMALL]),
}
SEEDS, STEPS, CHUNK, WARMUP = [0, 1], 12, 4, 10
THREE_SEEDS = [0, 1, 2]  # the heijn/boxer and planner-mode batches
ATOL = 1e-5
JAX_ATOL = 1e-4


def _leaves(x) -> dict:
    return {
        f.name: np.asarray(getattr(x, f.name))
        for f in dataclasses.fields(x)
        if f.metadata.get("pytree_node", True) and getattr(x, f.name) is not None
    }


def _serial(config_name, overrides, seeds=SEEDS, steps=STEPS):
    cfg = load_config(config_name, overrides)
    loop, out = None, []
    for s in seeds:
        cfg.mppi.seed_val = s
        if loop is None:
            loop = SimLoop(cfg, device="cpu")
        else:
            loop.reset(s)
        loop.warmup(WARMUP)
        out.append((loop.run_chunked(steps, chunk=CHUNK), loop._view))
    return out


@pytest.mark.parametrize("family", list(FAMILIES))
def test_batch_equals_serial_runs(family):
    """The panda and albert at ATOL (their FK's matmuls sum in another
    order at another batch shape); the point family bit for bit, the
    heijn/boxer and planner-mode batches with three seeds over two chunks."""
    config_name, overrides = FAMILIES[family]
    seeds, steps = (SEEDS, STEPS) if family in ("point_push_pull", "panda_multi_modal", "albert_push_reach") else (
        THREE_SEEDS, 2 * CHUNK
    )
    atol = ATOL if config_name in ("config_panda", "config_albert") else 0.0
    serial = _serial(config_name, overrides, seeds, steps)
    batch = BatchSimLoop(load_config(config_name, overrides), seeds, device="cpu")
    batch.warmup(WARMUP)
    logs = batch.run_chunked(steps, chunk=CHUNK)
    assert len(logs) == len(seeds)
    for b, (slog, sview) in enumerate(serial):
        blog, bview = logs[b], batch.views[b]
        assert blog.steps == slog.steps, b
        assert blog.success_step == slog.success_step, b
        assert blog.task == slog.task, b
        assert blog.collisions == slog.collisions, b
        for name in ("robot_pos", "robot_vel", "box_pos"):
            np.testing.assert_allclose(
                np.asarray(getattr(blog, name)), np.asarray(getattr(slog, name)), atol=atol, rtol=0,
                err_msg=f"seed {b} {name}",
            )
        for key, ref in sview.items():
            np.testing.assert_allclose(np.asarray(bview[key]), np.asarray(ref), atol=atol, rtol=0, err_msg=f"{b} {key}")
    # the seeds are genuinely different runs (per-seed Halton deltas and noise)
    key = {"config_panda": "ee_state", "config_albert": "ee_pos"}.get(config_name, "robot_pos")
    assert not np.allclose(np.asarray(batch.views[0][key]), np.asarray(batch.views[1][key]))


def test_early_finisher_freezes():
    """Navigation to a near goal: every seed latches, each log stops at its
    crossing tick with the robot within the 0.1 m gate, and a chunk entered
    with seed 0 pre-latched leaves seed 0's states exactly as they were
    while seeds 1 and 2 keep moving."""
    goal = np.array([0.7, -0.7])
    cfg = load_config("config_point", ["task=navigation", "goal=[0.7,-0.7]", *SMALL])
    batch = BatchSimLoop(cfg, [0, 1, 2], device="cpu")
    batch.warmup(WARMUP)
    logs = batch.run_chunked(40, chunk=CHUNK)
    assert batch.done.all(), [log.success_step for log in logs]
    for b, log in enumerate(logs):
        assert log.steps == log.success_step + 1, b  # the log froze at the crossing
        assert np.linalg.norm(np.asarray(batch.views[b]["robot_pos"]) - goal) < 0.1, b

    tamp = batch.tamp
    task = batch._stacked_task_params()
    ms0, rs0 = batch.mppi_state, tree_map(lambda x: x.clone(), batch.state)
    moving = dataclasses.replace(rs0, qd=torch.ones_like(rs0.qd))  # seeds 1, 2 would move
    done0 = torch.tensor([True, False, False])
    ms, rs, views, n_ticks, done = tamp._run_chunk_impl(ms0, moving, task, 0, CHUNK, gate=True, done0=done0)
    assert n_ticks.tolist()[0] == 0 and bool(done[0])
    assert torch.equal(views[0], torch.zeros_like(views[0]))
    for name in ("q", "qd", "dyn_pos", "dyn_vel"):
        assert torch.equal(getattr(rs, name)[0], getattr(moving, name)[0]), name
    for name in ("mean_action", "mean_action_1", "weights"):
        assert torch.equal(getattr(ms, name)[0], getattr(ms0, name)[0]), name
    assert not torch.equal(rs.q[1], moving.q[1]) and not torch.equal(rs.q[2], moving.q[2])


def test_panda_prelatched_seed_keeps_its_latch():
    """A panda seed entered done stays done for the whole chunk, and its
    zero action lets its arm coast to rest while the live seed plans."""
    config_name, overrides = FAMILIES["panda_multi_modal"]
    batch = BatchSimLoop(load_config(config_name, overrides), SEEDS[:2], device="cpu")
    batch.warmup(WARMUP)
    tamp = batch.tamp
    out = tamp._run_chunk_panda_impl(
        batch.mppi_state, batch.state, batch._stage, batch._zs, CHUNK, done0=torch.tensor([True, False])
    )
    rs, dones = out[1], out[7]
    assert dones.shape == (2, CHUNK)
    assert bool(dones[0].all()) and not bool(dones[1].any())
    assert float(torch.max(torch.abs(rs.qd[0, :7]))) < float(torch.max(torch.abs(rs.qd[1, :7])))


def test_batched_chunk_matches_jax_batch_loop():
    overrides = ["task=push_pull", "multi_modal=True", "goal=[-3.75,-3.75]", *SMALL, "mppi.exploration_noise=0"]
    seeds = [0, 1]
    jbatch = JaxBatchSimLoop(jax_load_config("config_point", overrides), seeds)
    jbatch.warmup(WARMUP)
    # two different starts beside the box, so contact and suction are in play
    q = np.array([[0.0, 1.5], [-0.3, 1.4]], np.float32)
    qd = np.array([[0.0, -1.0], [0.5, 0.5]], np.float32)
    jbatch.state = jbatch.state.replace(q=jax.numpy.asarray(q), qd=jax.numpy.asarray(qd))
    views = np.asarray(jax.vmap(jbatch.env.view_vec)(jbatch.state))
    jbatch.views = [jbatch.env.view_unpack(v) for v in views]

    pbatch = BatchSimLoop(load_config("config_point", overrides), seeds, device="cpu")
    pbatch.state = convert.point_env_state_from_numpy(_leaves(jbatch.state))
    pbatch.mppi_state = convert.mppi_state_from_numpy(_leaves(jbatch.mppi_state))
    pbatch.views = [pbatch.env.view_unpack(v) for v in pbatch.env.view_vec(pbatch.state).numpy()]
    assert pbatch.mppi_state.halton_delta.shape == (2, 16, 8, 2)

    jlogs = jbatch.run_chunked(CHUNK, chunk=CHUNK)
    plogs = pbatch.run_chunked(CHUNK, chunk=CHUNK)
    for b in range(len(seeds)):
        assert plogs[b].steps == jlogs[b].steps == CHUNK
        assert plogs[b].task == jlogs[b].task
        for name in ("robot_pos", "robot_vel", "box_pos"):
            np.testing.assert_allclose(
                np.asarray(getattr(plogs[b], name)), np.asarray(getattr(jlogs[b], name)), atol=JAX_ATOL, rtol=0,
                err_msg=f"seed {b} {name}",
            )
        # the robot moved: not a comparison of two parked states
        assert np.linalg.norm(np.asarray(plogs[b].robot_pos[-1]) - q[b]) > 0.05
