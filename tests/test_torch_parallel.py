"""The port's device mesh (``m3p2i_aip_tpu_torch/parallel``) on the CPU.

The counterpart of ``tests/test_parallel.py``: a mesh of repeated ``cpu``
devices stands in for the JAX tests' 8-device virtual CPU mesh.

* ``make_mesh`` over ``[cpu] * 8`` has size 8; ``sample_sharding`` splits a
  leading axis into contiguous slices and gathers them back in order;
  ``shard_planner`` rejects a K the mesh does not divide, and a mesh that
  does not start on the planner's device.
* The sharded planner's command (K=32 over 8 shards, and K=30 over 3, where
  the mode boundary half_K = 15 falls inside shard 1) equals the unsharded
  command exactly over two ticks (actions, planner state, top
  trajectories), and is within 1e-4 of the JAX package's sharded command on
  the virtual mesh (the bar of tests/test_parallel.py:45), with
  ``mppi.exploration_noise=0`` (the one draw the two packages cannot share).
* The sharded plain point and albert rollouts, with their shards' global
  offsets ``k0``, equal the unsharded ones and match the JAX XLA rollout
  within 1e-4 on costs and 1e-5 on trajectory points (the bars of
  tests/test_parallel.py:146-147 and :186-187).
* A sharded panda tick makes ``refine_iters + 1`` rollouts per shard, each
  at its shard's offset, and equals the unsharded tick.
* A sharded planner through the per-tick loop, serial chunks and
  pipelined chunks gives the unsharded loop's logs and states.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from m3p2i_aip_tpu.config.config_store import load_config as jax_load_config
from m3p2i_aip_tpu.parallel import make_mesh as jax_make_mesh
from m3p2i_aip_tpu.parallel import shard_planner as jax_shard_planner
from m3p2i_aip_tpu.tamp.reactive_tamp import ReactiveTAMP as JaxReactiveTAMP
from m3p2i_aip_tpu_torch.config.config_store import load_config
from m3p2i_aip_tpu_torch.parallel import SAMPLE_AXIS, make_mesh, sample_sharding, shard_planner
from m3p2i_aip_tpu_torch.tamp.reactive_tamp import ReactiveTAMP
from m3p2i_aip_tpu_torch.utils import convert
from m3p2i_aip_tpu_torch.utils.tree import tree_map

CPU = torch.device("cpu")
JAX_ATOL = 1e-4  # tests/test_parallel.py:45
COST_ATOL, TRAJ_ATOL = 1e-4, 1e-5  # tests/test_parallel.py:146-147, :186-187


def _leaves(x) -> dict:
    return {
        f.name: np.asarray(getattr(x, f.name))
        for f in dataclasses.fields(x)
        if f.metadata.get("pytree_node", True) and getattr(x, f.name) is not None
    }


def _point_overrides(K):
    return [
        "task=push_pull", "multi_modal=True", "goal=[-3.75,-3.75]", f"mppi.num_samples={K}",
        "mppi.horizon=12", "mppi.u_per_command=12", "mppi.exploration_noise=0",
    ]


def test_mesh_creation():
    mesh = make_mesh([CPU] * 8)
    assert mesh.size == 8 and mesh.axis_name == SAMPLE_AXIS
    assert all(d == CPU for d in mesh.devices)
    if torch.cuda.device_count() == 0:  # the default mesh is every visible card
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh()
    else:
        assert make_mesh().size == torch.cuda.device_count()


def test_sample_sharding_splits_and_gathers_in_order():
    x = torch.arange(5 * 6 * 2, dtype=torch.float32).reshape(5, 6, 2)
    shard = sample_sharding(make_mesh([CPU] * 3))
    parts = shard.split(x, dim=1)
    assert [tuple(p.shape) for p in parts] == [(5, 2, 2)] * 3
    assert torch.equal(parts[1], x[:, 2:4])
    assert torch.equal(shard.gather(parts, dim=1), x)


def test_shard_planner_rejects_indivisible_K():
    tamp = ReactiveTAMP(load_config("config_point", _point_overrides(30)), device="cpu")
    with pytest.raises(ValueError, match="not divisible"):
        shard_planner(tamp.motion_planner, make_mesh([CPU] * 8))
    with pytest.raises(ValueError, match="starts on"):
        shard_planner(tamp.motion_planner, make_mesh([torch.device("meta")] * 3))
    assert tamp.motion_planner.mesh is None


@pytest.mark.parametrize("K, n", [(32, 8), (30, 3)])
def test_sharded_command_matches_unsharded_and_jax(K, n):
    plain = ReactiveTAMP(load_config("config_point", _point_overrides(K)), device="cpu")
    sharded = ReactiveTAMP(load_config("config_point", _point_overrides(K)), device="cpu")
    assert shard_planner(sharded.motion_planner, make_mesh([CPU] * n)) is sharded.motion_planner
    jtamp = JaxReactiveTAMP(jax_load_config("config_point", _point_overrides(K)))
    jax_shard_planner(jtamp.motion_planner, jax_make_mesh(jax.devices()[:n]))
    for tamp in (plain, sharded):
        tamp.mppi_state = convert.mppi_state_from_numpy(_leaves(jtamp.mppi_state))
    jstate = jtamp.env.init_state()
    state = convert.point_env_state_from_numpy(_leaves(jstate))
    for tick in range(2):
        act = sharded.run_tamp_sequence(state)
        assert torch.equal(act, plain.run_tamp_sequence(state)), tick
        for f in dataclasses.fields(plain.mppi_state):
            assert torch.equal(getattr(sharded.mppi_state, f.name), getattr(plain.mppi_state, f.name)), f.name
        assert torch.equal(sharded.top_trajs, plain.top_trajs)
        np.testing.assert_allclose(act.numpy(), np.asarray(jtamp.run_tamp_sequence(jstate)), atol=JAX_ATOL, rtol=0)


def _rollout_both(tamp, sim_state_k, acts, task, n):
    mp = tamp.motion_planner
    unsharded = mp._rollout(sim_state_k, acts, task)
    mp.set_mesh(make_mesh([CPU] * n))
    try:
        sharded = mp._rollout(sim_state_k, acts, task)
    finally:
        mp.set_mesh(None)
    for x, y in zip(sharded, unsharded):
        assert torch.equal(x, y)
    return sharded


def test_sharded_point_rollout_matches_unsharded_and_xla():
    """K=32 over 8 shards of 4 samples: shard 4 starts the pull half."""
    K, T = 32, 12
    tamp = ReactiveTAMP(load_config("config_point", _point_overrides(K)), device="cpu")
    jtamp = JaxReactiveTAMP(jax_load_config("config_point", _point_overrides(K)))
    jstate = jtamp.env.init_state()
    rng = np.random.default_rng(0)
    acts = rng.uniform(-3, 3, size=(K, T, 2)).astype(np.float32)
    state = convert.point_env_state_from_numpy(_leaves(jstate))
    sk = tree_map(lambda x: x.expand((K,) + x.shape), state)
    ch, tps = _rollout_both(tamp, sk, torch.as_tensor(acts), tamp.tamp_interface(state), 8)

    jmp = jtamp.motion_planner
    jsk = jax.tree_util.tree_map(lambda x: jnp.broadcast_to(x, (K,) + x.shape), jstate)
    jtask = jtamp.tamp_interface(jstate)
    ch_ref, tps_ref = jax.jit(lambda s, a: jmp._rollout(s, a, jtask))(jsk, jnp.asarray(acts))
    np.testing.assert_allclose(ch.numpy(), np.asarray(ch_ref), atol=COST_ATOL, rtol=0)
    np.testing.assert_allclose(tps.numpy(), np.asarray(tps_ref), atol=TRAJ_ATOL, rtol=0)


def test_sharded_albert_rollout_matches_unsharded_and_xla():
    """K=16 x T=4 push_reach over 8 shards of 2 samples (the albert is single
    mode: ``k0`` rides along)."""
    overrides = ["task=push_reach", "goal=[3.0,0.0,0.6]", "mppi.num_samples=16", "mppi.horizon=4",
                 "mppi.refine_iters=0"]
    K, T = 16, 4
    tamp = ReactiveTAMP(load_config("config_albert", overrides), device="cpu")
    jtamp = JaxReactiveTAMP(jax_load_config("config_albert", overrides))
    jstate = jtamp.env.init_state()
    rng = np.random.default_rng(2)
    acts = rng.uniform(-1.5, 1.5, size=(K, T, 13)).astype(np.float32)
    state = convert.albert_state_from_numpy(_leaves(jstate))
    sk = tree_map(lambda x: x.expand((K,) + x.shape), state)
    ch, tps = _rollout_both(tamp, sk, torch.as_tensor(acts), tamp.tamp_interface(state), 8)

    jmp = jtamp.motion_planner
    jsk = jax.tree_util.tree_map(lambda x: jnp.broadcast_to(x, (K,) + x.shape), jstate)
    jtask = jtamp.tamp_interface(jstate)
    ch_ref, tps_ref = jax.jit(lambda s, a: jmp._rollout(s, a, jtask))(jsk, jnp.asarray(acts))
    np.testing.assert_allclose(ch.numpy(), np.asarray(ch_ref), atol=COST_ATOL, rtol=0)
    np.testing.assert_allclose(tps.numpy(), np.asarray(tps_ref), atol=TRAJ_ATOL, rtol=0)


def test_sharded_panda_tick_rolls_out_refine_iters_plus_one_per_shard():
    """The multi-modal panda (K=16 x T=4, the refine ladder) over 4 shards:
    one tick calls the rollout ``refine_iters + 1`` times per shard, shard i
    at ``k0 = 4 i``, and plans the unsharded tick's actions."""
    overrides = ["multi_modal=True", "mppi.num_samples=16", "mppi.horizon=4"]
    plain = ReactiveTAMP(load_config("config_panda", overrides), device="cpu")
    sharded = ReactiveTAMP(load_config("config_panda", overrides), device="cpu")
    mp = sharded.motion_planner
    assert mp.refine_iters > 0
    shard_planner(mp, make_mesh([CPU] * 4))
    inner, calls = mp.rollout, []

    def counted(sim_state_k, acts, task, k0=None):
        calls.append((k0, acts.shape[0]))
        return inner(sim_state_k, acts, task, k0)

    mp.rollout = counted
    state = plain.env.init_state()
    act = sharded.run_tamp_sequence(state)
    assert calls == [(k0, 4) for k0 in (0, 4, 8, 12)] * (mp.refine_iters + 1)
    torch.testing.assert_close(act, plain.run_tamp_sequence(state), atol=1e-5, rtol=0)


@pytest.mark.parametrize("mode", ["run", "serial", "pipelined"])
def test_sharded_planner_through_the_loops(mode):
    """A sharded planner through ``SimLoop.run`` (per tick),
    ``run_chunked`` and ``run_chunked(pipelined=True)`` (K=16 over 4 shards,
    six ticks of the main path's task, exploration noise on): logs and final
    states bit-equal to the unsharded loop's."""
    from m3p2i_aip_tpu_torch.tamp.sim_loop import SimLoop

    overrides = ["task=push_pull", "multi_modal=True", "goal=[-3.75,-3.75]", "mppi.num_samples=16", "mppi.horizon=8"]
    logs = []
    for n in (None, 4):
        loop = SimLoop(load_config("config_point", overrides), device="cpu")
        if n is not None:
            shard_planner(loop.tamp.motion_planner, make_mesh([CPU] * n))
        loop.warmup(10)
        log = loop.run(6) if mode == "run" else loop.run_chunked(6, chunk=3, pipelined=mode == "pipelined")
        logs.append((log, loop.state))
    (log, state), (ref, ref_state) = logs
    assert (log.steps, log.success_step, log.task) == (ref.steps, ref.success_step, ref.task)
    for name in ("robot_pos", "robot_vel", "box_pos"):
        assert np.array_equal(np.asarray(getattr(log, name)), np.asarray(getattr(ref, name))), name
    for f in dataclasses.fields(state):
        x, y = getattr(state, f.name), getattr(ref_state, f.name)
        assert x is None or torch.equal(x, y), f.name
