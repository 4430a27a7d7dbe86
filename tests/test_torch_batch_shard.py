"""The port's seed batch split over a device mesh (``BatchSimLoop(shard=)``)
on the CPU, the counterpart of tests/test_batch_loop.py:154-245.

A mesh of repeated ``cpu`` devices stands in for the JAX tests' virtual
mesh.  Each shard holds its seeds' planner state, generators and done mask,
and launches the batched rollout and weights once per chunk tick on them,
so a sharded batch's logs and views equal the unsharded batch's: bit for
bit on the point (push_pull multi-modal, four seeds over four shards of one
and over two shards of two), and within 1e-5 on the panda (multi-modal
pick-place, then the settle), whose FK's matmuls sum in another order at
another batch shape (tests/test_torch_batch_loop.py).  ``reset`` re-checks
that the mesh divides the batch.
"""
import numpy as np
import pytest
import torch

from m3p2i_aip_tpu_torch.config.config_store import load_config
from m3p2i_aip_tpu_torch.parallel import make_mesh
from m3p2i_aip_tpu_torch.tamp.batch_loop import BatchSimLoop

CPU = torch.device("cpu")
SEEDS, STEPS, CHUNK, WARMUP = [0, 1, 2, 3], 12, 4, 10
POINT = ("config_point", ["task=push_pull", "multi_modal=True", "goal=[-3.75,-3.75]", "mppi.num_samples=16",
                          "mppi.horizon=8"])
PANDA = ("config_panda", ["multi_modal=True", "mppi.num_samples=16", "mppi.horizon=4"])
PANDA_ATOL = 1e-5  # tests/test_torch_batch_loop.py ATOL


def _run(config, shard):
    config_name, overrides = config
    batch = BatchSimLoop(load_config(config_name, overrides), SEEDS, shard=shard, device="cpu")
    batch.warmup(WARMUP)
    logs = batch.run_chunked(STEPS, chunk=CHUNK)
    if batch.is_panda:
        batch.settle(20)
    return batch, logs


@pytest.mark.parametrize(
    "config, n_shards, atol",
    [(POINT, 4, 0.0), (POINT, 2, 0.0), (PANDA, 4, PANDA_ATOL)],
    ids=["point-4x1", "point-2x2", "panda-4x1"],
)
def test_sharded_batch_equals_unsharded(config, n_shards, atol):
    plain, plain_logs = _run(config, False)
    sharded, logs = _run(config, make_mesh([CPU] * n_shards))
    assert len(sharded._shards) == n_shards
    for b, (log, ref) in enumerate(zip(logs, plain_logs)):
        assert (log.steps, log.success_step, log.task, log.collisions) == (
            ref.steps, ref.success_step, ref.task, ref.collisions
        ), b
        for name in ("robot_pos", "robot_vel", "box_pos"):
            assert np.array_equal(np.asarray(getattr(log, name)), np.asarray(getattr(ref, name))), (b, name)
        for key, value in plain.views[b].items():
            np.testing.assert_allclose(np.asarray(sharded.views[b][key]), np.asarray(value), atol=atol, rtol=0,
                                       err_msg=f"seed {b} {key}")
    # each shard planned its own seeds (per-seed deltas and noise)
    key = "ee_state" if plain.is_panda else "robot_pos"
    assert not np.allclose(np.asarray(sharded.views[0][key]), np.asarray(sharded.views[3][key]))


def test_reset_revalidates_shard_divisibility():
    config_name, overrides = POINT
    with pytest.raises(ValueError, match="must divide"):
        BatchSimLoop(load_config(config_name, overrides), [0, 1, 2], shard=make_mesh([CPU] * 2), device="cpu")
    batch = BatchSimLoop(load_config(config_name, overrides), SEEDS, shard=make_mesh([CPU] * 4), device="cpu")
    with pytest.raises(ValueError, match="must divide"):
        batch.reset(SEEDS + [4])
    batch.reset([5, 6, 7, 8])
    assert [sh.seeds for sh in batch._shards] == [slice(i, i + 1) for i in range(4)]
    with pytest.raises(AttributeError, match="per shard"):
        batch.state  # noqa: B018 (a sharded batch has no single state)


def test_shard_true_takes_the_default_mesh():
    """``shard=True`` on the CPU: a one-device mesh of the batch's device,
    through the sharded code."""
    config_name, overrides = POINT
    batch = BatchSimLoop(load_config(config_name, overrides), SEEDS, shard=True, device="cpu")
    assert batch.mesh.devices == (CPU,) and len(batch._shards) == 1
