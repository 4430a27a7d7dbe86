"""The port's experiment runner (``m3p2i_aip_tpu_torch/scripts/
run_experiments.py``) on the CPU at tiny K and T: ``parallel_seeds=True``
runs the seeds as one ``BatchSimLoop`` batch and writes one .npy row per
run in the reference's schema; ``parallel_seeds=shard`` runs them through
the sharded batch over the default mesh (here one CPU device) and writes
the same rows; a batch with domain noise is refused."""
import numpy as np
import pytest

from m3p2i_aip_tpu_torch.scripts import run_experiments

TINY = ["mppi.num_samples=8", "mppi.horizon=4", "n_steps=4", "n_runs=2", "chunked=2", "device=cpu"]


@pytest.mark.parametrize(
    "family, argv, cols",
    [
        ("point", ["task=push_pull", "multi_modal=True", "goal=[-3.75,-3.75]"], 19),
        ("albert", ["-cn", "config_albert"], 11),
    ],
)
def test_parallel_seeds_writes_rows(tmp_path, capsys, family, argv, cols):
    out = tmp_path / f"{family}.npy"
    run_experiments.main([*argv, *TINY, "parallel_seeds=True", f"out={out}"])
    rows = np.load(out)
    assert rows.shape == (2, cols)
    assert np.isfinite(rows).all()
    printed = capsys.readouterr().out
    assert "run 1: success=" in printed and "success rate:" in printed


@pytest.mark.parametrize("config_name", ["config_heijn", "config_boxer"])
def test_family_rows_serial_equal_parallel_seeds(tmp_path, config_name):
    """The heijn and boxer rows through ``finalize_point_row``: the serial
    runner's and the ``parallel_seeds=True`` runner's agree bit for bit in
    every column that is not a wall-clock time or rate."""
    argv = ["-cn", config_name, "task=push_pull", "multi_modal=True", "goal=[-3.75,-3.75]", *TINY]
    serial, batch = tmp_path / "serial.npy", tmp_path / "batch.npy"
    run_experiments.main([*argv, f"out={serial}"])
    run_experiments.main([*argv, "parallel_seeds=True", f"out={batch}"])
    s, b = np.load(serial), np.load(batch)
    assert s.shape == b.shape == (2, 19)
    assert np.isfinite(s).all() and np.isfinite(b).all()
    sim = [*range(1, 14), 17, 18]  # positions, velocities, box pose, goal, collisions, task time
    np.testing.assert_array_equal(s[:, sim], b[:, sim])
    assert not np.array_equal(s[0, 1:3], s[1, 1:3])  # two seeds, two runs


def test_parallel_seeds_shard_equals_parallel_seeds_true(tmp_path):
    """The sharded runner's rows equal the batched runner's in every column
    that is not a wall-clock time or rate."""
    argv = ["task=push_pull", "multi_modal=True", "goal=[-3.75,-3.75]", *TINY]
    batch, shard = tmp_path / "batch.npy", tmp_path / "shard.npy"
    run_experiments.main([*argv, "parallel_seeds=True", f"out={batch}"])
    run_experiments.main([*argv, "parallel_seeds=shard", f"out={shard}"])
    b, s = np.load(batch), np.load(shard)
    assert b.shape == s.shape == (2, 19)
    sim = [*range(1, 14), 17, 18]  # positions, velocities, box pose, goal, collisions, task time
    np.testing.assert_array_equal(s[:, sim], b[:, sim])


def test_parallel_seeds_refuses_domain_noise(tmp_path):
    with pytest.raises(SystemExit, match="parallel_seeds"):
        run_experiments.main([*TINY, "fric_noise=0.4", "parallel_seeds=True", f"out={tmp_path / 'x.npy'}"])
