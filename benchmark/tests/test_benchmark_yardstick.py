"""The frozen arithmetic: rates, percentiles and spreads on synthetic
clocks, the chunk clock on the host, the roofline counts by hand."""
from __future__ import annotations

import statistics
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark import check, layers
from benchmark.trace import breakdown, summarize
from benchmark.yardstick import rates, roofline


def test_rate_is_all_the_work_over_all_the_time():
    assert rates.rate(1000, 4.0) == 250.0
    with pytest.raises(ValueError):
        rates.rate(1, 0.0)


@pytest.mark.parametrize("q", [0, 25, 50, 95, 100])
def test_percentile_matches_numpy(q):
    xs = np.random.default_rng(3).exponential(size=101)
    assert rates.percentile(xs, q) == pytest.approx(np.percentile(xs, q), rel=1e-12)
    assert rates.percentile([], q) is None


def test_spread_is_the_quartile_distance_over_the_median():
    xs = [10.0, 11.0, 12.0, 13.0, 14.0, 15.0]
    q1, med, q3 = statistics.quantiles(xs, n=4)
    assert rates.spread(xs) == pytest.approx((q3 - q1) / med)


def test_host_chunk_clock_periods():
    clock = rates.ChunkClock(torch.device("cpu"))
    for _ in range(4):
        clock.mark()
    periods = clock.periods_s()
    assert len(periods) == 3 and all(p >= 0 for p in periods)


def test_trace_summary_on_a_synthetic_timeline():
    dev = [("k_a", 0, 10), ("k_b", 5, 20), ("spin_kernel", 25, 26), ("k_a", 30, 40), ("point_rollout_kernel", 50, 60)]
    host = [("cudaGraphLaunch", 18, 45), ("aten::copy_", 39, 44)]
    s = summarize(dev, host, n_ticks=2, wall=1e-4)
    assert s["busy_s"] == pytest.approx(40e-6)  # [0, 20] + [30, 40] + [50, 60]; the pad left out
    assert s["kernels"]["k_a"] == {"total_s": 20e-6, "launches": 2, "median_s": 10e-6}
    assert sorted(s["idle_gaps"]) == [["aten::copy_", 10e-6], ["cudaGraphLaunch", 10e-6]]  # the innermost op
    b = breakdown(s)
    assert b["device_ops"][0] == ["k_a", 20e-6] and len(b["idle_gaps"]) == 2
    ctx = {"trace": s, "ticks": 4, "window_s": 4 * 25e-6, "bounds": {"rollout": [1e-6, 3e-6, 2e-6]},
           "replay_s": 80e-6}
    assert layers.plain_ops_device_ms(ctx) == pytest.approx(1e3 * 35e-6 / 2)
    assert layers.device_idle_pct(ctx) == pytest.approx(100 * (1 - 80e-6 / 100e-6))
    assert layers.device_idle_pct(dict(ctx, replay_s=None)) is None
    assert layers.roofline_pct(ctx, "point_rollout_kernel", "rollout") == pytest.approx(100 * 2e-6 / 1e-2)
    assert layers.roofline_pct(ctx, "panda_rollout_kernel", "rollout") is None
    assert summarize([("spin_kernel", 0, 1)], host, 1, 1.0) is None
    copies = summarize([("k_a", 0, 10), ("Memcpy HtoD (Pinned -> Device)", 10, 14), ("Memset (Device)", 20, 21)],
                       [], 1, 1.0)
    assert layers.plain_ops_device_ms({"trace": copies}) == pytest.approx(1e3 * 10e-6)  # kernels only


def test_the_sample_takes_every_checked_tick_and_distinct_seeds_of_a_batch():
    cks = [{"i": i, "episode": e, "seed": b} for e in range(5) for i in (0, 50, 100, 150) for b in range(20)
           if not (e == 4 and i == 150)]  # the window's last episode ended early
    got = check.sample(cks, 2, 7)
    assert [c["i"] for c in got] == [0, 0, 50, 50, 100, 100, 150, 150]
    assert len({c["seed"] for c in got}) == 8 and check.sample(cks, 2, 7) == got
    assert len({c["seed"] for c in check.sample(cks, 6, 8)}) == 20  # every slot, then any
    one = [{"i": i, "episode": e} for e in range(3) for i in (0, 50)]
    got = check.sample(one, 1, 7)
    assert [c["i"] for c in got] == [0, 50] and check.sample(one, 5, 7) == one[0::2] + one[1::2]


def test_point_rollout_ops_by_hand():
    spec = SimpleNamespace(D=2, S=1, T=3, env_params=SimpleNamespace(pos_iters=1, substeps=1))
    per_iter = 2 * 2 * 57 + 2 * 1 * 122 + 2 * 1 * 130 + 1 * 55  # 228 + 244 + 260 + 55 = 787
    assert per_iter == 787
    per_sub = 40 + 80 + 787 + 4  # 911
    assert roofline.point_rollout_ops(spec, 5, live=7) == 5 * 3 * (911 + 150 + 55) + 90 * 7


def test_panda_rollout_ops_by_hand():
    spec = SimpleNamespace(S=1, T=2, env_params=SimpleNamespace(substeps=1))
    bodies = 3 * (28 + 16 + 57)  # 303
    per_sub = 108 + 330 + 10 + 35 + 303 + 60 + 945 + 55  # 1846
    assert roofline.panda_rollout_ops(spec, 4) == 4 * 2 * (per_sub + 200)


def test_weights_ops_and_bound_by_hand():
    cost = torch.zeros(6, 2)
    rounds = np.array([[1, 2, 0]])
    # n=1: 2KT + 3K + 8K = 24 + 18 + 48, then 4 x ((2 x 3) + (3 x 3) + (1 x 6))
    assert roofline.weights_ops(cost, 3, rounds) == 90 + 4 * 21
    gamma = torch.ones(2)
    n_bytes = 6 * 2 * 4 + 2 * 4 + 3 * 6 * 4
    assert roofline.weights_bound_ms(cost, gamma, 3, rounds) == pytest.approx(
        max(n_bytes / 3.35e12, 174 / 67e12) * 1e3)


def test_bound_takes_the_longer_of_bytes_and_operations():
    assert roofline.bound_ms(3.35e12, 0) == pytest.approx(1e3)
    assert roofline.bound_ms(0, 67e12) == pytest.approx(1e3)
    assert roofline.bound_ms(3.35e9, 67e12) == pytest.approx(1e3)


def test_point_step_ops_and_bound_by_hand():
    p = SimpleNamespace(pos_iters=1, substeps=2, num_actors=4, dyn_half=torch.zeros(2, 2), stat_pos=torch.zeros(1, 2))
    assert roofline.point_step_ops(p, 2, 1) == 2 * (40 + 80 + 787 + 4)  # per_iter 787 as in K1's count
    spec = SimpleNamespace(D=2, S=1, T=3, env_params=p)
    assert roofline.point_rollout_ops(spec, 5, live=7) == 5 * 3 * (2 * 911 + 150 + 55) + 90 * 7
    z = torch.zeros
    state = SimpleNamespace(q=z(2), qd=z(2), dyn_pos=z(2, 2), dyn_yaw=z(2), dyn_vel=z(2, 2), dyn_om=z(2),
                            fric_scale=z(2), contact_force=z(4, 3))
    ext = SimpleNamespace(robot=z(2), dyn=z(2, 2))
    consts = 4 * (11 + 6 * 2 + 7 * 1 + 4)
    read = 4 * (2 + 2 + 4 + 2 + 4 + 2 + 2 + 2 + 2 + 4)
    written = 4 * (2 + 2 + 4 + 2 + 4 + 2 + 12)
    ops = 2 * 911 + 90 * 3
    assert roofline.point_step_bound_ms(p, state, z(2), ext, state, live=3) == pytest.approx(
        max((consts + read + written) / 3.35e12, ops / 67e12) * 1e3)


def test_the_step_kernel_is_a_hand_written_kernel_with_its_roofline():
    dev = [("k_a", 0, 10), ("point_env_step_kernel_float", 10, 14), ("point_env_step_kernel_float", 20, 24)]
    s = summarize(dev, [], n_ticks=2, wall=1e-4)
    assert layers.plain_ops_device_ms({"trace": s}) == pytest.approx(1e3 * 10e-6 / 2)  # K5 left out
    ctx = {"trace": s, "bounds": {"step": [1e-6, 2e-6, 4e-6], "rollout": [1.0]}}
    assert layers.roofline_pct(ctx, "point_env_step_kernel", "step") == pytest.approx(100 * 2e-6 / 4e-3)
    assert layers.roofline_pct({"trace": s, "bounds": {}}, "point_env_step_kernel", "step") is None
