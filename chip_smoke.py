#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``m3p2i_aip_tpu_torch``).

Builds the port's CUDA kernels from ``m3p2i_aip_tpu_torch/csrc``, holds each
against its plain PyTorch version on the card, then drives the port's main
path -- the point-robot push_pull multi-modal M3P2I loop at K=200 x T=15 --
through ``SimLoop.run_chunked``, first with the success gates on (the box
must reach the corner goal) and then in benchmark mode (gates off).

Usage (one CUDA GPU, no arguments):

    python3 chip_smoke.py

Every check is an assert or a raise, so any failure exits non-zero.  There
is no CPU path: without a CUDA device the script exits 1 and prints no
result.  On success the last two lines of stdout are the kernel table and
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

MAIN_PATH = ["task=push_pull", "multi_modal=True", "goal=[-3.75,-3.75]"]
# start states of tests/test_pallas.py:212-232: (q, qd[, box position])
STARTS = [
    ([-0.3, 1.4], [0.5, 0.5]),
    ([-3.7, -3.7], [-2.0, -2.0]),
    ([-0.05, 1.75], [0.0, 2.0]),
    ([0.0, 1.55], [0.0, 7.0]),
    ([-3.3, -3.3], [-6.0, -6.0]),
    ([-2.6, -2.9], [-1.0, -1.0], [-3.3, -3.2]),
]
WEIGHTS_ATOL, SUM_TOL = 1e-6, 1e-5  # tests/test_pallas.py:131-132
COST_ATOL, TRAJ_ATOL = 1e-2, 1e-3  # tests/test_pallas.py:259-260
TIMED_CALLS = 50


def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, calls: int = TIMED_CALLS, warmup: int = 5) -> float:
    """Median device time of one call, by CUDA events around each call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(calls):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in pairs]))


def phase_weights(mp) -> dict:
    """K2 against its plain version at K=200, T=15."""
    from m3p2i_aip_tpu_torch.ops import weights

    rng = np.random.default_rng(0)
    cost = torch.as_tensor(rng.uniform(0, 50, size=(mp.K, mp.T)).astype(np.float32), device="cuda")
    args = (cost, mp.gamma_seq, mp.half_K, mp.eta_u, mp.eta_l)
    got = weights.multimodal_weights(*args)
    ref = weights.multimodal_weights_plain(*args)
    torch.cuda.synchronize()
    err = max(float(torch.max(torch.abs(g - r))) for g, r in zip(got, ref))
    sums = [float(torch.sum(g)) for g in got]
    print(f"[weights] max |kernel - plain| = {err:.3e}; sums = {sums}")
    assert err <= WEIGHTS_ATOL, f"weights kernel disagrees with its plain version: {err}"
    assert all(abs(s - 1.0) < SUM_TOL for s in sums), sums
    ms = _time_ms(lambda: weights.multimodal_weights(*args))
    plain_ms = _time_ms(lambda: weights.multimodal_weights_plain(*args))
    print(f"[weights] kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (median of {TIMED_CALLS})")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def phase_rollout(tamp) -> dict:
    """K1 against its plain version at full config_point physics, K=200,
    T=15, from the six start states (plus one case with per-sample friction
    and a nonzero global offset k0)."""
    from dataclasses import replace

    from m3p2i_aip_tpu_torch.ops import rollout as ro
    from m3p2i_aip_tpu_torch.utils.tree import tree_map

    mp, env = tamp.motion_planner, tamp.env
    spec = mp.rollout.spec
    rng = np.random.default_rng(0)
    cases = []
    for entry in STARTS:
        state = replace(
            env.init_state(),
            q=torch.tensor(entry[0], device="cuda"),
            qd=torch.tensor(entry[1], device="cuda"),
        )
        if len(entry) == 3:
            pos = state.dyn_pos.clone()
            pos[env.box_slot] = torch.tensor(entry[2], device="cuda")
            state = replace(state, dyn_pos=pos)
        cases.append((state, None))
    cases.append((cases[2][0], 50))  # friction draw + k0 != 0, from the box-contact start
    cost_err = traj_err = 0.0
    timed = None
    for n, (state, k0) in enumerate(cases):
        task = tamp.tamp_interface_view(env.view(state))
        sk = tree_map(lambda x: x.expand((mp.K,) + x.shape), state)
        if k0 is not None:
            fs = rng.uniform(0.7, 1.3, size=(mp.K, state.fric_scale.shape[0])).astype(np.float32)
            sk = replace(sk, fric_scale=torch.as_tensor(fs, device="cuda"))
        acts = torch.as_tensor(rng.uniform(-3, 3, size=(mp.K, mp.T, env.nu)).astype(np.float32), device="cuda")
        inputs = ro.rollout_inputs(sk, task, k0)
        c_k, t_k = ro.point_rollout(spec, *inputs, acts)
        c_p, t_p = ro.point_rollout_plain(spec, *inputs, acts)
        torch.cuda.synchronize()
        ce = float(torch.max(torch.abs(c_k - c_p)))
        te = float(torch.max(torch.abs(t_k - t_p)))
        print(f"[rollout] case {n} (q0={state.q.tolist()}, k0={k0}): cost err {ce:.3e}, traj err {te:.3e}")
        assert torch.isfinite(c_k).all() and torch.isfinite(t_k).all()
        assert ce <= COST_ATOL and te <= TRAJ_ATOL, f"rollout kernel disagrees with its plain version in case {n}"
        cost_err, traj_err = max(cost_err, ce), max(traj_err, te)
        if timed is None:
            timed = (inputs, acts)
    inputs, acts = timed
    ms = _time_ms(lambda: ro.point_rollout(spec, *inputs, acts))
    plain_ms = _time_ms(lambda: ro.point_rollout_plain(spec, *inputs, acts), calls=TIMED_CALLS, warmup=2)
    print(f"[rollout] max cost err {cost_err:.3e}, max traj err {traj_err:.3e}")
    print(f"[rollout] kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (median of {TIMED_CALLS})")
    return {"max_abs_err": cost_err, "ms": ms, "plain_ms": plain_ms}


def phase_main_path(cfg) -> tuple:
    """The main path with both gates on: the box must reach the goal, and
    both kernels must launch once per dispatched tick."""
    from m3p2i_aip_tpu_torch.ops import rollout as ro
    from m3p2i_aip_tpu_torch.ops import weights
    from m3p2i_aip_tpu_torch.tamp.sim_loop import SimLoop

    loop = SimLoop(cfg, device="cuda")
    loop.warmup(50)
    dispatched = 0
    run_chunk = loop.tamp.run_chunk

    def counted_run_chunk(ms, rs, task, i0, length):
        nonlocal dispatched
        dispatched += length
        return run_chunk(ms, rs, task, i0, length)

    loop.tamp.run_chunk = counted_run_chunk
    ro.rollout_launches = 0
    weights.weights_launches = 0
    t0 = time.perf_counter()
    log = loop.run_chunked(1000, chunk=50)
    wall = time.perf_counter() - t0
    launches = {"point_rollout": ro.rollout_launches, "multimodal_weights": weights.weights_launches}
    loop.tamp.run_chunk = run_chunk
    print(f"[main] {log.steps} ticks logged, {dispatched} dispatched in {wall:.2f} s; launches {launches}")
    assert dispatched > 0
    for name, n in launches.items():
        assert n == dispatched, f"{name}: {n} launches for {dispatched} dispatched ticks"
    robot, box = np.asarray(log.robot_pos), np.asarray(log.box_pos)
    assert np.isfinite(robot).all() and np.isfinite(box).all(), "non-finite positions"
    assert np.abs(box).max() <= 3.8, f"box tunnelled: max |coord| {np.abs(box).max()}"
    goal = np.asarray(cfg.goal, dtype=np.float32)
    final = float(np.linalg.norm(box[-1] - goal))
    print(f"[main] success tick {log.success_step}, final box-to-goal distance {final:.4f} m")
    assert log.success_step is not None and final <= 0.1, "the box did not reach the goal"
    return loop, launches


def phase_benchmark(loop, card: str) -> float:
    """Benchmark mode (bench.py:40-41): both gates off, 2 warm-up chunks of
    200, then 800 timed ticks in chunks of 200."""
    loop.tamp.task_planner.check_task_success = lambda view: False
    loop.tamp.device_gate = False
    chunk = 200
    for _ in range(2):
        loop.run_chunked(chunk, chunk=chunk)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(4):
        loop.run_chunked(chunk, chunk=chunk)
    hz = 4 * chunk / (time.perf_counter() - t0)
    print(f"[bench] {hz:.2f} Hz replan+step, K=200 x T=15 ({card})")
    return hz


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py: no CUDA device; this script runs only on a GPU")
    from m3p2i_aip_tpu_torch.config.config_store import load_config
    from m3p2i_aip_tpu_torch.ops import cuda_build
    from m3p2i_aip_tpu_torch.tamp.reactive_tamp import ReactiveTAMP

    # 1. device
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    card = _nvidia_smi()
    print(f"[device] {kind}; nvidia-smi: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    # 2. build
    t0 = time.perf_counter()
    cuda_build.load_kernels()
    print(f"[build] {time.perf_counter() - t0:.1f} s ({cuda_build.build_info['path']})")
    print(cuda_build.build_info["log"].strip())

    cfg = load_config("config_point", MAIN_PATH)
    tamp = ReactiveTAMP(cfg, device="cuda")
    # 3. / 4. each kernel against its plain version
    stats = {"multimodal_weights": phase_weights(tamp.motion_planner), "point_rollout": phase_rollout(tamp)}
    del tamp
    # 5. / 6. the main path
    loop, launches = phase_main_path(load_config("config_point", MAIN_PATH))
    hz = phase_benchmark(loop, card)

    sources = {
        "point_rollout": ("m3p2i_aip_tpu_torch/csrc/point_rollout.cu", "m3p2i_aip_tpu/ops/pallas_rollout.py:189"),
        "multimodal_weights": (
            "m3p2i_aip_tpu_torch/csrc/multimodal_weights.cu",
            "m3p2i_aip_tpu/ops/pallas_kernels.py:60",
        ),
    }
    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep, "launches": launches[name], **stats[name]}
        for name, (src, rep) in sources.items()
    ]
    print(f"[bench] {hz:.2f} Hz on {card}")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
