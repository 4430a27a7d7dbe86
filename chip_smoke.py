#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``m3p2i_aip_tpu_torch``).

Builds the port's CUDA kernels from ``m3p2i_aip_tpu_torch/csrc``, holds each
against its plain PyTorch version on the card, then drives the port's three
paths through ``SimLoop.run_chunked``:

* the point-robot push_pull multi-modal M3P2I loop at K=200 x T=15, first
  with the success gates on (the box must reach the corner goal) and then in
  benchmark mode (gates off);
* the panda active-inference pick-place loop (``-cn config_panda``) at
  K=200 x T=12 with the refine ladder: the table pick-place must grasp the
  cube and latch success, a short multi-modal shelf run must stay finite,
  and the replan+step rate is measured with ``scripts/bench_panda.py``'s
  protocol;
* the albert mobile manipulator (``-cn config_albert``) at K=128 x T=12
  with the softmax-only refine ladder: the ee_reach must latch success
  within 150 ticks with the base driven, the push_reach must push the box to
  its goal within 500 ticks, the replan+step rate is measured with
  ``scripts/bench_albert.py``'s protocol, and one tick is broken down into
  its pieces (host clock) and its device kernels (``torch.profiler``).

Each kernel's entry in the kernel table carries its bound: the least time
the card could take for the same work, the larger of the bytes it must move
over 3.35 TB/s and the f32 operations it does over 67 TFLOP/s (the H100 SXM
data-sheet peaks), the operations reckoned from the kernel's code at this
run's shapes.

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
COST_ATOL, TRAJ_ATOL = 1e-2, 1e-3  # tests/test_pallas.py:259-260 (and :379-384 for the panda)
TIMED_CALLS = 50
PANDA_TICKS = 900  # the table pick-place must latch success within this many ticks
ALBERT_ATOL = 1e-4  # K4 vs its plain version, cost and trajectory (tests/test_pallas.py:818-821)
EE_REACH_TICKS, PUSH_REACH_TICKS = 150, 500  # tests/test_albert.py:37, :193
PUSH_REACH = ["task=push_reach", "goal=[3.0,0.0,0.6]"]

# H100 SXM data-sheet peaks: device memory rate and f32 rate outside the tensor cores
PEAK_BYTES_S, PEAK_F32_S = 3.35e12, 67e12
# f32 operations reckoned from the kernels' code, counting each add, multiply,
# compare or select, division, square root, sine, cosine and exponential as
# one (so the bound is a lower bound: a transcendental costs the card more)
CIRCLE_CONTACT_OPS = 55 + 90  # circle_vs_obb + resolve (csrc/pbd2d.cuh)
CORNER_CONTACT_OPS = 120 + 4 * 90  # corners_vs_obb + four resolves (point_rollout.cu)
PANDA_FK_OPS = 330  # seven joints with a sin/cos each, the hand, the fingers (panda_fk.cuh)


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


def _bytes(*tensors) -> int:
    return sum(x.numel() * x.element_size() for x in tensors)


def _bound(n_bytes: int, n_ops: float) -> dict:
    """The least time the card could take: bytes moved once over the memory
    rate, or f32 operations over the f32 rate, whichever is longer."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES_S, n_ops / PEAK_F32_S
    return {"bound_ms": max(t_bytes, t_ops) * 1e3, "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def _point_rollout_ops(spec, K: int) -> float:
    """K1: per position iteration the five Jacobi passes (robot vs boxes,
    box pairs, boxes vs statics, robot vs statics, robot vs held boxes);
    per substep the drive, ground friction and integration; per step the
    costs with the wall-crush probe."""
    D, S, p = spec.D, spec.S, spec.env_params
    per_iter = (
        2 * D * (2 + CIRCLE_CONTACT_OPS) + D * (D - 1) * (2 + CORNER_CONTACT_OPS)
        + D * S * (CORNER_CONTACT_OPS + 10) + S * CIRCLE_CONTACT_OPS
    )
    per_sub = 40 + 40 * D + p.pos_iters * per_iter + 4
    return K * spec.T * (p.substeps * per_sub + 150 + 55 * S)


def _weights_ops(cost, mp) -> float:
    """K2: the cost-to-go, the group minima, and the three beta searches for
    as many rounds as this cost needs (replayed here: the kernel stops when
    all three groups are inside [eta_l, eta_u]), then the three softmaxes."""
    K, T = cost.shape
    tc = torch.sum(cost * mp.gamma_seq, dim=-1)
    k = torch.arange(K, device=cost.device)
    mask = torch.stack([k < mp.half_K, k >= mp.half_K, torch.ones_like(k, dtype=torch.bool)])
    c3 = torch.where(mask, tc, torch.inf)
    c3 = c3 - torch.amin(c3, dim=1, keepdim=True)
    beta = torch.ones(3, 1, device=cost.device)
    rounds = 0
    for rounds in range(1, 65):
        eta = torch.sum(torch.exp(-c3 / beta), dim=1, keepdim=True)
        high, low = eta > mp.eta_u, eta < mp.eta_l
        if not bool(torch.any(high | low)):
            break
        beta = torch.where(high, beta * 0.9, torch.where(low, beta * 1.2, beta))
    return 2 * K * T + 6 * K + rounds * 3 * K * 4 + 3 * K * 4


def _panda_rollout_ops(spec, K: int) -> float:
    """K3: per substep the 9-joint drive, the FK, the grasp test, the cube's
    quaternion, three bodies against the supports and statics, the held cube,
    and the seven arm probes against the table, shelf and cubeB; per step the
    costs."""
    S = spec.S
    bodies = 3 * (28 + 8 * (S + 1) + 57 * S)
    per_sub = 108 + PANDA_FK_OPS + 10 + 35 + bodies + 60 + 7 * 3 * 45 + 55
    return K * spec.T * (spec.env_params.substeps * per_sub + 200)


def _albert_rollout_ops(spec, K: int) -> float:
    """K4: per substep the base and arm drive with the clip, and with a box
    its ground friction, integration and two base-vs-box contact passes; per
    step the base-composed FK and the costs."""
    per_sub = 87 + (26 + 2 * (2 + CIRCLE_CONTACT_OPS) if spec.env_params.has_box else 0)
    return K * spec.T * (spec.env_params.substeps * per_sub + 2 + PANDA_FK_OPS + 60)


def _weights_check(mp, cost, label: str) -> float:
    """K2 against its plain version on one [K, T] cost with planner ``mp``'s
    discount, halves and eta bounds; returns the max error."""
    from m3p2i_aip_tpu_torch.ops import weights

    args = (cost, mp.gamma_seq, mp.half_K, mp.eta_u, mp.eta_l)
    got = weights.multimodal_weights(*args)
    ref = weights.multimodal_weights_plain(*args)
    torch.cuda.synchronize()
    err = max(float(torch.max(torch.abs(g - r))) for g, r in zip(got, ref))
    sums = [float(torch.sum(g)) for g in got]
    tc = torch.sum(cost * mp.gamma_seq, dim=-1)
    print(f"[{label}] cost-to-go in [{float(tc.min()):.1f}, {float(tc.max()):.1f}]; "
          f"max |kernel - plain| = {err:.3e}; sums = {sums}")
    assert err <= WEIGHTS_ATOL, f"{label}: weights kernel disagrees with its plain version: {err}"
    assert all(abs(x - 1.0) < SUM_TOL for x in sums), sums
    return err


def phase_weights(mp) -> dict:
    """K2 against its plain version at K=200, T=15."""
    from m3p2i_aip_tpu_torch.ops import weights

    rng = np.random.default_rng(0)
    cost = torch.as_tensor(rng.uniform(0, 50, size=(mp.K, mp.T)).astype(np.float32), device="cuda")
    err = _weights_check(mp, cost, "weights")
    args = (cost, mp.gamma_seq, mp.half_K, mp.eta_u, mp.eta_l)
    ms = _time_ms(lambda: weights.multimodal_weights(*args))
    plain_ms = _time_ms(lambda: weights.multimodal_weights_plain(*args))
    bound = _bound(_bytes(cost, mp.gamma_seq) + 3 * cost.shape[0] * 4, _weights_ops(cost, mp))
    print(f"[weights] kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (median of {TIMED_CALLS}); bound {bound}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **bound, "library_ms": None}


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
    K, T = acts.shape[:2]
    bound = _bound(_bytes(spec.params_buf, *inputs, acts) + K * T * 3 * 4, _point_rollout_ops(spec, K))
    print(f"[rollout] max cost err {cost_err:.3e}, max traj err {traj_err:.3e}")
    print(f"[rollout] kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (median of {TIMED_CALLS}); bound {bound}")
    return {"max_abs_err": cost_err, "ms": ms, "plain_ms": plain_ms, **bound, "library_ms": None}


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


def phase_panda_rollout() -> tuple:
    """K3 against its plain version at K=200, T=12 (config_panda physics),
    from the seven parity starts, for multi_modal False and True; in the
    multi-modal scene also K2 against its plain version on each case's K3
    cost horizon, with the panda planner's discount, halves and eta bounds
    (the shape and cost scale the shelf and benchmark paths give K2)."""
    from m3p2i_aip_tpu_torch.config.config_store import load_config
    from m3p2i_aip_tpu_torch.ops import panda_rollout as pr
    from m3p2i_aip_tpu_torch.ops import weights
    from m3p2i_aip_tpu_torch.planners.motion_planner.mppi import make_task_params
    from m3p2i_aip_tpu_torch.tamp.reactive_tamp import ReactiveTAMP
    from m3p2i_aip_tpu_torch.utils.tree import tree_map

    rng = np.random.default_rng(1)
    cost_err = traj_err = w_err = 0.0
    timed = w_timed = None
    for mm in (False, True):
        tamp = ReactiveTAMP(load_config("config_panda", [f"multi_modal={mm}"]), device="cuda")
        mp, base = tamp.motion_planner, tamp.env.init_state()
        spec, K, T = mp.rollout.spec, mp.K, mp.T
        for name, start, task_name, grip, zup in pr.PARITY_CASES:
            goal = pr.PARITY_GOAL if task_name == "pick" else [0.0] * 7
            task = make_task_params(task_name, goal, "none", zup, device="cuda")
            acts = rng.uniform(-1.5, 1.5, size=(K, T, 9)).astype(np.float32)
            if grip is not None:
                acts[..., 7:9] = grip
            acts = torch.as_tensor(acts, device="cuda")
            state_k = tree_map(lambda x: x.expand((K,) + x.shape), pr.parity_state(base, start))
            inputs = pr.rollout_inputs(state_k, task)
            c_k, t_k = pr.panda_rollout(spec, *inputs, acts)
            c_p, t_p = pr.panda_rollout_plain(spec, *inputs, acts)
            torch.cuda.synchronize()
            ce = float(torch.max(torch.abs(c_k - c_p)))
            te = float(torch.max(torch.abs(t_k - t_p)))
            print(f"[panda-rollout] multi_modal={mm} {name}: cost err {ce:.3e}, traj err {te:.3e}")
            assert torch.isfinite(c_k).all() and torch.isfinite(t_k).all()
            assert ce <= COST_ATOL and te <= TRAJ_ATOL, f"panda kernel disagrees with its plain version ({name})"
            cost_err, traj_err = max(cost_err, ce), max(traj_err, te)
            if timed is None:
                timed = (spec, inputs, acts)
            if mm:
                w_err = max(w_err, _weights_check(mp, c_k, f"panda-weights {name}"))
                if w_timed is None:
                    w_timed = (c_k, mp.gamma_seq, mp.half_K, mp.eta_u, mp.eta_l)
    spec, inputs, acts = timed
    ms = _time_ms(lambda: pr.panda_rollout(spec, *inputs, acts))
    plain_ms = _time_ms(lambda: pr.panda_rollout_plain(spec, *inputs, acts), calls=10, warmup=2)
    w_ms = _time_ms(lambda: weights.multimodal_weights(*w_timed))
    K, T = acts.shape[:2]
    bound = _bound(_bytes(spec.params_buf, *inputs, acts) + K * T * 3 * 4, _panda_rollout_ops(spec, K))
    print(f"[panda-rollout] max cost err {cost_err:.3e}, max traj err {traj_err:.3e}")
    print(f"[panda-rollout] kernel {ms:.4f} ms (median of {TIMED_CALLS}), plain {plain_ms:.4f} ms (median of 10); "
          f"bound {bound}")
    print(f"[panda-weights] max err {w_err:.3e}; kernel {w_ms:.4f} ms at K=200 x T=12 (median of {TIMED_CALLS})")
    return {"max_abs_err": cost_err, "ms": ms, "plain_ms": plain_ms, **bound, "library_ms": None}, w_err


def _count_panda_ticks(loop) -> list:
    """Wrap the loop's panda chunk entry to count dispatched ticks and keep
    each chunk's views (read after the run, not inside it)."""
    record = []
    run_chunk = loop.tamp.run_chunk_panda

    def counted(ms, rs, stage, zs, length):
        out = run_chunk(ms, rs, stage, zs, length)
        record.append((length, out[5]))
        return out

    loop.tamp.run_chunk_panda = counted
    return record


def phase_panda_main() -> int:
    """The panda main path: ``config_panda`` (reactive_pick, cube on the
    table, single mode) through ``SimLoop.run_chunked`` in chunks of 50.  The
    cube must be grasped, success must latch within PANDA_TICKS, and K3 must
    launch 1 + refine_iters times per dispatched tick."""
    from m3p2i_aip_tpu_torch.config.config_store import load_config
    from m3p2i_aip_tpu_torch.ops import panda_rollout as pr
    from m3p2i_aip_tpu_torch.ops import weights
    from m3p2i_aip_tpu_torch.ops.quat_np import general_ori_cube2goal
    from m3p2i_aip_tpu_torch.tamp.sim_loop import SimLoop

    cfg = load_config("config_panda")
    loop = SimLoop(cfg, device="cuda")
    loop.warmup(50)
    record = _count_panda_ticks(loop)
    per_tick = 1 + int(cfg.mppi.refine_iters)
    pr.panda_rollout_launches = 0
    weights.weights_launches = 0
    t0 = time.perf_counter()
    log = loop.run_chunked(PANDA_TICKS, chunk=50)
    wall = time.perf_counter() - t0
    launches = pr.panda_rollout_launches
    dispatched = sum(n for n, _ in record)
    views = torch.cat([v for _, v in record]).cpu().numpy()
    print(
        f"[panda-main] {log.steps} ticks logged, {dispatched} dispatched in {wall:.2f} s; "
        f"panda_rollout launches {launches}, multimodal_weights launches {weights.weights_launches}"
    )
    assert launches == per_tick * dispatched, f"panda_rollout: {launches} launches for {dispatched} ticks"
    assert weights.weights_launches == 0, "the single-mode panda path launched the weights kernel"
    assert np.isfinite(views).all(), "non-finite panda views"
    grasped = np.nonzero(views[:, 21] > 0.5)[0]
    print(f"[panda-main] first grasped tick {grasped[0] if grasped.size else None}; stages {sorted(set(log.task))}")
    assert grasped.size > 0, "the cube was never grasped"
    assert log.success_step is not None, "the panda pick-place did not latch success"
    loop.settle(150)
    view = loop._view
    pos_err = float(np.linalg.norm(view["cube_state"][:2] - view["cube_goal"][:2]))
    ori_err = float(general_ori_cube2goal(view["cube_state"][3:], view["cube_goal"][3:]))
    print(f"[panda-main] success tick {log.success_step}; settled cube error: pos {pos_err:.4f} m, ori {ori_err:.4f}")
    return launches


def phase_panda_shelf() -> float:
    """100 ticks of the multi-modal shelf pick (``multi_modal=True
    cube_on_shelf=True``): finite, K3 launched 1 + refine_iters and K2
    launched refine_iters times per dispatched tick (the greedy last rung
    computes no weights).  The run's own K3 cost horizons are kept, and
    after the counts are read K2 is held against its plain version on every
    tenth of them.  Returns that K2 error."""
    from m3p2i_aip_tpu_torch.config.config_store import load_config
    from m3p2i_aip_tpu_torch.ops import panda_rollout as pr
    from m3p2i_aip_tpu_torch.ops import weights
    from m3p2i_aip_tpu_torch.tamp.sim_loop import SimLoop

    cfg = load_config("config_panda", ["multi_modal=True", "cube_on_shelf=True"])
    loop = SimLoop(cfg, device="cuda")
    loop.warmup(50)
    record = _count_panda_ticks(loop)
    mp = loop.tamp.motion_planner
    rollout, costs = mp.rollout, []

    def recording(*args):
        out = rollout(*args)
        costs.append(out[0])
        return out

    mp.rollout = recording
    iters = int(cfg.mppi.refine_iters)
    pr.panda_rollout_launches = 0
    weights.weights_launches = 0
    log = loop.run_chunked(100, chunk=50)
    dispatched = sum(n for n, _ in record)
    views = torch.cat([v for _, v in record]).cpu().numpy()
    counts = (pr.panda_rollout_launches, weights.weights_launches)
    mp.rollout = rollout
    print(f"[panda-shelf] {dispatched} ticks; launches panda_rollout {counts[0]}, multimodal_weights {counts[1]}; "
          f"stages {sorted(set(log.task))}; cube {views[-1, :3].tolist()}")
    assert np.isfinite(views).all(), "non-finite shelf views"
    assert counts == ((1 + iters) * dispatched, iters * dispatched), counts
    assert len(costs) == counts[0]
    return max(_weights_check(mp, c, f"panda-shelf K2, rollout {n}") for n, c in list(enumerate(costs))[::10])


def phase_panda_bench(card: str) -> float:
    """The panda replan+step rate, scripts/bench_panda.py:58-77: multi-modal
    K=200 x T=12, warm-up 50, two warm-up chunks of 200, then 800 timed
    ticks in chunks of 200 chained from the start state."""
    from m3p2i_aip_tpu_torch.config.config_store import load_config
    from m3p2i_aip_tpu_torch.tamp.sim_loop import SimLoop

    loop = SimLoop(load_config("config_panda", ["multi_modal=True"]), device="cuda")
    loop.warmup(50)
    tamp, chunk = loop.tamp, 200

    def run(n_ticks):
        ms, rs, stage, zs = tamp.mppi_state, loop.state, 0, tamp.zup_zs0()
        for _ in range(n_ticks // chunk):
            ms, rs, stage, zs, _, views, _, _ = tamp.run_chunk_panda(ms, rs, stage, zs, chunk)
        torch.cuda.synchronize()
        return views

    run(2 * chunk)
    t0 = time.perf_counter()
    run(4 * chunk)
    hz = 4 * chunk / (time.perf_counter() - t0)
    print(f"[panda-bench] {hz:.2f} Hz replan+step, K=200 x T=12, multi-modal, 800 timed ticks ({card})")
    return hz


def phase_albert_rollout() -> dict:
    """K4 against its plain version at K=128 x T=12 (config_albert physics)
    on the five starts and tasks of ``albert_rollout.PARITY_CASES``, each
    call launching the kernel once."""
    from m3p2i_aip_tpu_torch.config.config_store import load_config
    from m3p2i_aip_tpu_torch.ops import albert_rollout as ar
    from m3p2i_aip_tpu_torch.planners.motion_planner.mppi import make_task_params
    from m3p2i_aip_tpu_torch.tamp.reactive_tamp import ReactiveTAMP
    from m3p2i_aip_tpu_torch.utils.tree import tree_map

    tamp = ReactiveTAMP(load_config("config_albert"), device="cuda")
    mp = tamp.motion_planner
    spec, K, T = mp.rollout.spec, mp.K, mp.T
    rng = np.random.default_rng(2)
    cost_err = traj_err = 0.0
    timed = None
    for name, start, task_name, goal in ar.PARITY_CASES:
        task = make_task_params(task_name, goal, device="cuda")
        acts = rng.uniform(-1.5, 1.5, size=(K, T, 13)).astype(np.float32)
        acts[..., 11:13] *= 8.0  # the wheels at the config's +-12 authority, so the box moves
        acts = torch.as_tensor(acts, device="cuda")
        state_k = tree_map(lambda x: x.expand((K,) + x.shape), ar.parity_state(tamp.env.params, start))
        inputs = ar.rollout_inputs(state_k, task)
        before = ar.albert_rollout_launches
        c_k, t_k = ar.albert_rollout(spec, *inputs, acts)
        assert ar.albert_rollout_launches == before + 1
        c_p, t_p = ar.albert_rollout_plain(spec, *inputs, acts)
        torch.cuda.synchronize()
        ce = float(torch.max(torch.abs(c_k - c_p)))
        te = float(torch.max(torch.abs(t_k - t_p)))
        print(f"[albert-rollout] {name}: cost err {ce:.3e}, traj err {te:.3e} "
              f"(cost in [{float(c_p.min()):.2f}, {float(c_p.max()):.2f}])")
        assert torch.isfinite(c_k).all() and torch.isfinite(t_k).all()
        assert ce <= ALBERT_ATOL and te <= ALBERT_ATOL, f"albert kernel disagrees with its plain version ({name})"
        cost_err, traj_err = max(cost_err, ce), max(traj_err, te)
        if timed is None:
            timed = (inputs, acts)
    inputs, acts = timed
    ms = _time_ms(lambda: ar.albert_rollout(spec, *inputs, acts))
    plain_ms = _time_ms(lambda: ar.albert_rollout_plain(spec, *inputs, acts), calls=10, warmup=2)
    bound = _bound(_bytes(spec.params_buf, *inputs, acts) + K * T * 3 * 4, _albert_rollout_ops(spec, K))
    print(f"[albert-rollout] max cost err {cost_err:.3e}, max traj err {traj_err:.3e}")
    print(f"[albert-rollout] kernel {ms:.4f} ms (median of {TIMED_CALLS}), plain {plain_ms:.4f} ms (median of 10); "
          f"bound {bound}")
    return {"max_abs_err": max(cost_err, traj_err), "ms": ms, "plain_ms": plain_ms, **bound, "library_ms": None}


def _albert_gated_run(label: str, overrides: list, n_ticks: int):
    """One gated albert run through ``run_chunked(n_ticks, chunk=10)`` with
    the launch counts set to 0 just before and read just after: K4 launched
    1 + refine_iters times per dispatched tick, K2 never, every view finite,
    success latched.  The chunk entry records each chunk's length and views
    (read after the run, not inside it).  Returns (cfg, views, log, K4
    launches)."""
    from m3p2i_aip_tpu_torch.config.config_store import load_config
    from m3p2i_aip_tpu_torch.ops import albert_rollout as ar
    from m3p2i_aip_tpu_torch.ops import weights
    from m3p2i_aip_tpu_torch.tamp.sim_loop import SimLoop

    cfg = load_config("config_albert", overrides)
    loop = SimLoop(cfg, device="cuda")
    loop.warmup(20)
    record = []
    run_chunk = loop.tamp.run_chunk

    def counted(ms, rs, task, i0, length):
        out = run_chunk(ms, rs, task, i0, length)
        record.append((length, out[2]))
        return out

    loop.tamp.run_chunk = counted
    view0 = loop.env.view_vec(loop.state).cpu().numpy()
    ar.albert_rollout_launches = 0
    weights.weights_launches = 0
    t0 = time.perf_counter()
    log = loop.run_chunked(n_ticks, chunk=10)
    wall = time.perf_counter() - t0
    launches, w_launches = ar.albert_rollout_launches, weights.weights_launches
    dispatched = sum(n for n, _ in record)
    views = np.concatenate([view0[None]] + [v.cpu().numpy() for _, v in record])
    print(f"[{label}] {log.steps} ticks logged, {dispatched} dispatched in {wall:.2f} s; "
          f"albert_rollout launches {launches}, multimodal_weights launches {w_launches}; "
          f"success tick {log.success_step}; tasks {sorted(set(log.task))}")
    assert dispatched > 0
    assert launches == (1 + int(cfg.mppi.refine_iters)) * dispatched, f"{label}: {launches} K4 launches"
    assert w_launches == 0, f"{label}: the single-mode albert path launched the weights kernel"
    assert np.isfinite(views).all(), f"{label}: non-finite views"
    assert log.success_step is not None and log.success_step < n_ticks, f"{label}: no success in {n_ticks} ticks"
    return cfg, views[: log.success_step + 2], log, launches


def phase_albert_main() -> int:
    """The albert main path: ``config_albert`` defaults (ee_reach to
    [2, 2, 0.8], K=128 x T=12) through ``SimLoop.run_chunked`` in chunks of
    10 (scripts/run_experiments.py:107).  Success within 150 ticks, and the
    base must have driven more than 0.8 m (tests/test_albert.py:37-47)."""
    cfg, views, log, launches = _albert_gated_run("albert-main", [], EE_REACH_TICKS)
    ee_err = float(np.linalg.norm(views[-1, 6:9] - np.asarray(cfg.goal, np.float32)))
    base = float(np.linalg.norm(views[-1, 0:2]))
    print(f"[albert-main] ee error at success {ee_err:.4f} m, base driven to {base:.3f} m from the origin")
    assert base > 0.8, f"the base did not drive: {base:.3f} m"
    return launches


def phase_albert_push() -> None:
    """The albert push_reach to [3, 0, 0.6]: success within 500 ticks
    (tests/test_albert.py:193), the box finite and moved toward the goal."""
    cfg, views, log, _ = _albert_gated_run("albert-push", PUSH_REACH, PUSH_REACH_TICKS)
    goal = np.asarray(cfg.goal, np.float32)[:2]
    d0, d1 = (float(np.linalg.norm(views[i, 9:11] - goal)) for i in (0, -1))
    hover = float(np.linalg.norm(views[-1, 6:9] - np.r_[views[-1, 9:11], cfg.goal[2]]))
    print(f"[albert-push] box-to-goal {d0:.3f} -> {d1:.4f} m; ee hover error at success {hover:.4f} m")
    assert d1 < d0 and d1 <= 0.1 + 1e-6, "the box did not reach the goal"


def phase_albert_bench(card: str) -> float:
    """The albert replan+step rate, scripts/bench_albert.py's protocol:
    push_reach to [3, 0, 0.6], warm-up 20, both gates off, two warm-up chunks
    of 100, then 400 timed ticks in chunks of 100."""
    from m3p2i_aip_tpu_torch.config.config_store import load_config
    from m3p2i_aip_tpu_torch.tamp.sim_loop import SimLoop

    loop = SimLoop(load_config("config_albert", PUSH_REACH), device="cuda")
    loop.warmup(20)
    loop.tamp.task_planner.check_task_success = lambda view: False
    loop.tamp.device_gate = False
    chunk = 100
    for _ in range(2):
        loop.run_chunked(chunk, chunk=chunk)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(4):
        loop.run_chunked(chunk, chunk=chunk)
    hz = 4 * chunk / (time.perf_counter() - t0)
    print(f"[albert-bench] {hz:.2f} Hz replan+step, K=128 x T=12, push_reach, 400 timed ticks ({card})")
    return hz


def _host_ms(fn, calls: int = 10) -> float:
    """Median host time of one call that ends in a synchronize."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return float(np.median(times)) * 1e3


def phase_albert_breakdown(card: str) -> None:
    """One benchmark-mode push_reach tick in pieces: medians of 10 calls on
    the host clock with a synchronize (the real-env step on one state, the
    planner with its four K4 launches, the view, a whole tick, a 20-tick
    chunk per tick), then ``torch.profiler`` over a 20-tick chunk: device
    kernels per tick, device time per tick, K4's share, the idle share."""
    from m3p2i_aip_tpu_torch.config.config_store import load_config
    from m3p2i_aip_tpu_torch.tamp.sim_loop import SimLoop

    loop = SimLoop(load_config("config_albert", PUSH_REACH), device="cuda")
    loop.warmup(20)
    tamp, env = loop.tamp, loop.env
    task = tamp.tamp_interface_view(loop._view)
    ms, rs = tamp.mppi_state, loop.state
    zero_u, ext = torch.zeros(env.nu, device="cuda"), env.zero_ext()
    pieces = {
        "real-env albert.step": lambda: env.step(rs, zero_u, ext),
        "planner _command_impl": lambda: tamp.motion_planner._command_impl(ms, rs, task),
        "view_vec": lambda: env.view_vec(rs),
        "whole tick": lambda: tamp._run_chunk_impl(ms, rs, task, 0, 1, gate=False),
        "chunk of 20, per tick": lambda: tamp._run_chunk_impl(ms, rs, task, 0, 20, gate=False),
    }
    for name, fn in pieces.items():
        t = _host_ms(fn, calls=5 if "20" in name else 10)
        print(f"[albert-breakdown] {name}: {t / (20 if '20' in name else 1):.3f} ms ({card})")

    from torch.profiler import ProfilerActivity, profile

    n = 20
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tamp._run_chunk_impl(ms, rs, task, 0, n, gate=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        print("[albert-breakdown] torch.profiler recorded no device kernels: device time not measured")
        return
    dev_us = sum(e.time_range.elapsed_us() for e in kernels)
    k4_us = sum(e.time_range.elapsed_us() for e in kernels if "albert_rollout" in e.name)
    print(f"[albert-breakdown] profiler over {n} ticks: {len(kernels) / n:.0f} device kernels a tick, "
          f"{dev_us / n / 1e3:.3f} ms device time a tick (K4 {k4_us / n / 1e3:.3f} ms), "
          f"profiled wall {wall / n * 1e3:.3f} ms a tick, device idle {100 * (1 - dev_us / 1e6 / wall):.1f}% ({card})")


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
    # 5. / 6. the point main path
    loop, launches = phase_main_path(load_config("config_point", MAIN_PATH))
    hz = phase_benchmark(loop, card)
    del loop
    # 7. K3 against its plain version; 8. / 9. / 10. the panda path
    stats["panda_rollout"], w_err = phase_panda_rollout()
    launches["panda_rollout"] = phase_panda_main()
    w_err = max(w_err, phase_panda_shelf())
    k2 = stats["multimodal_weights"]
    k2["max_abs_err"] = max(k2["max_abs_err"], w_err)  # over the point and the panda shapes and costs
    panda_hz = phase_panda_bench(card)
    # 11. K4 against its plain version; 12. - 15. the albert path
    stats["albert_rollout"] = phase_albert_rollout()
    launches["albert_rollout"] = phase_albert_main()
    phase_albert_push()
    albert_hz = phase_albert_bench(card)
    phase_albert_breakdown(card)

    sources = {
        "point_rollout": ("m3p2i_aip_tpu_torch/csrc/point_rollout.cu", "m3p2i_aip_tpu/ops/pallas_rollout.py:189"),
        "multimodal_weights": (
            "m3p2i_aip_tpu_torch/csrc/multimodal_weights.cu",
            "m3p2i_aip_tpu/ops/pallas_kernels.py:60",
        ),
        "panda_rollout": (
            "m3p2i_aip_tpu_torch/csrc/panda_rollout.cu",
            "m3p2i_aip_tpu/ops/pallas_panda_rollout.py:185",
        ),
        "albert_rollout": (
            "m3p2i_aip_tpu_torch/csrc/albert_rollout.cu",
            "m3p2i_aip_tpu/ops/pallas_albert_rollout.py:55",
        ),
    }
    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep, "launches": launches[name], **stats[name]}
        for name, (src, rep) in sources.items()
    ]
    print(f"[bench] point {hz:.2f} Hz, panda {panda_hz:.2f} Hz, albert {albert_hz:.2f} Hz on {card}")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
