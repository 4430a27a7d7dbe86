#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``m3p2i_aip_tpu_torch``).

Builds the port's CUDA kernels from ``m3p2i_aip_tpu_torch/csrc``, holds each
against its plain PyTorch version on the card, then drives the port's three
paths through ``SimLoop.run_chunked``.  The runs that record every kernel
call's inputs from Python run the eager tick (``graphs=False``, ``--eager``;
their warm-ups and settles, which launch no kernel, replay a compiled step);
the compiled tick, the entry points' default on the card (one CUDA graph a
tick, replayed), is held to them bit for bit in its own phase, and the runs
that record nothing run it (``graphs=True``, or the default):

* the point-robot push_pull multi-modal M3P2I loop at K=200 x T=15 with the
  success gates on (the box must reach the corner goal);
* the panda active-inference pick-place loop (``-cn config_panda``) at
  K=200 x T=12 with the refine ladder: the table pick-place must grasp the
  cube and latch success, and a short multi-modal shelf run must stay
  finite;
* the albert mobile manipulator (``-cn config_albert``) at K=128 x T=12
  with the softmax-only refine ladder: the ee_reach must latch success
  within 150 ticks with the base driven, the push_reach must push the box to
  its goal within 500 ticks, and one tick is broken down into its pieces
  (host clock) and its device kernels (``torch.profiler``);
* batched seed evaluation (``BatchSimLoop``): the four batched kernels
  (K1b-K4b, one launch per rollout per tick for the whole batch) against
  their plain versions and against serial single-kernel launches on four
  seeds, and timed at B=20; three n=20 batches (seeds 0-19, gates on: the
  point push_pull hybrid, the panda multi-modal table pick-place with its
  settle, the albert ee_reach), each of which must succeed on at least 18
  seeds with the batched kernels launched once per rollout per tick and the
  single kernels not at all, and each of which prints its per-seed rows;
  and three seeds batched against three serial runs, compiled (point and
  panda: equal tick counts and success ticks, positions within 1e-4);
* the point family's real-env step kernel (K5, K5b at B=20): every step
  the main path and the point n=20 batch took through it, their warm-ups'
  included, run again and held to ``point_env.step`` bit for bit, timed
  single and replayed at B=1 and B=20 beside the plain step, and K1's
  device time a launch after K5 and after the plain step.  Every step a
  point-family env on the card is asked for is counted apart from the
  kernel's launches, through the runs' graph replays too, and every launch
  count the phases below read holds K5 and K5b to one launch a step;
* the panda's real-env step kernel (K6, K6b at B=20): every eager step the
  panda main path and the panda n=20 batch took through it run again, a
  single state held to ``panda_env.step`` bit for bit, a batch to single
  launches (and every 25th to the plain step of each state alone), timed
  single and replayed at B=1 and B=20 beside the plain step; every step a
  panda env on the card is asked for is counted as the point family's, and
  the launch counts hold K6 and K6b to one launch a step;
* the heijn (3-dof omni) and boxer (differential drive) bases and the
  planner modes beyond the default, each a gated ``run_chunked`` at
  K=200 x T=15 that must reach its goal, with its launch counts and success
  tick: heijn push, boxer pull, boxer staged pure push (its reposition must
  engage), the boxer corner hybrid; on the point, simple-mode, random-
  sampling and update_cov navigation and the update_cov_per_mode hybrid.
  Every K1 call of these runs is held to the plain version
  (``phase_every_call``), their K2 calls join K2's closed-loop phase, and
  the heijn and boxer replan+step rates, compiled, are measured with
  ``scripts/bench_family.py``'s protocol;
* the README's entry points: the port's ``run_tamp`` script (``main``,
  one replan+step a tick through ``SimLoop.run``, the host task planner
  every tick), gated, on the point main path (it must latch at the chunked
  main path's tick) and on ``-cn config_panda`` (it must latch success
  within 300 ticks), with the per-tick rates; the two terminals, the port's
  ``rpc.Server`` serving ``ReactiveTAMPServer`` on the card from a thread
  and the port's sim client ticking against it over a localhost socket (the
  point push to [-1, -1] must reach its goal within 300 ticks; 20 ticks of
  the panda and of the albert), each run compiled (the server's command and
  the client's warm-up and steps replayed from CUDA graphs, the default)
  and then eager, the compiled run ending in the eager run's state bit for
  bit, with the round trip per tick of both beside the in-process tick; and
  checkpoint / resume of the point main path and the
  panda, compiled, 20 ticks, a checkpoint, a fresh loop, 20 ticks,
  bit-equal to 40 uninterrupted ticks.  Every launch count is set to 0 just before each of
  these runs and read just after, and every K1, K3 and K4 call of them is
  held to its plain version (their K2 calls join K2's closed-loop phase).
  F3: the per-tick and chunked panda runs recorded tick by tick from one
  scene must agree bit for bit until the device gate first plans the pick
  and part there, the host planner switching one tick later;
* pipelined chunks (``run_chunked(pipelined=True)``, one chunk in flight) on
  the main path: gated, the same latch and bit-equal logs as serial chunks,
  no host sync in any enqueue (``torch.cuda.set_sync_debug_mode``), K1 and
  K2 once per dispatched tick;
* gradient refinement, the round-4 panda setting (``mppi.grad_refine_steps=8
  mppi.refine_iters=0``, multi-modal) at K=200 x T=12, eager and then
  compiled (three graphs a tick: the tick up to the refinement, one
  gradient step replayed eight times, the rest): finite means every tick,
  K3 and K2 once a tick, the tick's time and the autograd chain's share of
  it, one tick's refinement repeated on the CPU from the same inputs within
  1e-4, and the compiled ticks' planner states bit-equal to the eager
  ticks', with each graph's nodes, capture time and pool;
* the URDF FK cross-check: the vendored franka and albert URDFs' chains
  (``utils/urdf.py``) against ``panda_fk.fk`` and ``albert.fk`` on the card;
* the compiled tick (``tamp/graph_tick.py``, ``scripts/graph_ab.py``): the
  gated main path (latch 47), the point in benchmark mode and per tick, the
  gated panda table (latch 83), the albert push_reach and the n=20 point,
  panda and albert batches, each compiled and bit-equal to its eager run (chunk
  outputs, log, final carry), with its launches (captured launches x
  replays) once per dispatched tick per rollout and weight update, each
  graph's capture time, nodes and pool; the gated main path pipelined and
  compiled, equal to the eager serial run, with no host sync in any
  enqueue after the one that captures; and the rates eager and compiled
  in turns (serial, pipelined, per tick, the B=20 batched tick, the panda,
  the albert, the north-star shape), each mode profiled (device time, idle
  share), each profile's kernel events equal to the launches its wrappers
  counted (eager) or its graph replays made (compiled); and ``MPPI.command``
  itself compiled (one CUDA graph a command) against ``graphs=False``: ten
  chained commands of the point main path, the panda multi-modal, the
  albert push_reach, a B=3 point seed batch and the point over 8 shards of
  the card, bit for bit in actions, planner states and top trajectories,
  with each graph's nodes, capture time and ms a call in turns;
* the sample axis split over shards of the card (``parallel.shard_planner``
  on a mesh that repeats ``cuda:0``): the gated main path over 8 shards
  (pipelined, no host sync in any enqueue) and over 5, each latching at the
  unsharded tick with bit-equal logs, every K1 call at its shard's global
  offset equal to the plain version, and the 8-shard run again compiled
  (each shard's rollout a parallel branch of the tick's graph), its log and
  launches the eager run's; the multi-modal panda and the albert
  push_reach over 8 shards, tick for tick equal to their unsharded runs,
  every K3 / K4 call held to its plain version; the gather's time, a
  profile, and ``scripts/bench_sharded.py``'s sweep of compiled commands
  (K = 512, 2048, 8192, 16384, unsharded against 8 shards, in turns, and
  the compiled 1-shard command against an eager unsharded one);
* the seed axis over 4 shards of the card (``BatchSimLoop(shard=mesh)``),
  compiled: the n=20 point and panda batches, every seed's row and success
  tick equal to the unsharded eager batch's, the compiled seed-tick rate
  beside the unsharded in turns, and ``run_experiments
  parallel_seeds=shard`` on the default mesh;
* the benchmark twins (``m3p2i_aip_tpu_torch/scripts/bench*.py``,
  ``analyze_utilization``): every rate above is measured by a twin's
  ``measure`` (the point, panda, albert, heijn and boxer rates) or
  ``sweep_row`` (the sharded sweep, K = 512 to 16384), each with its
  per-chunk spread; the north-star shape K=500 x T=30 (every K1 call of 20
  recorded ticks held to the plain version; its rates are the compiled
  tick's phase's); K2 and K2b at K = 16384 and 65536 against their plain
  versions (the cost-to-go in opted-in shared memory, then in global
  scratch; at 16384 a captured launch bit-equal to an eager one); and the
  utilization table of the reference and north-star workloads, compiled.

The inputs the point, panda and albert main paths and their n=20 batches
gave K1, K1b, K3, K3b, K4 and K4b are recorded, each timed, and the slowest
held against the plain version sample by sample at the family's bars (a
sample beyond the bars passes only where a one- to four-ulp nudge of its own
actions carries the plain version to the kernel's output) and timed beside
the check inputs: the point and albert kernels' times depend on their data
(they skip work whose result no output reads).  Then a rollout-scaling phase
times K1 and K3 at K = 200, 1000 and 4000, K4 at K = 128, 1024 and 4096, and
K1b, K3b and K4b at B = 1, 4 and 20 on both kinds of input (kernel times
only, each with its waves).  Every weights call of the point main path,
the panda shelf run and the point and panda n=20 batches (K2 and K2b, the
wrappers patched by name in the mppi module) is held to the plain version
and timed, with each path's beta-round histogram per group
(``weights.beta_rounds``), and K2 is swept over K = 200, 1024 and 4096 and
K2b over B = 1, 4 and 20 on random and closed-loop costs.  Each kernel is
timed twice: single calls between CUDA events (``ms``, ``closed_loop_ms``)
and calls replayed back to back from a CUDA graph (``device_ms``,
``closed_loop_device_ms``, which leave out the host's time to issue a
call).

Each kernel's entry in the kernel table carries ``launches``, the launches
its wrapper counted on the runs above (every kernel must have some), and
``graph_launches``, those the compiled runs' graph replays made (captured
launches x replays; the profiled chunks show them as kernel events), and its
bound: the least time
the card could take for the same work, the larger of the bytes it must move
over 3.35 TB/s and the f32 operations it does over 67 TFLOP/s (the H100 SXM
data-sheet peaks), the operations reckoned from the kernel's code at this
run's shapes (for the point rollout, from this run's live contacts too).

Usage (one CUDA GPU, no arguments):

    python3 chip_smoke.py

Every check is an assert or a raise, so any failure exits non-zero.  There
is no CPU path: without a CUDA device the script exits 1 and prints no
result.  On success the last three lines of stdout are the kernel table, the card's
name and power limit, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import re
import sys
import time

import numpy as np
import torch

from m3p2i_aip_tpu_torch.analysis import bench_record, roofline
from m3p2i_aip_tpu_torch.analysis.bench_record import event_ms as _time_ms
from m3p2i_aip_tpu_torch.analysis.bench_record import host_ms as _host_ms
from m3p2i_aip_tpu_torch.analysis.bench_record import replayed_ms as _device_ms
from m3p2i_aip_tpu_torch.models import point_env
from m3p2i_aip_tpu_torch.ops import panda_step as pps
from m3p2i_aip_tpu_torch.ops import point_step as ps
from m3p2i_aip_tpu_torch.scripts import graph_ab
from m3p2i_aip_tpu_torch.scripts.bench import MAIN_PATH
from m3p2i_aip_tpu_torch.tamp import graph_tick
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
PLANAR_BARS = (COST_ATOL, TRAJ_ATOL)  # the point and panda rollouts' (cost, trajectory) bars
TIMED_CALLS = 50
PANDA_STEP_PLAIN_EVERY = 25  # every n-th recorded K6b call is held to the plain step of each of its states
PANDA_TICKS = 900  # the table pick-place must latch success within this many ticks
ALBERT_ATOL = 1e-4  # K4 vs its plain version, cost and trajectory (tests/test_pallas.py:818-821)
ALBERT_BARS = (ALBERT_ATOL, ALBERT_ATOL)
EE_REACH_TICKS, PUSH_REACH_TICKS = 150, 500  # tests/test_albert.py:37, :193
PUSH_REACH = ["task=push_reach", "goal=[3.0,0.0,0.6]"]
BENCH_CHUNK = 50  # the heijn and boxer rates' chunk: 2 warm-up chunks, then FAMILY_TIMED timed chunks
N_SEEDS = 20  # the n=20 protocol of RESULTS.md
CHECK_SEEDS = 4  # seeds of the batched kernels' checks against their plain versions
SERIAL_ATOL = 0.0  # a batched kernel against its single kernel per seed: the same body, so the same bits
SCALING_K = (200, 1000, 4000)  # K1's and K3's sample counts in the rollout-scaling phase
SCALING_B = (1, 4, 20)  # the batched kernels' seed counts there
ALBERT_SCALING_K = (128, 1024, 4096)  # K4's: whole tilings of its K=128 samples
WEIGHTS_SCALING_K = (200, 1024, 4096)  # K2's: one parent warp short of a pass, 32 parent warps, 4096 strided
# A rollout kernel on a recorded closed-loop input: a sample beyond COST_ATOL
# / TRAJ_ATOL passes only if a nudge of all its own actions by 1 .. NUDGE_ULPS
# ulp carries the plain version's same sample to the kernel's output, within
# the same bars
NUDGE_ULPS = 4
BATCH_PARITY_ATOL = 1e-4  # batched runs against serial runs (tests/test_batch_loop.py:44-78)
MIN_SUCCESS = 18  # of N_SEEDS, per n=20 batch
# the heijn/boxer closed loops and the planner-mode runs at K=200 x T=15, each
# gated and required to reach its goal: (label, config, overrides, tick cap),
# with the JAX tests' protocols (warm-up 10; tests/test_tamp_integration.py
# :558 heijn push, :575 boxer pull, :90 boxer staged pure push;
# tests/test_mppi_simple.py:126 / :149 the simple and random-sampling
# navigations), and the boxer corner hybrid, whose staged pocket endgame
# (pull -> reposition -> push) must engage.  At K=200 the pure push
# finishes seed 0 unstaged, in the JAX package too
NAV = ["task=navigation", "goal=[-3,3]"]
FAMILY_LOOPS = [
    ("heijn push", "config_heijn", ["task=push", "goal=[-1,-1]"], 300),
    ("boxer pull", "config_boxer", ["task=pull", "goal=[0,0]"], 400),
    ("boxer staged push", "config_boxer", ["task=push", "goal=[-1,-1]"], 900),
    ("boxer corner hybrid", "config_boxer", MAIN_PATH, 1000),
]
MODE_LOOPS = [
    ("simple navigation", "config_point", [*NAV, "mppi.mppi_mode=simple"], 200),
    ("random-sampling navigation", "config_point", [*NAV, "mppi.sampling_method=random"], 200),
    # the reference's covariance EMA settles near kappa / step_size_cov, so
    # the sampling scale collapses to ~0.13 and a run to [-3, 3] parks at the
    # wall in the JAX package too (2 of 3 seeds in 600 ticks, K=200,
    # scripts/run_experiments.py); to [1.5, 1] its seeds 0-3 arrive at
    # ticks 11-14
    ("update_cov navigation", "config_point", ["task=navigation", "goal=[1.5,1.0]", "mppi.update_cov=True"], 200),
    ("update_cov_per_mode hybrid", "config_point", [*MAIN_PATH, "mppi.update_cov_per_mode=True"], 300),
]
RUN_SIM_PANDA_TICKS = 300  # the per-tick panda run's cap
RPC_PUSH = ["task=push", "goal=[-1,-1]"]  # the two-terminal point run: the box within 0.1 m of the goal ...
RPC_PUSH_TICKS = 300  # ... within this many ticks
RPC_FAMILY_TICKS = 20  # the panda and albert ticks over the socket
CKPT_TICKS = 20  # ticks before and after the checkpoint
LOOP_CHUNK = 10  # the n=20 campaigns' chunked=10 (scripts/run_quality_campaign_r3.sh)
CHECK_GROUP = 100  # recorded K1 calls held to the batched plain version at once
PIPELINE_CHUNK = 10  # the gated serial / pipelined main-path runs' chunk
FAMILY_TIMED = 2  # the heijn and boxer rates' timed chunks of BENCH_CHUNK
GRAD_REFINE = ["multi_modal=True", "mppi.grad_refine_steps=8", "mppi.grad_refine_unroll=True", "mppi.refine_iters=0"]
GRAD_REFINE_TICKS = 2  # ticks of the round-4 panda setting (config/mppi/panda.yaml:25-32) a mode, seconds each
GRAD_REFINE_ATOL = 1e-4  # its refined means on the card against the port on the CPU, one recorded tick
URDF_SAMPLES = 1024  # joint vectors of the URDF cross-check
URDF_ATOL = 1e-5  # tests/test_urdf.py's bar
# the sample axis split over shards of one card (parallel/mesh.py): the main
# path over 8 shards (25 samples each, the pull half from shard 4's start)
# and over 5 (40 each, half_K = 100 at local index 20 of shard 2); the
# multi-modal panda and the albert push_reach over 8
SAMPLE_SHARDS = (8, 5)
FAMILY_SHARDS = 8
PANDA_SHARD_TICKS = 30  # the sharded and unsharded multi-modal panda, tick for tick
SWEEP_K = (512, 2048, 8192, 16384)  # scripts/bench_sharded.py's sweep (horizon 12), unsharded against 8 shards
SWEEP_TICKS = 10  # its timed replans a turn (scripts/bench_sharded.py --ticks)
SEED_SHARDS = 4  # the n=20 point and panda batches over 4 shards of one card: 5 seeds each
STEP_NEIGHBOUR_REPLAYS = 20  # replays of a [step, K1] graph a profile, K5 and the plain step in turns
NORTHSTAR_CHECKED = 20  # the north-star's recorded ticks, every K1 call held to the plain version
UTIL_CHUNK_TICKS = 4  # the utilization table's chunk: the tick in a chunk, and the profile
WEIGHTS_LARGE_K = (16384, 65536)  # K2 / K2b with the cost-to-go in opted-in shared memory, then in global scratch
SEED_BENCH_CHUNKS = 1  # the seed-shard rate: 1 warm-up chunk, then this many of LOOP_CHUNK a turn
SHARD_PROFILE_TICKS = 2  # the sharded runs' profiled ticks (a 4-shard batched tick is ~19,000 device kernels)
SIM_COLUMNS = {"point": [*range(1, 14), 17, 18], "panda": list(range(1, 15))}  # a row's columns that are not clocks
GRAPH_RATE_CHUNK, GRAPH_RATE_TIMED = 10, 20  # the paired eager / compiled rates: 2 chunks to settle, then these
# MPPI.command compiled against graphs=False: (label, config, overrides, seeds B, sample shards of the card), the
# chained commands of each held bit for bit, then the chained commands timed a turn (eager, compiled, compiled, eager)
COMMAND_CASES = (
    ("point", "config_point", MAIN_PATH, 1, None),
    ("panda multi-modal", "config_panda", ["multi_modal=True"], 1, None),
    ("albert push_reach", "config_albert", PUSH_REACH, 1, None),
    ("point B=3", "config_point", MAIN_PATH, 3, None),
    ("point x8 shards", "config_point", MAIN_PATH, 1, 8),
)
COMMAND_CALLS, COMMAND_TIMED = 10, 20
COMMAND_LAUNCHES = {  # a command's launches, by counter
    "point": {"rollout_launches": 1, "weights_launches": 1},
    "panda multi-modal": {"panda_rollout_launches": 4, "weights_launches": 3},
    "albert push_reach": {"albert_rollout_launches": 4},
    "point B=3": {"rollout_batched_launches": 1, "weights_batched_launches": 1},
    "point x8 shards": {"rollout_launches": 8, "weights_launches": 1},
}
# the eager runs held against their compiled twins in phase_graphs (graph_ab's record of each: chunk outputs, log,
# final carry), kept by the phases that run them, under graph_ab.LOOPS's and graph_ab.BATCHES's labels
EAGER_RUNS: dict = {}
# a compiled run's launches a dispatched tick, by counter (graph_ab's labels)
GRAPH_LAUNCHES = {
    "point gated": {"rollout_launches": 1, "weights_launches": 1},
    "point benchmark": {"rollout_launches": 1, "weights_launches": 1},
    "panda gated": {"panda_rollout_launches": 4},
    "albert push_reach": {"albert_rollout_launches": 4},
    "point per tick": {"rollout_launches": 1, "weights_launches": 1},
    "point batch": {"rollout_batched_launches": 1, "weights_batched_launches": 1},
    "panda batch": {"panda_rollout_batched_launches": 4, "weights_batched_launches": 3},
    "albert batch": {"albert_rollout_batched_launches": 4},
}
# four point tasks for the batched checks: (name, goal)
POINT_TASKS = [("push_pull", [-3.75, -3.75]), ("pull", [1.0, 3.0]), ("push", [-1.0, -1.0]), ("navigation", [1.5, 1.0])]

@contextlib.contextmanager
def _recorded(mod, name: str):
    """Inside the block, each call of the wrapper ``mod.name(spec, *tensors)``
    is recorded into the yielded list as (spec, copies of its tensors); the
    call itself goes through unchanged, launch count included."""
    fn, calls = getattr(mod, name), []

    def recording(spec, *args):
        calls.append((spec, tuple(x.clone() for x in args)))
        return fn(spec, *args)

    setattr(mod, name, recording)
    try:
        yield calls
    finally:
        setattr(mod, name, fn)


@contextlib.contextmanager
def _recorded_weights(name: str):
    """Inside the block, each call the planner makes of the weights wrapper
    ``name`` (``multimodal_weights`` or ``multimodal_weights_batched``,
    looked up in the mppi module, which imports both by name) is recorded
    into the yielded list as (a copy of its costs, gamma, half_K, eta_u,
    eta_l); the call itself goes through unchanged, launch count included."""
    from m3p2i_aip_tpu_torch.planners.motion_planner import mppi

    fn, calls = getattr(mppi, name), []

    def recording(cost, *args):
        calls.append((cost.clone(),) + args)
        return fn(cost, *args)

    setattr(mppi, name, recording)
    try:
        yield calls
    finally:
        setattr(mppi, name, fn)


@contextlib.contextmanager
def _recorded_steps(mod=ps, name: str = "point_step"):
    """Inside the block, each call of a real-env step kernel's wrapper
    (``point_step.point_step``, which a point-family env's step calls on the
    card, or ``panda_step.panda_step``, the panda's) outside a graph capture
    is recorded into the yielded list as (params, param buffer, copies of
    the state, action and forces); the call itself goes through unchanged,
    launch count included."""
    from m3p2i_aip_tpu_torch.utils.tree import tree_map

    fn, calls = getattr(mod, name), []

    def recording(params, buf, state, u, ext):
        if not torch.cuda.is_current_stream_capturing():
            calls.append((params, buf, tree_map(torch.clone, state), u.clone(), tree_map(torch.clone, ext)))
        return fn(params, buf, state, u, ext)

    setattr(mod, name, recording)
    try:
        yield calls
    finally:
        setattr(mod, name, fn)


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
    dev_ms = _device_ms(lambda: weights.multimodal_weights(*args))
    plain_ms = _time_ms(lambda: weights.multimodal_weights_plain(*args))
    bound = roofline.weights_bound(args)
    print(f"[weights] kernel {ms:.4f} ms ({dev_ms:.4f} replayed from a graph), plain {plain_ms:.4f} ms (median of "
          f"{TIMED_CALLS}); bound {bound}")
    return {"max_abs_err": err, "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms, **bound, "library_ms": None}


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
        with roofline.live_contacts() as live:
            c_p, t_p = ro.point_rollout_plain(spec, *inputs, acts)
        torch.cuda.synchronize()
        ce = float(torch.max(torch.abs(c_k - c_p)))
        te = float(torch.max(torch.abs(t_k - t_p)))
        print(f"[rollout] case {n} (q0={state.q.tolist()}, k0={k0}): cost err {ce:.3e}, traj err {te:.3e}")
        assert torch.isfinite(c_k).all() and torch.isfinite(t_k).all()
        assert ce <= COST_ATOL and te <= TRAJ_ATOL, f"rollout kernel disagrees with its plain version in case {n}"
        cost_err, traj_err = max(cost_err, ce), max(traj_err, te)
        if timed is None:
            timed = (inputs, acts, roofline.total(live))
    inputs, acts, n_live = timed
    ms = _time_ms(lambda: ro.point_rollout(spec, *inputs, acts))
    dev_ms = _device_ms(lambda: ro.point_rollout(spec, *inputs, acts))
    plain_ms = _time_ms(lambda: ro.point_rollout_plain(spec, *inputs, acts), calls=5, warmup=1)
    K, T = acts.shape[:2]
    bound = roofline.rollout_bound(spec, inputs + (acts,), K, roofline.point_rollout_ops(spec, K, n_live))
    print(f"[rollout] max cost err {cost_err:.3e}, max traj err {traj_err:.3e}; "
          f"case 0 (timed) projects {n_live} live contacts")
    print(f"[rollout] kernel {ms:.4f} ms (median of {TIMED_CALLS}; {dev_ms:.4f} replayed from a graph), plain {plain_ms:.4f} "
          f"ms (median of 5); bound {bound}")
    return {"max_abs_err": cost_err, "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms, **bound, "library_ms": None}


def _launch_shape(source: str, symbol: str) -> dict:
    """A team kernel's width and block (its source's constants), the
    registers, stack frame and spill stores a thread of its instantiation
    ``symbol`` (the build's ptxas report), and the
    blocks an SM holds at that register count: an H100 SM has 64K
    registers, allocated 256 a warp, and holds at most 64 warps and 32
    blocks (the kernel's few hundred bytes of shared memory a block bind
    nothing)."""
    from m3p2i_aip_tpu_torch.ops import cuda_build

    src = (cuda_build.CSRC_DIR / f"{source}.cu").read_text()
    team, threads = (int(re.search(rf"constexpr int {n} = (\d+);", src).group(1)) for n in ("kTeam", "kThreads"))
    m = re.search(
        rf"for \S*{symbol}\S*\n\s*(\d+) bytes stack frame, (\d+) bytes spill stores[^\n]*\n[^\n]*?Used (\d+) "
        "registers",
        cuda_build.build_info["log"],
    )
    assert m is not None, f"the build log holds no ptxas report of {symbol}"
    stack, spill, regs = (int(v) for v in m.groups())
    warps = threads // 32
    per_sm = min(32, 64 // warps, 65536 // (-(-regs * 32 // 256) * 256 * warps))
    return {"team": team, "threads": threads, "samples": threads // team, "registers": regs, "stack": stack,
            "spill": spill, "per_wave": per_sm * torch.cuda.get_device_properties(0).multi_processor_count}


def _slowest(calls, kernel) -> tuple:
    """Each recorded (spec, inputs) call of a rollout kernel wrapper timed
    (CUDA events, median of 5 calls): the median over the calls, and the
    slowest call."""
    times = [_time_ms(lambda: kernel(spec, *args), calls=5, warmup=1) for spec, args in calls]
    return float(np.median(times)), calls[int(np.argmax(times))]


def _beyond(out, ref, bars: tuple = PLANAR_BARS) -> tuple:
    """Per sample of [B, K] rollouts: the cost and trajectory errors of
    ``out`` against ``ref``, and where either lies beyond its bar in
    ``bars`` (cost, trajectory)."""
    ce = torch.abs(out[0] - ref[0]).amax(-1)
    te = torch.abs(out[1] - ref[1]).amax((-2, -1))
    return ce, te, (ce > bars[0]) | (te > bars[1])


def _nudges():
    """The nudges of a sample's own actions that ``_closed_loop_check`` tries,
    in order, as (label, ulp, up): all of its [T, nu] actions n ulp up, then
    down, for n = 1 .. NUDGE_ULPS."""
    for n in range(1, NUDGE_ULPS + 1):
        for up in (True, False):
            yield f"{n} ulp {'up' if up else 'down'}", n, up


def _nudged(acts, samples, n: int, up: bool):
    """``acts`` [B, K, T, nu] with every action of ``samples`` [B, K] moved n
    ulp up (or down), every other sample's as it is."""
    where = samples[..., None, None]
    toward = torch.full_like(acts, torch.inf if up else -torch.inf)
    for _ in range(n):
        acts = torch.where(where, torch.nextafter(acts, toward), acts)
    return acts


def _closed_loop_check(label: str, plain, inputs, out, ref=None, bars: tuple = PLANAR_BARS) -> tuple:
    """A rollout kernel's (cost, traj) ``out`` [B, K, ...] on B seeds'
    recorded closed-loop ``inputs`` (actions last) against the family's
    batched plain version ``plain(*inputs)`` (``ref``, if the caller ran it
    already), sample by sample, at the family's (cost, trajectory) ``bars``;
    returns (samples beyond the bars, samples explained).

    A closed-loop input can be ill-conditioned: a sample that sits on a
    contact gate takes the other branch after a one-ulp difference in any
    earlier operation, and its trajectory parts from there.  A sample's
    outputs depend only on its own actions, its seed's start state and task,
    and its index, so the evidence is per sample: a sample beyond the bars
    is explained when a nudge of its own actions (``_nudges``, in turn; one
    plain run of the affected seeds per nudge, every other sample unchanged)
    carries the plain version's same sample to the kernel's output, within
    the same bars: the plain version itself sits on a gate there, and its
    other branch is the kernel's.  Any sample no nudge explains fails the
    check, whatever their share."""
    c_k, t_k = out
    if ref is None:
        ref = plain(*inputs)
    ce, te, beyond = _beyond(out, ref, bars)
    within = ~beyond
    ce_in, te_in = (float(x[within].max()) if within.any() else 0.0 for x in (ce, te))
    print(f"[{label}] vs plain: {int(beyond.sum())} of {beyond.numel()} samples beyond the bars; within them max cost "
          f"err {ce_in:.3e}, traj err {te_in:.3e}; overall max cost err {float(ce.max()):.3e}, traj err "
          f"{float(te.max()):.3e}")
    unexplained, explained_by = beyond.clone(), {}
    for nudge, n, up in _nudges():
        seeds = torch.nonzero(unexplained.any(-1)).flatten()
        if seeds.numel() == 0:
            break
        samples = unexplained[seeds]
        x = [v[seeds] for v in inputs]
        x[-1] = _nudged(x[-1], samples, n, up)
        landed = ~_beyond(plain(*x), tuple(o[seeds] for o in out), bars)[2] & samples
        if landed.any():
            explained_by[nudge] = int(landed.sum())
        unexplained[seeds] = samples & ~landed
    n_beyond, n_explained = int(beyond.sum()), sum(explained_by.values())
    print(f"[{label}] {n_beyond} beyond, {n_explained} explained by nudges of their own actions {explained_by}")
    lost = [f"seed {int(b)} sample {int(k)} (cost err {float(ce[b, k]):.3e}, traj err {float(te[b, k]):.3e})"
            for b, k in torch.nonzero(unexplained).tolist()]
    for line in lost:
        print(f"[{label}] unexplained: {line}")
    assert torch.isfinite(c_k).all() and torch.isfinite(t_k).all()
    assert not lost, (
        f"{label}: kernel disagrees with its plain version at {len(lost)} unexplained samples: " + "; ".join(lost)
    )
    return n_beyond, n_explained


def phase_closed_loop(card: str, label: str, calls: list, kernel, plain, ops, single=None, live=False,
                      bars: tuple = PLANAR_BARS) -> tuple:
    """A rollout kernel on the inputs a closed loop gave it: every recorded
    (spec, inputs) call timed (``_slowest``); the slowest held against the plain batched
    version ``plain(spec, ...)`` sample by sample at the family's ``bars``
    (``_closed_loop_check``; a batched kernel also against its ``single``
    kernel per seed, exactly) and timed with TIMED_CALLS single calls and
    replayed from a graph (``_device_ms``).  The bound's
    operations are ``ops(spec, samples)``, or, where ``live`` (the point
    kernel), ``ops(spec, samples, live contacts)`` with the contacts the
    plain version projects.  Returns the kernel's closed-loop keys and its
    slowest input."""
    med, (spec, x) = _slowest(calls, kernel)
    out = kernel(spec, *x)
    xb, out = (x, out) if single is not None else (tuple(v[None] for v in x), tuple(v[None] for v in out))
    with roofline.live_contacts() if live else contextlib.nullcontext([]) as counted:
        ref = plain(spec, *xb)
    n_live = roofline.total(counted)
    _closed_loop_check(f"closed-loop {label}, slowest of {len(calls)} recorded calls", lambda *a: plain(spec, *a),
                       xb, out, ref, bars)
    if single is not None:
        se = 0.0
        for b in range(out[0].shape[0]):
            c_s, t_s = single(spec, *(v[b] for v in x))
            se = max(se, float(torch.max(torch.abs(out[0][b] - c_s))), float(torch.max(torch.abs(out[1][b] - t_s))))
        print(f"[closed-loop {label}] vs {out[0].shape[0]} single launches max err {se:.3e}")
        assert se <= SERIAL_ATOL, f"closed-loop {label} disagrees with its single kernel: {se}"
    ms = _time_ms(lambda: kernel(spec, *x))
    dev_ms = _device_ms(lambda: kernel(spec, *x))
    n, T = x[-1].shape[:-2].numel(), x[-1].shape[-2]
    bound = roofline.rollout_bound(spec, x, n, ops(spec, n, n_live) if live else ops(spec, n))
    counted_note = f", {n_live} live contacts" if live else ""
    print(f"[closed-loop {label}] {tuple(x[-1].shape[:-2])} samples: slowest input {ms:.4f} ms (median of "
          f"{TIMED_CALLS}; {dev_ms:.4f} replayed from a graph){counted_note}, bound {bound}; median over the recorded "
          f"inputs {med:.4f} ms ({card})")
    return {"closed_loop_ms": ms, "closed_loop_device_ms": dev_ms, "closed_loop_median_ms": med,
            "closed_loop_bound_ms": bound["bound_ms"]}, (spec, x)


def _round_histogram(label: str, calls: list) -> None:
    """Each group's beta rounds over one path's recorded weights calls
    (``weights.beta_rounds``, seeds of a batch counted alone): the
    histogram, the calls at the 64-round cap, the calls whose search turns
    and the calls whose group ties (every shifted cost 0, which the kernel
    answers without a search)."""
    from m3p2i_aip_tpu_torch.ops import weights

    cost = torch.stack([c for c, *_ in calls])
    rounds, turns, _ = weights.beta_rounds(cost, *calls[0][1:])
    rounds, turns = rounds.reshape(-1, 3), turns.reshape(-1, 3)
    c3 = weights._shifted_costs(cost, *calls[0][1:3]).reshape(-1, 3, cost.shape[-2])
    ties = (torch.where(torch.isinf(c3), 0.0, c3).amax(-1) == 0).cpu().numpy()  # every shift 0: no search
    for g in range(3):
        hist = dict(zip(*(v.tolist() for v in np.unique(rounds[:, g], return_counts=True))))
        print(f"[{label}] group {g}: {rounds.shape[0]} searches, rounds {{rounds: searches}} {hist}; "
              f"{int((rounds[:, g] == weights.BETA_ITERS).sum())} at the cap, {int((turns[:, g] > 0).sum())} turn, "
              f"{int(ties[:, g].sum())} tied")


def phase_weights_closed_loop(card: str, label: str, paths: dict, kernel, plain, single=None) -> tuple:
    """K2 (or K2b) on every input the closed loops gave it (``paths``:
    {path: recorded (cost, gamma, half_K, eta_u, eta_l) calls}): each call
    held to the plain version at WEIGHTS_ATOL / SUM_TOL (``plain`` on all of
    a path's calls at once, each seed searched alone; a batched kernel also
    to one ``single`` launch per seed, exactly), each path's
    beta-round histogram (``_round_histogram``), each call timed (median of
    5 single calls, and 10 replayed from a graph); the slowest replayed
    call timed again with TIMED_CALLS single calls and 20 replayed.
    Returns the closed-loop keys and the slowest input."""
    from m3p2i_aip_tpu_torch.ops import weights

    singles, replays, inputs = [], [], []
    for path, calls in paths.items():
        t0 = time.perf_counter()
        got = [torch.stack(w) for w in zip(*(kernel(*args) for args in calls))]  # 3 x [calls, (B,) K]
        # the plain version on every call at once: each leading index searches alone
        ref = plain(torch.stack([c for c, *_ in calls]), *calls[0][1:])
        err = max(float(torch.max(torch.abs(g - r))) for g, r in zip(got, ref))
        dev = max(float(torch.max(torch.abs(torch.sum(g, dim=-1) - 1.0))) for g in got)
        if single is not None:
            for n, args in enumerate(calls):
                for b in range(args[0].shape[0]):
                    for g, x in zip(got, single(args[0][b], *args[1:])):
                        assert torch.equal(g[n, b], x), f"{label} {path}: call {n} seed {b} differs from its single launch"
        t1 = time.perf_counter()
        for args in calls:
            singles.append(_time_ms(lambda: kernel(*args), calls=5, warmup=1))
            replays.append(_device_ms(lambda: kernel(*args), launches=10, reps=3))
            inputs.append(args)
        print(f"[closed-loop {label}] {path}: checked in {t1 - t0:.1f} s, timed in {time.perf_counter() - t1:.1f} s")
        serial = ", each seed equal to its single launch" if single is not None else ""
        print(f"[closed-loop {label}] {path}: {len(calls)} calls of {tuple(calls[0][0].shape)}: vs plain max err "
              f"{err:.3e}, max |sum - 1| {dev:.3e}{serial}")
        assert err <= WEIGHTS_ATOL and dev < SUM_TOL, f"{label} {path}: weights disagree with their plain version"
        _round_histogram(f"closed-loop {label}, {path}", calls)
    slowest = inputs[int(np.argmax(replays))]
    ms = _time_ms(lambda: kernel(*slowest))
    dev_ms = _device_ms(lambda: kernel(*slowest))
    cost = slowest[0]
    bound = roofline.weights_bound(slowest)
    most = weights.beta_rounds(*slowest)[0].reshape(-1, 3).max(0).tolist()
    print(f"[closed-loop {label}] slowest of {len(inputs)} recorded calls {tuple(cost.shape)} (most rounds per group "
          f"{most}): {ms:.4f} ms (median of {TIMED_CALLS}; {dev_ms:.4f} replayed from a graph), bound "
          f"{bound}; median over the recorded inputs {float(np.median(singles)):.4f} ms single, "
          f"{float(np.median(replays)):.4f} ms replayed ({card})")
    return {"closed_loop_ms": ms, "closed_loop_device_ms": dev_ms, "closed_loop_median_ms": float(np.median(singles)),
            "closed_loop_bound_ms": bound["bound_ms"]}, slowest


def phase_weights_random_inputs() -> tuple:
    """K2's and K2b's random inputs of the sweep: phase_weights' uniform(0,
    50) costs at the point planner's K=200 x T=15, and N_SEEDS seeds of
    them, with its discount, halves and eta bounds."""
    from m3p2i_aip_tpu_torch.config.config_store import load_config
    from m3p2i_aip_tpu_torch.tamp.reactive_tamp import ReactiveTAMP

    mp = ReactiveTAMP(load_config("config_point", MAIN_PATH), device="cuda", graphs=False).motion_planner
    rng = np.random.default_rng(0)
    cost = torch.as_tensor(rng.uniform(0, 50, size=(N_SEEDS + 1, mp.K, mp.T)).astype(np.float32), device="cuda")
    rest = (mp.gamma_seq, mp.half_K, mp.eta_u, mp.eta_l)
    return (cost[0].contiguous(),) + rest, (cost[1:].contiguous(),) + rest


def phase_weights_scaling(card: str, single_inputs: dict, batched_inputs: dict) -> None:
    """K2 at K in WEIGHTS_SCALING_K (the [K0, T] rows tiled, half_K = K / 2)
    and K2b at B in SCALING_B (the first B seeds), on each kind of input
    ({kind: recorded-style args}): the block's warps at each K, times single
    and replayed, after the kernel's registers."""
    from m3p2i_aip_tpu_torch.ops import cuda_build, weights

    src = (cuda_build.CSRC_DIR / "multimodal_weights.cu").read_text()
    consts = {n: int(v) for n, v in re.findall(r"constexpr int (\w+) = (\d+);", src)}
    m = re.search(r"for \S*multimodal_weights_kernel\S*\n\s*(\d+) bytes stack frame, (\d+) bytes spill stores[^\n]*"
                  r"\n[^\n]*?Used (\d+) registers", cuda_build.build_info["log"])
    assert m is not None, "the build log holds no ptxas report of multimodal_weights_kernel"
    print(f"[weights-scaling] K2: {consts['kCandidates']} candidate betas a step, {consts['kLanes']} lanes a parent "
          f"warp; {m.group(3)} registers, a {m.group(1)}-byte stack frame, {m.group(2)} bytes of spill stores ({card})")
    for kind, (cost, *rest) in single_inputs.items():
        for K in WEIGHTS_SCALING_K:
            x = cost.repeat(-(-K // cost.shape[0]), 1)[:K].contiguous()
            args = (x, rest[0], K // 2, *rest[2:])
            parent_warps = min(-(-K // 32), 32)
            team = min(-(-parent_warps * consts["kLanes"] // 32), consts["kMaxThreads"] // (32 * consts["kCandidates"]))
            print(f"[weights-scaling] {kind} K2 K={K} x T={x.shape[1]}: {_time_ms(lambda: weights.multimodal_weights(*args)):.4f}"
                  f" ms ({_device_ms(lambda: weights.multimodal_weights(*args)):.4f} replayed), "
                  f"{consts['kCandidates'] * team} warps, rounds {weights.beta_rounds(*args)[0].tolist()} ({card})")
    for kind, (cost, *rest) in batched_inputs.items():
        for B in SCALING_B:
            args = (cost[:B].contiguous(), *rest)
            print(f"[weights-scaling] {kind} K2b B={B} x K={cost.shape[1]} x T={cost.shape[2]}: "
                  f"{_time_ms(lambda: weights.multimodal_weights_batched(*args)):.4f} ms "
                  f"({_device_ms(lambda: weights.multimodal_weights_batched(*args)):.4f} replayed), most rounds "
                  f"{weights.beta_rounds(*args)[0].reshape(-1, 3).max(0).tolist()} ({card})")


def _point_random_inputs() -> tuple:
    """K1's and K1b's random-action inputs of the scaling sweep (few live
    contacts): one start with a friction draw at K=200 x T=15, and B=20
    seeds as the batched check makes them."""
    from dataclasses import replace

    from m3p2i_aip_tpu_torch.config.config_store import load_config
    from m3p2i_aip_tpu_torch.ops import rollout as ro
    from m3p2i_aip_tpu_torch.tamp.reactive_tamp import ReactiveTAMP
    from m3p2i_aip_tpu_torch.utils.tree import tree_map

    tamp = ReactiveTAMP(load_config("config_point", MAIN_PATH), device="cuda", graphs=False)
    env, spec = tamp.env, tamp.motion_planner.rollout.spec
    rng = np.random.default_rng(13)
    state = replace(env.init_state(), q=torch.tensor(STARTS[0][0], device="cuda"),
                    qd=torch.tensor(STARTS[0][1], device="cuda"))
    sk = tree_map(lambda x: x.expand((spec.K,) + x.shape), state)
    fric = rng.uniform(0.7, 1.3, size=(spec.K, state.fric_scale.shape[0])).astype(np.float32)
    sk = replace(sk, fric_scale=torch.as_tensor(fric, device="cuda"))
    acts = torch.as_tensor(rng.uniform(-3, 3, size=(spec.K, spec.T, env.nu)).astype(np.float32), device="cuda")
    single = (spec, ro.rollout_inputs(sk, tamp.tamp_interface_view(env.view(state))) + (acts,))
    return single, (spec, _point_batch_inputs(tamp, max(SCALING_B), rng))


def phase_rollout_scaling(card: str, names: tuple, shape: dict, kernel, batched, inputs: dict,
                          ks: tuple = SCALING_K) -> None:
    """A team rollout kernel (``names[0]``, launch ``shape``) at K in ``ks``
    (the recorded samples tiled, so each K is a multiple of theirs) and its
    batched call (``names[1]``) at B in SCALING_B (the first B seeds), on
    each kind of input in ``inputs`` ({kind: ((spec, single inputs), (spec,
    batched inputs))}): kernel times only (CUDA events, medians of
    TIMED_CALLS single calls, and replayed from a graph), each with its
    blocks and waves, after the kernel's team width, registers and spills."""
    from dataclasses import replace

    print(f"[rollout-scaling] {names[0]}: team {shape['team']} lanes a sample, {shape['threads']} threads "
          f"({shape['samples']} samples) a block, {shape['registers']} registers, a {shape['stack']}-byte stack frame "
          f"and {shape['spill']} bytes of spill stores a thread, {shape['per_wave']} blocks a wave ({card})")
    for kind, ((sp, x), (sp_b, xb)) in inputs.items():
        for K in ks:
            n = K // x[-1].shape[0]
            tiled = tuple(v.repeat(n, *[1] * (v.dim() - 1)) if v.dim() > 1 else v for v in x)  # the per-sample rows
            ms = _time_ms(lambda: kernel(replace(sp, K=K), *tiled))
            dev_ms = _device_ms(lambda: kernel(replace(sp, K=K), *tiled))
            blocks = -(-K // shape["samples"])
            print(f"[rollout-scaling] {kind} {names[0]} K={K} x T={sp.T}: {ms:.4f} ms ({dev_ms:.4f} replayed), "
                  f"{blocks} blocks, {-(-blocks // shape['per_wave'])} wave(s) ({card})")
        for B in SCALING_B:
            ms = _time_ms(lambda: batched(sp_b, *(v[:B] for v in xb)))
            dev_ms = _device_ms(lambda: batched(sp_b, *(v[:B] for v in xb)))
            blocks = B * -(-sp_b.K // shape["samples"])
            print(f"[rollout-scaling] {kind} {names[1]} B={B} x K={sp_b.K} x T={sp_b.T}: {ms:.4f} ms ({dev_ms:.4f} "
                  f"replayed), {blocks} blocks, {-(-blocks // shape['per_wave'])} wave(s) ({card})")


def phase_main_path(cfg) -> tuple:
    """The main path with both gates on: the box must reach the goal, and
    K1, K2 and the real-env step's K5 must launch once per dispatched tick,
    every other kernel never.  Returns the loop, the launch counts and K1's
    recorded inputs."""
    from m3p2i_aip_tpu_torch.ops import rollout as ro
    from m3p2i_aip_tpu_torch.tamp.sim_loop import SimLoop

    loop = SimLoop(cfg, device="cuda", graphs=False)
    _compiled_steps(loop, "warmup", 50)
    dispatched = 0
    run_chunk = loop.tamp.run_chunk

    def counted_run_chunk(ms, rs, task, i0, length):
        nonlocal dispatched
        dispatched += length
        return run_chunk(ms, rs, task, i0, length)

    loop.tamp.run_chunk = counted_run_chunk
    outputs = graph_ab.record_chunks(loop)
    _zero_launches()
    t0 = time.perf_counter()
    with _recorded(ro, "point_rollout") as calls:
        log = loop.run_chunked(1000, chunk=50)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _read_launches()
    EAGER_RUNS["point gated"] = graph_ab.loop_record(loop, outputs)
    loop.tamp.run_chunk = run_chunk
    print(f"[main] {log.steps} ticks logged, {dispatched} dispatched in {wall:.2f} s")
    assert dispatched > 0
    _expect_launches("main", counts, {name: dispatched for name in ("rollout_launches", "weights_launches",
                                                                     "step_launches")})
    launches = {KERNEL_OF_COUNTER[name]: n for name, n in counts.items()}
    robot, box = np.asarray(log.robot_pos), np.asarray(log.box_pos)
    assert np.isfinite(robot).all() and np.isfinite(box).all(), "non-finite positions"
    assert np.abs(box).max() <= 3.8, f"box tunnelled: max |coord| {np.abs(box).max()}"
    goal = np.asarray(cfg.goal, dtype=np.float32)
    final = float(np.linalg.norm(box[-1] - goal))
    print(f"[main] success tick {log.success_step}, final box-to-goal distance {final:.4f} m")
    assert log.success_step is not None and final <= 0.1, "the box did not reach the goal"
    return loop, launches, calls


def _graph_of(fn) -> torch.cuda.CUDAGraph:
    """``fn`` captured once into a CUDA graph, warmed up off the capture as
    ``bench_record.replayed_ms`` does."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    return graph


def phase_point_step(card: str, calls: list, k1_call) -> tuple:
    """K5 and K5b, the point family's real-env step, on the inputs the
    closed loops gave them (``calls``, recorded by ``_recorded_steps``: the
    main path's single states and the n=20 batch's [20] states, D = 2 and
    S = 5, with their warm-ups' steps): each call run again through the
    wrapper and held to ``point_env.step`` on the same inputs, every field
    bit for bit.  Then the last call of each layout timed single (CUDA
    events, median of TIMED_CALLS: the host's time to issue it, where the
    kernel is shorter) and replayed from a CUDA graph, beside the plain step
    (median of 5), with its bound: the scene constants and each operand read
    once and each output written once, against the step's operations
    (``roofline.point_step_ops``, and a projection for each live contact).
    Then K1's device time a launch beside each step: a graph of [step, K1]
    on the main path's inputs replayed STEP_NEIGHBOUR_REPLAYS times under
    the profiler, K5 and the plain step in turns.  Returns the kernel
    table's entries of K5 and K5b."""
    from m3p2i_aip_tpu_torch.ops import rollout as ro

    layouts = {"point_step": [c for c in calls if c[2].q.dim() == 1],
               "point_step_batched": [c for c in calls if c[2].q.dim() > 1]}
    entries = {}
    for name, group in layouts.items():
        assert group, f"{name}: no recorded call"
        for n, (params, buf, state, u, ext) in enumerate(group):
            got, ref = ps.point_step(params, buf, state, u, ext), point_env.step(params, state, u, ext)
            for f in dataclasses.fields(ref):
                a, b = getattr(got, f.name), getattr(ref, f.name)
                assert a.shape == b.shape and torch.equal(a.contiguous().view(torch.int32),
                                                          b.contiguous().view(torch.int32)), (
                    f"{name} call {n} of {len(group)}: {f.name} differs from the plain step by "
                    f"{float((a - b).abs().max())}")
        params, buf, state, u, ext = group[-1]
        B, D, S = int(np.prod(state.q.shape[:-1])), params.dyn_half.shape[0], params.stat_pos.shape[0]
        step = lambda: ps.point_step(params, buf, state, u, ext)  # noqa: E731
        ms, dev_ms = _time_ms(step), _device_ms(step)
        with roofline.live_contacts() as live:
            plain = point_env.step(params, state, u, ext)
        plain_ms = _time_ms(lambda: point_env.step(params, state, u, ext), calls=5, warmup=1)
        outputs = [getattr(plain, f) for f in ps.OUTPUTS]
        operands = [getattr(state, f) for f in ps.INPUTS[:7]] + [u, ext.robot, ext.dyn]
        n_live = roofline.total(live)
        bound = roofline.bound(roofline.tensor_bytes(buf, *operands, *outputs),
                               B * roofline.point_step_ops(params, D, S) + roofline.RESOLVE_OPS * n_live)
        print(f"[{name}] {len(group)} recorded calls at B={B}, D={D}, S={S} ({params.robot_type}): every field bit "
              f"for bit the plain step's; the last call ({n_live} live contacts): kernel {ms:.4f} ms single (median "
              f"of {TIMED_CALLS}), {dev_ms:.4f} ms replayed, plain {plain_ms:.4f} ms (median of 5); bound {bound} "
              f"({card})")
        entries[name] = {"max_abs_err": 0.0, "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms, **bound,
                         "library_ms": None, "calls_checked": len(group)}

    spec, k1_inputs = k1_call
    params, buf, state, u, ext = layouts["point_step"][-1]
    steps = {"K5": lambda: ps.point_step(params, buf, state, u, ext),
             "plain step": lambda: point_env.step(params, state, u, ext)}
    k1_ms: dict = {}
    for before in ("K5", "plain step", "plain step", "K5"):
        graph = _graph_of(lambda: (steps[before](), ro.point_rollout(spec, *k1_inputs)))
        prof = bench_record.profile(lambda: [graph.replay() for _ in range(STEP_NEIGHBOUR_REPLAYS)],
                                    STEP_NEIGHBOUR_REPLAYS, {"K1": "point_rollout_kernel"})
        assert prof is not None, f"K1 beside {before}: the profiler saw no device kernel"
        traced = prof["traced_launches"]["point_rollout_kernel"]
        assert traced > 0, f"K1 beside {before}: no K1 event traced"
        k1_ms.setdefault(before, []).append(prof["kernel_ms_per_tick"]["K1"] * STEP_NEIGHBOUR_REPLAYS / traced)
        del graph
    print("[K1 beside the step] K1's device ms a launch in a replayed [step, K1] graph, profiled, in turns: " + "; ".join(
        f"after {before} {', '.join(f'{t:.4f}' for t in ts)}" for before, ts in k1_ms.items()) + f" ({card})")
    return entries["point_step"], entries["point_step_batched"]


def phase_panda_step(card: str, calls: list) -> tuple:
    """K6 and K6b, the panda's real-env step, on the inputs the closed loops
    gave them (``calls``, recorded by ``_recorded_steps``: the panda main
    path's single states and the n=20 panda batch's [20] states): each
    single call run again through the wrapper and held to
    ``panda_env.step`` on the same inputs, every field bit for bit; each
    batched call held to one single launch a state, and every
    PANDA_STEP_PLAIN_EVERY-th to the plain step of each state alone, bit for
    bit (cuBLAS forms some 3x3 products of a batch in another order than
    one state's, tests/test_torch_cuda.py, so the batched plain step is not
    the reference).  Then the last call of each layout timed single (CUDA
    events, median of TIMED_CALLS: the host's time to issue it, where the
    kernel is shorter) and replayed from a CUDA graph, beside the plain step
    (median of 5), with its bound: the scene constants and each operand read
    once and each output written once, against ``roofline.panda_step_ops``.
    Returns the kernel table's entries of K6 and K6b."""
    from m3p2i_aip_tpu_torch.models import panda_env
    from m3p2i_aip_tpu_torch.utils.tree import tree_map

    def same(got, ref, what: str) -> None:
        for f in dataclasses.fields(ref):
            a, b = getattr(got, f.name), getattr(ref, f.name)
            assert a.shape == b.shape and torch.equal(a.contiguous().view(torch.int32),
                                                      b.contiguous().view(torch.int32)), (
                f"{what}: {f.name} differs by {float((a - b).abs().max())}")

    layouts = {"panda_step": [c for c in calls if c[2].q.dim() == 1],
               "panda_step_batched": [c for c in calls if c[2].q.dim() > 1]}
    entries = {}
    for name, group in layouts.items():
        assert group, f"{name}: no recorded call"
        plain_checked = 0
        for n, (params, buf, state, u, ext) in enumerate(group):
            got = pps.panda_step(params, buf, state, u, ext)
            if state.q.dim() == 1:
                same(got, panda_env.step(params, state, u, ext), f"{name} call {n} of {len(group)}")
                plain_checked += 1
                continue
            for b in range(state.q.shape[0]):
                row = lambda x: x[b]  # noqa: E731
                args = (tree_map(row, state), u[b], tree_map(row, ext))
                same(tree_map(row, got), pps.panda_step(params, buf, *args), f"{name} call {n} state {b}: single")
                if n % PANDA_STEP_PLAIN_EVERY == 0:
                    same(tree_map(row, got), panda_env.step(params, *args), f"{name} call {n} state {b}: plain")
            plain_checked += n % PANDA_STEP_PLAIN_EVERY == 0
        params, buf, state, u, ext = group[-1]
        B, S = int(np.prod(state.q.shape[:-1])), params.stat_min.shape[0]
        step = lambda: pps.panda_step(params, buf, state, u, ext)  # noqa: E731
        ms, dev_ms = _time_ms(step), _device_ms(step)
        plain = panda_env.step(params, state, u, ext)
        plain_ms = _time_ms(lambda: panda_env.step(params, state, u, ext), calls=5, warmup=1)
        operands = [getattr(state, f) for f in pps.INPUTS[:9]] + [u, ext.body]
        outputs = [getattr(plain, f) for f in pps.OUTPUTS]
        bound = roofline.bound(roofline.tensor_bytes(buf, *operands, *outputs), B * roofline.panda_step_ops(params, S))
        print(f"[{name}] {len(group)} recorded calls at B={B}, S={S}: every field bit for bit the plain step's "
              f"({plain_checked} calls against the plain step, the rest against single launches); the last call: "
              f"kernel {ms:.4f} ms single (median of {TIMED_CALLS}), {dev_ms:.4f} ms replayed, plain {plain_ms:.4f} "
              f"ms (median of 5); bound {bound} ({card})")
        entries[name] = {"max_abs_err": 0.0, "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms, **bound,
                         "library_ms": None, "calls_checked": len(group)}
    return entries["panda_step"], entries["panda_step_batched"]


def _rate_line(rate: dict) -> str:
    """A twin's rate with its per-chunk spread."""
    return (f"{rate['value']:.2f} Hz replan+step (chunks: median {rate['chunk_hz_median']:.2f}, quartiles "
            f"{rate['chunk_hz_q1']:.2f} / {rate['chunk_hz_q3']:.2f}, {rate['chunk_clock']})")


def phase_panda_rollout() -> tuple:
    """K3 against its plain version at K=200, T=12 (config_panda physics),
    from the seven parity starts, for multi_modal False and True; in the
    multi-modal scene also K2 against its plain version on each case's K3
    cost horizon, with the panda planner's discount, halves and eta bounds
    (the shape and cost scale the shelf and benchmark paths give K2).
    Returns K3's stats, K2's error and the timed (first) input."""
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
        tamp = ReactiveTAMP(load_config("config_panda", [f"multi_modal={mm}"]), device="cuda", graphs=False)
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
    dev_ms = _device_ms(lambda: pr.panda_rollout(spec, *inputs, acts))
    plain_ms = _time_ms(lambda: pr.panda_rollout_plain(spec, *inputs, acts), calls=10, warmup=2)
    w_ms = _time_ms(lambda: weights.multimodal_weights(*w_timed))
    K, T = acts.shape[:2]
    bound = roofline.rollout_bound(spec, inputs + (acts,), K, roofline.panda_rollout_ops(spec, K))
    print(f"[panda-rollout] max cost err {cost_err:.3e}, max traj err {traj_err:.3e}")
    print(f"[panda-rollout] kernel {ms:.4f} ms (median of {TIMED_CALLS}; {dev_ms:.4f} replayed from a graph), plain "
          f"{plain_ms:.4f} ms (median of 10); bound {bound}")
    print(f"[panda-weights] max err {w_err:.3e}; kernel {w_ms:.4f} ms at K=200 x T=12 (median of {TIMED_CALLS})")
    stats = {"max_abs_err": cost_err, "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms, **bound, "library_ms": None}
    return stats, w_err, (spec, inputs + (acts,))


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


def _count_chunk_views(loop) -> list:
    """Wrap the loop's chunk entry to record each chunk's length and views
    (read after the run, not inside it)."""
    record, run_chunk = [], loop.tamp.run_chunk

    def counted(ms, rs, task, i0, length):
        out = run_chunk(ms, rs, task, i0, length)
        record.append((length, out[2]))
        return out

    loop.tamp.run_chunk = counted
    return record


def phase_panda_main() -> tuple:
    """The panda main path: ``config_panda`` (reactive_pick, cube on the
    table, single mode) through ``SimLoop.run_chunked`` in chunks of 50.  The
    cube must be grasped, success must latch within PANDA_TICKS, K3 must
    launch 1 + refine_iters times and K6 once per dispatched tick.  Returns
    K3's launch count, its recorded inputs, the success tick and K6's launch
    count."""
    from m3p2i_aip_tpu_torch.config.config_store import load_config
    from m3p2i_aip_tpu_torch.ops import panda_rollout as pr
    from m3p2i_aip_tpu_torch.ops import weights
    from m3p2i_aip_tpu_torch.ops.quat_np import general_ori_cube2goal
    from m3p2i_aip_tpu_torch.tamp.sim_loop import SimLoop

    cfg = load_config("config_panda")
    loop = SimLoop(cfg, device="cuda", graphs=False)
    _compiled_steps(loop, "warmup", 50)
    record = _count_panda_ticks(loop)
    outputs = graph_ab.record_chunks(loop)
    per_tick = 1 + int(cfg.mppi.refine_iters)
    pr.panda_rollout_launches = 0
    weights.weights_launches = 0
    pps.panda_step_launches = 0
    t0 = time.perf_counter()
    with _recorded(pr, "panda_rollout") as calls:
        log = loop.run_chunked(PANDA_TICKS, chunk=50)
    wall = time.perf_counter() - t0
    EAGER_RUNS["panda gated"] = graph_ab.loop_record(loop, outputs)
    launches, step_launches = pr.panda_rollout_launches, pps.panda_step_launches
    dispatched = sum(n for n, _ in record)
    views = torch.cat([v for _, v in record]).cpu().numpy()
    print(
        f"[panda-main] {log.steps} ticks logged, {dispatched} dispatched in {wall:.2f} s; "
        f"panda_rollout launches {launches}, multimodal_weights launches {weights.weights_launches}, "
        f"panda_step launches {step_launches}"
    )
    assert launches == per_tick * dispatched, f"panda_rollout: {launches} launches for {dispatched} ticks"
    assert step_launches == dispatched, f"panda_step: {step_launches} launches for {dispatched} ticks"
    assert weights.weights_launches == 0, "the single-mode panda path launched the weights kernel"
    assert np.isfinite(views).all(), "non-finite panda views"
    grasped = np.nonzero(views[:, 21] > 0.5)[0]
    print(f"[panda-main] first grasped tick {grasped[0] if grasped.size else None}; stages {sorted(set(log.task))}")
    assert grasped.size > 0, "the cube was never grasped"
    assert log.success_step is not None, "the panda pick-place did not latch success"
    _compiled_steps(loop, "settle", 150)
    view = loop._view
    pos_err = float(np.linalg.norm(view["cube_state"][:2] - view["cube_goal"][:2]))
    ori_err = float(general_ori_cube2goal(view["cube_state"][3:], view["cube_goal"][3:]))
    print(f"[panda-main] success tick {log.success_step}; settled cube error: pos {pos_err:.4f} m, ori {ori_err:.4f}")
    return launches, calls, log.success_step, step_launches


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
    loop = SimLoop(cfg, device="cuda", graphs=False)
    _compiled_steps(loop, "warmup", 50)
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


def phase_albert_rollout(card: str) -> tuple:
    """K4 against its plain version at K=128 x T=12 (config_albert physics)
    on the five starts and tasks of ``albert_rollout.PARITY_CASES``, each
    call launching the kernel once.  Returns K4's stats and the timed
    (first) input."""
    from m3p2i_aip_tpu_torch.config.config_store import load_config
    from m3p2i_aip_tpu_torch.ops import albert_rollout as ar
    from m3p2i_aip_tpu_torch.planners.motion_planner.mppi import make_task_params
    from m3p2i_aip_tpu_torch.tamp.reactive_tamp import ReactiveTAMP
    from m3p2i_aip_tpu_torch.utils.tree import tree_map

    tamp = ReactiveTAMP(load_config("config_albert"), device="cuda", graphs=False)
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
    dev_ms = _device_ms(lambda: ar.albert_rollout(spec, *inputs, acts))
    plain_ms = _time_ms(lambda: ar.albert_rollout_plain(spec, *inputs, acts), calls=10, warmup=2)
    bound = roofline.rollout_bound(spec, inputs + (acts,), K, roofline.albert_rollout_ops(spec, K))
    print(f"[albert-rollout] max cost err {cost_err:.3e}, max traj err {traj_err:.3e}")
    print(f"[albert-rollout] kernel {ms:.4f} ms (median of {TIMED_CALLS}; {dev_ms:.4f} replayed from a graph), plain "
          f"{plain_ms:.4f} ms (median of 10); bound {bound}")
    # the time against K, and the launch floor: an empty kernel timed the same two ways
    for k in (8, 32, K):
        x = acts[:k].contiguous()
        print(f"[albert-rollout] K4 at K={k} x T={T}: {_time_ms(lambda: ar.albert_rollout(spec, *inputs, x)):.4f} ms "
              f"single, {_device_ms(lambda: ar.albert_rollout(spec, *inputs, x)):.4f} ms replayed from a graph ({card})")
    print(f"[albert-rollout] an empty kernel (torch.cuda._sleep(0)): {_time_ms(lambda: torch.cuda._sleep(0)):.4f} ms "
          f"single, {_device_ms(lambda: torch.cuda._sleep(0)):.4f} ms replayed from a graph ({card})")
    stats = {"max_abs_err": max(cost_err, traj_err), "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms, **bound,
             "library_ms": None}
    return stats, (spec, inputs + (acts,))


def _albert_gated_run(label: str, overrides: list, n_ticks: int, keep: str = None):
    """One gated albert run through ``run_chunked(n_ticks, chunk=10)`` with
    the launch counts set to 0 just before and read just after: K4 launched
    1 + refine_iters times per dispatched tick, K2 never, every view finite,
    success latched.  The chunk entry records each chunk's length and views
    (read after the run, not inside it); ``keep`` names the run's record in
    EAGER_RUNS.  Returns (cfg, views, log, K4 launches)."""
    from m3p2i_aip_tpu_torch.config.config_store import load_config
    from m3p2i_aip_tpu_torch.ops import albert_rollout as ar
    from m3p2i_aip_tpu_torch.ops import weights
    from m3p2i_aip_tpu_torch.tamp.sim_loop import SimLoop

    cfg = load_config("config_albert", overrides)
    loop = SimLoop(cfg, device="cuda", graphs=False)
    _compiled_steps(loop, "warmup", 20)
    record = _count_chunk_views(loop)
    outputs = graph_ab.record_chunks(loop) if keep is not None else None
    view0 = loop.env.view_vec(loop.state).cpu().numpy()
    ar.albert_rollout_launches = 0
    weights.weights_launches = 0
    t0 = time.perf_counter()
    log = loop.run_chunked(n_ticks, chunk=10)
    wall = time.perf_counter() - t0
    if keep is not None:
        EAGER_RUNS[keep] = graph_ab.loop_record(loop, outputs)
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
    cfg, views, log, _ = _albert_gated_run("albert-push", PUSH_REACH, PUSH_REACH_TICKS, keep="albert push_reach")
    goal = np.asarray(cfg.goal, np.float32)[:2]
    d0, d1 = (float(np.linalg.norm(views[i, 9:11] - goal)) for i in (0, -1))
    hover = float(np.linalg.norm(views[-1, 6:9] - np.r_[views[-1, 9:11], cfg.goal[2]]))
    print(f"[albert-push] box-to-goal {d0:.3f} -> {d1:.4f} m; ee hover error at success {hover:.4f} m")
    assert d1 < d0 and d1 <= 0.1 + 1e-6, "the box did not reach the goal"


def _profile_ticks(label: str, card: str, run, n: int, kernels: dict) -> None:
    """``bench_record.profile`` over ``run()``, a chunk of n ticks, printed:
    device kernels and device time a tick, the time a tick of each kernel in
    ``kernels`` ({label: a substring of its name}), the profiled wall a tick
    and the device's idle share."""
    p = bench_record.profile(run, n, kernels)
    if p is None:
        print(f"[{label}] torch.profiler recorded no device kernels: device time not measured")
        return
    parts = ", ".join(f"{k} {ms:.3f} ms" for k, ms in p["kernel_ms_per_tick"].items())
    print(f"[{label}] profiler over {n} ticks: {p['kernels_per_tick']:.0f} device kernels a tick, "
          f"{p['device_ms_per_tick']:.3f} ms device time a tick ({parts}), profiled wall {p['wall_ms_per_tick']:.3f} "
          f"ms a tick, device idle {p['idle_pct']:.1f}% ({card})")


def phase_albert_breakdown(card: str) -> None:
    """One benchmark-mode push_reach tick in pieces: medians of 10 calls on
    the host clock with a synchronize (the real-env step on one state, the
    planner with its four K4 launches, the view, a whole tick, a 20-tick
    chunk per tick), then ``torch.profiler`` over a 20-tick chunk: device
    kernels per tick, device time per tick, K4's share, the idle share."""
    from m3p2i_aip_tpu_torch.config.config_store import load_config
    from m3p2i_aip_tpu_torch.tamp.sim_loop import SimLoop

    loop = SimLoop(load_config("config_albert", PUSH_REACH), device="cuda", graphs=False)
    _compiled_steps(loop, "warmup", 20)
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

    _profile_ticks("albert-breakdown", card, lambda: tamp._run_chunk_impl(ms, rs, task, 0, 20, gate=False), 20,
                   {"K4": "albert_rollout"})


# ------------------------------------------------------------------------
# batched seed evaluation: K1b-K4b and BatchSimLoop

def _launch_counters() -> list:
    """(module, attribute) of every kernel wrapper's launch count."""
    return list(bench_record.launch_counters().values())


class _EnvSteps:
    """The steps that point-family and panda envs on the card were asked for
    since ``_zero_launches``, for one state and for a batch, counted by the
    env's step function (``_count_env_steps``) apart from the kernels'
    launch counts: ``_read_launches`` holds K5 / K5b and K6 / K6b to one
    launch a step."""

    env_steps = 0
    env_batched_steps = 0
    panda_env_steps = 0
    panda_env_batched_steps = 0


STEP_OF_COUNTER = {"step_launches": "env_steps", "step_batched_launches": "env_batched_steps",
                   "panda_step_launches": "panda_env_steps", "panda_step_batched_launches": "panda_env_batched_steps"}


def _count_env_steps() -> None:
    """From here on, count in ``_EnvSteps`` every step asked of a
    point-family or panda env on the card: the step functions ``envs.py``
    makes (``point_step.make_step``, ``panda_step.make_step``) are wrapped
    at each env's making, and the counts join the launch counts
    ``graph_tick`` takes around a capture, so a replayed graph adds the steps
    it captured, times its replays, as it adds its launches."""
    launch_counts = graph_tick._launch_counts

    def counting(mod, prefix: str) -> None:
        make_step = mod.make_step

        def counting_make_step(params):
            step = make_step(params)
            if params.device.type != "cuda":
                return step

            def counted(state, u, ext):
                name = f"{prefix}env_batched_steps" if state.q.dim() > 1 else f"{prefix}env_steps"
                setattr(_EnvSteps, name, getattr(_EnvSteps, name) + 1)
                return step(state, u, ext)

            return counted

        mod.make_step = counting_make_step

    counting(ps, "")
    counting(pps, "panda_")
    graph_tick._launch_counts = lambda: {
        **launch_counts(), **{(_EnvSteps, name): getattr(_EnvSteps, name) for name in STEP_OF_COUNTER.values()},
    }


KERNEL_OF_COUNTER = {
    "rollout_launches": "point_rollout", "rollout_batched_launches": "point_rollout_batched",
    "weights_launches": "multimodal_weights", "weights_batched_launches": "multimodal_weights_batched",
    "panda_rollout_launches": "panda_rollout", "panda_rollout_batched_launches": "panda_rollout_batched",
    "albert_rollout_launches": "albert_rollout", "albert_rollout_batched_launches": "albert_rollout_batched",
    "step_launches": "point_step", "step_batched_launches": "point_step_batched",
    "panda_step_launches": "panda_step", "panda_step_batched_launches": "panda_step_batched",
}


def _zero_launches() -> None:
    for mod, name in _launch_counters():
        setattr(mod, name, 0)
    for name in STEP_OF_COUNTER.values():
        setattr(_EnvSteps, name, 0)
    graph_tick.replayed_launches.clear()


def _read_launches() -> dict:
    """Every kernel's launches since ``_zero_launches``, by wrapper count:
    those its wrapper made plus those graph replays made (captured launches
    x replays, ``graph_tick.replayed_launches``).  K5 and K5b (K6 and K6b)
    must have launched exactly once for each step of a point-family (panda)
    env on the card since then, one state and a batch (``_EnvSteps``,
    replays included)."""
    counts = {name: getattr(mod, name) + graph_tick.replayed_launches.get(name, 0) for mod, name in _launch_counters()}
    for counter, name in STEP_OF_COUNTER.items():
        steps = getattr(_EnvSteps, name) + graph_tick.replayed_launches.get(name, 0)
        assert counts[counter] == steps, f"{counter}: {counts[counter]} launches for {steps} env steps on the card"
    return counts


def _read_replayed() -> dict:
    """The part of ``_read_launches`` that graph replays made, by kernel:
    the smoke's ``kernels`` line reports it as ``graph_launches``, apart from
    the launches the wrappers counted (``phase_graphs`` holds it to the
    profiler's kernel events)."""
    return {KERNEL_OF_COUNTER[name]: n for name, n in graph_tick.replayed_launches.items()
            if n and name in KERNEL_OF_COUNTER}  # not the env steps


def _add_launches(launches: dict, graph_launches: dict, counts: dict, replayed: dict) -> None:
    """Add a phase's launches by kernel (``counts``, replays included) to the
    wrapper-counted ``launches`` and its replayed part to ``graph_launches``."""
    for name, n in counts.items():
        launches[name] += n - replayed.get(name, 0)
    for name, n in replayed.items():
        graph_launches[name] = graph_launches.get(name, 0) + n


def _stack_rows(rows, acts) -> tuple:
    """One batched input tuple from B single-seed (task_vec, state0, ...) rows."""
    return tuple(torch.stack(xs) for xs in zip(*rows)) + (acts,)


def _batched_check(label: str, batched, plain, single, inputs, cost_atol: float, traj_atol: float) -> float:
    """A batched rollout kernel against its batched plain version (at the
    single kernel's bars) and against one single launch per seed on the
    same inputs (at SERIAL_ATOL); returns the max error against plain."""
    c_k, t_k = batched(*inputs)
    c_p, t_p = plain(*inputs)
    torch.cuda.synchronize()
    ce = float(torch.max(torch.abs(c_k - c_p)))
    te = float(torch.max(torch.abs(t_k - t_p)))
    se = 0.0
    for b in range(c_k.shape[0]):
        c_s, t_s = single(*(x[b] for x in inputs))
        se = max(se, float(torch.max(torch.abs(c_k[b] - c_s))), float(torch.max(torch.abs(t_k[b] - t_s))))
    print(f"[{label}] B={c_k.shape[0]}: vs plain cost err {ce:.3e}, traj err {te:.3e}; "
          f"vs {c_k.shape[0]} single launches max err {se:.3e}")
    assert torch.isfinite(c_k).all() and torch.isfinite(t_k).all()
    assert ce <= cost_atol and te <= traj_atol, f"{label}: batched kernel disagrees with its plain version"
    assert se <= SERIAL_ATOL, f"{label}: batched kernel disagrees with its single kernel: {se}"
    return max(ce, te)


def _batched_weights_check(mp, cost, label: str) -> float:
    """K2b against its plain version and against one K2 launch per seed on
    [B, K, T] costs; returns the max error against plain."""
    from m3p2i_aip_tpu_torch.ops import weights

    args = (cost, mp.gamma_seq, mp.half_K, mp.eta_u, mp.eta_l)
    got = weights.multimodal_weights_batched(*args)
    ref = weights.multimodal_weights_batched_plain(*args)
    torch.cuda.synchronize()
    err = max(float(torch.max(torch.abs(g - r))) for g, r in zip(got, ref))
    sums = max(float(torch.max(torch.abs(torch.sum(g, dim=-1) - 1.0))) for g in got)
    se = 0.0
    for b in range(cost.shape[0]):
        single = weights.multimodal_weights(cost[b].contiguous(), *args[1:])
        se = max(se, *(float(torch.max(torch.abs(g[b] - s))) for g, s in zip(got, single)))
    print(f"[{label}] B={cost.shape[0]}: vs plain max err {err:.3e}, max |sum - 1| {sums:.3e}; "
          f"vs single launches {se:.3e}")
    assert err <= WEIGHTS_ATOL and sums < SUM_TOL, f"{label}: batched weights disagree with their plain version"
    assert se <= SERIAL_ATOL, f"{label}: batched weights disagree with the single kernel: {se}"
    return err


def _time_batched(label: str, kernel, plain, inputs, bound: dict, plain_calls: int) -> dict:
    """Kernel and plain-version times at the inputs' width, beside ``bound``."""
    ms = _time_ms(lambda: kernel(*inputs))
    dev_ms = _device_ms(lambda: kernel(*inputs))
    plain_ms = _time_ms(lambda: plain(*inputs), calls=plain_calls, warmup=0)
    print(f"[{label}] kernel {ms:.4f} ms (median of {TIMED_CALLS}; {dev_ms:.4f} replayed from a graph), plain {plain_ms:.4f} "
          f"ms (median of {plain_calls}); bound {bound}")
    return {"ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms, **bound, "library_ms": None}


def _point_batch_inputs(tamp, B: int, rng) -> tuple:
    """K1b inputs of B seeds at the planner's K x T: seed b starts from
    STARTS[b % 6] with its own per-sample friction draw and runs
    POINT_TASKS[b % 4]."""
    from dataclasses import replace

    from m3p2i_aip_tpu_torch.ops import rollout as ro
    from m3p2i_aip_tpu_torch.planners.motion_planner.mppi import make_task_params
    from m3p2i_aip_tpu_torch.utils.tree import tree_map

    mp, env = tamp.motion_planner, tamp.env
    rows = []
    for b in range(B):
        entry = STARTS[b % len(STARTS)]
        state = replace(env.init_state(), q=torch.tensor(entry[0], device="cuda"), qd=torch.tensor(entry[1], device="cuda"))
        if len(entry) == 3:
            pos = state.dyn_pos.clone()
            pos[env.box_slot] = torch.tensor(entry[2], device="cuda")
            state = replace(state, dyn_pos=pos)
        sk = tree_map(lambda x: x.expand((mp.K,) + x.shape), state)
        fric = rng.uniform(0.7, 1.3, size=(mp.K, state.fric_scale.shape[0])).astype(np.float32)
        sk = replace(sk, fric_scale=torch.as_tensor(fric, device="cuda"))
        name, goal = POINT_TASKS[b % len(POINT_TASKS)]
        rows.append(ro.rollout_inputs(sk, make_task_params(name, goal, device="cuda")))
    acts = torch.as_tensor(rng.uniform(-3, 3, size=(B, mp.K, mp.T, env.nu)).astype(np.float32), device="cuda")
    return _stack_rows(rows, acts)


def phase_point_batched() -> tuple:
    """K1b and K2b at the point main path's K=200 x T=15: against their
    plain versions and single launches on CHECK_SEEDS seeds, K1b also at
    B=N_SEEDS (counting its live contacts for the bound), then timed at
    B=N_SEEDS (K2b on K1b's own costs)."""
    from m3p2i_aip_tpu_torch.config.config_store import load_config
    from m3p2i_aip_tpu_torch.ops import rollout as ro
    from m3p2i_aip_tpu_torch.ops import weights
    from m3p2i_aip_tpu_torch.tamp.reactive_tamp import ReactiveTAMP

    tamp = ReactiveTAMP(load_config("config_point", MAIN_PATH), device="cuda", graphs=False)
    mp, spec = tamp.motion_planner, tamp.motion_planner.rollout.spec
    rng = np.random.default_rng(10)
    fns = (
        lambda *a: ro.point_rollout_batched(spec, *a),
        lambda *a: ro.point_rollout_batched_plain(spec, *a),
        lambda *a: ro.point_rollout(spec, *a),
    )
    inputs = _point_batch_inputs(tamp, CHECK_SEEDS, rng)
    k1b_err = _batched_check("point-batched K1b", *fns, inputs, COST_ATOL, TRAJ_ATOL)
    k2b_err = _batched_weights_check(mp, fns[0](*inputs)[0], "point-batched K2b")

    inputs = _point_batch_inputs(tamp, N_SEEDS, rng)
    B, K, T = inputs[-1].shape[:3]
    with roofline.live_contacts() as live:
        k1b_err = max(k1b_err, _batched_check("point-batched K1b", *fns, inputs, COST_ATOL, TRAJ_ATOL))
    k1b = _time_batched(
        f"point-batched K1b at B={B}", fns[0], fns[1], inputs,
        roofline.rollout_bound(spec, inputs, B * K, roofline.point_rollout_ops(spec, B * K, roofline.total(live))),
        plain_calls=1,
    )
    cost = fns[0](*inputs)[0]
    k2b_err = max(k2b_err, _batched_weights_check(mp, cost, f"point-batched K2b on K1b's B={B} costs"))
    args = (cost, mp.gamma_seq, mp.half_K, mp.eta_u, mp.eta_l)
    k2b = _time_batched(
        f"point-batched K2b at B={B}", weights.multimodal_weights_batched, weights.multimodal_weights_batched_plain,
        args, roofline.weights_bound(args), plain_calls=5,
    )
    return {"max_abs_err": k1b_err, **k1b}, {"max_abs_err": k2b_err, **k2b}


def phase_panda_batched() -> tuple:
    """K3b at the panda's K=200 x T=12 (multi-modal scene): seed b takes
    panda_rollout.PARITY_CASES[b % 7]; against its plain version and single
    launches on CHECK_SEEDS seeds (and K2b on their costs), then timed at
    B=N_SEEDS.  Returns (K3b stats, K2b error)."""
    from m3p2i_aip_tpu_torch.config.config_store import load_config
    from m3p2i_aip_tpu_torch.ops import panda_rollout as pr
    from m3p2i_aip_tpu_torch.planners.motion_planner.mppi import make_task_params
    from m3p2i_aip_tpu_torch.tamp.reactive_tamp import ReactiveTAMP
    from m3p2i_aip_tpu_torch.utils.tree import tree_map

    tamp = ReactiveTAMP(load_config("config_panda", ["multi_modal=True"]), device="cuda", graphs=False)
    mp, base = tamp.motion_planner, tamp.env.init_state()
    spec, K, T = mp.rollout.spec, mp.K, mp.T
    rng = np.random.default_rng(11)

    def inputs_of(B: int) -> tuple:
        rows, acts = [], []
        for b in range(B):
            name, start, task_name, grip, zup = pr.PARITY_CASES[b % len(pr.PARITY_CASES)]
            goal = pr.PARITY_GOAL if task_name == "pick" else [0.0] * 7
            sk = tree_map(lambda x: x.expand((K,) + x.shape), pr.parity_state(base, start))
            rows.append(pr.rollout_inputs(sk, make_task_params(task_name, goal, "none", zup, device="cuda")))
            a = rng.uniform(-1.5, 1.5, size=(K, T, 9)).astype(np.float32)
            if grip is not None:
                a[..., 7:9] = grip
            acts.append(a)
        return _stack_rows(rows, torch.as_tensor(np.stack(acts), device="cuda"))

    fns = (
        lambda *a: pr.panda_rollout_batched(spec, *a),
        lambda *a: pr.panda_rollout_batched_plain(spec, *a),
        lambda *a: pr.panda_rollout(spec, *a),
    )
    inputs = inputs_of(CHECK_SEEDS)
    err = _batched_check("panda-batched K3b", *fns, inputs, COST_ATOL, TRAJ_ATOL)
    w_err = _batched_weights_check(mp, fns[0](*inputs)[0], "panda-batched K2b")
    inputs = inputs_of(N_SEEDS)
    B = inputs[-1].shape[0]
    stats = _time_batched(
        f"panda-batched K3b at B={B}", fns[0], fns[1], inputs,
        roofline.rollout_bound(spec, inputs, B * K, roofline.panda_rollout_ops(spec, B * K)), plain_calls=1,
    )
    return {"max_abs_err": err, **stats}, w_err, (spec, inputs)


def phase_albert_batched() -> tuple:
    """K4b at the albert's K=128 x T=12: seed b takes
    albert_rollout.PARITY_CASES[b % 5]; against its plain version and single
    launches on CHECK_SEEDS seeds and at B=N_SEEDS, then timed at B=N_SEEDS.
    Returns K4b's stats and the B=N_SEEDS input."""
    from m3p2i_aip_tpu_torch.config.config_store import load_config
    from m3p2i_aip_tpu_torch.ops import albert_rollout as ar
    from m3p2i_aip_tpu_torch.planners.motion_planner.mppi import make_task_params
    from m3p2i_aip_tpu_torch.tamp.reactive_tamp import ReactiveTAMP
    from m3p2i_aip_tpu_torch.utils.tree import tree_map

    tamp = ReactiveTAMP(load_config("config_albert"), device="cuda", graphs=False)
    mp = tamp.motion_planner
    spec, K, T = mp.rollout.spec, mp.K, mp.T
    rng = np.random.default_rng(12)

    def inputs_of(B: int) -> tuple:
        rows = []
        for b in range(B):
            name, start, task_name, goal = ar.PARITY_CASES[b % len(ar.PARITY_CASES)]
            sk = tree_map(lambda x: x.expand((K,) + x.shape), ar.parity_state(tamp.env.params, start))
            rows.append(ar.rollout_inputs(sk, make_task_params(task_name, goal, device="cuda")))
        acts = rng.uniform(-1.5, 1.5, size=(B, K, T, 13)).astype(np.float32)
        acts[..., 11:13] *= 8.0  # the wheels at the config's +-12 authority, so the box moves
        return _stack_rows(rows, torch.as_tensor(acts, device="cuda"))

    fns = (
        lambda *a: ar.albert_rollout_batched(spec, *a),
        lambda *a: ar.albert_rollout_batched_plain(spec, *a),
        lambda *a: ar.albert_rollout(spec, *a),
    )
    err = _batched_check("albert-batched K4b", *fns, inputs_of(CHECK_SEEDS), ALBERT_ATOL, ALBERT_ATOL)
    inputs = inputs_of(N_SEEDS)
    err = max(err, _batched_check("albert-batched K4b", *fns, inputs, ALBERT_ATOL, ALBERT_ATOL))
    B = inputs[-1].shape[0]
    stats = _time_batched(
        f"albert-batched K4b at B={B}", fns[0], fns[1], inputs,
        roofline.rollout_bound(spec, inputs, B * K, roofline.albert_rollout_ops(spec, B * K)), plain_calls=1,
    )
    return {"max_abs_err": err, **stats}, (spec, inputs)


def _count_batch_ticks(batch) -> list:
    """Wrap the chunk entry of each of the batch's shards to record each
    dispatched chunk length (a chunk of a sharded batch counts once a shard)."""
    record = []
    name = "_run_chunk_panda_impl" if batch.is_panda else "_run_chunk_impl"
    for tamp in batch._tamps:
        chunk_fn = getattr(tamp, name)

        def counted(*args, chunk_fn=chunk_fn, **kwargs):
            record.append(args[4])  # the chunk length of either entry
            return chunk_fn(*args, **kwargs)

        setattr(tamp, name, counted)
    return record


def phase_seed_batch(label: str, config_name: str, overrides: list, chunk: int, max_ticks: int, per_tick: dict,
                     shard=False, keep: str = None, graphs=None):
    """One n=20 batch through ``BatchSimLoop`` (seeds 0-19, warm-up 20, gates
    on), as ``run_experiments parallel_seeds=True`` runs it (``shard``: as
    ``parallel_seeds=shard`` runs it, over that mesh): every launch count set
    to 0 just before ``run_chunked`` and read just after; each batched
    kernel in ``per_tick`` launched that many times per dispatched tick of
    each shard, every other kernel never.  The panda batch settles 150 steps
    before its rows are logged.  Prints each seed's row (``_seed_rows``),
    the success count and the row statistics of ``analysis.summarize``;
    ``keep`` names the run's record in EAGER_RUNS (taken before the settle);
    ``graphs`` goes to the batch.  Returns the counts (replays included),
    the rows, the success ticks and the replayed part of the counts by
    kernel."""
    from m3p2i_aip_tpu_torch.analysis import (
        finalize_albert_row,
        finalize_panda_row,
        finalize_point_row,
        per_seed,
        summarize,
    )
    from m3p2i_aip_tpu_torch.config.config_store import load_config
    from m3p2i_aip_tpu_torch.tamp.batch_loop import BatchSimLoop

    cfg = load_config(config_name, overrides)
    batch = BatchSimLoop(cfg, list(range(N_SEEDS)), shard=shard, device="cuda", graphs=graphs)
    batch.warmup(20)
    record = _count_batch_ticks(batch)
    outputs = graph_ab.record_chunks(batch) if keep is not None else None
    _zero_launches()
    t_start = time.time()
    t0 = time.perf_counter()
    logs = batch.run_chunked(max_ticks, chunk=chunk)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if keep is not None:
        EAGER_RUNS[keep] = graph_ab.batch_record(batch, outputs, logs)
    counts, replayed = _read_launches(), _read_replayed()
    dispatched = sum(record)
    print(f"[{label}] {len(record)} chunks, {dispatched} batched ticks dispatched for {N_SEEDS} seeds in "
          f"{len(batch._shards)} shard(s) in {wall:.2f} s; launches {counts}")
    for name, n in counts.items():
        want = per_tick.get(name, 0) * dispatched
        assert n == want, f"{label}: {name} launched {n} times, expected {want}"
    family = {"panda_env": "panda", "albert_env": "albert"}.get(cfg.env_type, "point")
    if family == "panda":
        batch.settle(150)
    rows = []
    for b, log in enumerate(logs):
        view = batch.views[b]
        if family == "panda":
            rows.append(finalize_panda_row(view))
        elif family == "albert":
            rows.append(finalize_albert_row(log, view, cfg.goal, dt=cfg.sim.dt))
        else:
            rows.append(finalize_point_row(log, view, cfg.goal, t_start, dt=cfg.sim.dt))
    rows = np.stack(rows)
    assert np.isfinite(rows).all(), f"{label}: non-finite rows"
    ok = [log.success_step is not None for log in logs]
    steps = [log.success_step for log in logs]
    cubes = np.stack([np.asarray(v["cube_state"])[:3] for v in batch.views]) if family == "panda" else None
    for line in _seed_rows(per_seed(rows, family), steps, cubes):
        print(f"[{label}] {line}")
    stats = {k: (round(m, 4), round(s, 4)) for k, (m, s) in summarize(rows, family).items()}
    print(f"[{label}] success {sum(ok)}/{N_SEEDS}; success ticks {steps}; stats (mean, std) {stats}")
    if family != "panda":
        done = [s for s in steps if s is not None]
        print(f"[{label}] task time {np.mean(done) * cfg.sim.dt:.4f} ± {np.std(done) * cfg.sim.dt:.4f} s "
              f"over the {len(done)} successful seeds")
    assert sum(ok) >= MIN_SUCCESS, f"{label}: only {sum(ok)}/{N_SEEDS} seeds succeeded"
    return counts, rows, steps, replayed


def _seed_rows(per_seed: dict, steps: list, cubes=None) -> list:
    """One line per seed of an n=20 batch: its entry of each of
    ``analysis.per_seed``'s arrays, the settled cube's xyz where ``cubes``
    [B, 3] are given (the panda), and its success tick."""
    lines = []
    for b, step in enumerate(steps):
        cells = [f"{k} {v[b]:.4f}" for k, v in per_seed.items()]
        if cubes is not None:
            cells.append(f"cube at [{', '.join(f'{c:.4f}' for c in cubes[b])}]")
        lines.append(f"seed {b}: {', '.join(cells)}, success tick {step}")
    return lines


def phase_batch_vs_serial(label: str, config_name: str, overrides: list, chunk: int, max_ticks: int) -> None:
    """Seeds 0-2 through ``BatchSimLoop`` against three serial
    ``SimLoop.run_chunked`` runs at the same chunk size (warm-up 20 each),
    all compiled (the serial loop ``reset`` between seeds): equal tick
    counts and success ticks, positions within 1e-4."""
    from m3p2i_aip_tpu_torch.config.config_store import load_config
    from m3p2i_aip_tpu_torch.tamp.batch_loop import BatchSimLoop
    from m3p2i_aip_tpu_torch.tamp.sim_loop import SimLoop

    seeds = [0, 1, 2]
    cfg = load_config(config_name, overrides)
    serial, loop = [], None
    for s in seeds:
        cfg.mppi.seed_val = s
        if loop is None:
            loop = SimLoop(cfg, device="cuda", graphs=True)
        else:
            loop.reset(s)  # the same graphs: reset re-seeds in place and re-captures nothing
        loop.warmup(20)
        serial.append((loop.run_chunked(max_ticks, chunk=chunk), loop._view))
    batch = BatchSimLoop(load_config(config_name, overrides), seeds, device="cuda", graphs=True)
    batch.warmup(20)
    logs = batch.run_chunked(max_ticks, chunk=chunk)
    worst = 0.0
    for b, (slog, sview) in enumerate(serial):
        blog, bview = logs[b], batch.views[b]
        assert (blog.steps, blog.success_step) == (slog.steps, slog.success_step), (
            f"{label} seed {b}: batched {blog.steps} ticks / success {blog.success_step}, "
            f"serial {slog.steps} / {slog.success_step}"
        )
        assert blog.task == slog.task, f"{label} seed {b}: task sequences differ"
        pairs = [(np.asarray(getattr(blog, n)), np.asarray(getattr(slog, n))) for n in ("robot_pos", "box_pos")]
        pairs += [(np.asarray(bview[k]), np.asarray(v)) for k, v in sview.items()]
        err = max(float(np.max(np.abs(x - y))) if x.size else 0.0 for x, y in pairs)
        worst = max(worst, err)
        print(f"[{label}] seed {b}: {blog.steps} ticks, success tick {blog.success_step} in both; "
              f"max position difference {err:.3e}")
    assert worst <= BATCH_PARITY_ATOL, f"{label}: batched and serial positions differ by {worst}"


# ------------------------------------------------------------------------
# the heijn and boxer bases, and the planner modes beyond the default

def phase_gated_loop(label: str, config_name: str, overrides: list, max_ticks: int) -> tuple:
    """One gated closed loop through ``SimLoop.run_chunked`` (warm-up 10,
    chunks of LOOP_CHUNK): every launch count set to 0 just before and read
    just after, K1 and the real-env step's K5 launched once per dispatched
    tick and K2 once per tick of a multi-modal halton planner (never in
    single mode or simple mode), every other kernel never; the box (the
    robot, for navigation) must reach the goal, and the boxer corner
    hybrid's staged endgame must engage.
    Returns (the launch counts, K1's recorded calls)."""
    from m3p2i_aip_tpu_torch.config.config_store import load_config
    from m3p2i_aip_tpu_torch.ops import rollout as ro
    from m3p2i_aip_tpu_torch.tamp.sim_loop import SimLoop

    cfg = load_config(config_name, overrides)
    loop = SimLoop(cfg, device="cuda", graphs=False)
    mp = loop.tamp.motion_planner
    assert mp.refine_iters == 0, f"{label}: one rollout a tick expected"
    _compiled_steps(loop, "warmup", 10)
    dispatched, run_chunk = 0, loop.tamp.run_chunk

    def counted_run_chunk(ms, rs, task, i0, length):
        nonlocal dispatched
        dispatched += length
        return run_chunk(ms, rs, task, i0, length)

    loop.tamp.run_chunk = counted_run_chunk
    _zero_launches()
    t0 = time.perf_counter()
    with _recorded(ro, "point_rollout") as calls:
        log = loop.run_chunked(max_ticks, chunk=LOOP_CHUNK)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _read_launches()
    weighted = mp.multi_modal and mp.mppi_mode != "simple"
    want = {"rollout_launches": dispatched, "weights_launches": dispatched if weighted else 0,
            "step_launches": dispatched}
    print(f"[{label}] {log.steps} ticks logged, {dispatched} dispatched in {wall:.2f} s; launches {counts}")
    for name, n in counts.items():
        assert n == want.get(name, 0), f"{label}: {name} launched {n} times, expected {want.get(name, 0)}"
    robot, box = np.asarray(log.robot_pos), np.asarray(log.box_pos)
    assert np.isfinite(robot).all() and np.isfinite(box).all(), f"{label}: non-finite positions"
    assert np.abs(box).max() <= 3.8, f"{label}: box tunnelled: max |coord| {np.abs(box).max()}"
    final = float(np.linalg.norm((robot if cfg.task == "navigation" else box)[-1] - np.asarray(cfg.goal)))
    stage = getattr(loop.tamp.task_planner, "_pocket_stage", None)
    print(f"[{label}] success tick {log.success_step}, final distance to the goal {final:.4f} m, pocket stage {stage}")
    assert log.success_step is not None, f"{label}: the goal was not reached in {max_ticks} ticks"
    if label == "boxer corner hybrid":
        assert stage == 2, f"{label}: the staged endgame never engaged"
    return counts, calls


def _flat_task(task_vec, K: int, goal: slice, zup: int = None):
    """The task of B recorded calls laid side by side, per sample: call b's
    task id and goal columns ``goal`` of ``task_vec`` [B, ...] (and its
    ``zup_gate`` column) for its K samples."""
    from types import SimpleNamespace

    rows = lambda x: x.repeat_interleave(K, dim=0)  # noqa: E731 (sample k of call b takes call b's row)
    task = SimpleNamespace(task_id=rows(task_vec[:, 0]), goal=rows(task_vec[:, goal]))
    if zup is not None:
        task.zup_gate = rows(task_vec[:, zup])
    return task


def _flat_mode(spec, task_vec, K: int, k0: int):
    """Each sample's mode from its call's global offset (column ``k0`` of
    ``task_vec``): the second half of the ``spec.K`` samples pulls."""
    gk = torch.arange(K, device=task_vec.device, dtype=torch.float32) + task_vec[:, k0 : k0 + 1]
    return ((gk >= spec.K // 2) & (gk < spec.K)).to(torch.int32).reshape(-1)


def _point_plain_flat(spec, task_vec, state0, fric_k, acts) -> tuple:
    """K1's plain version on B recorded calls at once: the calls' K samples
    side by side as one [B K] plain rollout (each sample from its own call's
    start state, with its own call's task and global offset ``k0``), the
    same ``point_env.step`` and objective as ``rollout.point_rollout_plain``,
    which takes one start state and one call at a time.  ``task_vec`` [B, 4],
    ``state0`` [B, n_state], ``fric_k`` [B, K, D], ``acts`` [B, K, T, n_u];
    returns [B, K, T] costs and [B, K, T, 2] trajectory points."""
    from m3p2i_aip_tpu_torch.models import point_env

    p, D, n_q = spec.env_params, spec.D, spec.n_q
    B, K, T = acts.shape[:3]
    n, o = B * K, 2 * n_q
    s0 = state0.repeat_interleave(K, dim=0)  # [B K, n_state]: sample k of call b starts from call b's state
    state = point_env.PointEnvState(
        q=s0[:, :n_q], qd=s0[:, n_q:o], dyn_pos=s0[:, o : o + 2 * D].reshape(n, D, 2), dyn_yaw=s0[:, o + 2 * D : o + 3 * D],
        dyn_vel=s0[:, o + 3 * D : o + 5 * D].reshape(n, D, 2), dyn_om=s0[:, o + 5 * D : o + 6 * D],
        contact_force=torch.zeros(n, p.num_actors, 3, dtype=acts.dtype, device=acts.device),
        fric_scale=fric_k.reshape(n, D),
    )
    mode, task = _flat_mode(spec, task_vec, K, 3), _flat_task(task_vec, K, slice(1, 3))
    ext, flat = point_env.zero_ext(p, (n,)), acts.reshape(n, T, -1)
    costs, points = [], []
    for t in range(T):
        state = point_env.step(p, state, flat[:, t], ext)
        cost, ext = spec.objective.compute(state, flat[:, t], task, mode)
        costs.append(cost)
        points.append(state.q[:, :2])
    return torch.stack(costs, dim=1).reshape(B, K, T), torch.stack(points, dim=1).reshape(B, K, T, 2)


def _stacked_starts(rows) -> object:
    """One state of B x K samples from B calls' broadcast start states (each
    [K, ...]), call b's samples at b K .. b K + K - 1."""
    return dataclasses.replace(rows[0], **{f.name: torch.cat([getattr(r, f.name) for r in rows])
                                           for f in dataclasses.fields(rows[0])})


def _panda_plain_flat(spec, task_vec, state0, acts) -> tuple:
    """K3's plain version on B recorded calls at once, as
    ``_point_plain_flat`` does K1's: the calls' K samples side by side as one
    [B K] plain rollout, the same ``panda_env.step``, ``panda_fk.fk`` and
    objective as ``panda_rollout.panda_rollout_plain``.  ``task_vec`` [B, 10],
    ``state0`` [B, 56], ``acts`` [B, K, T, 9]; returns [B, K, T] costs and
    [B, K, T, 2] trajectory points."""
    from m3p2i_aip_tpu_torch.models import panda_env, panda_fk
    from m3p2i_aip_tpu_torch.ops import panda_rollout as pr

    p, (B, K, T) = spec.env_params, acts.shape[:3]
    state = _stacked_starts([pr.unpack_state(row, K, p) for row in state0])
    mode, task = _flat_mode(spec, task_vec, K, 8), _flat_task(task_vec, K, slice(1, 8), zup=9)
    ext, flat = panda_env.zero_ext(p, (B * K,)), acts.reshape(B * K, T, -1)
    costs, points = [], []
    for t in range(T):
        state = panda_env.step(p, state, flat[:, t], ext)
        links = panda_fk.fk(state.q, p.base_pos)
        cost, ext = spec.objective.compute(state, flat[:, t], task, mode, links)
        costs.append(cost)
        points.append(links["ee"][0][:, :2])
    return torch.stack(costs, dim=1).reshape(B, K, T), torch.stack(points, dim=1).reshape(B, K, T, 2)


def _albert_plain_flat(spec, task_vec, state0, acts) -> tuple:
    """K4's plain version on B recorded calls at once, as
    ``_panda_plain_flat``, with ``albert_rollout.albert_rollout_plain``'s
    ``albert.step``, ``albert.fk`` and objective (single mode: ``k0`` unused).
    ``task_vec`` [B, 5], ``state0`` [B, 30], ``acts`` [B, K, T, 13]."""
    from m3p2i_aip_tpu_torch.models import albert
    from m3p2i_aip_tpu_torch.ops import albert_rollout as ar

    B, K, T = acts.shape[:3]
    state = _stacked_starts([ar.unpack_state(row, K) for row in state0])
    task = _flat_task(task_vec, K, slice(1, 4))
    flat = acts.reshape(B * K, T, -1)
    costs, points = [], []
    for t in range(T):
        state = albert.step(spec.env_params, state, flat[:, t])
        cost, _ = spec.objective.compute(state, flat[:, t], task, None, ee_pos=albert.fk(state)["ee"][0])
        costs.append(cost)
        points.append(state.q[:, :2])
    return torch.stack(costs, dim=1).reshape(B, K, T), torch.stack(points, dim=1).reshape(B, K, T, 2)


def phase_every_call(label: str, calls: list, kernel, flat=_point_plain_flat, bars: tuple = PLANAR_BARS) -> float:
    """A rollout kernel on every recorded (spec, inputs) call of one run,
    held to its plain version laid flat (``_point_plain_flat``,
    ``_panda_plain_flat`` or ``_albert_plain_flat``: up to CHECK_GROUP
    consecutive calls in one plain rollout, each sample under its own call's
    task and global offset) sample by sample at ``bars``
    (``_closed_loop_check``: every sample beyond them must be explained by a
    nudge of its own actions).  Returns the largest cost or trajectory
    difference from the plain version over every call."""
    spec = calls[0][0]
    assert all(s is spec for s, _ in calls), f"{label}: one rollout spec a run"
    groups = [calls[i : i + CHECK_GROUP] for i in range(0, len(calls), CHECK_GROUP)]
    beyond = explained = 0
    worst = 0.0
    t0 = time.perf_counter()
    for group in groups:
        xb = tuple(torch.stack(v) for v in zip(*(x for _, x in group)))
        out = tuple(torch.stack(v) for v in zip(*(kernel(spec, *x) for _, x in group)))
        ref = flat(spec, *xb)
        worst = max([worst] + [float(torch.abs(o - r).max()) for o, r in zip(out, ref)])
        nb, ne = _closed_loop_check(f"every call {label}, {len(group)} calls", lambda *a: flat(spec, *a), xb, out,
                                    ref=ref, bars=bars)
        beyond, explained = beyond + nb, explained + ne
    print(f"[every call {label}] {len(calls)} recorded calls in {len(groups)} groups held to the plain version in "
          f"{time.perf_counter() - t0:.1f} s: {beyond} samples beyond the bars, {explained} explained; max err "
          f"{worst:.3e}")
    return worst


def _expect_launches(label: str, counts: dict, want: dict) -> None:
    """Every kernel's launch count of one run: ``want`` where named, else 0;
    the real-env steps' (K5 / K5b, K6 / K6b), where not named, as
    ``_read_launches`` held them, one a step of the run's env on the card
    (its warm-ups and settles too)."""
    print(f"[{label}] launches {counts}")
    for name, n in counts.items():
        if name in STEP_OF_COUNTER and name not in want:
            continue
        assert n == want.get(name, 0), f"{label}: {name} launched {n} times, expected {want.get(name, 0)}"


def phase_run_sim(card: str, chunked_ticks: dict) -> tuple:
    """The port's ``run_tamp`` script (``main``: ``run_sim`` -> ``SimLoop.run``,
    one replan+step a tick, the host task planner every tick) on the card,
    gated, on the point main path and on ``-cn config_panda`` capped at
    RUN_SIM_PANDA_TICKS: every launch count set to 0 just before each run
    and read just after, K1 once and K2 once a replanned tick on the point,
    K3 1 + refine_iters times a replanned tick on the panda (a tick whose
    observation already meets the host planner's success check logs without
    a replan, ``SimLoop.tick``); the point run must latch at the
    chunked main path's tick (``chunked_ticks``), the panda run must latch
    success.  Every K1 and K3 call is held to its plain version.  Returns
    (launch counts summed, K2's recorded calls, the point run's median
    in-process tick in ms)."""
    from m3p2i_aip_tpu_torch.config.config_store import load_config
    from m3p2i_aip_tpu_torch.ops import panda_rollout as pr
    from m3p2i_aip_tpu_torch.ops import rollout as ro
    from m3p2i_aip_tpu_torch.scripts import run_tamp

    def report(label: str, log, chunked_tick) -> tuple:
        """(replanned ticks, their median ms), printed with the rate."""
        ticks = [t for t in log.replan_s if t > 0]
        ms = float(np.median(ticks)) * 1e3
        print(f"[{label}] {log.steps} ticks logged, {len(ticks)} replanned; success tick {log.success_step} per tick, "
              f"{chunked_tick} chunked; stages {sorted(set(log.task))}; {len(ticks) / sum(ticks):.2f} Hz replan+step "
              f"per tick, median tick {ms:.2f} ms ({card})")
        return len(ticks), ms

    _zero_launches()
    with _recorded(ro, "point_rollout") as k1_calls, _recorded_weights("multimodal_weights") as k2_calls:
        log = run_tamp.main([*MAIN_PATH, "--eager"])
    torch.cuda.synchronize()
    counts = _read_launches()
    replans, point_ms = report("run_sim point", log, chunked_ticks["point"])
    _expect_launches("run_sim point", counts, {"rollout_launches": replans, "weights_launches": replans})
    total = {"point_rollout": replans, "multimodal_weights": replans}
    robot, box = np.asarray(log.robot_pos), np.asarray(log.box_pos)
    assert np.isfinite(robot).all() and np.isfinite(box).all() and np.abs(box).max() <= 3.8
    assert log.success_step is not None and log.success_step == chunked_ticks["point"], (
        f"the per-tick point run latched at {log.success_step}, the chunked main path at {chunked_ticks['point']}"
    )
    phase_every_call("K1 run_sim point", k1_calls, ro.point_rollout)
    k1_calls.clear()

    _zero_launches()
    with _recorded(pr, "panda_rollout") as k3_calls:
        log = run_tamp.main(["-cn", "config_panda", f"n_steps={RUN_SIM_PANDA_TICKS}", "--eager"])
    torch.cuda.synchronize()
    counts = _read_launches()
    replans, _ = report("run_sim panda", log, chunked_ticks["panda"])
    per_tick = 1 + int(load_config("config_panda").mppi.refine_iters)
    _expect_launches("run_sim panda", counts, {"panda_rollout_launches": per_tick * replans})
    total["panda_rollout"] = per_tick * replans
    assert log.success_step is not None, f"the per-tick panda run did not latch success in {RUN_SIM_PANDA_TICKS} ticks"
    phase_every_call("K3 run_sim panda", k3_calls, pr.panda_rollout, _panda_plain_flat)
    phase_f3(card)
    return total, k2_calls, point_ms


def phase_f3(card: str) -> None:
    """F3 (ROADMAP Queue 3): the per-tick and the chunked panda runs from one
    warmed-up scene and generator state, recorded tick by tick
    (``scripts/trace_tick_paths.py``).  They must agree bit for bit (task,
    means, real state) on every tick before the chunked run's device gate
    first plans a pick, and part there: on that tick the per-tick run's host
    planner still plans the reach and plans the pick one tick later (the
    active-inference agent's one-observation lag, the JAX package's too).
    Both must latch success; the latch ticks are printed, not compared: past
    the switch the two runs are different trajectories."""
    from m3p2i_aip_tpu_torch.config.config_store import load_config
    from m3p2i_aip_tpu_torch.scripts import trace_tick_paths as ttp

    per_tick, per_tick_success = ttp.record_per_tick(load_config("config_panda"), RUN_SIM_PANDA_TICKS, 50, "cuda")
    chunked, chunked_success = ttp.record_chunked(load_config("config_panda"), RUN_SIM_PANDA_TICKS, 50, "cuda")
    switch = next(i for i, row in enumerate(chunked) if row["task_id"] == 5)
    first = ttp.first_differences(per_tick, chunked)
    part = min(t for t, _ in first.values())
    print(f"[F3] per-tick and chunked panda runs bit-equal for {part} ticks; the device gate plans the pick at tick "
          f"{switch}, the host planner at tick {switch + 1}; fields parting there: "
          f"{sorted(k for k, (t, _) in first.items() if t == part)}; success tick per tick {per_tick_success}, "
          f"chunked {chunked_success} ({card})")
    assert part == switch, f"F3: the runs part at tick {part}, the device gate plans the pick at tick {switch}"
    assert per_tick[switch]["task_id"] == 4 and per_tick[switch + 1]["task_id"] == 5, "F3: the host switch is not one tick late"
    assert per_tick_success is not None and chunked_success is not None, "F3: a run did not latch success"


def _rpc_run(label: str, config_name: str, overrides: list, n_ticks: int, until=None, graphs=None) -> tuple:
    """The two-terminal workflow on the card, in one process: the port's
    ``rpc.Server`` serves ``ReactiveTAMPServer(cfg, device="cuda")`` from a
    thread on an ephemeral localhost port, and the port's sim client
    (``scripts/sim.py`` ``drive``, pacing off) ticks against it, every
    launch count set to 0 just before and read just after.  ``graphs`` goes
    to the server and the client (None, the default: the server's command
    and the client's warm-up and steps replayed from CUDA graphs; False:
    eager).  A failure in the server reaches the client as an error.
    Returns (env, final state, ticks, launch counts with replays, their
    replayed part by kernel, round-trip seconds, tick seconds)."""
    import threading

    from m3p2i_aip_tpu_torch.config.config_store import load_config
    from m3p2i_aip_tpu_torch.scripts.sim import drive
    from m3p2i_aip_tpu_torch.tamp.reactive_tamp import ReactiveTAMPServer
    from m3p2i_aip_tpu_torch.utils import rpc

    server = rpc.Server(ReactiveTAMPServer(load_config(config_name, overrides), device="cuda", graphs=graphs),
                        "127.0.0.1", 0)
    thread = threading.Thread(target=server.run, daemon=True)
    thread.start()
    client = rpc.Client().connect("127.0.0.1", server.port)
    try:
        _zero_launches()
        env, state, rpc_s, tick_s = drive(load_config(config_name, overrides), client, n_ticks=n_ticks, pace=False,
                                          device="cuda", until=until, graphs=graphs)
        torch.cuda.synchronize()
        counts, replayed = _read_launches(), _read_replayed()
    finally:
        client.close()
        server.close()
    thread.join(timeout=60)
    assert not thread.is_alive(), f"{label}: the server thread did not stop"
    mode = "eager" if graphs is False else "compiled"
    print(f"[{label}] {mode}: {len(rpc_s)} ticks over the socket: run_tamp round trip median "
          f"{float(np.median(rpc_s)) * 1e3:.2f} ms (max {max(rpc_s) * 1e3:.2f}), the client's whole tick (with its "
          f"real-env step) median {float(np.median(tick_s)) * 1e3:.2f} ms, {len(tick_s) / sum(tick_s):.2f} Hz")
    return env, state, len(rpc_s), counts, replayed, rpc_s, tick_s


def phase_two_terminal(card: str, in_process_ms: float) -> tuple:
    """The reference's two terminals on the card, each run compiled (the
    default) and then eager (``graphs=False``): the point push to [-1, -1]
    must bring the box within 0.1 m of the goal within RPC_PUSH_TICKS ticks,
    then RPC_FAMILY_TICKS ticks of ``config_panda`` and ``config_albert``.
    Each run launches K1 / K3 / K4 1 + refine_iters times a tick (the
    compiled run: its first tick's calls and its replays); the eager run's
    calls are recorded and held to their plain versions; the compiled run
    ends in the eager run's state bit for bit after as many ticks.  The
    round trip and the client's tick of both are printed beside the
    in-process per-tick time.  Returns (launch counts by kernel, their
    replayed part)."""
    from m3p2i_aip_tpu_torch.config.config_store import load_config
    from m3p2i_aip_tpu_torch.ops import albert_rollout as ar
    from m3p2i_aip_tpu_torch.ops import panda_rollout as pr
    from m3p2i_aip_tpu_torch.ops import rollout as ro

    goal = torch.tensor([-1.0, -1.0], device="cuda")

    def box_at_goal(env, state):
        return float(torch.linalg.vector_norm(state.dyn_pos[env.box_slot] - goal)) <= 0.1

    launches, replayed = {}, {}
    for label, config_name, overrides, n_ticks, until, mod, name, counter, flat, bars in (
        ("rpc point push", "config_point", RPC_PUSH, RPC_PUSH_TICKS, box_at_goal, ro, "point_rollout",
         "rollout_launches", _point_plain_flat, PLANAR_BARS),
        ("rpc panda", "config_panda", [], RPC_FAMILY_TICKS, None, pr, "panda_rollout", "panda_rollout_launches",
         _panda_plain_flat, PLANAR_BARS),
        ("rpc albert", "config_albert", [], RPC_FAMILY_TICKS, None, ar, "albert_rollout", "albert_rollout_launches",
         _albert_plain_flat, ALBERT_BARS),
    ):
        per_tick = 1 + int(load_config(config_name, overrides).mppi.refine_iters)
        env, state, ticks, counts, rep, _, _ = _rpc_run(label, config_name, overrides, n_ticks, until)
        _expect_launches(f"{label} compiled", counts, {counter: per_tick * ticks})
        with _recorded(mod, name) as calls:
            env, ref, ref_ticks, ref_counts, _, _, _ = _rpc_run(label, config_name, overrides, n_ticks, until,
                                                                graphs=False)
        _expect_launches(f"{label} eager", ref_counts, {counter: per_tick * ref_ticks})
        assert ticks == ref_ticks and (until is not None or ticks == n_ticks), f"{label}: {ticks} / {ref_ticks} ticks"
        same = all(torch.equal(getattr(state, f.name), getattr(ref, f.name)) for f in dataclasses.fields(ref)
                   if torch.is_tensor(getattr(ref, f.name)))
        print(f"[{label}] compiled and eager: {ticks} ticks each, final states bit-equal {same}")
        assert same, f"{label}: the compiled two terminals end in another state than the eager ones"
        assert torch.isfinite(env.dof_state_view(ref)).all(), f"{label}: non-finite state"
        if until is not None:
            final = float(torch.linalg.vector_norm(ref.dyn_pos[env.box_slot] - goal))
            print(f"[{label}] box {final:.4f} m from the goal after {ticks} ticks; the in-process per-tick point "
                  f"main path's median tick {in_process_ms:.2f} ms ({card})")
            assert final <= 0.1, f"the box is {final} m from the goal after {ticks} ticks over the socket"
        phase_every_call(f"{label[4:]} over RPC", calls, getattr(mod, name), flat, bars)
        launches[name] = launches.get(name, 0) + counts[counter] + ref_counts[counter]
        for kernel, n in rep.items():
            replayed[kernel] = replayed.get(kernel, 0) + n
    return launches, replayed


def phase_checkpoint() -> tuple:
    """Checkpoint / resume on the card, point main path and ``config_panda``
    per tick, compiled (one replay a tick; the checkpoint reads the states
    copied out of the graphs' buffers and the resumed loop's first tick
    copies the loaded ones in): CKPT_TICKS ticks, ``save_checkpoint``, a
    fresh loop ``load_checkpoint``s it and ticks CKPT_TICKS more; its real
    state, planner state, task and log rows must equal 2 x CKPT_TICKS
    uninterrupted ticks bit for bit (the exploration noise on).  Returns the
    launch counts summed by kernel and their replayed part (captured
    launches x replays)."""
    import dataclasses
    import os
    import tempfile

    from m3p2i_aip_tpu_torch.config.config_store import load_config
    from m3p2i_aip_tpu_torch.tamp.sim_loop import SimLoop
    from m3p2i_aip_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint

    total, replayed = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for label, config_name, overrides in (("point", "config_point", MAIN_PATH), ("panda", "config_panda", [])):
            _zero_launches()
            ref = SimLoop(load_config(config_name, overrides), device="cuda", graphs=True)
            ref.warmup(50)
            for i in range(CKPT_TICKS):
                ref.tick(i)
            path = save_checkpoint(os.path.join(tmp, label), ref.tamp, ref.state)
            for i in range(CKPT_TICKS, 2 * CKPT_TICKS):
                ref.tick(i)
            loop = SimLoop(load_config(config_name, overrides), device="cuda", graphs=True)
            loop.state = load_checkpoint(path, loop.tamp, loop.state, device="cuda")
            for i in range(CKPT_TICKS, 2 * CKPT_TICKS):
                loop.tick(i)
            torch.cuda.synchronize()
            ticks = 3 * CKPT_TICKS  # the uninterrupted run's and the resumed run's
            mp = ref.tamp.motion_planner
            if label == "point":
                want = {"rollout_launches": ticks, "weights_launches": ticks}
            else:
                want = {"panda_rollout_launches": (1 + mp.refine_iters) * ticks}
            counts = _read_launches()
            _expect_launches(f"checkpoint {label}", counts, want)
            for name, n in counts.items():
                total[KERNEL_OF_COUNTER[name]] = total.get(KERNEL_OF_COUNTER[name], 0) + n
            for name, n in _read_replayed().items():
                replayed[name] = replayed.get(name, 0) + n
            differ = [f.name for a, b in ((ref.state, loop.state), (ref.tamp.mppi_state, loop.tamp.mppi_state))
                      for f in dataclasses.fields(a) if not torch.equal(getattr(a, f.name), getattr(b, f.name))]
            rows = ref.log.task[CKPT_TICKS:] == loop.log.task and all(
                np.array_equal(np.asarray(getattr(ref.log, n)[CKPT_TICKS:]), np.asarray(getattr(loop.log, n)))
                for n in ("robot_pos", "robot_vel", "box_pos"))
            print(f"[checkpoint {label}] {CKPT_TICKS} + {CKPT_TICKS} ticks resumed from a checkpoint: fields that "
                  f"differ from {2 * CKPT_TICKS} uninterrupted ticks {differ}, log rows equal {rows}, exploration "
                  f"noise {mp.exploration_noise}, task {loop.tamp.task_planner.task}")
            assert not differ and rows, f"checkpoint {label}: the resumed run differs from the uninterrupted one"
    return total, replayed


def phase_family_bench(card: str, config_name: str, label: str) -> float:
    """The bench_family twin's protocol at a shorter depth: push_pull
    multi-modal to the corner goal, warm-up 50, both gates off, two chunks
    of BENCH_CHUNK to settle, then FAMILY_TIMED timed chunks, pipelined,
    compiled (a CUDA graph a tick)."""
    from m3p2i_aip_tpu_torch.scripts import bench_family
    from m3p2i_aip_tpu_torch.tamp.sim_loop import SimLoop

    loop = SimLoop(bench_family.config(["-cn", config_name, *MAIN_PATH]), device="cuda", graphs=True)
    loop.warmup(50)
    rate = bench_family.measure(loop, BENCH_CHUNK, FAMILY_TIMED * BENCH_CHUNK)
    print(f"[{label}] {_rate_line(rate)}, K=200 x T=15, {FAMILY_TIMED * BENCH_CHUNK} timed ticks, pipelined ({card})")
    return rate["value"]


def _watch_syncs(fn, syncs: list):
    """``fn`` run with ``torch.cuda.set_sync_debug_mode("warn")``: each call
    appends to ``syncs`` the host-device synchronisations it made."""
    import warnings

    def watched(*args):
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                out = fn(*args)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        syncs.append([str(w.message) for w in caught if "synchroniz" in str(w.message).lower()])
        return out

    return watched


def phase_pipelined(card: str) -> tuple:
    """The main path with one chunk in flight (``run_chunked(pipelined=True)``)
    against serial chunks: gated, in chunks of PIPELINE_CHUNK, the two must
    latch at the same tick with bit-equal logs, K1 and K2 launched once per
    dispatched tick (the discarded in-flight chunk's ticks included), and no
    enqueue of a pipelined chunk may synchronise the host with the device
    (``torch.cuda.set_sync_debug_mode`` around each, 0 warnings).  Returns
    (launch counts of the gated pipelined run, its K1 calls, its K2 calls,
    the serial run's log).  The eager rates of both are phase_graphs'."""
    from m3p2i_aip_tpu_torch.config.config_store import load_config
    from m3p2i_aip_tpu_torch.ops import rollout as ro
    from m3p2i_aip_tpu_torch.tamp.sim_loop import SimLoop

    logs, syncs = {}, []
    for pipelined in (False, True):
        loop = SimLoop(load_config("config_point", MAIN_PATH), device="cuda", graphs=False)
        _compiled_steps(loop, "warmup", 50)
        dispatched, run_chunk, enqueue = 0, loop.tamp.run_chunk, loop._enqueue_chunk

        def counted_run_chunk(ms, rs, task, i0, length, run_chunk=run_chunk):
            nonlocal dispatched
            dispatched += length
            return run_chunk(ms, rs, task, i0, length)

        loop.tamp.run_chunk, loop._enqueue_chunk = counted_run_chunk, _watch_syncs(enqueue, syncs)
        _zero_launches()
        with _recorded(ro, "point_rollout") as k1_calls, _recorded_weights("multimodal_weights") as k2_calls:
            logs[pipelined] = loop.run_chunked(1000, chunk=PIPELINE_CHUNK, pipelined=pipelined)
        torch.cuda.synchronize()
        counts = _read_launches()
        label = "pipelined gated" if pipelined else "serial gated"
        print(f"[{label}] {logs[pipelined].steps} ticks logged, {dispatched} dispatched, success tick "
              f"{logs[pipelined].success_step}")
        _expect_launches(label, counts, {"rollout_launches": dispatched, "weights_launches": dispatched})
    serial, piped = logs[False], logs[True]
    assert serial.success_step is not None and piped.success_step == serial.success_step, (
        f"pipelined latch {piped.success_step}, serial {serial.success_step}"
    )
    assert piped.steps == serial.steps and piped.task == serial.task
    for name in ("robot_pos", "robot_vel", "box_pos"):
        assert np.array_equal(np.asarray(getattr(piped, name)), np.asarray(getattr(serial, name))), name
    print(f"[pipelined gated] logs bit-equal to the serial run's; host syncs per enqueue {[len(x) for x in syncs]}")
    assert syncs and not any(syncs), f"a pipelined enqueue synchronised the host: {syncs}"
    return {"point_rollout": dispatched, "multimodal_weights": dispatched}, k1_calls, k2_calls, serial


# ------------------------------------------------------------------------
# the compiled tick: one CUDA graph a tick, replayed through every chunk

def phase_graphs(card: str, serial_log) -> tuple:
    """The compiled tick (``tamp/graph_tick.py``) against the eager tick,
    through ``scripts/graph_ab.py``.

    Each of graph_ab's parity runs compiled (``graphs=True``), every launch
    count set to 0 just before and read just after (captured launches x
    replays, plus the first tick's, which runs eagerly before the capture),
    and held bit for bit against its eager twin: chunk outputs (views,
    n_ticks and done; the panda's stages and dones), log and final carry.
    The eager twins are the runs the earlier phases made and kept
    (EAGER_RUNS: the gated main path latching at 47, the panda table at 83,
    the albert push_reach, the n=20 point, panda and albert batches); the point in
    benchmark mode and per tick run both here.  Then the gated main path
    pipelined and compiled: its log equal to the eager serial run's
    (``serial_log``), no host sync in any enqueue after the first (which
    captures the gated tick).  Then the rates in turns with a profile of each
    mode (``graph_ab.paired_rates``), each profile's kernel events held to
    the launches counted and replayed while it ran.  Prints each graph's
    capture time, nodes, pool and launches a replay.  Before the rates,
    ``MPPI.command`` itself compiled against eager (``phase_command``).
    Returns (the launch counts by kernel, their replayed part, the
    rates)."""
    from m3p2i_aip_tpu_torch.config.config_store import load_config
    from m3p2i_aip_tpu_torch.tamp.sim_loop import SimLoop

    launches, replayed = {}, {}

    def compiled_run(label: str, run):
        _zero_launches()
        rec = run()
        torch.cuda.synchronize()
        counts = _read_launches()
        outs = rec["outputs"]
        dispatched = len(outs) if label == "point per tick" else sum(o[0].shape[-2] for o in outs)  # views first
        _expect_launches(f"graphs {label}", counts, {k: n * dispatched for k, n in GRAPH_LAUNCHES[label].items()})
        for name, n in counts.items():
            if n:
                launches[KERNEL_OF_COUNTER[name]] = launches.get(KERNEL_OF_COUNTER[name], 0) + n
        for name, n in _read_replayed().items():
            replayed[name] = replayed.get(name, 0) + n
        return rec

    for label, config_name, overrides, warmup, ticks, chunk, gated in graph_ab.LOOPS:
        args = (config_name, overrides, warmup, ticks, chunk, gated)
        eager = EAGER_RUNS.pop(label, None) or graph_ab.run_loop(config_name, overrides, False, *args[2:])
        graph_ab.parity(label, eager, compiled_run(label, lambda: graph_ab.run_loop(config_name, overrides, True,
                                                                                    *args[2:])))
    eager = graph_ab.run_loop("config_point", MAIN_PATH, False, 50, graph_ab.PER_TICK, 1, True, per_tick=True)
    graph_ab.parity("point per tick", eager, compiled_run("point per tick", lambda: graph_ab.run_loop(
        "config_point", MAIN_PATH, True, 50, graph_ab.PER_TICK, 1, True, per_tick=True)))
    for label, config_name, overrides, chunk, cap in graph_ab.BATCHES:
        graph_ab.parity(label, EAGER_RUNS.pop(label), compiled_run(
            label, lambda: graph_ab.run_batch(config_name, overrides, True, chunk, cap)))

    loop = SimLoop(load_config("config_point", MAIN_PATH), device="cuda", graphs=True)
    loop.warmup(50)
    syncs = []
    loop._enqueue_chunk = _watch_syncs(loop._enqueue_chunk, syncs)
    log = loop.run_chunked(1000, chunk=PIPELINE_CHUNK, pipelined=True)
    torch.cuda.synchronize()
    print(f"[graph-pipelined] compiled, chunks of {PIPELINE_CHUNK}: success tick {log.success_step} (eager serial "
          f"{serial_log.success_step}); host syncs per enqueue {[len(x) for x in syncs]} (the first captures the "
          f"gated tick)")
    assert log.success_step == serial_log.success_step and log.task == serial_log.task
    for name in ("robot_pos", "robot_vel", "box_pos"):
        assert np.array_equal(np.asarray(getattr(log, name)), np.asarray(getattr(serial_log, name))), name
    assert len(syncs) > 1 and not any(syncs[1:]), f"a compiled pipelined enqueue synchronised the host: {syncs}"
    del loop

    for name, n in phase_command(card, replayed).items():
        launches[name] = launches.get(name, 0) + n

    names = tuple(name for name in graph_ab.RATES if "shards" not in name)  # phase_sample_shard runs the shards
    rates = graph_ab.paired_rates(card, names, chunk=GRAPH_RATE_CHUNK, timed=GRAPH_RATE_TIMED)
    return launches, replayed, rates


def _command_chain(tamp, B: int, calls: int) -> tuple:
    """``calls`` chained ``MPPI.command`` calls of ``tamp``'s planner from
    its start scene (B > 1: seeds 0..B-1, seed b's start moved 0.01 b),
    the real state stepped by each call's first action.  Returns (every
    call's (actions, planner state, aux), the last (state, real state,
    TaskParams))."""
    from m3p2i_aip_tpu_torch.utils.tree import tree_map

    mp, env = tamp.motion_planner, tamp.env
    real = env.init_state()
    task = tamp.tamp_interface(real)
    state = tamp.mppi_state
    if B > 1:
        real = tree_map(lambda x: x.expand((B,) + x.shape).clone(), real)
        real.q.add_(0.01 * torch.arange(B, dtype=torch.float32, device=real.q.device)[:, None])
        state = mp.init_state_batch(list(range(B)))
        task = tree_map(lambda x: x.expand((B,) + x.shape), task)
    ext = env.zero_ext((B,)) if B > 1 else env.zero_ext()
    out = []
    for _ in range(calls):
        action, state, aux = mp.command(state, real, task)
        out.append((action, state, aux))
        real = env.step(real, action[..., 0, :], ext)
    return out, (state, real, task)


def phase_command(card: str, replayed: dict) -> dict:
    """``MPPI.command`` itself compiled (the default on the card: one CUDA
    graph, captured at the first call after one eager run, replayed by each
    later one) against ``graphs=False``, for each of COMMAND_CASES:
    COMMAND_CALLS chained commands from the start scene, every call's
    actions, planner state and aux (weights, top trajectories and values)
    bit for bit, the launches of each run counted just around it (the
    compiled run's from its first call and its replays) and held to
    COMMAND_LAUNCHES; then COMMAND_TIMED chained commands timed in turns
    (eager, compiled, compiled, eager; host clock to a synchronize), printed
    with the graph's nodes and capture time.  Adds the replayed launches to
    ``replayed`` and returns the launches by kernel (replays included)."""
    from m3p2i_aip_tpu_torch.config.config_store import load_config
    from m3p2i_aip_tpu_torch.parallel import shard_planner
    from m3p2i_aip_tpu_torch.tamp.reactive_tamp import ReactiveTAMP

    counted: dict = {}
    for label, config_name, overrides, B, shards in COMMAND_CASES:
        runs = {}
        for graphs in (False, None):
            tamp = ReactiveTAMP(load_config(config_name, overrides), device="cuda", graphs=graphs)
            if shards:
                shard_planner(tamp.motion_planner, _card_mesh(shards))
            _zero_launches()
            out, last = _command_chain(tamp, B, COMMAND_CALLS)
            torch.cuda.synchronize()
            counts, rep = _read_launches(), _read_replayed()
            mode = "eager" if graphs is False else "compiled"
            _expect_launches(f"command {label} {mode}", counts,
                             {k: n * COMMAND_CALLS for k, n in COMMAND_LAUNCHES[label].items()})
            for name, n in counts.items():
                if n:
                    counted[KERNEL_OF_COUNTER[name]] = counted.get(KERNEL_OF_COUNTER[name], 0) + n
            for kernel, n in rep.items():
                replayed[kernel] = replayed.get(kernel, 0) + n
            runs[graphs] = (tamp, out, last)
        (eager, ref, _), (tamp, got, _) = runs[False], runs[None]
        same = [all(torch.equal(x, y) for x, y in zip(graph_tick._leaves(a), graph_tick._leaves(b)))
                for a, b in zip(got, ref)]
        (stats,) = tamp.ticks.stats()
        assert stats["key"][0] == "command" and not eager.ticks.programs, f"command {label}: {stats['key'][:4]}"

        def per_call(graphs) -> float:
            mp, (state, real, task) = runs[graphs][0].motion_planner, runs[graphs][2]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(COMMAND_TIMED):
                _, state, _ = mp.command(state, real, task)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) / COMMAND_TIMED * 1e3

        ms = {False: [], None: []}
        for graphs in (False, None, None, False):
            ms[graphs].append(per_call(graphs))
        print(f"[command {label}] compiled against eager, {COMMAND_CALLS} chained calls: actions, planner states and "
              f"aux bit-equal {all(same)} ({sum(same)} of {len(same)} calls); graph {stats['nodes']} nodes, capture "
              f"{stats['capture_s'] * 1e3:.1f} ms, launches a replay {stats['launches']}; ms a call in turns, eager "
              f"{', '.join(f'{t:.3f}' for t in ms[False])}, compiled {', '.join(f'{t:.3f}' for t in ms[None])} "
              f"({card})")
        assert all(same), f"command {label}: the compiled command differs from the eager one at calls " \
                          f"{[i for i, ok in enumerate(same) if not ok]}"
        del runs, eager, tamp
    return counted


def phase_grad_refine(card: str) -> tuple:
    """The round-4 panda setting (``config/mppi/panda.yaml:25-32``: eight
    gradient steps on the plain step and costs, no refine ladder,
    multi-modal) at K=200 x T=12 for GRAD_REFINE_TICKS chunked ticks,
    eagerly (``graphs=False``) and then compiled (the default: the first
    tick runs eagerly on the capture stream and captures three graphs, the
    tick up to the refinement, one gradient step replayed
    ``grad_refine_steps`` times, and the rest; the later ticks replay
    them).  Eager: K3 and K2 once a tick, finite means every tick, the
    tick's time and the gradient chain's share of it, and the last tick's
    ``_grad_refine`` repeated on the CPU from the same inputs, its three
    means within GRAD_REFINE_ATOL of the card's.  Compiled: every tick's
    planner state bit-equal to the eager tick's, K3 and K2 launched as
    often (its first tick's calls and its replays), each graph's nodes,
    capture time and pool.  Returns (launch counts, their replayed part, K3
    calls, K2 calls), the calls the eager run's."""
    from m3p2i_aip_tpu_torch.config.config_store import load_config
    from m3p2i_aip_tpu_torch.ops import panda_rollout as pr
    from m3p2i_aip_tpu_torch.tamp.reactive_tamp import ReactiveTAMP
    from m3p2i_aip_tpu_torch.tamp.sim_loop import SimLoop
    from m3p2i_aip_tpu_torch.utils.tree import tree_map

    cfg = load_config("config_panda", GRAD_REFINE)
    runs = {}
    for graphs in (False, None):
        loop = SimLoop(cfg, device="cuda", graphs=graphs)
        _compiled_steps(loop, "warmup", 50)
        mp = loop.tamp.motion_planner
        grad_refine, chain_s, recorded = mp._grad_refine, [], {}

        def timed_grad_refine(state, sim_state_k, task, grad_refine=grad_refine, chain_s=chain_s, recorded=recorded):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = grad_refine(state, sim_state_k, task)
            torch.cuda.synchronize()
            chain_s.append(time.perf_counter() - t0)
            recorded.update(inputs=(state, sim_state_k, task), out=out)
            return out

        if graphs is False:
            mp._grad_refine = timed_grad_refine
        tick_s, states = [], []
        _zero_launches()
        eager = graphs is False  # the compiled run records nothing: a replay makes no call
        with (_recorded(pr, "panda_rollout") if eager else contextlib.nullcontext([])) as k3_calls, \
                (_recorded_weights("multimodal_weights") if eager else contextlib.nullcontext([])) as k2_calls:
            for i in range(GRAD_REFINE_TICKS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                loop.run_chunked(1, chunk=1)
                torch.cuda.synchronize()
                tick_s.append(time.perf_counter() - t0)
                ms = loop.tamp.mppi_state
                states.append(graph_ab.carry_fields(ms))
                assert torch.isfinite(torch.stack([ms.mean_action, ms.mean_action_1, ms.mean_action_2])).all(), \
                    f"grad-refine tick {i}: non-finite means"
        mp._grad_refine = grad_refine
        counts, replayed = _read_launches(), _read_replayed()
        mode = "eager" if graphs is False else "compiled"
        _expect_launches(f"grad-refine panda {mode}", counts,
                         {"panda_rollout_launches": GRAD_REFINE_TICKS, "weights_launches": GRAD_REFINE_TICKS})
        runs[mode] = (states, tick_s, counts, replayed, loop.tamp.ticks.stats())
        if graphs is False:
            eager_calls = (k3_calls, k2_calls)
            tick_ms, chain_ms = float(np.median(tick_s)) * 1e3, float(np.median(chain_s)) * 1e3
            print(f"[grad-refine panda] eager: {GRAD_REFINE_TICKS} ticks at K={mp.K} x T={mp.T}, "
                  f"{mp.grad_refine_steps} gradient steps of 3 chains: median tick {tick_ms:.1f} ms, of it the chain "
                  f"{chain_ms:.1f} ms ({100 * chain_ms / tick_ms:.1f}%); ticks "
                  f"{', '.join(f'{t * 1e3:.1f}' for t in tick_s)} ms ({card})")
            cpu_mp = ReactiveTAMP(cfg, device="cpu").motion_planner
            state, sim_state_k, task = (tree_map(lambda x: x.cpu(), x) for x in recorded["inputs"])
            ref = cpu_mp._grad_refine(state, sim_state_k, task)
            err = max(float(torch.max(torch.abs(getattr(recorded["out"], f).cpu() - getattr(ref, f))))
                      for f in ("mean_action", "mean_action_1", "mean_action_2"))
            moved = float(torch.max(torch.abs(recorded["out"].mean_action - recorded["inputs"][0].mean_action)))
            print(f"[grad-refine panda] the last eager tick's refinement on the card against the port on the CPU "
                  f"from the same inputs: max abs err {err:.3e} (bar {GRAD_REFINE_ATOL}); it moved the global mean "
                  f"by up to {moved:.4f}")
            assert err <= GRAD_REFINE_ATOL, f"grad-refine: card vs CPU means differ by {err}"
        del loop
    (eager, eager_s, eager_counts, _, _), (comp, comp_s, comp_counts, replayed, graphs) = runs["eager"], runs["compiled"]
    diffs = graph_ab.differ(eager, comp)
    print(f"[grad-refine panda] compiled: ticks {', '.join(f'{t * 1e3:.1f}' for t in comp_s)} ms (the first runs "
          f"eagerly and captures); planner state after each tick bit-equal to the eager run's: {not diffs} ({card})")
    for g in graphs:
        print(f"[grad-refine panda] graph {g['key']}: capture {g['capture_s']:.2f} s, {g['nodes']} nodes, pool "
              f"{g['pool_bytes'] / 2**20:.1f} MiB, launches a replay {g['launches']}; segments (nodes x replays, "
              f"capture s) " + ", ".join(f"{x['nodes']} x {x['replays']} ({x['capture_s']:.2f})"
                                         for x in g["segments"]))
    assert not diffs, f"grad-refine: the compiled ticks differ from the eager ticks: {diffs[:5]}"
    assert any(len(g["segments"]) == 3 for g in graphs), "grad-refine: no three-segment tick was captured"
    counts = {KERNEL_OF_COUNTER[name]: eager_counts[name] + comp_counts[name] for name in eager_counts}
    return counts, replayed, *eager_calls


def phase_urdf(card: str) -> None:
    """The URDF FK cross-check on the card: the vendored franka URDF's
    chain (``utils/urdf.py``, read in place) against ``panda_fk.fk`` on
    URDF_SAMPLES random joint vectors, and the vendored albert URDF's chain
    at the base pose against ``albert.fk``, within URDF_ATOL."""
    from m3p2i_aip_tpu_torch.models import albert, panda_fk
    from m3p2i_aip_tpu_torch.utils import urdf
    from m3p2i_aip_tpu_torch.utils.path_utils import get_assets_path

    root = get_assets_path() / "urdf"
    g = torch.Generator(device="cuda").manual_seed(0)
    lo = torch.as_tensor(panda_fk.JOINT_LOWER, device="cuda")
    hi = torch.as_tensor(panda_fk.JOINT_UPPER, device="cuda")
    q9 = lo + (hi - lo) * torch.rand(URDF_SAMPLES, 9, generator=g, device="cuda")
    chain = urdf.load_chain(str(root / "franka_description/robots/franka_panda.urdf"), "panda_hand")
    n_pos, n_rot = panda_fk.fk(q9, torch.zeros(3, device="cuda"))["hand"]
    u_pos, u_rot = chain.fk(q9[:, :7])["panda_hand"]
    err = max(float(torch.max(torch.abs(u_pos - n_pos))), float(torch.max(torch.abs(u_rot - n_rot))))
    base = torch.rand(URDF_SAMPLES, 3, generator=g, device="cuda") * 4.0 - 2.0
    q = torch.cat([base, q9], dim=1)
    z = torch.zeros(URDF_SAMPLES, device="cuda")
    state = albert.AlbertState(q=q, qd=torch.zeros_like(q), box_pos=torch.zeros_like(base[:, :2]), box_yaw=z,
                               box_vel=torch.zeros_like(base[:, :2]), box_om=z)
    a_pos, a_rot = albert.fk(state)["hand"]
    achain = urdf.load_chain(str(root / "albert/albert.urdf"), "panda_hand", root_link="base_link")
    base_pos = torch.cat([q[:, :2], z[:, None]], dim=1)
    b_pos, b_rot = achain.fk(q[:, 3:10], base_pos=base_pos, base_rot=panda_fk._rot_z(q[:, 2]))["panda_hand"]
    a_err = max(float(torch.max(torch.abs(b_pos - a_pos))), float(torch.max(torch.abs(b_rot - a_rot))))
    print(f"[urdf] {URDF_SAMPLES} joint vectors on the card: franka URDF chain vs panda_fk max abs err {err:.3e}, "
          f"albert URDF chain at the base pose vs albert.fk {a_err:.3e} (bar {URDF_ATOL}; {card})")
    assert err <= URDF_ATOL and a_err <= URDF_ATOL, "the URDF chains disagree with the native FK"


# ------------------------------------------------------------------------
# the sample axis and the seed axis split over a mesh of one card's shards

def _card_mesh(n: int):
    """A mesh of ``n`` shards of the first card (``parallel.make_mesh``)."""
    from m3p2i_aip_tpu_torch.parallel import make_mesh

    return make_mesh([torch.device("cuda", 0)] * n)


def _log_record(log) -> dict:
    """A TickLog's ticks, success tick, tasks and positions, to compare runs."""
    return {"steps": log.steps, "success_step": log.success_step, "task": list(log.task),
            **{name: np.asarray(getattr(log, name)) for name in ("robot_pos", "robot_vel", "box_pos")}}


def _assert_same_log(label: str, log, ref: dict) -> None:
    for key, want in _log_record(log).items():
        same = np.array_equal(want, ref[key]) if isinstance(want, np.ndarray) else want == ref[key]
        assert same, f"{label}: {key} differs from the unsharded run's"


def _k0s(calls, column: int) -> list:
    """The global offsets of a run's recorded rollout calls, in order of first use."""
    return sorted({int(x[0][column]) for _, x in calls})


def phase_sample_shard(card: str, main_log: dict) -> tuple:
    """The sample axis split over shards of one card (``shard_planner``):
    the gated main path over each of SAMPLE_SHARDS (the 8-shard run
    pipelined, each enqueue watched for host syncs; the 5-shard run serial)
    must latch at the unsharded main path's tick with logs bit-equal to its
    (``main_log``), K1 launched once a shard and K2 once per dispatched
    tick; every K1 call, each at its shard's global offset, equal to the
    plain version bit for bit.  Then the multi-modal panda (PANDA_SHARD_TICKS,
    chunks of 10) and the albert push_reach (gated) over FAMILY_SHARDS,
    each tick for tick equal to its unsharded run with K3 / K4 launched once
    a shard a rollout, every call held to its plain version.  A profile of
    the 8-shard main path in benchmark mode, the gather's time, and the
    sweep of ``phase_shard_sweep``.  Returns (launch counts, K2 calls by run)."""
    from m3p2i_aip_tpu_torch.config.config_store import load_config
    from m3p2i_aip_tpu_torch.ops import albert_rollout as ar
    from m3p2i_aip_tpu_torch.ops import panda_rollout as pr
    from m3p2i_aip_tpu_torch.ops import rollout as ro
    from m3p2i_aip_tpu_torch.parallel import sample_sharding, shard_planner
    from m3p2i_aip_tpu_torch.tamp.sim_loop import SimLoop

    launches = {"point_rollout": 0, "multimodal_weights": 0, "panda_rollout": 0, "albert_rollout": 0}
    k2_runs, replayed = {}, {}
    for n in SAMPLE_SHARDS:
        label, pipelined = f"sample-shard point x{n}", n == SAMPLE_SHARDS[0]
        loop = SimLoop(load_config("config_point", MAIN_PATH), device="cuda", graphs=False)
        shard_planner(loop.tamp.motion_planner, _card_mesh(n))
        _compiled_steps(loop, "warmup", 50)
        dispatched, run_chunk, syncs = 0, loop.tamp.run_chunk, []

        def counted_run_chunk(ms, rs, task, i0, length, run_chunk=run_chunk):
            nonlocal dispatched
            dispatched += length
            return run_chunk(ms, rs, task, i0, length)

        loop.tamp.run_chunk = counted_run_chunk
        loop._enqueue_chunk = _watch_syncs(loop._enqueue_chunk, syncs)
        _zero_launches()
        t0 = time.perf_counter()
        with _recorded(ro, "point_rollout") as k1_calls, _recorded_weights("multimodal_weights") as k2_calls:
            log = loop.run_chunked(1000, chunk=50, pipelined=pipelined)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _read_launches()
        print(f"[{label}] {'pipelined' if pipelined else 'serial'}: {log.steps} ticks logged, {dispatched} dispatched "
              f"in {wall:.2f} s, success tick {log.success_step} (unsharded {main_log['success_step']}); host syncs "
              f"per enqueue {[len(x) for x in syncs]}")
        _expect_launches(label, counts, {"rollout_launches": n * dispatched, "weights_launches": dispatched})
        assert log.success_step is not None and log.success_step == main_log["success_step"]
        _assert_same_log(label, log, main_log)
        assert not pipelined or (syncs and not any(syncs)), f"{label}: an enqueue synchronised the host: {syncs}"
        k_loc = loop.tamp.motion_planner.K // n
        assert _k0s(k1_calls, 3) == list(range(0, n * k_loc, k_loc)), _k0s(k1_calls, 3)
        err = phase_every_call(f"K1 {label}", k1_calls, ro.point_rollout)
        assert err == 0.0, f"{label}: K1 differs from its plain version by {err}"
        launches["point_rollout"] += counts["rollout_launches"]
        launches["multimodal_weights"] += counts["weights_launches"]
        k2_runs[label] = k2_calls
        if pipelined:  # the same split compiled: one graph a tick, each shard's rollout a branch on a stream of its own
            cloop = SimLoop(load_config("config_point", MAIN_PATH), device="cuda")
            shard_planner(cloop.tamp.motion_planner, _card_mesh(n))
            cloop.warmup(50)
            _zero_launches()
            t0 = time.perf_counter()
            clog = cloop.run_chunked(1000, chunk=50, pipelined=True)
            torch.cuda.synchronize()
            cwall = time.perf_counter() - t0
            ccounts, crep = _read_launches(), _read_replayed()
            print(f"[{label}] compiled, pipelined: {clog.steps} ticks logged in {cwall:.2f} s, success tick "
                  f"{clog.success_step}; launches {ccounts} (replayed {crep}); graphs " + "; ".join(
                      f"{g['key']}: {g['nodes']} nodes, capture {g['capture_s'] * 1e3:.1f} ms"
                      for g in cloop.tamp.ticks.stats()))
            _assert_same_log(f"{label} compiled", clog, main_log)
            assert ccounts == counts, f"{label}: compiled launches {ccounts}, eager {counts}"
            assert cloop.tamp._compiled() and any(g["key"][0] == "gated" for g in cloop.tamp.ticks.stats()), \
                f"{label}: the sharded tick was not captured"
            launches["point_rollout"] += ccounts["rollout_launches"]
            launches["multimodal_weights"] += ccounts["weights_launches"]
            for kernel, m in crep.items():
                replayed[kernel] = replayed.get(kernel, 0) + m
            del cloop
        if pipelined:  # the split's costs on the main path: the gather and the device's idle share
            costs = torch.randn(loop.tamp.motion_planner.K, loop.tamp.motion_planner.T, device="cuda")
            shard = sample_sharding(loop.tamp.motion_planner.mesh)
            parts = shard.split(costs)
            print(f"[{label}] gather of the [K, T] costs from {n} shards: {_time_ms(lambda: shard.gather(parts)):.4f} "
                  f"ms single, {_device_ms(lambda: shard.gather(parts)):.4f} ms replayed ({card})")
            bench_record.gates_off(loop)
            _profile_ticks(label, card, lambda: loop.run_chunked(SHARD_PROFILE_TICKS, chunk=SHARD_PROFILE_TICKS // 2),
                           SHARD_PROFILE_TICKS, {"K1": "point_rollout", "K2": "weights"})
        del loop

    for label, config_name, overrides, mod, name, flat, bars, col in (
        ("sample-shard panda", "config_panda", ["multi_modal=True"], pr, "panda_rollout", _panda_plain_flat,
         PLANAR_BARS, 8),
        ("sample-shard albert", "config_albert", PUSH_REACH, ar, "albert_rollout", _albert_plain_flat, ALBERT_BARS, 4),
    ):
        panda, runs = config_name == "config_panda", {}
        cfg = load_config(config_name, overrides)
        for n in (None, FAMILY_SHARDS):
            loop = SimLoop(load_config(config_name, overrides), device="cuda", graphs=False)
            if n is not None:
                shard_planner(loop.tamp.motion_planner, _card_mesh(n))
            _compiled_steps(loop, "warmup", 50 if panda else 20)
            record = _count_panda_ticks(loop) if panda else _count_chunk_views(loop)
            _zero_launches()
            with _recorded(mod, name) as calls, _recorded_weights("multimodal_weights") as k2_calls:
                log = loop.run_chunked(PANDA_SHARD_TICKS if panda else PUSH_REACH_TICKS, chunk=10)
            torch.cuda.synchronize()
            views = torch.cat([v for _, v in record]).cpu().numpy()
            runs[n] = (log, views, calls, k2_calls, _read_launches(), sum(k for k, _ in record))
        (log, views, *_), (slog, sviews, calls, k2_calls, counts, dispatched) = runs[None], runs[FAMILY_SHARDS]
        rungs = 1 + int(cfg.mppi.refine_iters)
        k2_per_tick = int(cfg.mppi.refine_iters) if cfg.multi_modal else 0  # the greedy last rung takes no weights
        print(f"[{label} x{FAMILY_SHARDS}] {slog.steps} ticks logged, {dispatched} dispatched, success tick "
              f"{slog.success_step} (unsharded {log.success_step}); tasks {sorted(set(slog.task))}")
        _expect_launches(f"{label} x{FAMILY_SHARDS}", counts, {
            f"{name}_launches": FAMILY_SHARDS * rungs * dispatched, "weights_launches": k2_per_tick * dispatched,
        })
        assert (slog.steps, slog.success_step, slog.task) == (log.steps, log.success_step, log.task), label
        assert np.array_equal(sviews, views) and np.isfinite(views).all(), f"{label}: the views differ tick for tick"
        assert panda or slog.success_step is not None, f"{label}: no success in {PUSH_REACH_TICKS} ticks"
        print(f"[{label} x{FAMILY_SHARDS}] {views.shape[0]} ticks' views bit-equal to the unsharded run's")
        k_loc = cfg.mppi.num_samples // FAMILY_SHARDS
        assert _k0s(calls, col) == list(range(0, FAMILY_SHARDS * k_loc, k_loc)), _k0s(calls, col)
        phase_every_call(f"{name} {label}", calls, getattr(mod, name), flat, bars)
        launches[name] += counts[f"{name}_launches"]
        launches["multimodal_weights"] += counts["weights_launches"]
        if k2_calls:
            k2_runs[label] = k2_calls
    phase_shard_sweep(card)
    return launches, k2_runs, replayed


def phase_shard_sweep(card: str) -> None:
    """The bench_sharded twin's sweep on one card (``sweep_row``), its
    commands compiled (``MPPI.command``'s program, one CUDA graph a
    command): the main path's planner at K in SWEEP_K (horizon 12)
    unsharded and over 8 shards of the card; the first commands from
    identical planner states must be equal (K=16384 included: K2 past its
    old 12288 samples), then SWEEP_TICKS chained commands timed in turns
    (unsharded, 8, 8, unsharded): ms a replan and the ratio.  At each K the
    compiled command of a mesh of 1 shard (the sharded code path alone) must
    give exactly an eager unsharded planner's command: the second command of
    each from identical planner states (the compiled one's first replay)."""
    from m3p2i_aip_tpu_torch.parallel import shard_planner
    from m3p2i_aip_tpu_torch.scripts import bench_sharded
    from m3p2i_aip_tpu_torch.tamp.reactive_tamp import ReactiveTAMP

    for K in SWEEP_K:
        row = bench_sharded.sweep_row(K, SWEEP_TICKS, torch.device("cuda"), _card_mesh(8))
        assert row["tick"] == "graph", row["tick"]
        print(f"[shard-sweep] K={row['K']}, compiled, ms a replan in turns U 8 8 U: unsharded "
              f"{', '.join(f'{t:.3f}' for t in row['unsharded_runs_ms'])}, 8 shards "
              f"{', '.join(f'{t:.3f}' for t in row['sharded_runs_ms'])} (x{row['sharded_over_unsharded']:.3f}); first "
              f"commands' max |diff| {row['action_maxdiff']} ({card})")
        assert row["action_maxdiff"] == 0.0, f"K={row['K']}: the sharded first command differs"
        tamps = [ReactiveTAMP(bench_sharded.config(row["K"]), device="cuda", graphs=g) for g in (False, None)]
        shard_planner(tamps[1].motion_planner, _card_mesh(1))
        state = tamps[0].env.init_state()
        task = tamps[0].tamp_interface(state)
        first = []
        for tamp in tamps:  # the second command from the start state: the compiled planner's first replay
            tamp.motion_planner.command(tamp.mppi_state, state, task)
            first.append(tamp.motion_planner.command(tamp.mppi_state, state, task)[0])
        assert [g["key"][0] for g in tamps[1].ticks.stats()] == ["command"] and not tamps[0].ticks.programs
        assert torch.equal(*first), f"K={row['K']}: the 1-shard command differs from the unsharded one"
        print(f"[shard-sweep] K={row['K']}: the 1-shard mesh's compiled command equals the eager unsharded one")


def phase_northstar(card: str) -> tuple:
    """The north-star shape K=500 x T=30 through the bench_northstar twin's
    config: NORTHSTAR_CHECKED benchmark-mode ticks recorded (eager), every
    K1 call held to the plain version (K1's 63 blocks of 8 samples, the last
    partial, and its chain twice the main path's).  Returns (launch counts
    of the run, the recorded K2 calls)."""
    from m3p2i_aip_tpu_torch.ops import rollout as ro
    from m3p2i_aip_tpu_torch.scripts import bench_northstar
    from m3p2i_aip_tpu_torch.tamp.sim_loop import SimLoop

    loop = SimLoop(bench_northstar.config(), device="cuda", graphs=False)
    _compiled_steps(loop, "warmup", 50)
    bench_record.gates_off(loop)
    _zero_launches()
    with _recorded(ro, "point_rollout") as k1_calls, _recorded_weights("multimodal_weights") as k2_calls:
        loop.run_chunked(NORTHSTAR_CHECKED, chunk=NORTHSTAR_CHECKED)
    torch.cuda.synchronize()
    counts = _read_launches()
    err = phase_every_call("K1 north-star K=500 x T=30", k1_calls, ro.point_rollout)
    ticks = NORTHSTAR_CHECKED
    _expect_launches("north-star", counts, {"rollout_launches": ticks, "weights_launches": ticks})
    print(f"[north-star] K=500 x T=30: {ticks} ticks, K1 max err {err:.3e} ({card}); its rates, eager and "
          f"compiled, are [graph-rate north-star serial]'s")
    return {"point_rollout": ticks, "multimodal_weights": ticks}, k2_calls


def phase_weights_large(card: str) -> None:
    """K2 and K2b past the 12288 samples the kernel once took: at K in
    WEIGHTS_LARGE_K on uniform(0, 50) costs (T=15, the main path's
    discount, half_K = K / 2), the cost-to-go in opted-in shared memory
    (16384) and in global scratch (65536), against the plain version within
    K2's bars (each seed of a B=2 batch too); timed single and replayed.
    At 16384 a launch captured into a CUDA graph must equal an eager launch
    bit for bit (the shared-memory opt-in is made once per device, before
    any capture, not in the launch)."""
    from m3p2i_aip_tpu_torch.ops import weights

    gamma = torch.as_tensor(np.cumprod([1.0] + [0.95] * 14).astype(np.float32), device="cuda")
    for K in WEIGHTS_LARGE_K:
        rng = np.random.default_rng(K)
        cost = torch.as_tensor(rng.uniform(0, 50, size=(2, K, 15)).astype(np.float32), device="cuda")
        single = (cost[0], gamma, K // 2, 10.0, 3.0)
        batched = (cost, gamma, K // 2, 10.0, 3.0)
        errs = []
        for kernel, plain, args in ((weights.multimodal_weights, weights.multimodal_weights_plain, single),
                                    (weights.multimodal_weights_batched, weights.multimodal_weights_plain, batched)):
            got, ref = kernel(*args), plain(*args)
            torch.cuda.synchronize()
            errs.append(max(float(torch.max(torch.abs(g - r))) for g, r in zip(got, ref)))
            sums = torch.stack([g.sum(-1) for g in got]).flatten().tolist()
            assert errs[-1] <= WEIGHTS_ATOL and all(abs(x - 1.0) < SUM_TOL for x in sums), (K, errs[-1], sums)
        print(f"[weights-large] K={K}: max |kernel - plain| K2 {errs[0]:.3e}, K2b (B=2) {errs[1]:.3e}; rounds "
              f"{weights.beta_rounds(*single)[0].tolist()}; K2 {_time_ms(lambda: weights.multimodal_weights(*single)):.4f}"
              f" ms single, {_device_ms(lambda: weights.multimodal_weights(*single)):.4f} replayed; K2b "
              f"{_device_ms(lambda: weights.multimodal_weights_batched(*batched)):.4f} replayed; bound "
              f"{roofline.weights_bound(single)} ({card})")
    graph_ab.check_weights_captured(K=WEIGHTS_LARGE_K[0])


def phase_utilization(card: str) -> None:
    """The analyze_utilization twin's table (``workload``, chunks of
    UTIL_CHUNK_TICKS, the compiled tick): the reference and north-star
    workloads' K1 and K2 against their bounds, the tick and the device's
    idle share."""
    from m3p2i_aip_tpu_torch.scripts import analyze_utilization

    rows = [analyze_utilization.workload(K, T, torch.device("cuda"), UTIL_CHUNK_TICKS, graphs=True)
            for K, T in analyze_utilization.SHAPES]
    print(json.dumps(rows))
    print(analyze_utilization.table(rows))
    assert all(r["kernel_ms"] > 0 and r["weights_ms"] > 0 for r in rows), rows
    print(f"[utilization] {len(rows)} workloads, chunks of {UTIL_CHUNK_TICKS} ({card})")


def _chunk_bench(batch, tasks: list, n_chunks: int, i0: int, chunk: int = LOOP_CHUNK) -> None:
    """``n_chunks`` benchmark-mode chunks of ``chunk`` ticks of every shard
    of ``batch`` (gates off): every shard's chunk enqueued, then each
    shard's views fetched, as ``BatchSimLoop.run_chunked`` does."""
    for c in range(n_chunks):
        outs = [sh.tamp._run_chunk_impl(sh.mppi_state, sh.state, task, i0 + c * chunk, chunk, gate=False)
                for sh, task in zip(batch._shards, tasks)]
        for sh, (ms, rs, views, _, _) in zip(batch._shards, outs):
            sh.mppi_state, sh.state = ms, rs
            views.cpu()


def phase_seed_shard(card: str, unsharded: dict) -> tuple:
    """The seed axis over SEED_SHARDS shards of one card
    (``BatchSimLoop(shard=mesh)``), compiled (a graph a shard): the n=20
    point and panda batches of ``phase_seed_batch`` must give every seed
    the unsharded eager batch's row (in
    every column but the clocks) and success tick (``unsharded``: family ->
    (rows, success ticks)), each batched kernel launched once a shard per
    tick; then the point batch's seed-ticks/s sharded beside unsharded in
    turns (benchmark mode, warm-up 50), and ``run_experiments
    parallel_seeds=shard`` on the default mesh (every visible card).
    Returns the launch counts summed by counter and their replayed part by
    kernel."""
    import tempfile

    from m3p2i_aip_tpu_torch.config.config_store import load_config
    from m3p2i_aip_tpu_torch.scripts import run_experiments
    from m3p2i_aip_tpu_torch.tamp import batch_loop
    from m3p2i_aip_tpu_torch.tamp.batch_loop import BatchSimLoop

    total, replayed = {}, {}

    def add(counts: dict, part: dict) -> None:
        for name, n in counts.items():
            total[name] = total.get(name, 0) + n
        for name, n in part.items():
            replayed[name] = replayed.get(name, 0) + n

    mesh = _card_mesh(SEED_SHARDS)
    for family, config_name, overrides, chunk, cap, per_tick in (
        ("point", "config_point", MAIN_PATH, 4, 300,
         {"rollout_batched_launches": 1, "weights_batched_launches": 1, "step_batched_launches": 1}),
        ("panda", "config_panda", ["multi_modal=True"], 10, 600,
         {"panda_rollout_batched_launches": 4, "weights_batched_launches": 3, "panda_step_batched_launches": 1}),
    ):
        label = f"seed-shard {family} x{SEED_SHARDS}"
        counts, rows, steps, part = phase_seed_batch(label, config_name, overrides, chunk, cap, per_tick,
                                                     shard=mesh, graphs=True)
        ref_rows, ref_steps = unsharded[family]
        cols = SIM_COLUMNS[family]
        assert steps == ref_steps, f"{label}: success ticks {steps}, unsharded {ref_steps}"
        assert np.array_equal(rows[:, cols], ref_rows[:, cols]), f"{label}: rows differ from the unsharded batch's"
        print(f"[{label}] every seed's row and success tick equal to the unsharded batch's")
        add(counts, part)

    batches = {}
    for sharded in (False, True):
        batch = BatchSimLoop(load_config("config_point", MAIN_PATH), list(range(N_SEEDS)),
                             shard=mesh if sharded else False, device="cuda", graphs=True)
        batch.warmup(50)
        for b, tp in enumerate(batch.planners):
            tp.update_plan(batch.views[b])
        batches[sharded] = (batch, [batch._stacked_task_params(sh.seeds, sh.tamp.device) for sh in batch._shards])
    rates, i0 = {False: [], True: []}, {False: 0, True: 0}
    for sharded in (False, True, True, False):
        batch, tasks = batches[sharded]
        _chunk_bench(batch, tasks, 1, i0[sharded])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _chunk_bench(batch, tasks, SEED_BENCH_CHUNKS, i0[sharded] + LOOP_CHUNK)
        wall = time.perf_counter() - t0
        i0[sharded] += (1 + SEED_BENCH_CHUNKS) * LOOP_CHUNK
        rates[sharded].append(SEED_BENCH_CHUNKS * LOOP_CHUNK * N_SEEDS / wall)
    print(f"[seed-shard bench] B={N_SEEDS}, chunks of {LOOP_CHUNK}: unsharded "
          f"{', '.join(f'{r:.2f}' for r in rates[False])} seed-ticks/s, {SEED_SHARDS} shards "
          f"{', '.join(f'{r:.2f}' for r in rates[True])} seed-ticks/s (in turns U S S U; {SEED_BENCH_CHUNKS * LOOP_CHUNK} "
          f"timed ticks a turn) ({card})")
    _profile_ticks(f"seed-shard bench x{SEED_SHARDS}", card,
                   lambda: _chunk_bench(*batches[True], 1, 0, SHARD_PROFILE_TICKS), SHARD_PROFILE_TICKS,
                   {"K1b": "point_rollout", "K2b": "multimodal_weights"})
    del batches

    made, init = [], BatchSimLoop.__init__

    def recording_init(self, *args, **kwargs):
        init(self, *args, **kwargs)
        made.append(self)

    batch_loop.BatchSimLoop.__init__ = recording_init
    _zero_launches()
    try:
        with tempfile.TemporaryDirectory() as out:
            run_experiments.main([*MAIN_PATH, "n_runs=4", "chunked=4", "parallel_seeds=shard", f"out={out}/rows.npy"])
    finally:
        batch_loop.BatchSimLoop.__init__ = init
    torch.cuda.synchronize()
    counts = _read_launches()
    (batch,) = made
    ok = [log.success_step is not None for log in batch.logs]
    print(f"[seed-shard run_experiments] parallel_seeds=shard: a mesh of {batch.mesh.size} card(s), "
          f"{len(batch._shards)} shard(s); {sum(ok)}/4 succeeded; launches {counts}")
    assert batch.mesh is not None and batch.mesh.size == torch.cuda.device_count() == len(batch._shards)
    assert all(ok), "parallel_seeds=shard: a seed did not reach the goal"
    assert counts["rollout_batched_launches"] > 0 and counts["rollout_launches"] == 0, counts
    add(counts, _read_replayed())
    return total, replayed


_START = time.perf_counter()


def _compiled_steps(loop, method: str, n: int) -> None:
    """``loop.warmup(n)`` or ``loop.settle(n)`` with its steps replayed from a
    CUDA graph (``graph_tick.env_steps``) whatever the loop's tick mode: a
    warm-up or a settle launches no kernel, so a phase that runs the eager
    tick to record its kernel calls still steps its scene compiled (bit for
    bit the eager steps, tests/test_torch_compiled_paths.py)."""
    ticks = loop.tamp.ticks
    loop.tamp.ticks = graph_tick.TickGraphs(loop.env.device, None)
    try:
        getattr(loop, method)(n)
    finally:
        loop.tamp.ticks = ticks


def _stamp(label: str) -> None:
    """The smoke's elapsed wall time at the end of a step of ``main``."""
    print(f"[elapsed] {time.perf_counter() - _START:.1f} s after {label}")


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py: no CUDA device; this script runs only on a GPU")
    from m3p2i_aip_tpu_torch.config.config_store import load_config
    from m3p2i_aip_tpu_torch.ops import albert_rollout as ar
    from m3p2i_aip_tpu_torch.ops import cuda_build
    from m3p2i_aip_tpu_torch.ops import panda_rollout as pr
    from m3p2i_aip_tpu_torch.ops import rollout as ro
    from m3p2i_aip_tpu_torch.tamp.reactive_tamp import ReactiveTAMP

    # 1. device
    _count_env_steps()  # before any env is made
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    card = bench_record.nvidia_smi()
    print(f"[device] {kind}; nvidia-smi: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    # 2. build
    t0 = time.perf_counter()
    cuda_build.load_kernels()
    print(f"[build] {time.perf_counter() - t0:.1f} s ({cuda_build.build_info['path']})")
    print(cuda_build.build_info["log"].strip())

    # the runs that record every kernel call's inputs from Python (a replayed
    # CUDA graph makes no call) run the eager tick (graphs=False), and
    # phase_graphs holds the compiled tick, the entry points' default, to them
    # bit for bit; launches made by graph replays are kept apart, in
    # graph_launches
    graph_launches: dict = {}
    cfg = load_config("config_point", MAIN_PATH)
    tamp = ReactiveTAMP(cfg, device="cuda", graphs=False)
    _stamp("the build")
    # 3. / 4. each kernel against its plain version
    stats = {"multimodal_weights": phase_weights(tamp.motion_planner), "point_rollout": phase_rollout(tamp)}
    del tamp
    _stamp("the K1 / K2 checks")
    # 5. / 6. the point main path
    with _recorded_weights("multimodal_weights") as k2_point, _recorded_steps() as step_calls:
        loop, launches, k1_calls = phase_main_path(load_config("config_point", MAIN_PATH))
    point_chunked_tick = loop.log.success_step
    main_log = _log_record(loop.log)
    del loop
    _stamp("the point path")
    # 7. K3 against its plain version; 8. / 9. / 10. the panda path
    stats["panda_rollout"], w_err, k3_parity = phase_panda_rollout()
    with _recorded_steps(pps, "panda_step") as panda_step_calls:
        launches["panda_rollout"], k3_calls, panda_chunked_tick, launches["panda_step"] = phase_panda_main()
    with _recorded_weights("multimodal_weights") as k2_shelf:
        w_err = max(w_err, phase_panda_shelf())
    k2 = stats["multimodal_weights"]
    k2["max_abs_err"] = max(k2["max_abs_err"], w_err)  # over the point and the panda shapes and costs
    _stamp("the panda path")
    # 11. K4 against its plain version; 12. - 15. the albert path
    stats["albert_rollout"], k4_parity = phase_albert_rollout(card)
    with _recorded(ar, "albert_rollout") as k4_calls:
        launches["albert_rollout"] = phase_albert_main()
        phase_albert_push()
    phase_albert_breakdown(card)
    _stamp("the albert path")
    # 16. - 18. the batched kernels against their plain versions and single launches, timed at B=20
    stats["point_rollout_batched"], stats["multimodal_weights_batched"] = phase_point_batched()
    stats["panda_rollout_batched"], w_err, k3b_parity = phase_panda_batched()
    k2b = stats["multimodal_weights_batched"]
    k2b["max_abs_err"] = max(k2b["max_abs_err"], w_err)
    stats["albert_rollout_batched"], k4b_parity = phase_albert_batched()
    _stamp("the batched kernels' checks")
    # 19. - 21. the three n=20 batches through BatchSimLoop
    with _recorded(ro, "point_rollout_batched") as k1b_calls, \
            _recorded_weights("multimodal_weights_batched") as k2b_point, _recorded_steps() as step_b_calls:
        point_counts, point_rows, point_steps, _ = phase_seed_batch(
            "batch-point", "config_point", MAIN_PATH, 4, 300,
            {"rollout_batched_launches": 1, "weights_batched_launches": 1, "step_batched_launches": 1},
            keep="point batch", graphs=False,
        )
    with _recorded(pr, "panda_rollout_batched") as k3b_calls, \
            _recorded_weights("multimodal_weights_batched") as k2b_panda, \
            _recorded_steps(pps, "panda_step") as panda_step_b_calls:
        panda_counts, panda_rows, panda_steps, _ = phase_seed_batch(
            "batch-panda", "config_panda", ["multi_modal=True"], 10, 600,
            {"panda_rollout_batched_launches": 4, "weights_batched_launches": 3, "panda_step_batched_launches": 1},
            keep="panda batch", graphs=False,
        )
    with _recorded(ar, "albert_rollout_batched") as k4b_calls:
        albert_counts, _, _, _ = phase_seed_batch(
            "batch-albert", "config_albert", [], 10, 300, {"albert_rollout_batched_launches": 4},
            keep="albert batch", graphs=False,
        )
    launches["point_rollout_batched"] = point_counts["rollout_batched_launches"]
    launches["multimodal_weights_batched"] = (
        point_counts["weights_batched_launches"] + panda_counts["weights_batched_launches"]
    )
    launches["panda_rollout_batched"] = panda_counts["panda_rollout_batched_launches"]
    launches["albert_rollout_batched"] = albert_counts["albert_rollout_batched_launches"]
    launches["point_step_batched"] = point_counts["step_batched_launches"]
    launches["panda_step_batched"] = panda_counts["panda_step_batched_launches"]
    _stamp("the n=20 batches")
    # 21b. K5 and K5b against the plain step on the main path's and the n=20 batch's steps, timed;
    # K1 beside each step
    stats["point_step"], stats["point_step_batched"] = phase_point_step(card, step_calls + step_b_calls,
                                                                        k1_calls[-1])
    del step_calls, step_b_calls
    # 21c. K6 and K6b against the plain step on the panda main path's and the n=20 panda batch's steps, timed
    stats["panda_step"], stats["panda_step_batched"] = phase_panda_step(card, panda_step_calls + panda_step_b_calls)
    del panda_step_calls, panda_step_b_calls
    _stamp("the real-env step's checks")
    # 22. / 23. three seeds batched against three serial runs, compiled
    phase_batch_vs_serial("batch-vs-serial point", "config_point", MAIN_PATH, 4, 300)
    phase_batch_vs_serial("batch-vs-serial panda", "config_panda", ["multi_modal=True"], 10, 600)
    _stamp("batched vs serial")
    # 25. / 26. the heijn and boxer closed loops and the planner-mode runs, each gated;
    # 27. the heijn and boxer rates
    k1_runs, k2_runs = {}, {}
    for label, config_name, overrides, cap in FAMILY_LOOPS + MODE_LOOPS:
        with _recorded_weights("multimodal_weights") as k2_calls:
            counts, k1_runs[label] = phase_gated_loop(label, config_name, overrides, cap)
        if k2_calls:
            k2_runs[label] = k2_calls
        launches["point_rollout"] += counts["rollout_launches"]
        launches["multimodal_weights"] += counts["weights_launches"]
        launches["point_step"] += counts["step_launches"]
    family_hz = {name: phase_family_bench(card, f"config_{name}", f"family-bench {name}") for name in ("heijn", "boxer")}
    _stamp("the family and planner-mode runs")
    # 28. - 30. the README's entry points: the run_tamp script per tick, the two terminals over a
    # socket, checkpoint / resume
    counts, k2_runs["point per-tick"], in_process_ms = phase_run_sim(
        card, {"point": point_chunked_tick, "panda": panda_chunked_tick}
    )
    for name, n in counts.items():
        launches[name] += n
    _add_launches(launches, graph_launches, *phase_two_terminal(card, in_process_ms))
    _add_launches(launches, graph_launches, *phase_checkpoint())
    _stamp("the entry points")
    # 31. pipelined chunks on the main path; 32. the round-4 panda's gradient refinement;
    # 33. the URDF FK cross-check
    counts, k1_runs["pipelined gated"], k2_runs["pipelined gated"], serial_log = phase_pipelined(card)
    grad_counts, grad_replayed, k3_grad, k2_runs["panda grad-refine"] = phase_grad_refine(card)
    for name, n in counts.items():
        launches[name] += n
    _add_launches(launches, graph_launches, grad_counts, grad_replayed)
    phase_every_call("K3 grad-refine panda", k3_grad, pr.panda_rollout, _panda_plain_flat)
    del k3_grad
    phase_urdf(card)
    _stamp("pipelined chunks, gradient refinement and the URDF check")
    # 33b. the compiled tick against the eager tick: bits, capture, launches, rates in turns
    counts, replayed, rates = phase_graphs(card, serial_log)
    _add_launches(launches, graph_launches, counts, replayed)
    _stamp("the compiled tick")
    # 34. the sample axis over shards of the card: the main path, the panda and the albert, the
    # sweep; 35. the seed axis: the n=20 point and panda batches, the rate, run_experiments
    counts, shard_k2, shard_replayed = phase_sample_shard(card, main_log)
    k2_runs.update(shard_k2)
    seed_counts, replayed = phase_seed_shard(
        card, {"point": (point_rows, point_steps), "panda": (panda_rows, panda_steps)})
    _add_launches(launches, graph_launches, counts, shard_replayed)
    _add_launches(launches, graph_launches, {KERNEL_OF_COUNTER[name]: n for name, n in seed_counts.items()}, replayed)
    _stamp("the sample and seed shards")
    # 36. the twins' new paths: the north-star shape, K2 / K2b at K = 16384 and 65536, the
    # utilization table (the sharded K=16384 tick is step 34's sweep)
    counts, k2_runs["north-star"] = phase_northstar(card)
    for name, n in counts.items():
        launches[name] += n
    phase_weights_large(card)
    phase_utilization(card)
    _stamp("the north-star, K2 at large K and the utilization table")
    # 37. K1, K1b, K3, K3b, K4 and K4b on the closed loops' inputs (K1 on every call of
    # steps 25, 26 and 31's runs), then K2 and K2b; 38. the scaling sweeps
    slowest = {}
    for name, label, calls, kernel, plain, ops, single in (
        ("point_rollout", "K1", k1_calls, ro.point_rollout, ro.point_rollout_batched_plain,
         roofline.point_rollout_ops, None),
        ("point_rollout_batched", "K1b", k1b_calls, ro.point_rollout_batched, ro.point_rollout_batched_plain,
         roofline.point_rollout_ops, ro.point_rollout),
        ("panda_rollout", "K3", k3_calls, pr.panda_rollout, pr.panda_rollout_batched_plain,
         roofline.panda_rollout_ops, None),
        ("panda_rollout_batched", "K3b", k3b_calls, pr.panda_rollout_batched, pr.panda_rollout_batched_plain,
         roofline.panda_rollout_ops, pr.panda_rollout),
        ("albert_rollout", "K4", k4_calls, ar.albert_rollout, ar.albert_rollout_batched_plain,
         roofline.albert_rollout_ops, None),
        ("albert_rollout_batched", "K4b", k4b_calls, ar.albert_rollout_batched, ar.albert_rollout_batched_plain,
         roofline.albert_rollout_ops, ar.albert_rollout),
    ):
        live = name.startswith("point")  # the point kernel's bound counts its live contacts
        bars = ALBERT_BARS if name.startswith("albert") else PLANAR_BARS
        entry, slowest[label] = phase_closed_loop(card, label, calls, kernel, plain, ops, single, live, bars)
        stats[name].update(entry)
        calls.clear()
    for label, calls in k1_runs.items():
        phase_every_call(f"K1 {label}", calls, ro.point_rollout)
        phase_closed_loop(card, f"K1 {label}", calls, ro.point_rollout, ro.point_rollout_batched_plain,
                          roofline.point_rollout_ops, None, True, PLANAR_BARS)
        calls.clear()
    from m3p2i_aip_tpu_torch.ops import weights

    entry, slowest["K2"] = phase_weights_closed_loop(
        card, "K2", {"point main path": k2_point, "panda shelf": k2_shelf, **k2_runs},
        weights.multimodal_weights, weights.multimodal_weights_plain,
    )
    stats["multimodal_weights"].update(entry)
    entry, slowest["K2b"] = phase_weights_closed_loop(
        card, "K2b", {"point n=20 batch": k2b_point, "panda n=20 batch": k2b_panda},
        weights.multimodal_weights_batched, weights.multimodal_weights_plain, weights.multimodal_weights,
    )
    stats["multimodal_weights_batched"].update(entry)
    del k2_point, k2_shelf, k2b_point, k2b_panda, k2_runs
    phase_rollout_scaling(card, ("K1", "K1b"), _launch_shape("point_rollout", "point_rollout_kernel"),
                          ro.point_rollout, ro.point_rollout_batched,
                          {"random-action": _point_random_inputs(), "closed-loop": (slowest["K1"], slowest["K1b"])})
    # the S = 3 instantiation, which the panda scenes launch
    phase_rollout_scaling(card, ("K3", "K3b"), _launch_shape("panda_rollout", "panda_rollout_kernelILi3E"),
                          pr.panda_rollout, pr.panda_rollout_batched,
                          {"parity": (k3_parity, k3b_parity), "closed-loop": (slowest["K3"], slowest["K3b"])})
    phase_rollout_scaling(card, ("K4", "K4b"), _launch_shape("albert_rollout", "albert_rollout_kernel"),
                          ar.albert_rollout, ar.albert_rollout_batched,
                          {"parity": (k4_parity, k4b_parity), "closed-loop": (slowest["K4"], slowest["K4b"])},
                          ALBERT_SCALING_K)
    w_random = phase_weights_random_inputs()
    phase_weights_scaling(card, {"random": w_random[0], "closed-loop": slowest["K2"]},
                          {"random": w_random[1], "closed-loop": slowest["K2b"]})

    _stamp("the closed-loop checks and the sweeps")
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
        "point_rollout_batched": (
            "m3p2i_aip_tpu_torch/csrc/point_rollout.cu",
            "m3p2i_aip_tpu/ops/pallas_rollout.py:802",
        ),
        "multimodal_weights_batched": (
            "m3p2i_aip_tpu_torch/csrc/multimodal_weights.cu",
            "m3p2i_aip_tpu/ops/pallas_kernels.py:173",
        ),
        "panda_rollout_batched": (
            "m3p2i_aip_tpu_torch/csrc/panda_rollout.cu",
            "m3p2i_aip_tpu/ops/pallas_panda_rollout.py:851",
        ),
        "albert_rollout_batched": (
            "m3p2i_aip_tpu_torch/csrc/albert_rollout.cu",
            "m3p2i_aip_tpu/ops/pallas_albert_rollout.py:425",
        ),
        # no TPU kernel: the JAX real-env step is XLA code
        "point_step": ("m3p2i_aip_tpu_torch/csrc/point_step.cu", "none, XLA: m3p2i_aip_tpu/models/point_env.py:283"),
        "point_step_batched": (
            "m3p2i_aip_tpu_torch/csrc/point_step.cu",
            "none, XLA: m3p2i_aip_tpu/models/point_env.py:283",
        ),
        "panda_step": ("m3p2i_aip_tpu_torch/csrc/panda_step.cu", "none, XLA: m3p2i_aip_tpu/models/panda_env.py:204"),
        "panda_step_batched": (
            "m3p2i_aip_tpu_torch/csrc/panda_step.cu",
            "none, XLA: m3p2i_aip_tpu/models/panda_env.py:204",
        ),
    }
    never = [name for name in sources if launches[name] == 0]
    assert not never, f"kernels whose wrappers launched them no time: {never}"
    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep, "launches": launches[name],
         "graph_launches": graph_launches.get(name, 0), **stats[name]}
        for name, (src, rep) in sources.items()
    ]
    hz = {name: (float(np.median(r["compiled_hz"])), float(np.median(r["eager_hz"]))) for name, r in rates.items()}
    print("[bench] compiled / eager (medians of the turns): " + ", ".join(
        f"{name} {c:.2f} / {e:.2f} Hz" for name, (c, e) in hz.items()) + f"; heijn {family_hz['heijn']:.2f} Hz, "
        f"boxer {family_hz['boxer']:.2f} Hz compiled, on {card}")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
