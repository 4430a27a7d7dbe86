"""Record the per-tick and the chunked panda runs tick by tick and report
the first tick where they part.

Both runs start from the same warmed-up scene and the same generator state:
one is ``SimLoop.tick`` (the host active-inference planner every tick), the
other ``ReactiveTAMP.run_chunk_panda`` one tick at a time (the device gate
``_panda_gate_device``; a chunk's ticks are the same calls as one-tick
chunks).  For every tick the script keeps the task the tick planned for
(task id, goal, gripper, stall gate), the planner's three means after it and
the real state after it, and prints, for each of them, the first tick at
which the two runs differ in it and by how much (the goal only where a tick
plans a pick: the reach and place costs do not read it, and the host
planner leaves it at zeros until the first pick).

    python -m m3p2i_aip_tpu_torch.scripts.trace_tick_paths [n_ticks=120] [warmup=150] [device=cuda] [OVERRIDES...]

It ends with one JSON line: the first tick at which anything differs (null
when the runs agree), the fields that differ there, and each run's success
tick.
"""
from __future__ import annotations

import json
import sys

import numpy as np
import torch

from m3p2i_aip_tpu_torch.config.config_store import load_config_from_argv
from m3p2i_aip_tpu_torch.scripts.run_tamp import pop_option
from m3p2i_aip_tpu_torch.tamp.sim_loop import SimLoop

_STATE_FIELDS = ("q", "qd", "body_pos", "body_vel", "body_quat", "attached")
_MEAN_FIELDS = ("mean_action", "mean_action_1", "mean_action_2")


def _row(task, mppi_state, state) -> dict:
    """One tick's record as numpy arrays: the task it planned for, the means
    after it and the real state after it."""
    row = {
        "task_id": task.task_id, "goal": task.goal, "gripper": task.gripper, "zup_gate": task.zup_gate,
    }
    row.update({f: getattr(mppi_state, f) for f in _MEAN_FIELDS})
    row.update({f: getattr(state, f) for f in _STATE_FIELDS})
    return {k: v.detach().cpu().numpy().astype(np.float64) for k, v in row.items()}


def record_per_tick(cfg, n_ticks: int, warmup: int, device) -> tuple:
    """(rows, success tick) of ``SimLoop.tick``; a tick that logs success
    without replanning ends the record."""
    loop = SimLoop(cfg, device=device)
    loop.warmup(warmup)
    rows = []
    for i in range(n_ticks):
        done = loop.tick(i)
        if loop.log.replan_s[-1] == 0.0:  # logged without a replan
            break
        rows.append(_row(loop.tamp._tp_cached, loop.tamp.mppi_state, loop.state))
        if done:
            break
    return rows, loop.log.success_step


def record_chunked(cfg, n_ticks: int, warmup: int, device) -> tuple:
    """(rows, success tick) of one-tick ``run_chunk_panda`` calls."""
    loop = SimLoop(cfg, device=device)
    loop.warmup(warmup)
    tamp = loop.tamp
    stage = torch.zeros((), dtype=torch.int32, device=tamp.device)
    zs = tamp.zup_zs0()
    rows, success = [], None
    for i in range(n_ticks):
        task, _, _, _ = tamp._panda_gate_device(loop.state, stage, zs)
        tamp.mppi_state, loop.state, stage, zs, done, _, _, _ = tamp.run_chunk_panda(
            tamp.mppi_state, loop.state, stage, zs, 1
        )
        rows.append(_row(task, tamp.mppi_state, loop.state))
        if bool(done):
            success = i
            break
    return rows, success


def first_differences(a: list, b: list) -> dict:
    """{field: (first tick at which the records differ in it, the largest
    difference at that tick)} over the ticks both records share; a reach
    tick's goal counts only where the tick's costs read it (pick)."""
    first = {}
    for i, (ra, rb) in enumerate(zip(a, b)):
        for k in ra:
            if k in first or np.array_equal(ra[k], rb[k]):
                continue
            if k == "goal" and ra["task_id"] != 5 and rb["task_id"] != 5:
                continue
            first[k] = (i, float(np.max(np.abs(ra[k] - rb[k]))))
    return first


def main(argv) -> dict:
    n_ticks, argv = pop_option(argv, "n_ticks", "120")
    warmup, argv = pop_option(argv, "warmup", "150")
    device, argv = pop_option(argv, "device", "cuda")
    cfg = load_config_from_argv(["-cn", "config_panda"] + list(argv))
    per_tick, per_tick_success = record_per_tick(cfg, int(n_ticks), int(warmup), device)
    cfg = load_config_from_argv(["-cn", "config_panda"] + list(argv))
    chunked, chunked_success = record_chunked(cfg, int(n_ticks), int(warmup), device)
    first = first_differences(per_tick, chunked)
    shared = min(len(per_tick), len(chunked))
    if not first:
        print(f"the two runs agree on all {shared} ticks they share")
    for k, (tick, diff) in sorted(first.items(), key=lambda kv: kv[1][0]):
        print(f"{k}: first differs at tick {tick} by {diff:.3e} (task id per tick {per_tick[tick]['task_id']}, "
              f"chunked {chunked[tick]['task_id']}; stall gate {per_tick[tick]['zup_gate']} / {chunked[tick]['zup_gate']})")
    tick = min((t for t, _ in first.values()), default=None)
    result = {
        "shared_ticks": shared,
        "first_difference_tick": tick,
        "fields": sorted(k for k, (t, _) in first.items() if t == tick),
        "per_tick_success": per_tick_success,
        "chunked_success": chunked_success,
    }
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
