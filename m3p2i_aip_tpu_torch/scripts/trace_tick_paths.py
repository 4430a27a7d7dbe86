"""Record the per-tick and the chunked panda runs tick by tick and report
the first tick where they part; or, with ``seed=N``, trace one seed of a
point-family row tick by tick.

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

With ``seed=N`` (a point, heijn or boxer scene: the overrides name it) the
script runs seed N as ``run_experiments`` runs a row's seed (``reset(N)``,
a 20-step warm-up, ``run_chunked(n_steps, chunk=4)``, the chunk of the
two-corner rows of ``run_quality_campaign``; ``n_ticks=`` caps it) and
records every tick's robot and box positions and every plan the host task
planner makes at a chunk boundary: its task and goal, the pocket-endgame
stage, the stall count and the reposition budget.  It prints each change
of plan and one JSON line (the ticks the robot and the box last moved, the
repositions, the last plan); ``out=PATH.npz`` keeps the record (the views
the planner was given, in order).

    python -m m3p2i_aip_tpu_torch.scripts.trace_tick_paths seed=17 [n_ticks=1000] [out=PATH.npz] \\
        -cn config_boxer task=push_pull multi_modal=True ...
"""
from __future__ import annotations

import json
import sys
from typing import Optional

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


_PLAN_FIELDS = ("_pocket_stage", "_stall_n", "_relatch_left")
SEED_CHUNK = 4  # a seed trace's chunk: the two-corner rows' chunked=4 (run_quality_campaign.ROWS)


def _plan(tp) -> dict:
    """The host planner's plan after an ``update_plan``."""
    return {"task": tp.task, "goal": np.asarray(tp.curr_goal, np.float64)[:2].tolist(),
            **{f[1:]: int(getattr(tp, f)) for f in _PLAN_FIELDS},
            "latch_d_bg": getattr(tp, "_latch_d_bg", None)}


def record_seed(cfg, seed: int, n_ticks: int, chunk: int, device) -> dict:
    """One seed of a point-family row, chunked: {"views0": the view the first
    plan reads, "robot_pos", "box_pos" [ticks, 2] after each tick, "plans":
    [(tick, plan)] for every ``update_plan``, "success_step"}."""
    from m3p2i_aip_tpu_torch.tamp.sim_loop import SimLoop

    loop = SimLoop(cfg, device=device)
    loop.reset(seed)
    loop.warmup(20)
    tp, plans = loop.tamp.task_planner, []
    update = tp.update_plan

    def recorded(view):
        update(view)
        plans.append((loop.log.steps, _plan(tp)))

    tp.update_plan = recorded
    view0 = {k: np.asarray(loop._view[k], np.float32) for k in ("robot_pos", "box_pos")}
    log = loop.run_chunked(n_ticks, chunk=chunk)
    return {"views0": view0, "robot_pos": np.asarray(log.robot_pos, np.float32),
            "box_pos": np.asarray(log.box_pos, np.float32), "plans": plans, "success_step": log.success_step}


def _last_move(pos: np.ndarray, tol: float = 1e-3) -> int:
    """The last tick at which ``pos`` [ticks, 2] moved more than ``tol``."""
    moved = np.nonzero(np.linalg.norm(np.diff(pos, axis=0), axis=-1) > tol)[0]
    return int(moved[-1]) + 1 if moved.size else 0


def trace_seed(argv, seed: int, n_ticks: Optional[int], device) -> dict:
    """``seed=N``'s trace (see the module docstring); ``n_ticks`` None: the
    config's ``n_steps``."""
    out, argv = pop_option(argv, "out", None)
    cfg = load_config_from_argv(list(argv))
    rec = record_seed(cfg, seed, cfg.n_steps if n_ticks is None else n_ticks, SEED_CHUNK, device)
    prev = None
    for tick, plan in rec["plans"]:
        key = (plan["task"], plan["goal"], plan["pocket_stage"], plan["relatch_left"])
        if key != prev:
            print(f"tick {tick}: {plan}; robot {rec['robot_pos'][tick - 1] if tick else rec['views0']['robot_pos']}, "
                  f"box {rec['box_pos'][tick - 1] if tick else rec['views0']['box_pos']}")
            prev = key
    result = {
        "seed": seed, "ticks": int(rec["robot_pos"].shape[0]), "success_step": rec["success_step"],
        "robot_final": rec["robot_pos"][-1].tolist(), "box_final": rec["box_pos"][-1].tolist(),
        "robot_last_moved": _last_move(rec["robot_pos"]), "box_last_moved": _last_move(rec["box_pos"]),
        "repositions": sum(1 for (_, a), (_, b) in zip(rec["plans"], rec["plans"][1:])
                           if b["task"] == "reposition" and a["task"] != "reposition"),
        "last_plan": rec["plans"][-1][1],
    }
    if out:
        ticks, plans = zip(*rec["plans"])
        np.savez_compressed(out, robot_pos0=rec["views0"]["robot_pos"], box_pos0=rec["views0"]["box_pos"],
                            robot_pos=rec["robot_pos"], box_pos=rec["box_pos"], plan_tick=np.asarray(ticks),
                            plan=np.asarray([json.dumps(p) for p in plans]))
    print(json.dumps(result))
    return result


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
    n_ticks, argv = pop_option(argv, "n_ticks", None)
    warmup, argv = pop_option(argv, "warmup", "150")
    device, argv = pop_option(argv, "device", "cuda")
    seed, argv = pop_option(argv, "seed", None)
    if seed is not None:
        return trace_seed(argv, int(seed), None if n_ticks is None else int(n_ticks), device)
    cfg = load_config_from_argv(["-cn", "config_panda"] + list(argv))
    n_ticks = int(n_ticks or 120)
    per_tick, per_tick_success = record_per_tick(cfg, n_ticks, int(warmup), device)
    cfg = load_config_from_argv(["-cn", "config_panda"] + list(argv))
    chunked, chunked_success = record_chunked(cfg, n_ticks, int(warmup), device)
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
