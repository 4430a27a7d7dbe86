"""Sample-axis sharding benchmark of the port and its crossover study, on
the H100.

Twin of ``scripts/bench_sharded.py``: for each K of a sweep (default 512,
2048, 8192, 16384; each cut to a multiple of twice the shard count), the
main path's planner at horizon 12 unsharded and with its samples split over
a mesh (``parallel.shard_planner``): the first commands of both from
identical planner states (``action_equal`` within the JAX script's
K-scaled tolerance, ``action_maxdiff``), then ``--ticks`` chained commands
from the start state on the host clock to a synchronize, in turns
(unsharded, sharded, sharded, unsharded; medians), and the sharded /
unsharded ratio.  The commands are ``MPPI.command``'s compiled program, as
the JAX script times the jitted one (one CUDA graph replayed a command; on
one card the shards are parallel branches of it), or with ``--eager`` the
eager call; every line's ``"tick"`` says which (``graph``, ``eager``, or
``static`` on the CPU).  The mesh spans every visible card, or with
``--virtual`` 8 shards of one device (``cuda:0``, or the CPU with
``--device cpu``): on one card the split measures its overhead only.  The
affine crossover model of the JAX script is fitted to the sweep.

    python -m m3p2i_aip_tpu_torch.scripts.bench_sharded [--virtual] [--eager] [--ticks 20] \\
        [--sweep 512,2048,8192,16384] [--device cpu] [--out PATH|-]

Prints one JSON line per K and the summary line, written to
``results_h100/bench/PARALLEL_BENCH.json``.  Runs on the card unless
``--device cpu``.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from m3p2i_aip_tpu_torch.analysis import bench_record as br
from m3p2i_aip_tpu_torch.config.config_store import load_config
from m3p2i_aip_tpu_torch.parallel import make_mesh, shard_planner
from m3p2i_aip_tpu_torch.scripts.bench import MAIN_PATH
from m3p2i_aip_tpu_torch.tamp.reactive_tamp import ReactiveTAMP


def config(K: int):
    """``scripts/bench_sharded.py``'s composed config at K samples."""
    return load_config("config_point", [*MAIN_PATH, f"mppi.num_samples={K}", "mppi.horizon=12",
                                        "mppi.u_per_command=12"])


def _first_action_and_replan(tamp, ticks: int):
    """One command's first action from the planner's initial state (after
    one warm-up command), and a closure timing ``ticks`` chained commands:
    ms a replan on the host clock to a synchronize."""
    mp, device = tamp.motion_planner, tamp.device
    state = tamp.env.init_state()
    task = tamp.tamp_interface(state)
    mp.command(tamp.mppi_state, state, task)
    act = mp.command(tamp.mppi_state, state, task)[0][0]

    def replan_ms() -> float:
        ms = tamp.mppi_state
        br.synchronize(device)
        t0 = time.perf_counter()
        for _ in range(ticks):
            _, ms, _ = mp.command(ms, state, task)
        br.synchronize(device)
        return (time.perf_counter() - t0) / ticks * 1e3

    return act, replan_ms


def sweep_row(K_req: int, ticks: int, device, mesh, graphs=None) -> dict:
    """One K of the sweep: unsharded against ``mesh``, both planners'
    commands compiled (``graphs=None``) or eager (``graphs=False``)."""
    n = mesh.size
    K = K_req - K_req % (2 * n)  # an even split of each mode over the shards
    tamp_u = ReactiveTAMP(config(K), device=device, graphs=graphs)
    tamp_s = ReactiveTAMP(config(K), device=device, graphs=graphs)
    shard_planner(tamp_s.motion_planner, mesh)
    act_u, time_u = _first_action_and_replan(tamp_u, ticks)
    act_s, time_s = _first_action_and_replan(tamp_s, ticks)
    # the JAX package's tolerance: its sharded weights sum in a psum-tree
    # order; the port gathers the costs and sums them as unsharded
    maxdiff = float(torch.max(torch.abs(act_u - act_s)))
    runs = {"u": [], "s": []}
    for side in ("u", "s", "s", "u"):
        runs[side].append((time_u if side == "u" else time_s)())
    dt_u, dt_s = float(np.median(runs["u"])), float(np.median(runs["s"]))
    return {
        "K": K,
        "tick": tamp_s.ticks.mode,
        "unsharded_replan_ms": dt_u,
        "sharded_replan_ms": dt_s,
        "sharded_over_unsharded": dt_s / dt_u,
        "sharded_samples_per_sec_per_device": K / (dt_s * 1e-3) / n,
        "action_equal": maxdiff <= 1e-4 * max(1.0, K / 2048),
        "action_maxdiff": maxdiff,
        "unsharded_runs_ms": runs["u"],
        "sharded_runs_ms": runs["s"],
    }


def crossover_model(rows: list, n: int):
    """The JAX script's affine model: t_u(K) = a + b K fitted to the sweep,
    the partition cost c the median of t_s - t_u, and the K at which a real
    n-device mesh would win, K* = c / (b (1 - 1/n)); None when it has no
    positive fit."""
    if len(rows) < 2:
        return None
    Ks = np.asarray([r["K"] for r in rows], dtype=np.float64)
    t_u = np.asarray([r["unsharded_replan_ms"] for r in rows]) * 1e-3
    t_s = np.asarray([r["sharded_replan_ms"] for r in rows]) * 1e-3
    b_fit, a_fit = np.polyfit(Ks, t_u, 1)
    c_part = float(np.median(t_s - t_u))
    if b_fit <= 0 or c_part <= 0:
        return None
    return {
        "t_unsharded_affine_fit": {"a_s": float(a_fit), "b_s_per_sample": float(b_fit)},
        "c_partition_s": c_part,
        "c_partition_note": "median(t_sharded - t_unsharded) over the sweep; with the shards on one device this "
                            "is the split's overhead alone",
        "mesh_devices": n,
        "predicted_crossover_K_real_mesh": int(round(c_part / (b_fit * (1.0 - 1.0 / max(n, 2))))),
        "model": "K* = c_part / (b * (1 - 1/n))",
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--virtual", action="store_true", help="8 shards of one device")
    ap.add_argument("--eager", action="store_true", help="time the eager command, not its compiled program")
    ap.add_argument("--ticks", type=int, default=20)
    ap.add_argument("--sweep", type=str, default="512,2048,8192,16384", help="comma-separated K values")
    ap.add_argument("--device", type=str, default="cuda")
    ap.add_argument("--out", type=str, default=None)
    args = ap.parse_args(argv)
    device = br.require_device(args.device, "bench_sharded")
    home = torch.device("cuda", torch.cuda.current_device()) if device.type == "cuda" else device
    mesh = make_mesh([home] * 8 if args.virtual else (None if device.type == "cuda" else [device]))
    n = mesh.size

    rows, crossover_K = [], None
    for K_req in (int(x) for x in args.sweep.split(",")):
        row = sweep_row(K_req, args.ticks, device, mesh, graphs=False if args.eager else None)
        if crossover_K is None and row["sharded_over_unsharded"] < 1.0:
            crossover_K = row["K"]
        rows.append(row)
        br.emit(row, None, "-")
        if not row["action_equal"]:  # keep sweeping: one K over the tolerance must not lose the study
            print(f"MISMATCH at K={row['K']}: max |diff| {row['action_maxdiff']}", file=sys.stderr)
    model = crossover_model(rows, n)
    one_device = len(set(mesh.devices)) == 1
    dev = br.device_record(device)
    rec = {
        "devices": n,
        "tick": rows[0]["tick"],
        "platform": dev["platform"],
        "device": dev,
        "ticks": args.ticks,
        "sweep": rows,
        "crossover_model": model,
        "predicted_crossover_K_real_mesh": model["predicted_crossover_K_real_mesh"] if model else None,
        "crossover_K": crossover_K,  # the first K at which the split beat unsharded here (null: never)
        "note": ("every shard on one device: the sweep measures the split's overhead, not scaling"
                 if one_device else "a mesh of distinct devices"),
    }
    br.emit(rec, "PARALLEL_BENCH.json", args.out)
    return rec


if __name__ == "__main__":
    main()
