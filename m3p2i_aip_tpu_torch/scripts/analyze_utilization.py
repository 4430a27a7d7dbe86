"""Utilization and roofline evidence for the port's hot path, on the H100.

Twin of ``scripts/analyze_utilization.py`` for its two workloads (:1-28):
the point push_pull multi-modal path at the reference shape K=200 x T=15
and the north-star shape K=500 x T=30 (:data:`SHAPES`).  For each:

* the rollout kernel K1's f32 operations and bytes from
  ``analysis/roofline.py``'s counts of the kernel's work on these inputs
  (the live contacts of the plain version counted on them), not from a cost
  model, and the floors they give at the card's peaks (67 TFLOP/s f32,
  3.35 TB/s: NVIDIA's data sheet at 700 W; the card's power limit is
  recorded beside them);
* K1's time from CUDA events, one call (``kernel_ms_incl_dispatch``) and
  calls replayed from a CUDA graph (``kernel_ms``), with the achieved rates
  as shares of the peaks; the same for the weights kernel K2 on K1's costs;
* the whole replan+step tick on the host clock to a synchronize: one tick
  alone (``fused_tick_ms_incl_dispatch``) and per tick of a 20-tick chunk
  (``fused_tick_ms``), the JAX script's key names;
* the device's busy time a tick and its idle share over that chunk, from
  ``torch.profiler``.

Operations are the random-action inputs' (uniform(-3, 3), seed 0, from the
start state).  On the CPU (``device=cpu``) only the counts and the host
ticks are taken: no kernel time, no profile.

    python -m m3p2i_aip_tpu_torch.scripts.analyze_utilization [--eager] [device=cpu] [out=PATH|-]

Writes ``results_h100/UTILIZATION.json``, prints its JSON line and a
markdown table.  Runs on the card unless ``device=cpu``.
"""
from __future__ import annotations

import os
import sys

import numpy as np
import torch

from m3p2i_aip_tpu_torch.analysis import bench_record as br
from m3p2i_aip_tpu_torch.analysis import roofline
from m3p2i_aip_tpu_torch.config.config_store import load_config
from m3p2i_aip_tpu_torch.ops import rollout as ro
from m3p2i_aip_tpu_torch.ops import weights
from m3p2i_aip_tpu_torch.scripts.bench import MAIN_PATH
from m3p2i_aip_tpu_torch.scripts.run_tamp import pop_flag, pop_option
from m3p2i_aip_tpu_torch.tamp.sim_loop import SimLoop
from m3p2i_aip_tpu_torch.utils.tree import tree_map

SHAPES = ((200, 15), (500, 30))  # (K, T) of the two workloads (scripts/analyze_utilization.py:453-454)
CHUNK_TICKS = 20
LABELS = {(200, 15): "reference", (500, 30): "north-star"}


def config(K: int, T: int):
    """``scripts/analyze_utilization.py``'s composed config at K x T."""
    return load_config("config_point", [*MAIN_PATH, f"mppi.num_samples={K}", f"mppi.horizon={T}",
                                        f"mppi.u_per_command={T}"])


def _kernel_fields(prefix: str, fn, n_ops: float, n_bytes: int) -> dict:
    """A kernel's times on the card and its achieved shares of the peaks."""
    single, replayed = br.event_ms(fn), br.replayed_ms(fn)
    s = replayed * 1e-3
    return {
        f"{prefix}_ms_incl_dispatch": single,
        f"{prefix}_ms": replayed,
        f"{prefix}_flops_per_s": n_ops / s,
        f"{prefix}_pct_f32": 100 * n_ops / s / roofline.PEAK_F32_S,
        f"{prefix}_hbm_pct": 100 * n_bytes / s / roofline.PEAK_BYTES_S,
    }


def workload(K: int, T: int, device: torch.device, chunk_ticks: int, graphs=None) -> dict:
    """One workload's row (see the module docstring), its tick timed and
    profiled in chunks of ``chunk_ticks``; ``graphs`` as ``SimLoop``'s (the
    row's ``tick`` says which ran)."""
    cfg = config(K, T)
    loop = SimLoop(cfg, device=device, graphs=graphs)
    loop.warmup(50)
    tamp = loop.tamp
    mp, spec = tamp.motion_planner, tamp.motion_planner.rollout.spec
    task = tamp.tamp_interface_view(loop._view)
    sk = tree_map(lambda x: x.expand((K,) + x.shape), tamp.env.init_state())
    rng = np.random.default_rng(0)
    acts = torch.as_tensor(rng.uniform(-3, 3, size=(K, T, tamp.env.nu)).astype(np.float32), device=device)
    inputs = ro.rollout_inputs(sk, task)
    with roofline.live_contacts() as live:
        cost = ro.point_rollout_plain(spec, *inputs, acts)[0]
    flops = roofline.point_rollout_ops(spec, K, roofline.total(live))
    n_bytes = roofline.tensor_bytes(spec.params_buf, *inputs, acts) + K * T * 3 * 4
    w_args = (cost, mp.gamma_seq, mp.half_K, mp.eta_u, mp.eta_l)
    w_ops = roofline.weights_ops(w_args)
    w_bytes = roofline.tensor_bytes(cost, mp.gamma_seq) + 3 * K * 4
    row = {
        "workload": f"{LABELS.get((K, T), 'point')} (K={K} x T={T})",
        "tick": tamp.ticks.mode,
        "K": K,
        "T": T,
        "rollout_flops": flops,
        "kernel_hbm_bytes": n_bytes,
        "compute_floor_us": flops / roofline.PEAK_F32_S * 1e6,
        "memory_floor_us": n_bytes / roofline.PEAK_BYTES_S * 1e6,
        "weights_flops": w_ops,
        "weights_hbm_bytes": w_bytes,
        "weights_floor_us": roofline.weights_bound(w_args)["bound_ms"] * 1e3,
    }
    if device.type == "cuda":
        row.update(_kernel_fields("kernel", lambda: ro.point_rollout(spec, *inputs, acts), flops, n_bytes))
        row.update(_kernel_fields("weights", lambda: weights.multimodal_weights(*w_args), w_ops, w_bytes))
    br.gates_off(loop)
    ms, rs = tamp.mppi_state, loop.state
    row["fused_tick_ms_incl_dispatch"] = br.host_ms(lambda: tamp._run_chunk_impl(ms, rs, task, 0, 1, gate=False),
                                                    device=device)
    row["fused_tick_ms"] = br.host_ms(lambda: tamp._run_chunk_impl(ms, rs, task, 0, chunk_ticks, gate=False),
                                      calls=3, device=device) / chunk_ticks
    if device.type == "cuda":
        prof = br.profile(lambda: tamp._run_chunk_impl(ms, rs, task, 0, chunk_ticks, gate=False), chunk_ticks,
                          {"K1": "point_rollout", "K2": "weights"})
        if prof is not None:
            row.update(device_tick_ms=prof["device_ms_per_tick"], device_idle_pct=prof["idle_pct"],
                       kernels_per_tick=prof["kernels_per_tick"],
                       kernel_ms_per_tick=prof["kernel_ms_per_tick"])
    return row


def table(rows: list) -> str:
    """The markdown table of the JAX script's, for the port's fields."""
    def f(r, key):
        return "-" if r.get(key) is None else f"{r[key]:.4g}"

    lines = ["| workload | rollout GFLOP | K1 ms (replayed / single) | % f32 peak | % HBM | compute floor us | "
             "memory floor us | tick ms (in a chunk / alone) | device idle % |", "|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        lines.append(
            f"| {r['workload']} | {r['rollout_flops'] / 1e9:.4g} | {f(r, 'kernel_ms')} / "
            f"{f(r, 'kernel_ms_incl_dispatch')} | {f(r, 'kernel_pct_f32')} | {f(r, 'kernel_hbm_pct')} | "
            f"{f(r, 'compute_floor_us')} | {f(r, 'memory_floor_us')} | {f(r, 'fused_tick_ms')} / "
            f"{f(r, 'fused_tick_ms_incl_dispatch')} | {f(r, 'device_idle_pct')} |"
        )
    return "\n".join(lines)


def main(argv) -> dict:
    device, argv = pop_option(argv, "device", "cuda")
    out, argv = pop_option(argv, "out", None)
    eager, argv = pop_flag(argv, "--eager")
    device = br.require_device(device, "analyze_utilization")
    rows = [workload(K, T, device, CHUNK_TICKS, False if eager else None) for K, T in SHAPES]
    dev = br.device_record(device)
    rec = {
        "platform": dev["platform"],
        "device": dev,
        "peaks": {"f32_flops": roofline.PEAK_F32_S, "hbm_bytes_per_s": roofline.PEAK_BYTES_S,
                  "source": "NVIDIA H100 SXM data sheet, at 700 W", "power_limit": dev["power_limit"]},
        "rows": rows,
    }
    br.emit(rec, None, out or os.path.join(br.RESULTS_DIR, "UTILIZATION.json"))
    print("\n" + table(rows))
    return rec


if __name__ == "__main__":
    main(sys.argv[1:])
