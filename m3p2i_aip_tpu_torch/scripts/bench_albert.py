"""Albert replan-rate benchmark of the port: the mobile manipulator's
push_reach at its config's K x T, on the H100.

Twin of ``scripts/bench_albert.py`` at its protocol: ``config_albert`` with
``task=push_reach`` to [3, 0, 0.6], ``warmup(20)``, both success gates off,
two chunks of 100 to settle, then 400 timed ticks in chunks of 100
(``M3P2I_BENCH_CHUNK``, ``M3P2I_BENCH_TICKS``), one after another; every
tick a full replan with the softmax refine ladder and a real-env step.  The
metric's name carries the config's K and T (:67-70).  ``kernel`` (the JAX
script's ``use_pallas``) is true when the CUDA rollout kernel K4 ran the
planner's rollouts.

    python -m m3p2i_aip_tpu_torch.scripts.bench_albert [--eager] [device=cpu] [out=PATH|-] [overrides...]

Prints one JSON line and writes it to ``results_h100/bench/ALBERT_BENCH.json``
(``bench``'s line embeds it).  Runs on the card unless ``device=cpu``.
"""
from __future__ import annotations

import sys

from m3p2i_aip_tpu_torch.analysis import bench_record as br
from m3p2i_aip_tpu_torch.config.config_store import load_config
from m3p2i_aip_tpu_torch.scripts.run_tamp import pop_flag, pop_option
from m3p2i_aip_tpu_torch.tamp.sim_loop import SimLoop

PUSH_REACH = ["task=push_reach", "goal=[3.0,0.0,0.6]"]


def config(overrides=()):
    """``scripts/bench_albert.py``'s composed config, then ``overrides``."""
    return load_config("config_albert", [*PUSH_REACH, *overrides])


def measure(loop, chunk: int, ticks: int) -> dict:
    """The rate of a warmed-up albert loop at ``bench_albert.py``'s protocol."""
    return br.settled_rate(loop, chunk, ticks, pipelined=False)


def main(argv) -> dict:
    device, argv = pop_option(argv, "device", "cuda")
    out, argv = pop_option(argv, "out", None)
    eager, argv = pop_flag(argv, "--eager")
    device = br.require_device(device, "bench_albert")
    cfg = config(argv)
    chunk = br.env_int("M3P2I_BENCH_CHUNK", 100)
    ticks = br.env_int("M3P2I_BENCH_TICKS", 400)

    loop = SimLoop(cfg, device=device, graphs=False if eager else None)
    loop.warmup(20)
    before = br.launch_counts()
    rate = measure(loop, chunk, ticks)
    K, T = int(cfg.mppi.num_samples), int(cfg.mppi.horizon)
    return br.emit_rate(f"m3p2i_replan_rate_albert_K{K}_T{T}_push_reach", rate, cfg, device, chunk, ticks, before,
                        "ALBERT_BENCH.json", out, vs_baseline=rate["value"] / br.BASELINE_HZ,
                        tick=loop.tamp.ticks.mode)


if __name__ == "__main__":
    main(sys.argv[1:])
