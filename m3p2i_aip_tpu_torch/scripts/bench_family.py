"""Replan-rate benchmark of the port for any robot family config, on the
H100.

Twin of ``scripts/bench_family.py``: the config of ``-cn NAME`` and the
overrides, composed by the port's ``load_config_from_argv``
(``config_point`` by default); ``warmup(50)``, both success gates off, two
chunks of 200 to settle, then 800 timed ticks pipelined (one chunk in
flight), ``M3P2I_BENCH_CHUNK`` / ``M3P2I_BENCH_TICKS`` as there.  The
kernels on the path are K1, and K2 when the config is multi-modal.

    python -m m3p2i_aip_tpu_torch.scripts.bench_family -cn config_heijn task=push_pull \\
        multi_modal=True goal="[-3.75,-3.75]" [--eager]

Prints one JSON line and writes it to
``results_h100/bench/FAMILY_BENCH_<robot>.json``.  Runs on the card unless
``device=cpu``.
"""
from __future__ import annotations

import sys

from m3p2i_aip_tpu_torch.analysis import bench_record as br
from m3p2i_aip_tpu_torch.config.config_store import load_config_from_argv
from m3p2i_aip_tpu_torch.scripts.run_tamp import pop_flag, pop_option
from m3p2i_aip_tpu_torch.tamp.sim_loop import SimLoop


def config(argv=()):
    """``scripts/bench_family.py``'s composed config of ``argv``."""
    return load_config_from_argv(list(argv), default_config="config_point")


def measure(loop, chunk: int, ticks: int) -> dict:
    """The rate of a warmed-up loop at ``bench_family.py``'s protocol."""
    return br.settled_rate(loop, chunk, ticks, pipelined=True)


def main(argv) -> dict:
    device, argv = pop_option(argv, "device", "cuda")
    out, argv = pop_option(argv, "out", None)
    eager, argv = pop_flag(argv, "--eager")
    device = br.require_device(device, "bench_family")
    cfg = config(argv)
    chunk = br.env_int("M3P2I_BENCH_CHUNK", 200)
    ticks = br.env_int("M3P2I_BENCH_TICKS", 800)

    loop = SimLoop(cfg, device=device, graphs=False if eager else None)
    loop.warmup(50)
    before = br.launch_counts()
    rate = measure(loop, chunk, ticks)
    robot = str(getattr(loop.env.params, "robot_type", cfg.env_type))
    K, T = int(cfg.mppi.num_samples), int(cfg.mppi.horizon)
    return br.emit_rate(f"m3p2i_replan_rate_{robot}_K{K}_T{T}_{cfg.task}", rate, cfg, device, chunk, ticks, before,
                        f"FAMILY_BENCH_{robot}.json", out, vs_baseline=rate["value"] / br.BASELINE_HZ,
                        tick=loop.tamp.ticks.mode)


if __name__ == "__main__":
    main(sys.argv[1:])
