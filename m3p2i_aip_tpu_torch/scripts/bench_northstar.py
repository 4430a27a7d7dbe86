"""North-star benchmark of the port: the replan rate at K=500 x T=30 on
the point push_pull multi-modal path, against the 100 Hz target
(``SURVEY.md:424-426``), on the H100.

Twin of ``scripts/bench_northstar.py`` at its protocol: the main path's
config with ``mppi.num_samples=K`` and ``mppi.horizon=T``, ``warmup(50)``,
both success gates off, two chunks to settle, then 400 timed ticks in
chunks of 100, one after another.  The kernels on the path are K1 (63 blocks of 8 samples at K=500,
the last one partial) and K2 (``half_K`` = 250).

    python -m m3p2i_aip_tpu_torch.scripts.bench_northstar [K] [T] [chunk] [--eager] [device=cpu] [out=PATH|-]

Prints one JSON line and writes it to
``results_h100/bench/NORTHSTAR_BENCH.json``.  Runs on the card unless
``device=cpu``.
"""
from __future__ import annotations

import sys

from m3p2i_aip_tpu_torch.analysis import bench_record as br
from m3p2i_aip_tpu_torch.config.config_store import load_config
from m3p2i_aip_tpu_torch.scripts.bench import MAIN_PATH
from m3p2i_aip_tpu_torch.scripts.run_tamp import pop_flag, pop_option
from m3p2i_aip_tpu_torch.tamp.sim_loop import SimLoop

TARGET_HZ = 100.0
TICKS = 400  # timed ticks (scripts/bench_northstar.py:51)


def config(K: int = 500, T: int = 30):
    """``scripts/bench_northstar.py``'s composed config at K x T."""
    return load_config("config_point", [*MAIN_PATH, f"mppi.num_samples={K}", f"mppi.horizon={T}"])


def measure(loop, chunk: int, ticks: int) -> dict:
    """The rate of a warmed-up loop at ``bench_northstar.py``'s protocol."""
    return br.settled_rate(loop, chunk, ticks, pipelined=False)


def main(argv) -> dict:
    device, argv = pop_option(argv, "device", "cuda")
    out, argv = pop_option(argv, "out", None)
    eager, argv = pop_flag(argv, "--eager")
    device = br.require_device(device, "bench_northstar")
    K, T, chunk = (int(a) for a in (list(argv) + ["500", "30", "100"][len(argv):])[:3])
    cfg = config(K, T)

    loop = SimLoop(cfg, device=device, graphs=False if eager else None)
    loop.warmup(50)
    before = br.launch_counts()
    rate = measure(loop, chunk, TICKS)
    return br.emit_rate(f"m3p2i_replan_rate_point_K{K}_T{T}_multimodal", rate, cfg, device, chunk, TICKS, before,
                        "NORTHSTAR_BENCH.json", out, vs_target=rate["value"] / TARGET_HZ,
                        tick=loop.tamp.ticks.mode)


if __name__ == "__main__":
    main(sys.argv[1:])
