"""Panda headline benchmark of the port: the sustained pick-place replan
rate at K=200 x T=12, multi-modal, on the H100.

Twin of ``scripts/bench_panda.py`` at its protocol (:55-74):
``config_panda`` with ``multi_modal=True``, ``warmup(50)``, then chunks of
``ReactiveTAMP.run_chunk_panda`` chained on their carries from the start
state (``zup_zs0()``), with one synchronize at the end: two chunks to
settle, then 800 timed ticks in chunks of 200 (``M3P2I_BENCH_CHUNK``,
``M3P2I_BENCH_TICKS``).  Every tick is a full replan with the refine ladder,
the on-device AIF gate and a real-env step.  Each chunk's time comes from
CUDA events recorded as it is enqueued (no sync between chunks).

    python -m m3p2i_aip_tpu_torch.scripts.bench_panda [--eager] [device=cpu] [out=PATH|-] [overrides...]

Prints one JSON line and writes it to ``results_h100/bench/PANDA_BENCH.json``
(``bench``'s line embeds it).  Runs on the card unless ``device=cpu``.
"""
from __future__ import annotations

import sys
import time

from m3p2i_aip_tpu_torch.analysis import bench_record as br
from m3p2i_aip_tpu_torch.config.config_store import load_config
from m3p2i_aip_tpu_torch.scripts.run_tamp import pop_flag, pop_option
from m3p2i_aip_tpu_torch.tamp.sim_loop import SimLoop


def config(overrides=()):
    """``scripts/bench_panda.py``'s composed config, then ``overrides``."""
    return load_config("config_panda", ["multi_modal=True", *overrides])


def _chain(loop, n_ticks: int, chunk: int, clock=None):
    """``n_ticks`` panda ticks in chunks chained as device carries from the
    loop's start state; marks ``clock`` before each chunk and at the end."""
    tamp = loop.tamp
    ms, rs, stage, zs = tamp.mppi_state, loop.state, 0, tamp.zup_zs0()
    for _ in range(n_ticks // chunk):
        if clock is not None:
            clock.mark()
        ms, rs, stage, zs, _d, views, _st, _dn = tamp.run_chunk_panda(ms, rs, stage, zs, chunk)
    if clock is not None:
        clock.mark()
    br.synchronize(loop.env.device)
    return views


def measure(loop, chunk: int, ticks: int) -> dict:
    """The rate of a warmed-up panda loop at ``bench_panda.py``'s protocol."""
    _chain(loop, 2 * chunk, chunk)  # settle
    clock = br.ChunkClock(loop.env.device)
    t0 = time.perf_counter()
    _chain(loop, ticks, chunk, clock)
    return br.rate_record(ticks, time.perf_counter() - t0, chunk, clock)


def main(argv) -> dict:
    device, argv = pop_option(argv, "device", "cuda")
    out, argv = pop_option(argv, "out", None)
    eager, argv = pop_flag(argv, "--eager")
    device = br.require_device(device, "bench_panda")
    cfg = config(argv)
    chunk = br.env_int("M3P2I_BENCH_CHUNK", 200)
    ticks = br.env_int("M3P2I_BENCH_TICKS", 800)

    loop = SimLoop(cfg, device=device, graphs=False if eager else None)
    loop.warmup(50)
    before = br.launch_counts()
    rate = measure(loop, chunk, ticks)
    K, T = int(cfg.mppi.num_samples), int(cfg.mppi.horizon)
    return br.emit_rate(f"m3p2i_replan_rate_panda_K{K}_T{T}_multimodal", rate, cfg, device, chunk, ticks, before,
                        "PANDA_BENCH.json", out, vs_baseline=rate["value"] / br.BASELINE_HZ,
                        tick=loop.tamp.ticks.mode)


if __name__ == "__main__":
    main(sys.argv[1:])
