"""Headline benchmark of the port: the M3P2I replanning rate on the
reference workload, on the H100.

Twin of the repository's ``bench.py`` at its protocol (:31-72):
``config_point`` with push_pull, multi_modal and the goal [-3.75, -3.75]
(K=200 x T=15), ``warmup(50)``, both success gates off, two chunks of 200 to
settle, then 800 timed ticks, every tick a full K-sample replan and a
real-env step.  Chunks are pipelined (one in flight) by default; ``--serial``
or ``M3P2I_BENCH_SERIAL=1`` runs them one after another, and
``M3P2I_BENCH_CHUNK`` sets the chunk, as in ``bench.py``.  Config overrides
(``mppi.num_samples=16``) follow the protocol's.

The value is the JAX script's: timed ticks over the host seconds to a
``torch.cuda.synchronize()``; beside it the per-chunk rates' median and
quartiles, and the card's name and power limit.  ``vs_baseline`` is against
the original's best logged scenario mean, 21.2 Hz (``BASELINE.md:16``).  The
line embeds the port's own panda and albert artifacts
(``results_h100/bench/PANDA_BENCH.json``, ``ALBERT_BENCH.json``, written by
the ``bench_panda`` / ``bench_albert`` twins) with their age, never the
TPU-era files at the repository's root.

    python -m m3p2i_aip_tpu_torch.scripts.bench [--serial] [--eager] [device=cpu] [out=PATH|-]

Prints one JSON line and writes it to ``results_h100/bench/BENCH.json``.
Runs on the card unless ``device=cpu`` is given; with no card it exits
non-zero.
"""
from __future__ import annotations

import json
import os
import sys
import time

from m3p2i_aip_tpu_torch.analysis import bench_record as br
from m3p2i_aip_tpu_torch.config.config_store import load_config
from m3p2i_aip_tpu_torch.scripts.run_tamp import pop_flag, pop_option
from m3p2i_aip_tpu_torch.tamp.sim_loop import SimLoop

# the reference workload's task, shared by every program that drives it
MAIN_PATH = ["task=push_pull", "multi_modal=True", "goal=[-3.75,-3.75]"]
TICKS = 800  # timed ticks (bench.py:62)


def config(overrides=()):
    """``bench.py``'s composed config, then ``overrides``."""
    return load_config("config_point", [*MAIN_PATH, *overrides])


def measure(loop, chunk: int, ticks: int, pipelined: bool) -> dict:
    """The rate of a warmed-up main-path loop at ``bench.py``'s protocol."""
    return br.settled_rate(loop, chunk, ticks, pipelined)


def _embedded(family: str) -> dict:
    """The port's own ``<FAMILY>_BENCH.json`` rate with its age, or {}."""
    path = os.path.join(br.BENCH_DIR, f"{family.upper()}_BENCH.json")
    try:
        with open(path) as f:
            rec = json.load(f)
    except (OSError, ValueError) as e:  # missing or corrupt: warn, don't hide
        print(f"bench: no {family} artifact embedded ({path}: {e})", file=sys.stderr)
        return {}
    mtime = os.path.getmtime(path)
    return {
        f"{family}_hz": rec["value"],
        f"{family}_vs_baseline": rec.get("vs_baseline"),
        f"{family}_measured_utc": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime(mtime)),
        f"{family}_age_h": (time.time() - mtime) / 3600.0,
    }


def main(argv) -> dict:
    device, argv = pop_option(argv, "device", "cuda")
    out, argv = pop_option(argv, "out", None)
    eager, argv = pop_flag(argv, "--eager")
    device = br.require_device(device, "bench")
    pipelined = not ("--serial" in argv or os.environ.get("M3P2I_BENCH_SERIAL") == "1")
    cfg = config([a for a in argv if a != "--serial"])
    chunk = br.env_int("M3P2I_BENCH_CHUNK", 200)

    loop = SimLoop(cfg, device=device, graphs=False if eager else None)
    loop.warmup(50)
    before = br.launch_counts()
    rate = measure(loop, chunk, TICKS, pipelined)
    K, T = int(cfg.mppi.num_samples), int(cfg.mppi.horizon)
    embedded = {k: v for family in ("panda", "albert") for k, v in _embedded(family).items()}
    return br.emit_rate(f"m3p2i_replan_rate_point_K{K}_T{T}_multimodal", rate, cfg, device, chunk, TICKS, before,
                        "BENCH.json", out, vs_baseline=rate["value"] / br.BASELINE_HZ, pipelined=pipelined,
                        **embedded, tick=loop.tamp.ticks.mode)


if __name__ == "__main__":
    main(sys.argv[1:])
