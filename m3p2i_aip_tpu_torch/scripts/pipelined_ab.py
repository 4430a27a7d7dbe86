"""Serial against pipelined chunks on the main path, in alternating pairs.

The point push_pull multi-modal main path at K=200 x T=15 in benchmark mode
(``bench.py``'s: both success gates off, warm-up 50), one loop per mode
built once: each run times ``ticks`` replan+step ticks of
``run_chunked(ticks, chunk, pipelined=...)`` after one warm-up chunk, and
the pairs alternate which mode runs first.  Prints every run's rate, each
mode's median and quartiles, and how many pairs the pipelined run won, with
the card's name and power limit; ends with one JSON line.

    python -m m3p2i_aip_tpu_torch.scripts.pipelined_ab [pairs=10] [ticks=150] [chunk=50]

Runs on the card only: without CUDA it exits non-zero.
"""
from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

from m3p2i_aip_tpu_torch.analysis import bench_record as br
from m3p2i_aip_tpu_torch.config.config_store import load_config
from m3p2i_aip_tpu_torch.scripts.bench import MAIN_PATH
from m3p2i_aip_tpu_torch.scripts.run_tamp import pop_option
from m3p2i_aip_tpu_torch.tamp.sim_loop import SimLoop


def _bench_loop() -> SimLoop:
    loop = SimLoop(load_config("config_point", MAIN_PATH), device="cuda")
    loop.warmup(50)
    br.gates_off(loop)
    return loop


def _rate(loop: SimLoop, ticks: int, chunk: int, pipelined: bool) -> float:
    loop.run_chunked(chunk, chunk=chunk, pipelined=pipelined)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loop.run_chunked(ticks, chunk=chunk, pipelined=pipelined)
    torch.cuda.synchronize()
    return ticks / (time.perf_counter() - t0)


def main(argv) -> dict:
    if not torch.cuda.is_available():
        sys.exit("pipelined_ab: no CUDA device; this script runs only on a GPU")
    pairs, argv = pop_option(argv, "pairs", "10")
    ticks, argv = pop_option(argv, "ticks", "150")
    chunk, argv = pop_option(argv, "chunk", "50")
    pairs, ticks, chunk = int(pairs), int(ticks), int(chunk)
    card = br.nvidia_smi()
    loops = {False: _bench_loop(), True: _bench_loop()}
    rates = {False: [], True: []}
    for p in range(pairs):
        order = (False, True) if p % 2 == 0 else (True, False)
        for pipelined in order:
            rates[pipelined].append(_rate(loops[pipelined], ticks, chunk, pipelined))
        print(f"pair {p}: serial {rates[False][-1]:.2f} Hz, pipelined {rates[True][-1]:.2f} Hz "
              f"({'serial' if order[0] is False else 'pipelined'} first)", flush=True)
    wins = sum(b > a for a, b in zip(rates[False], rates[True]))
    summary = {"card": card, "pairs": pairs, "ticks": ticks, "chunk": chunk, "pipelined_wins": wins}
    for pipelined, name in ((False, "serial"), (True, "pipelined")):
        q1, med, q3 = np.percentile(rates[pipelined], [25, 50, 75])
        summary[name] = {"median_hz": float(med), "q1_hz": float(q1), "q3_hz": float(q3), "runs_hz": rates[pipelined]}
        print(f"{name}: median {med:.2f} Hz, quartiles {q1:.2f} / {q3:.2f} ({card})")
    print(f"pipelined faster in {wins} of {pairs} pairs")
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main(sys.argv[1:])
