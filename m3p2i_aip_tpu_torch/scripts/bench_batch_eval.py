"""Serial against batched seed evaluation on the port, on the H100.

Twin of ``scripts/bench_batch_eval.py`` at its protocol (:97-118): the n
seeds 0 .. n-1 of one scenario run to success (warm-up 20, chunks of 10,
``n_steps`` ticks at most; the panda then settles 150 steps) serially
through one ``SimLoop`` and then together through one ``BatchSimLoop`` (one
batched launch per rollout per tick for the whole batch), each swept twice
on the same loop objects: the first sweep pays the first launches, the
second is the steady cost.  The point scenario is case2 push to [-1, -1],
the panda's the table pick-place.  Kernels: K1 and K1b (K2, K2b where the
config is multi-modal) or K3 and K3b with K2 and K2b.

    python -m m3p2i_aip_tpu_torch.scripts.bench_batch_eval [n_runs=20] [family=point|panda] \\
        [--eager] [device=cpu] [out=PATH|-] [overrides...]

Prints one JSON line, ``batch_eval_speedup_<family>`` with both success
counts, and writes it to ``results_h100/bench/BATCH_EVAL_BENCH[_PANDA].json``.
Runs on the card unless ``device=cpu``.
"""
from __future__ import annotations

import sys
import time

from m3p2i_aip_tpu_torch.analysis import bench_record as br
from m3p2i_aip_tpu_torch.config.config_store import load_config
from m3p2i_aip_tpu_torch.scripts.run_tamp import pop_flag, pop_option
from m3p2i_aip_tpu_torch.tamp.batch_loop import BatchSimLoop
from m3p2i_aip_tpu_torch.tamp.sim_loop import SimLoop

CHUNK = 10
WARMUP = 20
SCENARIOS = {  # family: (config, overrides, the JAX script's scenario label)
    "point": ("config_point", ["task=push", "goal=[-1,-1]"], "push goal=[-1,-1] chunk=10"),
    "panda": ("config_panda", [], "pick-place chunk=10"),
}


def config(family: str = "point", overrides=()):
    """``scripts/bench_batch_eval.py``'s composed config, then ``overrides``."""
    name, base, _ = SCENARIOS[family]
    return load_config(name, [*base, *overrides])


def _serial(loop, seeds, n_steps: int, panda: bool) -> tuple:
    """One sweep of the seeds on one SimLoop: (seconds, ticks, successes)."""
    t0, ticks, ok = time.perf_counter(), 0, 0
    for s in seeds:
        loop.reset(s)
        loop.warmup(WARMUP)
        log = loop.run_chunked(n_steps, chunk=CHUNK)
        if panda:
            loop.settle(150)  # rows log the released, settled cube
        ticks += log.steps
        ok += int(log.success_step is not None)
    br.synchronize(loop.env.device)
    return time.perf_counter() - t0, ticks, ok


def _batched(batch, seeds, n_steps: int, panda: bool) -> tuple:
    """One sweep of the seeds as one batch: (seconds, ticks, successes)."""
    t0 = time.perf_counter()
    batch.reset(seeds)
    batch.warmup(WARMUP)
    logs = batch.run_chunked(n_steps, chunk=CHUNK)
    if panda:
        batch.settle(150)
    br.synchronize(batch.tamp.env.device)
    return (time.perf_counter() - t0, sum(log.steps for log in logs),
            sum(int(log.success_step is not None) for log in logs))


def main(argv) -> dict:
    device, argv = pop_option(argv, "device", "cuda")
    out, argv = pop_option(argv, "out", None)
    n_runs, argv = pop_option(argv, "n_runs", "20")
    family, argv = pop_option(argv, "family", "point")
    eager, argv = pop_flag(argv, "--eager")
    graphs = False if eager else None
    device = br.require_device(device, "bench_batch_eval")
    n_runs, panda = int(n_runs), family == "panda"
    seeds = list(range(n_runs))

    before = br.launch_counts()
    cfg_s = config(family, argv)
    n_steps = int(cfg_s.n_steps)
    serial_loop = SimLoop(cfg_s, device=device, graphs=graphs)
    serial_s, serial_ticks, serial_ok = _serial(serial_loop, seeds, n_steps, panda)
    serial2_s, _, _ = _serial(serial_loop, seeds, n_steps, panda)
    serial_fields = br.kernel_fields(before)

    before = br.launch_counts()
    batch = BatchSimLoop(config(family, argv), seeds, device=device, graphs=graphs)
    batched_s, batched_ticks, batched_ok = _batched(batch, seeds, n_steps, panda)
    batched2_s, _, _ = _batched(batch, seeds, n_steps, panda)
    batched_fields = br.kernel_fields(before)

    dev = br.device_record(device)
    rec = {
        "metric": f"batch_eval_speedup_{family}",
        "value": serial2_s / batched2_s,
        "unit": "x (serial / batched wall, warm)",
        "B": n_runs,
        "platform": dev["platform"],
        "device": dev,
        "task": SCENARIOS[family][2],
        "kernel": serial_fields["kernel"] and batched_fields["kernel"],
        "serial_launches": serial_fields["launches"],
        "batched_launches": batched_fields["launches"],
        "serial_graph_launches": serial_fields["graph_launches"],
        "batched_graph_launches": batched_fields["graph_launches"],
        "serial_s": serial_s,
        "batched_s": batched_s,
        "serial_warm_s": serial2_s,
        "batched_warm_s": batched2_s,
        "cold_speedup": serial_s / batched_s,
        "serial_ticks": serial_ticks,
        "batched_ticks": batched_ticks,
        "serial_success": f"{serial_ok}/{n_runs}",
        "batched_success": f"{batched_ok}/{n_runs}",
        "tick": batch.tamp.ticks.mode,
    }
    br.emit(rec, "BATCH_EVAL_BENCH_PANDA.json" if panda else "BATCH_EVAL_BENCH.json", out)
    return rec


if __name__ == "__main__":
    main(sys.argv[1:])
