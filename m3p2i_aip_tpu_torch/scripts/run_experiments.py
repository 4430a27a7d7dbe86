"""Batch experiment runner: N seeded runs of one scenario -> .npy rows +
statistics, in the reference's schemas and formulas.

Port of ``scripts/run_experiments.py``, with the same argv grammar: the
config overrides and ``-cn NAME`` of ``load_config_from_argv``, plus
``n_runs=``, ``chunked=``, ``reactive_perturb=``, ``seed_offset=``,
``out=``, ``parallel_seeds=`` and ``device=`` (``cuda``, the default, or
``cpu``).  Seeds ``seed_offset .. seed_offset + n_runs - 1`` run serially
through one ``SimLoop`` (``chunked=N``: N ticks per device round trip), or
with ``parallel_seeds=True`` all together through ``BatchSimLoop`` (one
batched kernel launch per rollout per tick for the whole batch), or with
``parallel_seeds=shard`` split over every visible card (``BatchSimLoop(
shard=True)``: one launch per rollout per tick on each card's seeds; on the
CPU, one shard).  The log goes to ``out=``, by default
``results_h100/{point,panda,albert}/<task>[_mm].npy`` under the working
directory: ``plot/`` holds the JAX package's committed logs.

Run from the repository root:

    python -m m3p2i_aip_tpu_torch.scripts.run_experiments task=push_pull \\
        multi_modal=True goal="[-3.75,-3.75]" n_runs=20 chunked=4 \\
        parallel_seeds=True out=results_h100/point/hybrid.npy
    python -m m3p2i_aip_tpu_torch.scripts.run_experiments -cn config_panda \\
        multi_modal=True n_runs=20 parallel_seeds=True
"""
from __future__ import annotations

import os
import sys
import time

import numpy as np

from m3p2i_aip_tpu_torch.analysis import (
    RunLogger,
    finalize_albert_row,
    finalize_panda_row,
    finalize_point_row,
    summarize,
)
from m3p2i_aip_tpu_torch.analysis.bench_record import RESULTS_DIR, require_device
from m3p2i_aip_tpu_torch.config.config_store import load_config_from_argv
from m3p2i_aip_tpu_torch.sim.sim_config import load_env_cfgs
from m3p2i_aip_tpu_torch.tamp.sim_loop import SimLoop

_TRUE = ("true", "1")


def _parse(argv):
    opts = dict(
        n_runs=20, out=None, chunked=0, reactive_perturb=0.0, seed_offset=0, parallel_seeds="", device="cuda"
    )
    casts = dict(n_runs=int, chunked=int, reactive_perturb=float, seed_offset=int)
    config_name, passthrough = "config_point", []
    i = 0
    while i < len(argv):
        a = argv[i]
        key = a.split("=", 1)[0]
        if "=" in a and key in opts:
            value = a.split("=", 1)[1]
            opts[key] = casts.get(key, str)(value)
        elif a in ("-cn", "--config-name"):
            config_name = argv[i + 1]
            i += 1
        else:
            passthrough.append(a)
        i += 1
    return opts, load_config_from_argv(passthrough, default_config=config_name)


def _row(family: str, log, view, cfg, t0: float) -> np.ndarray:
    if family == "panda":
        return finalize_panda_row(view)
    if family == "albert":
        return finalize_albert_row(log, view, cfg.goal, dt=cfg.sim.dt)
    return finalize_point_row(log, view, cfg.goal, t0, dt=cfg.sim.dt)


def _report(path: str, n_runs: int, successes: int, family: str) -> None:
    print(f"success rate: {successes}/{n_runs}")
    for k, (m, s) in summarize(np.load(path), family).items():
        print(f"{k}: {m:.4f} ± {s:.4f}")


def _run_batch(cfg, opts, family: str, out: str) -> None:
    """Every seed as one batch (BatchSimLoop), chunk ``chunked`` or 10."""
    from m3p2i_aip_tpu_torch.tamp.batch_loop import BatchSimLoop

    t0 = time.time()
    n_runs = opts["n_runs"]
    seeds = [r + opts["seed_offset"] for r in range(n_runs)]
    batch = BatchSimLoop(cfg, seeds, shard=opts["parallel_seeds"].lower() == "shard", device=opts["device"])
    batch.warmup(20)
    logs = batch.run_chunked(cfg.n_steps, chunk=opts["chunked"] or 10)
    if family == "panda":
        # reference protocol: rows log the RELEASED, settled cube
        batch.settle(150)
    logger = RunLogger(out)
    successes = 0
    for run, log in enumerate(logs):
        ok = log.success_step is not None
        successes += int(ok)
        logger.add(_row(family, log, batch.views[run], cfg, t0))
        print(f"run {run}: success={ok} steps={log.steps} collisions={log.collisions}", flush=True)
    path = logger.save()
    print(f"\nsaved {n_runs} rows -> {path} ({time.time() - t0:.1f} s wall for the whole batch)")
    _report(path, n_runs, successes, family)


def _run_serial(cfg, opts, family: str, out: str, domain_noise: bool) -> None:
    """One seed after another through one SimLoop (rebuilt per seed when the
    scene carries domain noise, which is baked into the env params)."""
    chunked, perturb = opts["chunked"], opts["reactive_perturb"]
    logger = RunLogger(out)
    successes = 0
    loop = None
    for run in range(opts["n_runs"]):
        cfg.mppi.seed_val = run + opts["seed_offset"]
        t0 = time.time()
        if loop is None or domain_noise:
            loop = SimLoop(cfg, device=opts["device"])
        else:
            loop.reset(cfg.mppi.seed_val)
        loop.warmup(20)
        if perturb and family == "panda" and chunked:
            # the reference's "reactive" scenario: the cube shoved mid-reach
            log = loop.run_chunked(40, chunk=chunked)
            if log.success_step is None:
                loop.perturb_body("cubeA", [0.0, perturb, 0.0])
                log = loop.run_chunked(cfg.n_steps, chunk=chunked)
        elif chunked:
            log = loop.run_chunked(cfg.n_steps, chunk=chunked)
        else:
            for i in range(cfg.n_steps):
                if perturb and family == "panda" and i == 40:
                    loop.perturb_body("cubeA", [0.0, perturb, 0.0])
                if loop.tick(i):
                    break
            log = loop.log
        ok = log.success_step is not None
        successes += int(ok)
        if family == "panda":
            # reference protocol: the logged row is the released, settled cube
            loop.settle(150)
        logger.add(_row(family, log, loop._view, cfg, t0))
        print(
            f"run {run}: success={ok} steps={log.steps} collisions={log.collisions} "
            f"replan_hz={1.0 / max(np.mean(log.replan_s), 1e-9):.1f}",
            flush=True,
        )
    path = logger.save()
    print(f"\nsaved {opts['n_runs']} rows -> {path}")
    _report(path, opts["n_runs"], successes, family)


def main(argv) -> None:
    opts, cfg = _parse(argv)
    require_device(opts["device"], "run_experiments")
    family = {"panda_env": "panda", "albert_env": "albert"}.get(cfg.env_type, "point")
    out = opts["out"] or os.path.join(RESULTS_DIR, family, f"{cfg.task}{'_mm' if cfg.multi_modal else ''}.npy")
    domain_noise = float(getattr(cfg, "fric_noise", 0.0)) > 0.0 or any(
        a.noise_percentage_friction or a.noise_sigma_size for a in load_env_cfgs(cfg.env_type)
    )
    if opts["parallel_seeds"].lower() in _TRUE + ("shard",):
        if domain_noise or opts["reactive_perturb"]:
            sys.exit(
                "parallel_seeds covers batches without domain noise or scripted perturbation "
                "(per-seed scene rebuilds / mid-run host interventions need the serial path)"
            )
        _run_batch(cfg, opts, family, out)
    else:
        _run_serial(cfg, opts, family, out, domain_noise)


if __name__ == "__main__":
    main(sys.argv[1:])
