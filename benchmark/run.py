"""The benchmark of m3p2i_aip_tpu_torch on one H100: one run of one cell.

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

From the root of a checkout.  The cell (``BENCHMARK.json``'s
``workloads``) names a configuration and a traffic mix; the mix's ``loop``
names the loop (``benchmark/loops/<loop>.py``).  A run builds the program,
settles the scene and runs one episode, which captures every program the
window replays (set-up, ``setup_s``); then it runs the mix's
``warm_seconds`` of episodes (not counted), measures for ``--seconds``,
reads the device's peak memory, frees the program, and holds a sample of
the window's ticks to the plain reference that the configuration names
(``benchmark/check.py``; a configuration that names none, or one whose
file is missing, fails at set-up, before the window).  With
``--trace 1`` the window also times every graph replay between CUDA
events, a stretch of ticks runs under the profiler after it, and the line
carries the per-layer metrics and a breakdown instead of the end-to-end
metrics.

It prints each compared number beside its limit as its last lines on
standard error and, as the last line of standard output, one JSON object.
It exits non-zero and prints no result without a card (or with fewer
cards than the cell asks for), when the program is missing, and when the
process holds any JAX module or the JAX package after the window.
``--device cpu`` (for the tests only) runs the same on the CPU.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()  # noqa: E402 (set-up counts from here)

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "m3p2i_aip_tpu")
INF = 1e300  # what the line prints for an infinite gap


def cache_dirs(root: pathlib.Path) -> None:
    """Every build and kernel cache at a fixed path inside the checkout (the
    program's own kernel library builds into ``m3p2i_aip_tpu_torch/_build``)."""
    base = root / ".bench_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(base / sub)
    os.environ["USE_FLAX"] = "0"


def forbidden_modules() -> list:
    """Top-level names of loaded modules that are JAX's or the JAX
    package's, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0].split(",")[-1].strip()
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--device", default="cuda", help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def run(argv, t_start: float = T_START) -> dict:
    """One run; returns the result line's object (raises SystemExit where
    the run may print no result)."""
    args = parse(argv)
    cache_dirs(ROOT)
    import torch

    from benchmark import check, spec as spec_mod, trace as trace_mod

    spec = spec_mod.load()
    cell = spec_mod.cell(spec, args.workload)
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
            raise SystemExit(f"benchmark: the cell needs {cell['chips']} CUDA device(s); "
                             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible")
    cfg_file = spec_mod.config_file(spec, cell)
    traffic = spec_mod.traffic(cell)
    limits = spec_mod.limits(cell)
    try:
        spec_mod.reference(cfg_file.get("reference"))
    except LookupError as e:
        raise SystemExit(f"benchmark: configuration {cell['config']!r}: {e}") from None

    loop = spec_mod.loop(traffic["loop"])(cfg_file, traffic, args.seed, device)
    loop.setup()
    setup_s = time.perf_counter() - t_start
    loop.warm()
    window_s = loop.window(args.seconds, time_replays=bool(args.trace))
    periods = [round(1e3 * c, 2) for c in loop.chunk_s] or [round(1e3 * t, 3) for t in loop.tick_s][:2000]
    print(f"window: {window_s:.3f} s, {loop.ticks} ticks, {'chunk' if loop.chunk_s else 'tick'} ms: {periods}",
          file=sys.stderr, flush=True)
    summary = None
    if args.trace:
        summary = trace_mod.profile(lambda: loop.trace_run(int(traffic["trace_ticks"])),
                                    int(traffic["trace_ticks"])) if device.type == "cuda" else None
    ctx = {"setup_s": setup_s, "window_s": window_s, "ticks": loop.ticks, "seeds_per_tick": loop.seeds_per_tick,
           "tick_s": loop.tick_s, "chunk_s": loop.chunk_s, "trace": summary, "replay_s": loop.replay_s}
    if device.type == "cuda":
        ctx["graph_nodes"] = loop.graph_nodes()
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": int(cell["chips"]),
               "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device)), "power_limit": power_limit()}
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    checkpoints = loop.checkpoints
    loop.close()
    del loop
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    result = check.compare(cfg_file, checkpoints, int(traffic["checks_per_tick"]), args.seed, limits, device,
                           count_live=bool(args.trace), seeds_per_tick=ctx["seeds_per_tick"])
    ctx["bounds"] = result["bounds"]
    chosen = spec_mod.per_layer(spec, cell) if args.trace else spec_mod.end_to_end(spec, cell)
    metrics = {}
    for m in chosen:
        value = spec_mod.reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    line = {"correct": bool(result["correct"]), "attempted": int(ctx["ticks"] * ctx["seeds_per_tick"]), "failed":
            sum(g > result["numbers"]["view_gap"]["limit"] for g in result["gaps"]), "metrics": metrics,
            "device": dev}
    if summary is not None:
        line["device"].update(busy_s=summary["busy_s"], window_s=summary["wall_s"])
        line["breakdown"] = trace_mod.breakdown(summary)
    line["ticks_checked"] = result["checked"]
    line["checked"] = {name: {"value": v["value"], "limit": v["limit"]} for name, v in result["numbers"].items()}
    return line


def main(argv=None) -> int:
    line = run(sys.argv[1:] if argv is None else argv)
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: the process holds {', '.join(bad)} after the window; no result", file=sys.stderr)
        return 3
    for name, v in line["checked"].items():
        print(f"checked {name}: {v['value']} (limit {v['limit']})", file=sys.stderr)
        v["value"] = min(v["value"], INF)  # a row missing or not finite: the line stays JSON
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
