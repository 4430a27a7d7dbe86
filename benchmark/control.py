"""The readings a cell's correctness limit is set from, in one process.

    python3 benchmark/control.py --workload NAME --seeds 1,2,3 [--control-seeds 1,2,3]
        [--seconds 3] [--precisions tf32,bf16] [--out PATH]

Builds the cell's program once (as ``run.py`` does), then for each seed runs
a short window at the cell's own load and samples its checkpoints as a run
of that seed samples them.  For each seed it reads ``view_gap`` of the
program against the reference (the lower reading: sound runs), and for each
control seed the same number with the control in the program's place: the
reference computed in a lower precision (``tf32``: float32 products in
TF32; ``bf16``: every tensor between the tick's stages rounded to
bfloat16) against the reference in float32.  Prints one JSON object (and
writes it to ``--out``).  The benchmark's own runs do not run this.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--precisions", default="tf32,bf16")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda", help=argparse.SUPPRESS)
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)

    import numpy as np
    import torch

    from benchmark import check, run, spec as spec_mod

    run.cache_dirs(ROOT)
    spec = spec_mod.load()
    cell = spec_mod.cell(spec, args.workload)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("control: no CUDA device")
    cfg_file, traffic = spec_mod.config_file(spec, cell), spec_mod.traffic(cell)
    n = int(traffic["checks_per_tick"])
    seeds = [int(s) for s in args.seeds.split(",") if s]
    control_seeds = [int(s) for s in args.control_seeds.split(",") if s]
    loop = spec_mod.loop(traffic["loop"])(cfg_file, traffic, seeds[0], device)
    loop.setup()
    loop.warm()
    rows = []
    for seed in sorted(set(seeds) | set(control_seeds)):
        loop.rng = np.random.default_rng(seed)
        loop.window(args.seconds)
        cks = check.sample(loop.checkpoints, n, seed)
        t0 = time.perf_counter()
        ref, _ = check.reference_views(cfg_file, cks, device, seeds_per_tick=loop.seeds_per_tick)
        row = {"seed": seed, "ticks": [[c["i"], c.get("seed", 0)] for c in cks], "reference_s": time.perf_counter() - t0,
               "program": [check.view_gap(c["view"], r) for c, r in zip(cks, ref)]}
        if seed in control_seeds:
            for p in args.precisions.split(","):
                low, _ = check.reference_views(cfg_file, cks, device, precision=p)
                row[p] = [check.view_gap(lw, r) for lw, r in zip(low, ref)]
        rows.append(row)
        print(json.dumps(row), file=sys.stderr, flush=True)
    out = {"workload": args.workload, "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "power_limit": run.power_limit() if device.type == "cuda" else None, "rows": rows,
           "lower": max(max(r["program"]) for r in rows if r["seed"] in seeds),
           "upper": {p: min(max(r[p]) for r in rows if p in r) for p in args.precisions.split(",")
                     if any(p in r for r in rows)}}
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(line + "\n")
    return out


if __name__ == "__main__":
    main()
