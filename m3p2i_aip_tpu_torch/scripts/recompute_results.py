"""Recompute a results row's statistics from its experiment log.

Twin of ``scripts/recompute_results.py``: the schema is taken from the
column count (19 point, 15 panda, 11 albert; ``analysis/run_logger.py``) and
the statistics come from the port's ``analysis.stats.summarize``, the
reference's formulas.  It reads the JAX package's committed logs under
``plot/`` and the port's under ``results_h100/`` alike, prints what the JAX
script prints, and ends each log's lines with one JSON line of the same
statistics.

    python -m m3p2i_aip_tpu_torch.scripts.recompute_results results_h100/albert/push_reach.npy [more.npy]
"""
from __future__ import annotations

import json
import sys

import numpy as np

from m3p2i_aip_tpu_torch.analysis import summarize

SCHEMAS = {19: "point", 15: "panda", 11: "albert"}


def recompute(path: str) -> dict:
    """Print the log's statistics; returns them ({name: (mean, std)})."""
    data = np.load(path)
    env = SCHEMAS.get(data.shape[1])
    if env is None:
        raise SystemExit(f"{path}: {data.shape[1]} columns matches no known schema ({SCHEMAS})")
    print(f"--- {path} (n={data.shape[0]}, schema={env}) ---")
    stats = summarize(data, env)
    for k, (m, s) in stats.items():
        print(f"{k}: {m:.4f} +- {s:.4f}")
    if env == "albert":
        # per-axis EE breakdown for the push_reach hover-floor note
        ee, goal = data[:, 1:4], data[:, 6:9]
        err = np.linalg.norm(ee - goal, axis=1)
        xy = np.linalg.norm(ee[:, :2] - goal[:, :2], axis=1)
        z = np.abs(ee[:, 2] - goal[:, 2])
        print(f"ee xy: {xy.mean():.4f} +- {xy.std():.4f}  ee z: {z.mean():.4f} +- {z.std():.4f}  worst: {err.max():.4f}")
        print(f"success: {int(data[:, 9].sum())}/{len(data)}")
    print(json.dumps({"path": path, "schema": env, "n": int(data.shape[0]),
                      "stats": {k: [float(m), float(s)] for k, (m, s) in stats.items()}}))
    return stats


def main(argv) -> None:
    if not argv:
        raise SystemExit(__doc__)
    for path in argv:
        recompute(path)


if __name__ == "__main__":
    main(sys.argv[1:])
