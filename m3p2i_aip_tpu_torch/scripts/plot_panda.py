"""Offline statistics over the panda experiment logs.

Port of ``plot/plot_panda.py``: the 15-column rows (timestamp, cube pose 7,
goal pose 7; ``analysis/run_logger.py``), the cube's position and
orientation errors against the goal, mean +- std per log, and a box plot of
the position error (matplotlib, when installed) written to ``out=DIR``;
without ``out=`` nothing is written.  Reads the committed logs under
``plot/panda/`` unless given another directory.

    python -m m3p2i_aip_tpu_torch.scripts.plot_panda [LOGDIR] [out=DIR]
"""
from __future__ import annotations

import glob
import os
import sys

import numpy as np

from m3p2i_aip_tpu_torch.analysis.stats import box_plot, panda_costs, summarize
from m3p2i_aip_tpu_torch.scripts.run_tamp import pop_option
from m3p2i_aip_tpu_torch.utils.path_utils import get_plot_path


def main(argv) -> dict:
    """Print each log's statistics; returns {log name: {metric: (mean, std)}}."""
    out, argv = pop_option(argv, "out", None)
    logdir = argv[0] if argv else str(get_plot_path() / "panda")
    files = sorted(glob.glob(os.path.join(logdir, "*.npy")))
    if not files:
        print(f"no .npy logs under {logdir}; run the run_experiments script first")
        return {}
    results, groups = {}, {}
    for f in files:
        name = os.path.splitext(os.path.basename(f))[0]
        data = np.load(f)
        print(f"---------{name} (n={data.shape[0]})---------")
        results[name] = summarize(data, "panda")
        for k, (m, s) in results[name].items():
            print(f"{k}: {m:.4f} ± {s:.4f}")
        groups[name] = panda_costs(data)[0]
    if out:
        os.makedirs(out, exist_ok=True)
        path = box_plot(groups, os.path.join(out, "pos_error_box.png"))
        print(f"\nbox plot -> {path}" if path else "\nno box plot: matplotlib is not installed")
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
