"""Offline statistics over the point-family experiment logs.

Port of ``plot/plot_point.py``: the 19-column rows of
``analysis/run_logger.py``, the position error against the goal, the
orientation error, mean +- std per log, and box plots of the task time and
the position error (matplotlib, when installed) written to ``out=DIR``;
without ``out=`` nothing is written.  Reads the committed logs under
``plot/point/`` unless given another directory.

    python -m m3p2i_aip_tpu_torch.scripts.plot_point [LOGDIR] [out=DIR]
"""
from __future__ import annotations

import glob
import os
import sys

import numpy as np

from m3p2i_aip_tpu_torch.analysis.stats import box_plot, point_costs, summarize
from m3p2i_aip_tpu_torch.scripts.run_tamp import pop_option
from m3p2i_aip_tpu_torch.utils.path_utils import get_plot_path


def main(argv) -> dict:
    """Print each log's statistics; returns {log name: {metric: (mean, std)}}."""
    out, argv = pop_option(argv, "out", None)
    logdir = argv[0] if argv else str(get_plot_path() / "point")
    files = sorted(glob.glob(os.path.join(logdir, "*.npy")))
    if not files:
        print(f"no .npy logs under {logdir}; run the run_experiments script first")
        return {}
    results, groups_time, groups_pos = {}, {}, {}
    for f in files:
        name = os.path.splitext(os.path.basename(f))[0]
        data = np.load(f)
        print(f"---------{name} (n={data.shape[0]})---------")
        results[name] = summarize(data, "point")
        for k, (m, s) in results[name].items():
            print(f"{k}: {m:.4f} ± {s:.4f}")
        groups_pos[name] = point_costs(data)[0]
        groups_time[name] = data[:, 18]
    if out:
        os.makedirs(out, exist_ok=True)
        paths = [box_plot(groups_time, os.path.join(out, "task_time_box.png")),
                 box_plot(groups_pos, os.path.join(out, "pos_error_box.png"))]
        print(f"\nbox plots -> {', '.join(paths)}" if all(paths) else "\nno box plots: matplotlib is not installed")
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
