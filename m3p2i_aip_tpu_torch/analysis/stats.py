"""Offline statistics over logged runs: the reference's plot_* formulas.

Port of ``m3p2i_aip_tpu/analysis/stats.py`` (without its box plot).  The
orientation error is the port's numpy ``general_ori_cube2goal``
(``ops/quat_np.py``), batched over runs.  Parity: ``plot/plot_point.py:37-45``
(position error against the goal and orientation error against the identity
quaternion) and ``plot/plot_panda.py:23-29`` (cube-vs-goal pose errors).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from m3p2i_aip_tpu_torch.ops.quat_np import general_ori_cube2goal


def _batched_ori_cost(quats: np.ndarray, goals: np.ndarray) -> np.ndarray:
    return general_ori_cube2goal(np.asarray(quats, dtype=np.float32), np.asarray(goals, dtype=np.float32))


def point_costs(data: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(pos_cost, quat_cost) per run. Parity: plot_point.compute_cost:37-45."""
    n = data.shape[0]
    goal_quat = np.tile(np.asarray([0.0, 0, 0, 1]), (n, 1))
    quat_cost = _batched_ori_cost(data[:, 8:12], goal_quat)
    pos_cost = np.linalg.norm(data[:, 5:7] - data[:, 12:14], axis=1)
    return pos_cost, quat_cost


def panda_costs(data: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(pos_cost, quat_cost) per run. Parity: plot_panda.compute_cost:23-29."""
    quat_cost = _batched_ori_cost(data[:, 4:8], data[:, 11:15])
    pos_cost = np.linalg.norm(data[:, 1:3] - data[:, 8:10], axis=1)
    return pos_cost, quat_cost


def mean_std(x: np.ndarray, label: str = "") -> Tuple[float, float]:
    m, s = float(np.mean(x)), float(np.std(x))
    if label:
        print(label, format(m, ".4f"), "±", format(s, ".4f"))
    return m, s


def per_seed(data: np.ndarray, env: str = "point") -> Dict[str, np.ndarray]:
    """Per run (row): pos/ori error (+ collisions and task time for point
    runs); the albert's ee error, success and task time."""
    if env == "point":
        pos, quat = point_costs(data)
        return {"pos_error": pos, "ori_error": quat, "collisions": data[:, 17], "task_time": data[:, 18]}
    if env == "albert":
        # 11-col albert schema (run_logger.finalize_albert_row)
        pos = np.linalg.norm(data[:, 1:4] - data[:, 6:9], axis=1)
        return {"ee_pos_error": pos, "success": data[:, 9], "task_time": data[:, 10]}
    pos, quat = panda_costs(data)
    return {"pos_error": pos, "ori_error": quat}


def summarize(data: np.ndarray, env: str = "point") -> Dict[str, Tuple[float, float]]:
    """mean±std of each of :func:`per_seed`'s arrays."""
    return {k: mean_std(v) for k, v in per_seed(data, env).items()}


def box_plot(groups: Dict[str, np.ndarray], path: str) -> Optional[str]:
    """Grouped box plot PNG at ``path`` (plot_point.py:105+); returns the
    path, or None when matplotlib is not installed."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return None
    fig, ax = plt.subplots(figsize=(1.5 + 1.2 * len(groups), 4))
    try:
        ax.boxplot(list(groups.values()), tick_labels=list(groups.keys()))
    except TypeError:  # matplotlib before 3.9 names them labels
        ax.boxplot(list(groups.values()), labels=list(groups.keys()))
    fig.savefig(path, dpi=100, bbox_inches="tight")
    plt.close(fig)
    return path
