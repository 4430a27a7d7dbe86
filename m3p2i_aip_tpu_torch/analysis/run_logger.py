"""Per-run experiment logging in the reference's .npy row schemas.

Port of ``m3p2i_aip_tpu/analysis/run_logger.py`` (numpy only, as there).
Parity: the row layouts documented at ``plot/plot_point.py:26-34`` (point,
19 columns) and consumed by ``plot/plot_panda.py:23-29`` (panda, 15 columns):

point row:
  [save_time,
   robot_pos_x, robot_pos_y, robot_vel_x, robot_vel_y,
   block_pos_x, block_pos_y, block_pos_z,
   block_quat_1..4,
   block_goal_x, block_goal_y,
   avg_sim_freq, avg_task_freq, avg_mot_freq, dyn_obs_coll, task_time]

panda row:
  [save_time, cube_pos_x, cube_pos_y, cube_pos_z, cube_quat_1..4,
   goal_pos_x, goal_pos_y, goal_pos_z, goal_quat_1..4]
"""
from __future__ import annotations

import os
import time
from typing import List

import numpy as np


def finalize_point_row(
    log, view: dict, goal, start_time: float, dt: float = 0.05
) -> np.ndarray:
    """Build one 19-col point row from a finished SimLoop or BatchSimLoop TickLog.

    ``task_time`` (col 18) is SIM time to success (ticks x dt): the reference
    ran soft real-time so its wall-clock task_time approximates sim time;
    ours runs much faster than real time, so sim time is the comparable
    quantity.
    """
    avg_sim = 1.0 / max(float(np.mean(log.sim_s)) if log.sim_s else 0.0, 1e-9)
    avg_mot = 1.0 / max(
        float(np.mean(log.replan_s)) if log.replan_s else 0.0, 1e-9
    )
    # task planner cost is folded into replan time in this architecture; log
    # its effective rate as the tick rate (the reference's PLANNER_SIMPLE is
    # a no-op measured in isolation, plot_point.py col 15)
    avg_task = avg_mot
    dt_steps = log.success_step if log.success_step is not None else log.steps
    return np.asarray(
        [
            time.time(),
            *np.asarray(view["robot_pos"], dtype=np.float64),
            *np.asarray(view["robot_vel"], dtype=np.float64),
            *np.asarray(view["box_pos"], dtype=np.float64),
            0.05,  # block z (resting height)
            *np.asarray(view["box_quat"], dtype=np.float64),
            float(goal[0]),
            float(goal[1]),
            avg_sim,
            avg_task,
            avg_mot,
            float(log.collisions),
            dt_steps * dt,
        ],
        dtype=np.float64,
    )


def finalize_albert_row(log, view: dict, goal, dt: float = 0.05) -> np.ndarray:
    """One 11-col albert (mobile manipulation) row.

    No reference schema exists (the reference ships the albert asset unused);
    columns: [save_time, ee_x, ee_y, ee_z, base_x, base_y,
    goal_x, goal_y, goal_z, success, task_time].
    """
    steps = log.success_step if log.success_step is not None else log.steps
    return np.asarray(
        [
            time.time(),
            *np.asarray(view["ee_pos"], dtype=np.float64),
            *np.asarray(view["robot_pos"], dtype=np.float64)[:2],
            float(goal[0]),
            float(goal[1]),
            float(goal[2]),
            float(log.success_step is not None),
            steps * dt,
        ],
        dtype=np.float64,
    )


def finalize_panda_row(view: dict) -> np.ndarray:
    """Build one 15-col panda row (cube pose + goal pose + timestamp)."""
    return np.asarray(
        [
            time.time(),
            *np.asarray(view["cube_state"], dtype=np.float64),
            *np.asarray(view["cube_goal"], dtype=np.float64),
        ],
        dtype=np.float64,
    )


class RunLogger:
    """Accumulate rows over repeated runs and save to .npy.

    ``append=True`` loads existing rows first (the reference's multi-session
    accumulation style); the default OVERWRITES so a batch's saved stats are
    exactly that batch's runs.
    """

    def __init__(self, path: str, append: bool = False):
        self.path = path
        self.rows: List[np.ndarray] = []
        if append and os.path.exists(path):
            existing = np.load(path)
            self.rows = [existing[i] for i in range(existing.shape[0])]

    def add(self, row: np.ndarray) -> None:
        self.rows.append(np.asarray(row, dtype=np.float64))

    def save(self) -> str:
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        np.save(self.path, np.stack(self.rows))
        return self.path
