"""Headless scene rendering: an ASCII top-down view and offline frames.

Port of ``m3p2i_aip_tpu/utils/render.py``, in place of the Isaac Gym viewer
the reference inspects runs with (``isaacgym_wrapper.py:374-460``: camera,
top-20 trajectory lines, keyboard feedback).  The ASCII view needs nothing;
the PNG plot and frames need matplotlib (and PIL for the GIF), imported
only when called: without it they return None.  Frames are drawn for the
point family only; on another scene ``save_frames`` says so and returns
None.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _pyplot():
    """matplotlib's pyplot on the Agg backend, or None where it is absent."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return None
    return plt


def _draw_statics(plt, ax, params) -> None:
    stat_pos, stat_half = _np(params.stat_pos), _np(params.stat_half)
    for pos, half in zip(stat_pos, stat_half):
        ax.add_patch(plt.Rectangle(pos - half, 2 * half[0], 2 * half[1], color="0.3"))


def render_point_env(env, state, width: int = 41, height: int = 21, extent: float = 4.2,
                     trajs: Optional[np.ndarray] = None) -> str:
    """Top-down ASCII view of a point-family scene: R robot, B box, D the
    other dynamic bodies, # statics; ``trajs`` [n, T, 2] overlays planned
    rollout points as ``.`` (the viewer's top-20 trajectory lines,
    isaacgym_wrapper.py:374-391)."""
    grid = [[" "] * width for _ in range(height)]

    def to_cell(x, y):
        c = int((x + extent) / (2 * extent) * (width - 1))
        r = int((extent - y) / (2 * extent) * (height - 1))
        return min(max(r, 0), height - 1), min(max(c, 0), width - 1)

    if trajs is not None:
        for x, y in _np(trajs).reshape(-1, 2):
            r, c = to_cell(x, y)
            grid[r][c] = "."
    p = env.params
    for (px, py), (hx, hy) in zip(_np(p.stat_pos), _np(p.stat_half)):
        for sx in np.linspace(-hx, hx, max(2, int(20 * hx))):
            for sy in np.linspace(-hy, hy, max(2, int(20 * hy))):
                r, c = to_cell(px + sx, py + sy)
                grid[r][c] = "#"
    names = list(p.actor_names)
    for (x, y), actor in zip(_np(state.dyn_pos), p.dyn_actor_idx):
        r, c = to_cell(x, y)
        grid[r][c] = "B" if names[actor] == "box" else "D"
    q = _np(state.q)
    r, c = to_cell(q[0], q[1])
    grid[r][c] = "R"
    border = "+" + "-" * width + "+"
    return "\n".join([border] + ["|" + "".join(row) + "|" for row in grid] + [border])


def save_trajectory_plot(env, log, path: str, top_trajs=None, goal=None) -> Optional[str]:
    """A PNG of a point-family run: the scene, the robot and box paths and
    the top rollouts (the viewer's trajectory lines plus
    plot/plot_point.py).  Returns the path, or None without matplotlib."""
    plt = _pyplot()
    if plt is None:
        return None
    fig, ax = plt.subplots(figsize=(6, 6))
    _draw_statics(plt, ax, env.params)
    if log.robot_pos:
        rp = np.asarray(log.robot_pos)
        ax.plot(rp[:, 0], rp[:, 1], "b-", label="robot")
    if log.box_pos:
        bp = np.asarray(log.box_pos)
        ax.plot(bp[:, 0], bp[:, 1], "r-", label="box")
    if top_trajs is not None:
        for traj in _np(top_trajs):
            ax.plot(traj[:, 0], traj[:, 1], "g-", alpha=0.2, lw=0.5)
    if goal is not None:
        ax.plot(goal[0], goal[1], "g*", markersize=15, label="goal")
    ax.set_xlim(-4.5, 4.5)
    ax.set_ylim(-4.5, 4.5)
    ax.set_aspect("equal")
    ax.legend(loc="upper right", fontsize=8)
    fig.savefig(path, dpi=100, bbox_inches="tight")
    plt.close(fig)
    return path


def save_frames(env, log, outdir: str, every: int = 5, goal=None, gif: bool = True) -> Optional[str]:
    """A point-family run as PNG frames of every ``every``-th tick (the
    statics, the robot and box paths so far, their current positions) and,
    where PIL is present, an animated GIF: the offline twin of the viewer's
    live camera.  Returns the GIF's path (the frame directory without PIL),
    or None without matplotlib, without logged positions or on another
    scene."""
    if env.env_type != "point_env":
        print(f"save_frames: frames are drawn for the point family only, not {env.env_type}")
        return None
    plt = _pyplot()
    if plt is None or not log.robot_pos:
        return None
    os.makedirs(outdir, exist_ok=True)
    rp = np.asarray(log.robot_pos)
    bp = np.asarray(log.box_pos) if log.box_pos else None
    paths = []
    for t in range(0, rp.shape[0], max(1, every)):
        fig, ax = plt.subplots(figsize=(4, 4))
        _draw_statics(plt, ax, env.params)
        ax.plot(rp[: t + 1, 0], rp[: t + 1, 1], "b-", lw=1)
        ax.plot(rp[t, 0], rp[t, 1], "bo", markersize=8)
        if bp is not None and bp.shape[0] > t:
            ax.plot(bp[: t + 1, 0], bp[: t + 1, 1], "r-", lw=1)
            ax.plot(bp[t, 0], bp[t, 1], "rs", markersize=8)
        if goal is not None:
            ax.plot(goal[0], goal[1], "g*", markersize=12)
        ax.set_xlim(-4.5, 4.5)
        ax.set_ylim(-4.5, 4.5)
        ax.set_aspect("equal")
        ax.set_title(f"tick {t}")
        fp = os.path.join(outdir, f"frame_{t:05d}.png")
        fig.savefig(fp, dpi=80, bbox_inches="tight")
        plt.close(fig)
        paths.append(fp)
    if gif:
        try:
            from PIL import Image
        except ImportError:
            return outdir
        frames = [Image.open(fp) for fp in paths]
        gif_path = os.path.join(outdir, "run.gif")
        frames[0].save(gif_path, save_all=True, append_images=frames[1:], duration=100, loop=0)
        return gif_path
    return outdir
