"""The albert's task-indexed running costs (frozen copy of the port's
``AlbertObjective`` and ``sigmoid``, ``planners/motion_planner/
cost_functions.py``, which the frozen ``cost_functions.py`` beside this file
leaves out).

Port of ``AlbertObjective``
(``m3p2i_aip_tpu/planners/motion_planner/cost_functions.py:363``).  Task
selection is data: all four costs are evaluated and ``torch.where`` picks
one per the traced ``task_id``, so a task switch never branches on the host.
"""
from __future__ import annotations

import torch

from benchmark.reference.plain.models import albert
from benchmark.reference.plain.ops.norm import vector_norm


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """1 / (1 + exp(-x)), written out so that the albert rollout kernel can
    round it the same way (``torch.sigmoid`` may differ by an ulp)."""
    return 1.0 / (1.0 + torch.exp(-x))


class AlbertObjective:
    """ee_reach / push_reach / reposition / navigation costs for the albert
    (``cost_functions.py:363``).  Every push_reach threshold derives from one
    contact radius, the base footprint plus the box half size.
    ``compute`` returns (cost [...], the albert's empty ext)."""

    def __init__(self, params: albert.AlbertParams):
        self.params = params
        box_half = float(torch.mean(params.box_half.cpu())) if params.has_box else 0.2
        self.contact_r = float(params.base_radius) + box_half
        self.approach_r = self.contact_r + 0.03  # approach shaping boundary
        self.hover_gate_r = self.contact_r + 0.05  # hover reweight midpoint
        self.clearance_r = self.contact_r + 0.10  # reposition keep-out

    def compute(self, state: albert.AlbertState, u, task, mode, ee_pos=None):
        """Task dispatch: 9 push_reach, 7 ee_reach, 8 reposition, anything
        else navigation; all four are evaluated and one is picked per the
        task id.  ``ee_pos`` takes an EE position of ``state`` already at hand."""
        if ee_pos is None:
            ee_pos = albert.fk(state)["ee"][0]
        goal = task.goal
        q_xy = state.q[..., :2]
        ee_cost = 10.0 * vector_norm(ee_pos - goal[..., :3], dim=-1)
        nav_cost = vector_norm(q_xy - goal[..., :2], dim=-1)
        # base-progress shaping: ranks wheel samples apart from the arm noise
        base_cost = 3.0 * vector_norm(q_xy - goal[..., :2], dim=-1)

        # push_reach: the base shoves the box to goal[:2] while the arm keeps
        # the EE hovering over the moving box at height goal[2]
        r2b = state.box_pos - q_xy
        b2g = goal[..., :2] - state.box_pos
        d_rb = vector_norm(r2b, dim=-1)
        d_bg = vector_norm(b2g, dim=-1)
        cos_theta = torch.sum(-r2b * b2g, dim=-1) / torch.clamp(d_rb * d_bg, min=1e-9)
        approach = 5.0 * torch.clamp(d_rb - self.approach_r, min=0.0)
        push_cost = 3.0 * (d_rb + d_bg * 10.0) + 1.5 * (1.0 + cos_theta) + approach
        hover = torch.cat([state.box_pos, goal[..., 2:3].expand(state.box_pos.shape[:-1] + (1,))], dim=-1)
        # contact-gated hover weight, 1.5 far -> 4.0 in contact
        hover_w = 1.5 + 2.5 * sigmoid((self.hover_gate_r - d_rb) / 0.03)
        hover_cost = hover_w * vector_norm(ee_pos - hover, dim=-1)
        # reposition: navigate around the box to the standoff
        repo_cost = nav_cost + 10.0 * torch.clamp(self.clearance_r - d_rb, min=0.0)

        tid = task.task_id
        cost = torch.where(
            tid == 9,
            push_cost + hover_cost,
            torch.where(tid == 7, ee_cost + base_cost, torch.where(tid == 8, repo_cost, nav_cost)),
        )
        return cost, albert.zero_ext(cost.shape, cost.device)
