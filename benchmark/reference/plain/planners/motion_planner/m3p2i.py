"""M3P2I: multi-modal MPPI with per-mode distributions + mode arbitration.

Port of ``m3p2i_aip_tpu/planners/motion_planner/m3p2i.py``.  The multi-modal
math lives in :class:`~.mppi.MPPI` behind ``multi_modal``; this adds the
task-facing API: gripper command selection and the push-vs-pull preference.
"""
from __future__ import annotations

import torch

from benchmark.reference.plain.planners.motion_planner.mppi import MPPI, MPPIState


class M3P2I(MPPI):
    def __init__(self, cfg, rollout, **kwargs):
        super().__init__(cfg, rollout, **kwargs)
        self.suction_active = bool(cfg.suction_active)
        self.gripper_command = "open"

    def update_gripper_command(self, task: str) -> str:
        """Parity: m3p2i.update_gripper_command:10-14."""
        if task in ("reach", "place"):
            self.gripper_command = "open"
        elif task == "pick":
            self.gripper_command = "close"
        return self.gripper_command

    def get_pull_preference(self, state: MPPIState) -> int:
        """1 when the pull half's summed weights beat the push half's
        (m3p2i.get_pull_preference:16-22).  Reads the weights back to the
        host: for queries between chunks, not for the chunk loop."""
        if self.multi_modal:
            w_push = float(torch.sum(state.weights[: self.half_K]))
            w_pull = float(torch.sum(state.weights[self.half_K :]))
            return int(w_pull > w_push)
        return int(self.suction_active)
