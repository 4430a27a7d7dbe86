"""Active-inference pick sequence: scripted observations drive reach ->
pick -> place -> idle_success.

Port of ``examples/example_aip_panda.py``: the documented progression
(reach while obs = 0, pick at obs = 1, place at obs = 2, idle_success at
obs = 3, then back to reach) of ``tests/test_task_planner.py``'s golden
sequence.  Host-only (numpy): its arguments, ``device=``
among them, are accepted and unused.

    python -m m3p2i_aip_tpu_torch.examples.example_aip_panda
"""
from __future__ import annotations

import sys

import numpy as np

from m3p2i_aip_tpu_torch.planners.task_planner import adaptive_action_selection, ai_agent, state_action_templates

# (first round, preferences, observation) of each phase
_PHASES = (
    (0, [[0], [1], [0], [0]], 0),  # cube_at_table -> reach
    (5, [[1], [0], [0], [0]], 1),  # cube_close_to_gripper -> pick
    (10, [[1], [0], [0], [0]], 2),  # cube_at_pre_place -> place
    (15, [[0], [0], [0], [1]], 3),  # cube_at_goal -> idle_success
    (20, [[0], [1], [0], [0]], 0),  # back to reach
)


def main(argv=()) -> list:
    """Print and return the 25 rounds' actions."""
    agents = [ai_agent.AiAgent(state_action_templates.MDPIsCubeAtReal())]
    actions = []
    for i in range(25):
        _, prefs, obs = [p for p in _PHASES if p[0] <= i][-1]
        agents[0].set_preferences(np.array(prefs))
        _, curr_action = adaptive_action_selection.adapt_act_sel(agents, [obs])
        print("Round:", i, "Current action:", curr_action)
        actions.append(curr_action)
    return actions


if __name__ == "__main__":
    main(sys.argv[1:])
