"""Parallel plans: two MDP agents with interdependent preconditions.

Port of ``examples/example_aip_parallel.py``: ``par_act_sel`` emits the
lists of parallelizable plans over four rounds.  Host-only (numpy):
its arguments, ``device=`` among them, are accepted and unused.

    python -m m3p2i_aip_tpu_torch.examples.example_aip_parallel
"""
from __future__ import annotations

import sys

import numpy as np

from m3p2i_aip_tpu_torch.planners.task_planner import ai_agent, parallel_action_selection, state_action_templates


def main(argv=()) -> list:
    """Print and return the four rounds' (outcome, plans)."""
    agents = [ai_agent.AiAgent(state_action_templates.MDPIsAt()), ai_agent.AiAgent(state_action_templates.MDPIsCloseTo())]
    agents[0].set_preferences(np.array([[1.0], [0.0]]))  # want at_goal
    agents[1].set_preferences(np.array([[1.0], [0.0]]))  # want close_to
    rounds = []
    for i in range(4):
        outcome, plans = parallel_action_selection.par_act_sel(agents, [1, 1])  # neither satisfied
        print("Round:", i, "outcome:", outcome, "plans:", plans)
        rounds.append((outcome, plans))
    return rounds


if __name__ == "__main__":
    main(sys.argv[1:])
