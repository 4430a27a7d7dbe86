"""Adaptive action selection: active inference with subgoal back-chaining.

Given one agent per symbolic predicate, pick the next executable action: run
state/policy inference, and when the winning action's preconditions are not
believed true, push each missing state as a high-priority preference (weight
2) on whichever agent owns it, inhibit the blocked action, and re-score.
Inhibitions plus the drifting belief prior D surface alternatives on the
re-score passes, which deliberately do NOT refresh state inference - only
policy scoring (see :class:`~.ai_agent.AiAgent` docstring).

Behavioral parity target: reference
``planners/task_planner/adaptive_action_selection.py:12-84``. One deliberate
deviation: the reference's refinement loop is unbounded (it polls
``infer_policies`` forever if every agent settles on idle while alternatives
are being sought); here the same polling runs up to ``MAX_REFINEMENT_ROUNDS``
and then reports failure, so a planner tick can never hang.
"""
from __future__ import annotations

MAX_REFINEMENT_ROUNDS = 32

FAILURE = ("failure", "idle_fail")


def _as_agent_obs_pairs(agents, observations):
    if not isinstance(agents, list):
        agents, observations = [agents], [observations]
    return list(zip(agents, observations))


def _settle_preferences(agent, obs) -> None:
    """Start-of-tick housekeeping on one agent.

    Restore the habit prior (un-inhibit all actions) and retire any pushed
    subgoal (positive log-preference) that the current observation shows has
    been achieved.
    """
    agent.reset_habits()
    if obs != "null" and agent.preference_weight(obs) > 0:
        agent.set_preferences(0, obs)


def _goal_observed(agent, obs) -> bool:
    """True when the observation is a desired state (log-preference == 0)."""
    return obs != "null" and agent.preference_weight(obs) == 0


def push_subgoal(pairs, state_name: str) -> None:
    """Mark ``state_name`` as a high-priority preference on its owner agent."""
    for agent, _ in pairs:
        names = agent._mdp.state_names
        if state_name in names:
            agent.set_preferences(2, names.index(state_name))


def missing_preconditions(agent, action_index: int, believed_states) -> list:
    """Preconditions of the action not currently believed true anywhere."""
    return [
        name
        for name in agent._mdp.preconditions[action_index]
        if name != "none" and name not in believed_states
    ]


def adapt_act_sel(agents, observations):
    """Return ``(outcome, action_name)`` for the next tick.

    Outcomes: ``("success", "idle_success")`` when a desired state is already
    observed, ``("running", <action>)`` when an executable action is found,
    ``("failure", "idle_fail")`` when every agent wants idle with no pushed
    subgoals outstanding - or when the refinement bound is exhausted.
    """
    pairs = _as_agent_obs_pairs(agents, observations)

    for agent, obs in pairs:
        _settle_preferences(agent, obs)
    if any(_goal_observed(agent, obs) for agent, obs in pairs):
        return "success", "idle_success"

    refining = False  # set once any subgoal has been pushed
    for _ in range(MAX_REFINEMENT_ROUNDS):
        proposals = []  # (agent, chosen action index) for agents with evidence
        for agent, obs in pairs:
            if obs == "null":
                continue
            if not refining:
                agent.infer_states(obs)
            _, action = agent.infer_policies()
            proposals.append((agent, action))
        believed = {agent.most_likely_state() for agent, _ in proposals}

        if all(action == 0 for _, action in proposals):
            if not refining:
                return FAILURE
            continue  # inhibitions/drifting D may surface an alternative

        for agent, action in proposals:
            if action == 0:
                continue
            missing = missing_preconditions(agent, action, believed)
            if not missing:
                return "running", agent._mdp.action_names[action]
            refining = True
            for state_name in missing:
                push_subgoal(pairs, state_name)
            agent.reset_habits(action)  # inhibit until preconditions hold

    return FAILURE
