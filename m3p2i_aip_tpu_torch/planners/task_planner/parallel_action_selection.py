"""Parallel action selection: collect every currently-executable action.

Where :func:`~.adaptive_action_selection.adapt_act_sel` stops at the first
executable action, this variant keeps scoring after each hit - inhibiting
found actions so the next pass surfaces the runner-up - and finally groups
the collected actions into plans whose members touch disjoint predicates and
can therefore run in parallel.

Behavioral parity target: reference
``planners/task_planner/parallel_action_selection.py:12-106``. Deviations,
both deliberate: the search loop is bounded (the reference's is not), and
plan grouping keeps discovery order within each plan (the reference round-
trips plans through Python sets, which scrambles member order).
"""
from __future__ import annotations

from m3p2i_aip_tpu_torch.planners.task_planner.adaptive_action_selection import (
    MAX_REFINEMENT_ROUNDS,
    _as_agent_obs_pairs,
    _goal_observed,
    _settle_preferences,
    missing_preconditions,
    push_subgoal,
)


def _group_parallel_plans(found):
    """Group found actions into plans over disjoint agents.

    ``found`` is a list of ``(action_name, owner_index)``. Each found action
    seeds one plan; the plan then absorbs, in discovery order, one action per
    *other* owner. Plans containing the same action set are deduplicated.
    """
    plans, seen_action_sets = [], set()
    for seed_name, seed_owner in found:
        plan, owners = [seed_name], {seed_owner}
        for name, owner in found:
            if owner not in owners:
                plan.append(name)
                owners.add(owner)
        action_set = frozenset(plan)
        if action_set not in seen_action_sets:
            seen_action_sets.add(action_set)
            plans.append(plan)
    return plans


def par_act_sel(agents, observations):
    """Return ``(outcome, plans)`` where plans is a list of action lists.

    ``("success", ["idle_success", ...])`` when a desired state is observed
    (one entry per satisfied agent), ``("running", <plans>)`` when at least
    one executable action was found, ``("failure", [])`` otherwise.
    """
    pairs = _as_agent_obs_pairs(agents, observations)

    for agent, obs in pairs:
        _settle_preferences(agent, obs)
    satisfied = sum(_goal_observed(agent, obs) for agent, obs in pairs)
    if satisfied:
        return "success", ["idle_success"] * satisfied

    found = []  # (action_name, owner agent index), in discovery order
    refining = False
    for _ in range(MAX_REFINEMENT_ROUNDS):
        proposals = []  # (owner index, agent, chosen action index)
        for owner, (agent, obs) in enumerate(pairs):
            if obs == "null":
                continue
            if not refining:
                agent.infer_states(obs)
            _, action = agent.infer_policies()
            proposals.append((owner, agent, action))
        believed = {agent.most_likely_state() for _, agent, _ in proposals}

        if all(action == 0 for _, _, action in proposals):
            break  # every agent content with idle: search exhausted

        for owner, agent, action in proposals:
            if action == 0:
                continue
            missing = missing_preconditions(agent, action, believed)
            if missing:
                refining = True
                for state_name in missing:
                    push_subgoal(pairs, state_name)
                agent.reset_habits(action)
            else:
                # Executable: record it, then inhibit it so the next pass
                # can surface this agent's runner-up action.
                found.append((agent._mdp.action_names[action], owner))
                agent.reset_habits(action)

    if not found:
        return "failure", []
    return "running", _group_parallel_plans(found)
