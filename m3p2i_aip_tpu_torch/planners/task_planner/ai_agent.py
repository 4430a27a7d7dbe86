"""Active-inference agent over tiny discrete MDPs.

Implements the symbolic layer of the RA-L 2024 M3P2I-AIP system (Pezzato et
al.): variational state inference by marginal message passing over a two-step
window, expected-free-energy policy scoring, and a habit/priority mechanism
that the action-selection loops use to push subgoals and inhibit actions.
Behavioral parity target: reference ``planners/task_planner/ai_agent.py``
(infer_states :52-109, infer_policies :111-144).

Design notes (this is a re-derivation, not a port):

* The reference iterates Python loops over policies; every update here is
  batched matrix algebra with the policy axis leading (``(n_policies, ...)``
  arrays, one einsum per message). For the 2-4 state MDPs this is a wash
  performance-wise - the point is that the math reads as math.
* The backward message into the first window slot is ``B.T @ uniform``,
  which is exactly ``1/n_states`` per entry for a column-stochastic B - a
  constant that cancels in the softmax. It is therefore omitted rather than
  computed.
* The policy posterior is ``softmax(habits - F - G)``; the reference takes
  ``argmax(softmax(log(.)))`` of it, which is the same argmax.

Host-side numpy by design: the matrices are 2-4 states and the planner runs
once per control tick (SURVEY.md section 1 L4a); only the resulting task id /
goal are fed to the jitted motion planner.
"""
from __future__ import annotations

import copy

import numpy as np

_TINY = 1e-16  # additive floor inside logs; log(1 + _TINY) == 0.0 in float64

# Window length for marginal message passing: the present step plus one
# lookahead (the reference hard-codes t_horizon = 2).
_WINDOW = 2


def log_stable(x) -> np.ndarray:
    """Elementwise log with an additive floor so log(0) stays finite."""
    return np.log(np.asarray(x, dtype=np.float64) + _TINY)


def columns_to_distributions(mat) -> np.ndarray:
    """Normalize each column to a probability vector (uniform where empty)."""
    mat = np.asarray(mat, dtype=np.float64)
    totals = mat.sum(axis=0, keepdims=True)
    uniform = np.full_like(mat, 1.0 / mat.shape[0])
    with np.errstate(invalid="ignore", divide="ignore"):
        scaled = mat / totals
    return np.where(totals > 0, scaled, uniform)


def softmax_last(x) -> np.ndarray:
    """Softmax along the last axis (stabilized per slice)."""
    x = np.asarray(x, dtype=np.float64)
    shifted = np.exp(x - x.max(axis=-1, keepdims=True))
    return shifted / shifted.sum(axis=-1, keepdims=True)


class AiAgent:
    """Free-energy-minimizing agent for one symbolic predicate MDP.

    The MDP template supplies states, one-step policies ``V`` (each policy is
    a single action index), transitions ``B``, likelihood ``A``, preferences
    ``C``, initial belief ``D``, habits ``E``, and the belief learning rate
    ``kappa_d`` (see ``state_action_templates.py``).

    Mutable state across calls: the belief prior ``D`` (updated with rate
    kappa_d after each policy inference), the log-preferences ``C`` (subgoal
    pushing), and the log-habits ``E`` (action inhibition). The selection
    loops exercise exactly this surface: calling :meth:`infer_policies`
    repeatedly *without* re-running :meth:`infer_states` re-scores the same
    beliefs under updated habits/preferences, which is how inhibited actions
    give way to alternatives.
    """

    def __init__(self, mdp):
        self._mdp = copy.deepcopy(mdp)
        spec = self._mdp

        self.n_states = spec.B.shape[0]
        self.n_actions = spec.B.shape[2]
        # V maps each one-step policy to the action it executes.
        self.policies = np.asarray(spec.V, dtype=int).reshape(-1)
        self.n_policies = self.policies.shape[0]

        if hasattr(spec, "D"):
            spec.D = columns_to_distributions(np.asarray(spec.D, dtype=np.float64))
        else:
            spec.D = np.full((self.n_states, 1), 1.0 / self.n_states)
        spec.C = log_stable(spec.C)
        spec.E = log_stable(columns_to_distributions(spec.E))
        self._habit_prior = spec.E.copy()

        # P(o|s) with columns normalized, and one column-stochastic transition
        # matrix per policy, gathered up front: (n_policies, ns, ns).
        self.obs_model = columns_to_distributions(spec.A)
        per_action = np.stack(
            [columns_to_distributions(spec.B[:, :, a]) for a in range(self.n_actions)]
        )
        self._trans = per_action[self.policies]

        # Ambiguity of each state under the observation model: diag(A^T log A).
        self._ambiguity = np.einsum(
            "os,os->s", self.obs_model, log_stable(self.obs_model)
        )

        self.free_energy = np.zeros((self.n_policies, 1))
        # Posterior state beliefs per policy and window slot: (npol, _WINDOW, ns).
        self.beliefs = np.full(
            (self.n_policies, _WINDOW, self.n_states), 1.0 / self.n_states
        )
        self.expected_free_energy = np.zeros((self.n_policies, 1))
        self.u = 0

    # ------------------------------------------------------------- inference
    def infer_states(self, obs: int):
        """Marginal message passing over the window, all policies at once.

        Slot 0 combines the prior ``log D`` with the evidence for the actual
        observation; slot 1 combines the forward message ``log(B_pi @ q_0)``
        with evidence for the observation *predicted* from ``q_0``. The
        variational free energy per policy accumulates
        ``q . (log q - forward message - evidence)`` over both slots.

        Parity: reference ``infer_states`` :52-109.
        """
        ns = self.n_states

        # Slot 0: identical input for every policy (transitions act later),
        # so compute once and broadcast. The backward message is a constant
        # (see module docstring) and is omitted.
        evidence_now = log_stable(self.obs_model[:, obs])  # (ns,)
        prior = log_stable(self._mdp.D[:, 0])  # (ns,)
        q0 = softmax_last(prior + evidence_now)  # (ns,)
        f0 = q0 @ (log_stable(q0) - prior - evidence_now)  # scalar
        q0_all = np.broadcast_to(q0, (self.n_policies, ns))

        # Slot 1 per policy: forward-propagate q0 and self-predict the
        # observation as the likeliest outcome of the propagated belief.
        forward = np.einsum("pij,j->pi", self._trans, q0)  # (npol, ns)
        predicted_obs = np.argmax(self.obs_model @ q0)  # same q0 for all p
        evidence_next = log_stable(self.obs_model[:, predicted_obs])
        q1 = softmax_last(log_stable(forward) + evidence_next)  # (npol, ns)
        f1 = np.einsum(
            "pi,pi->p", q1, log_stable(q1) - log_stable(forward) - evidence_next
        )

        self.beliefs = np.stack([q0_all, q1], axis=1)
        self.free_energy = (f0 + f1).reshape(self.n_policies, 1)
        return self.free_energy, self.beliefs

    def infer_policies(self):
        """Score policies by expected free energy and pick the best action.

        G(pi) = risk + ambiguity, with risk the negated log-preference of the
        outcome each policy is predicted to bring about, and ambiguity the
        expected observation-model entropy under the slot-1 belief. The
        policy posterior is ``softmax(habits - F - G)``; afterwards the
        belief prior D moves toward the policy-averaged slot-0 belief with
        rate kappa_d (tiny entries pruned to keep D sparse).

        Parity: reference ``infer_policies`` :111-144.
        """
        # Predicted outcome state per policy from the slot-0 belief.
        propagated = np.einsum("pij,pj->pi", self._trans, self.beliefs[:, 0, :])
        outcomes = np.argmax(propagated, axis=1)  # (npol,)
        risk = log_stable(1.0) - self._mdp.C[outcomes, 0]
        ambiguity = self.beliefs[:, 1, :] @ self._ambiguity
        self.expected_free_energy = (risk + ambiguity).reshape(self.n_policies, 1)

        score = self._mdp.E - self.free_energy - self.expected_free_energy
        policy_posterior = softmax_last(score[:, 0]).reshape(self.n_policies, 1)
        self.u = int(np.argmax(policy_posterior))

        # Bayesian model average of the slot-0 belief, then learn D.
        averaged = self.beliefs[:, 0, :].T @ policy_posterior  # (ns, 1)
        updated = columns_to_distributions(
            self._mdp.D + self._mdp.kappa_d * averaged
        )
        updated[updated < 1e-5] = 0.0
        self._mdp.D = columns_to_distributions(updated)
        return self.expected_free_energy, self.u

    # ------------------------------------------------------------- interface
    def set_observation(self, obs):
        self._mdp.o = obs

    def set_preferences(self, weight, index=None):
        """Store preference weight(s) in log space.

        Weight 1 marks a desired state (log-preference exactly 0), weight 2 a
        pushed high-priority subgoal (positive), weight 0 clears (strongly
        negative). Parity: reference ``set_preferences`` :172-176.
        """
        if index is None or index == "none":
            self._mdp.C = log_stable(weight)
        else:
            self._mdp.C[index] = log_stable(weight)

    def preference_weight(self, index) -> float:
        """Log-space preference for one state (see :meth:`set_preferences`)."""
        return float(np.asarray(self._mdp.C[index]).reshape(-1)[0])

    def get_action(self) -> int:
        return self.u

    def get_current_state(self):
        """Current belief prior D over symbolic states."""
        return self._mdp.D

    def most_likely_state(self) -> str:
        """Name of the state the belief prior currently favors."""
        return self._mdp.state_names[int(np.argmax(self._mdp.D))]

    def reset_habits(self, index=None):
        """Restore the habit prior, or inhibit one action (log-habit -> -inf).

        Parity: reference ``reset_habits`` :187-191.
        """
        if index is None or index == "none":
            self._mdp.E = self._habit_prior.copy()
        else:
            self._mdp.E[index] = log_stable(0)

    def reset_current_state(self):
        self._mdp.D = np.full((self.n_states, 1), 1.0 / self.n_states)
