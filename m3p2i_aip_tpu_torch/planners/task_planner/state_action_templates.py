"""MDP templates for the active-inference task planner.

Behavioral port of
``src/m3p2i_aip/planners/task_planner/isaac_state_action_templates.py``: each
class defines the symbolic states, actions, transition model B, preconditions,
likelihood A, preferences C, initial belief D, habits E, and learning rate
kappa_d of one binary/quaternary predicate MDP.
"""
from __future__ import annotations

import numpy as np


def _achieve_first_state(n_states: int) -> np.ndarray:
    """Transition matrix for an action that makes state 0 true from anywhere."""
    b = np.zeros((n_states, n_states))
    b[0, :] = 1.0
    return b


class MDPIsAt:
    """Parity: isaac_state_action_templates.MDPIsAt:6-40."""

    def __init__(self):
        self.state_name = "isAt"
        self.state_names = ["at_goal", "not_at_goal"]
        self.action_names = ["idle", "move_to"]
        self.V = np.array([0, 1])
        self.B = np.zeros((2, 2, 2))
        self.B[:, :, 0] = np.eye(2)
        self.B[:, :, 1] = _achieve_first_state(2)
        self.preconditions = [["none"], ["battery_ok"]]
        self.A = np.eye(2)
        self.C = np.array([[0.0], [0.0]])
        self.D = np.array([[0.5], [0.5]])
        self.E = np.array([[1.01], [1.0]])
        self.kappa_d = 1


class MDPIsCloseTo:
    """Parity: MDPIsCloseTo:42-76."""

    def __init__(self):
        self.state_name = "isCloseTo"
        self.state_names = ["close_to", "not_close_to"]
        self.action_names = ["idle", "approach_obj"]
        self.V = np.array([0, 1])
        self.B = np.zeros((2, 2, 2))
        self.B[:, :, 0] = np.eye(2)
        self.B[:, :, 1] = _achieve_first_state(2)
        self.preconditions = [["none"], ["none"]]
        self.A = np.eye(2)
        self.C = np.array([[0.0], [0.0]])
        self.D = np.array([[0.5], [0.5]])
        self.E = np.array([[1.01], [1.0]])
        self.kappa_d = 1


class MDPIsLocFree:
    """Parity: MDPIsLocFree:78-115."""

    def __init__(self):
        self.state_name = "isLocFree"
        self.state_names = ["loc_free", "not_loc_free"]
        self.action_names = ["idle", "push_to_non_goal", "pull_to_non_goal"]
        self.V = np.array([0, 1, 2])
        self.B = np.zeros((2, 2, 3))
        self.B[:, :, 0] = np.eye(2)
        self.B[:, :, 1] = _achieve_first_state(2)
        self.B[:, :, 2] = _achieve_first_state(2)
        self.preconditions = [["none"], ["close_to"], ["close_to"]]
        self.A = np.eye(2)
        self.C = np.array([[0.0], [0.0]])
        self.D = np.array([[0.5], [0.5]])
        self.d = np.array([[0.5], [0.5]])
        self.E = np.array([[1.01], [1.0], [1.0]])
        self.kappa_d = 1


class MDPIsBlockAt:
    """Parity: MDPIsBlockAt:117-154."""

    def __init__(self):
        self.state_name = "isBlockAt"
        self.state_names = ["block_at_loc", "not_block_at_loc"]
        self.action_names = ["idle", "push_to_goal", "pull_to_goal"]
        self.V = np.array([0, 1, 2])
        self.B = np.zeros((2, 2, 3))
        self.B[:, :, 0] = np.eye(2)
        self.B[:, :, 1] = _achieve_first_state(2)
        self.B[:, :, 2] = _achieve_first_state(2)
        self.preconditions = [["none"], ["loc_free", "close_to"], ["loc_free", "close_to"]]
        self.A = np.eye(2)
        self.C = np.array([[0.0], [0.0]])
        self.D = np.array([[0.5], [0.5]])
        self.d = np.array([[0.5], [0.5]])
        self.E = np.array([[1.01], [1.0], [1.0]])
        self.kappa_d = 1


class MDPIsCubeAt:
    """Parity: MDPIsCubeAt:156-190."""

    def __init__(self):
        self.state_name = "isCubeAt"
        self.state_names = ["cube_at_table", "cube_at_hand", "cube_at_goal"]
        self.action_names = ["idle", "pick", "place"]
        self.V = np.array([0, 1, 2])
        self.B = np.zeros((3, 3, 3))
        self.B[:, :, 0] = np.eye(3)
        self.B[:, :, 1] = _achieve_first_state(3)
        self.B[:, :, 2] = _achieve_first_state(3)
        self.preconditions = [["cube_at_goal"], ["cube_at_table"], ["cube_at_hand"]]
        self.A = np.eye(3)
        self.C = np.array([[0], [0], [0]])
        self.D = np.array([[0.5], [0.5], [0.5]])
        self.E = np.array([[1.0], [1.01], [1.0]])
        self.kappa_d = 0.8


class MDPIsCubeAtReal:
    """4-state pick-and-place predicate used by the panda planner.

    Parity: MDPIsCubeAtReal:192-232.
    """

    def __init__(self):
        self.state_name = "isCubeAt"
        self.state_names = [
            "cube_at_table",
            "cube_close_to_gripper",
            "cube_at_pre_place",
            "cube_at_goal",
        ]
        self.action_names = ["idle", "reach", "pick", "place"]
        self.V = np.array([0, 1, 2, 3])
        self.B = np.zeros((4, 4, 4))
        self.B[:, :, 0] = np.eye(4)
        for a in (1, 2, 3):
            self.B[:, :, a] = _achieve_first_state(4)
        self.preconditions = [
            ["cube_at_goal"],
            ["cube_at_table"],
            ["cube_close_to_gripper"],
            ["cube_at_pre_place"],
        ]
        self.A = np.eye(4)
        self.C = np.array([[0], [0], [0], [0]])
        self.D = np.array([[0.5], [0.5], [0.5], [0.5]])
        self.E = np.array([[1.0], [1.01], [1.0], [1.0]])
        self.kappa_d = 0.8
