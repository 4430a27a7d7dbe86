"""Task planners: fixed-goal, active-inference (panda), and patrolling.

Behavioral port of ``src/m3p2i_aip/planners/task_planner/task_planner.py``.
Host-side by design (SURVEY.md §1 L4a): the planners consume a small
*observation view* dict of the current real-env state (produced by
``Env.view(state)``) instead of a live Isaac Gym wrapper, and emit
``(task, curr_goal)`` which the orchestrator packs into traced
:class:`~m3p2i_aip_tpu_torch.planners.motion_planner.mppi.TaskParams` — the
host/device cut described in SURVEY.md §7 ("Host/device cut for AIP").

View schemas:
  point env : robot_pos [2], robot_vel [2], box_pos [2], box_quat [4]
  panda env : cube_state [7], cube_goal [7], ee_state [7]
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from m3p2i_aip_tpu_torch.planners.task_planner import (
    adaptive_action_selection,
    ai_agent,
    state_action_templates,
)
from m3p2i_aip_tpu_torch.ops.quat_np import general_ori_cube2goal


# Wedged-pick stall-detector thresholds, shared by the host mirror
# (PLANNER_AIF_PANDA.update_plan) and the on-device chunked gate
# (ReactiveTAMP._zup_update): the zup_gate flips on after ZUP_STALL_TICKS
# ticks with no new best progress toward the place goal while the cube is
# attached, and releases after ZUP_RELEASE_M of progress past the latch.
ZUP_STALL_TICKS = 30
ZUP_IMPROVE_M = 0.005
ZUP_RELEASE_M = 0.05


def set_task_planner(cfg):
    """Dispatch on env type. Parity: task_planner.set_task_planner:7-11."""
    if cfg.env_type in ("point_env", "heijn_env", "boxer_env", "albert_env"):
        return PLANNER_SIMPLE(cfg)
    return PLANNER_AIF_PANDA(cfg)


class PLANNER_SIMPLE:
    """Fixed task + goal from config. Parity: PLANNER_SIMPLE (task_planner.py:13-39)."""

    def __init__(self, cfg) -> None:
        self.task = cfg.task
        self.curr_goal = np.asarray(cfg.goal, dtype=np.float32)
        self.dist_threshold = 0.1
        # Diff-drive pocket-endgame plan (extension; no reference
        # equivalent — its published scenarios are point-robot only).
        # Completing a pull at a goal inside a zero-clearance wall pocket
        # requires the puller to occupy the strip between box and wall; a
        # nonholonomic base then cannot swing out past the box it is
        # suction-locked to (measured: boxer corner hybrid 1/20; with only
        # the rollout-level veto the pull half "holds" the box at the veto
        # radius forever, 9/20; a bare flip to push leaves the robot
        # diametrically opposite the push pose and it wedges at the wall).
        # The symbolic layer owns the fix — a three-stage plan:
        #   0 approach:   push_pull (pull drags the box to the pocket mouth)
        #   1 reposition: navigate to a standoff pose BEHIND the box on the
        #                 box->goal line (navigation cost, no success gate)
        #   2 finish:     pure push drives the box flush into the corner
        # Stage 0 latches on proximity OR stall: en route to a corner goal
        # the pull drags the box along a wall, and the boundary-crush veto
        # can kill the pull half while the box is still far outside the
        # proximity radius (measured: total freeze at d_bg=2.2, robot
        # wall-pinned on the goal side of the box).  A stalled box with the
        # robot adjacent means the pull is vetoed/stuck — reposition then.
        # Stage 2 re-latches reposition on a push stall (bounded), giving a
        # push <-> reposition recovery cycle for fresh wedges on the way in.
        self._base_task = cfg.task
        self._base_goal = self.curr_goal.copy()
        self._pocket_lim: Optional[float] = None
        self._prox_latch = True
        self._min_clearance = 0.0
        self._pocket_stage = 0
        self._stall_prev: Optional[np.ndarray] = None
        self._stall_n = 0
        self._relatch_left = 5
        self._latch_d_bg: Optional[float] = None
        self._stalled = False
        self._observed = False

    _POCKET_LATCH_R = 1.25  # > the 1.0 rollout veto radius: latch fires first
    _STANDOFF = 0.75  # m behind the box center (robot r 0.3 + box half 0.2)
    _STALL_CALLS = 15  # stall ticks before the latch fires (see observe())

    def configure_pocket_endgame(
        self,
        pocket_lim: float,
        proximity_latch: bool = True,
        min_clearance: float = 0.0,
    ) -> None:
        """Arm the staged plan with the arena pocket limit: goals beyond
        ``pocket_lim`` from the center sit in a wall pocket the robot cannot
        stand in.  Armed for push_pull (the pocket endgame proper) AND pure
        push — the nonholonomic base parks beside the box it should circle
        behind (the repositioning arc exceeds the lookahead; measured 1/20
        without staging), and the same stall -> reposition -> push cycle
        breaks that fixed point.

        ``proximity_latch=False`` (holonomic bases) arms ONLY the stall
        latch: a holonomic robot finishes pocket goals through rollout
        arbitration alone (corner1 hybrid 20/20 without staging), but a
        two-corner drag (box STARTS in a corner — the reference's corner2
        scenario) can back the puller into the goal pocket where the
        boundary-crush veto freezes it 0.3 m short; the stall latch
        detects exactly that freeze and repositions for the final push.

        Also armed for the albert ``push_reach`` (same diff-drive
        parks-beside-the-box fixed point, open floor, stall latch only).

        Round 5 extends the stall latch to POCKET-GOAL pure pulls (the
        corner1-pull 14/20 / corner2-pull 11/20 honest negatives): the
        failing seeds freeze mid-drag when the boundary-crush veto kills a
        wall-hugging pull far from the goal — exactly the freeze the latch
        detects.  The recovery cycle stays within pull semantics: reposition
        to a standoff on the GOAL side of the box (a puller drags the box
        toward itself), then resume PULL.  Open-floor pulls (e.g. the
        case2 dyn-obstacle scenario, goal at the center) never arm, so the
        published n=60 rows are untouched.

        ``min_clearance`` (meters): keep the reposition standoff at least
        this far from the box even after arena clipping — the motion cost's
        reposition keep-out term (e.g. AlbertObjective.clearance_r) would
        otherwise fight the nav term when a corner box clips the naive
        behind-the-box pose inside it."""
        armed = self._base_task in ("push", "push_pull", "hybrid", "push_reach")
        if self._base_task == "pull" and (
            np.max(np.abs(self._base_goal[:2])) > pocket_lim
        ):
            armed = True
        if armed:
            self._pocket_lim = pocket_lim
            self._prox_latch = proximity_latch
            self._min_clearance = float(min_clearance)

    def _box_stalled(self, box, robot) -> bool:
        """True after _STALL_CALLS consecutive calls with the box unmoving
        while the robot sits beside it (an actively pushed/pulled box moves
        every tick; a near-robot stalled box means the contact task is
        vetoed or wedged)."""
        moved = (
            self._stall_prev is None
            or np.linalg.norm(box - self._stall_prev) > 0.002
        )
        self._stall_prev = box.copy()
        if not moved and np.linalg.norm(robot - box) < 0.8:
            self._stall_n += 1
        else:
            self._stall_n = 0
        return self._stall_n >= self._STALL_CALLS

    def _latch_reposition(self, box) -> None:
        if self._base_task == "pull":
            # a puller drags the box toward itself: stand on the GOAL side
            away = self._base_goal[:2] - box
        else:
            away = box - self._base_goal[:2]
        away = away / max(float(np.linalg.norm(away)), 1e-6)
        standoff = box + self._STANDOFF * away
        # keep the standoff reachable: a corner-start box puts the naive
        # behind-the-box pose outside the arena walls
        if self._pocket_lim is not None:
            lim = self._pocket_lim
            standoff = np.clip(standoff, -lim, lim)
            # ... and outside the motion cost's keep-out radius: a clipped
            # standoff inside it makes the nav and clearance terms fight and
            # the base hovers short of the goal.  Pick the admissible
            # candidate farthest from the box, tie-broken by closeness to
            # the naive behind-the-box pose.
            clear = getattr(self, "_min_clearance", 0.0)
            if clear > 0.0 and float(np.linalg.norm(standoff - box)) < clear:
                naive = box + self._STANDOFF * away
                r = 1.05 * clear
                dirs = [away] + [
                    np.asarray(v, np.float64)
                    for v in ([1, 0], [-1, 0], [0, 1], [0, -1])
                ]
                cands = [np.clip(box + r * d, -lim, lim) for d in dirs]
                standoff = max(
                    cands,
                    key=lambda p: (
                        round(float(np.linalg.norm(p - box)), 6),
                        -float(np.linalg.norm(p - naive)),
                    ),
                )
        self.task = "reposition"
        self.curr_goal = standoff.astype(np.float32)
        self._pocket_stage = 1
        self._stall_n = 0

    def observe(self, view) -> None:
        """Per-tick stall bookkeeping, decoupled from the planning cadence.

        Chunked loops call ``update_plan`` once per CHUNK, which used to make
        the stall latch wait ``_STALL_CALLS`` *chunks* (150 ticks at chunk=10)
        instead of ticks — the albert push_reach chunked envelope timed out
        8/20 seeds purely on that latch latency (each push<->reposition
        recovery cycle paid the 10x detection delay).  The chunk drains every
        per-tick view host-side anyway, so the loops feed them here and the
        latch stays tick-granular under any chunk size; ``update_plan`` then
        consumes the freshest verdict at the next plan boundary."""
        if self._pocket_lim is None:
            return
        box = np.asarray(view["box_pos"], dtype=np.float32)[:2]
        robot = np.asarray(view["robot_pos"], dtype=np.float32)[:2]
        self._stalled = self._box_stalled(box, robot)
        self._observed = True

    def update_plan(self, view) -> None:
        if self._pocket_lim is None:
            return
        # The proximity latch pre-empts only POCKET pulls (goals inside a
        # zero-clearance wall pocket); the stall latch is always armed —
        # a box that stopped moving with the robot beside it means the
        # contact task is wedged regardless of where the goal is
        pocket_goal = (
            self._prox_latch
            and self._base_task in ("push_pull", "hybrid")
            and np.max(np.abs(self._base_goal[:2])) > self._pocket_lim
        )
        box = np.asarray(view["box_pos"], dtype=np.float32)[:2]
        robot = np.asarray(view["robot_pos"], dtype=np.float32)[:2]
        if not self._observed:  # per-tick loop: update_plan IS the observer
            self.observe(view)
        self._observed = False
        stalled = self._stalled
        if self._pocket_stage == 0:
            near = pocket_goal and (
                np.linalg.norm(box - self._base_goal[:2])
                < self._POCKET_LATCH_R
            )
            if near or stalled:
                self._latch_reposition(box)
        elif self._pocket_stage == 1:
            if np.linalg.norm(robot - self.curr_goal[:2]) < 0.15:
                # finish stage: PURE push for the point family (even from a
                # push_pull base plan); push_reach keeps its own cost (the
                # EE hover must stay active through the endgame); a pull
                # base plan RESUMES PULL (its recovery cycle must stay
                # within pull semantics — see configure_pocket_endgame)
                self.task = (
                    self._base_task
                    if self._base_task in ("push_reach", "pull")
                    else "push"
                )
                self.curr_goal = self._base_goal.copy()
                self._pocket_stage = 2
                self._stall_n = 0
        elif stalled:
            # a recovery cycle that moved the box closer since the last
            # latch is WORKING — refill the budget BEFORE gating on it (the
            # bound exists to stop unproductive spinning, not productive
            # multi-arc pushes)
            d_bg = float(np.linalg.norm(box - self._base_goal[:2]))
            if self._latch_d_bg is not None and d_bg < self._latch_d_bg - 0.05:
                self._relatch_left = 5
            if self._relatch_left > 0:
                self._latch_d_bg = d_bg
                self._relatch_left -= 1
                self._latch_reposition(box)

    def reset_plan(self) -> None:
        self.task = self._base_task
        self.curr_goal = self._base_goal.copy()
        self._pocket_stage = 0
        self._stall_prev = None
        self._stall_n = 0
        self._stalled = False
        self._observed = False
        self._relatch_left = 5
        self._latch_d_bg = None

    def check_task_success(self, view) -> bool:
        if self.task == "navigation":
            return bool(
                np.linalg.norm(np.asarray(view["robot_pos"]) - self.curr_goal[:2])
                < self.dist_threshold
            )
        if self.task in ("push", "pull", "push_pull", "hybrid"):
            return bool(
                np.linalg.norm(np.asarray(view["box_pos"]) - self.curr_goal[:2])
                <= self.dist_threshold
            )
        if self.task == "ee_reach":  # albert: end effector at a 3D goal
            return bool(
                np.linalg.norm(np.asarray(view["ee_pos"]) - self.curr_goal[:3])
                < self.dist_threshold
            )
        if self.task == "push_reach":  # albert: box at the planar goal
            return bool(
                np.linalg.norm(np.asarray(view["box_pos"]) - self.curr_goal[:2])
                <= self.dist_threshold
            )
        return False


class PLANNER_AIF_PANDA(PLANNER_SIMPLE):
    """Active-inference reach/pick/place planner for the panda env.

    Parity: PLANNER_AIF_PANDA (task_planner.py:41-107) including the
    ``pick_always`` / ``place_always`` hysteresis latches (:58-76).  The
    reference's ``sim.step()`` inside ``update_plan`` (:79) exists only to
    refresh link tensors after the state sync; here link states come from FK
    on the synced state directly, so no extra step is needed.
    """

    def __init__(self, cfg) -> None:
        self.task = "idle"
        self.curr_goal = np.zeros(7, dtype=np.float32)
        self.curr_action = "idle"
        mdp_isCubeAt = state_action_templates.MDPIsCubeAtReal()
        self.ai_agent_task = [ai_agent.AiAgent(mdp_isCubeAt)]
        self.obs = 0
        self.pick_always = False
        self.place_always = False
        self.pre_pick_place_threshold = float(cfg.pre_height_diff) + 0.005
        self.pre_place_loc = np.zeros(7, dtype=np.float32)
        self.dist_threshold = 0.1
        self._zup_reset()

    def _zup_reset(self) -> None:
        self.zup_gate = 0.0
        self._zup_best = np.inf
        self._zup_n = 0
        self._zup_latch = 0.0

    def _zup_update(self, d: float, in_pick: bool, att: float) -> None:
        """Host mirror of ReactiveTAMP._zup_update (same thresholds): flag
        the pick as wedged when the attached cube stops making new best
        progress toward the place goal (a wedged cube RATTLES at 0.2-0.5
        m/s, so no instantaneous-velocity test can detect it)."""
        improved = d < self._zup_best - ZUP_IMPROVE_M
        self._zup_best = min(self._zup_best, d)
        active = in_pick and att > 0.5
        self._zup_n = self._zup_n + 1 if (active and not improved) else 0
        was_on = self.zup_gate > 0.5
        turn_on = self._zup_n >= ZUP_STALL_TICKS
        if active and turn_on and not was_on:
            self._zup_latch = d
        release = d < self._zup_latch - ZUP_RELEASE_M
        self.zup_gate = (
            1.0 if (active and ((was_on and not release) or turn_on)) else 0.0
        )
        if not in_pick:
            self._zup_best = np.inf

    def get_obs(self, cube_state, cube_goal, ee_state) -> None:
        """Discrete observation {0,1,2} with hysteresis (task_planner.py:58-76)."""
        reach_cost = float(np.linalg.norm(ee_state[:3] - cube_state[:3]))
        dist_cost = float(np.linalg.norm(self.pre_place_loc[:2] - cube_state[:2]))
        ori_cost = float(
            general_ori_cube2goal(
                np.asarray(cube_goal[3:]).reshape(4), np.asarray(cube_state[3:]).reshape(4)
            )
        )
        if dist_cost + ori_cost < 0.03 or self.place_always:
            self.obs = 2
            self.ai_agent_task[0].set_preferences(np.array([[1], [0], [0], [0]]))
            self.place_always = True
        elif reach_cost < self.pre_pick_place_threshold or self.pick_always:
            self.obs = 1
            self.ai_agent_task[0].set_preferences(np.array([[1], [0], [0], [0]]))
            self.pick_always = True
        elif not self.pick_always:
            self.obs = 0
            self.ai_agent_task[0].set_preferences(np.array([[0], [1], [0], [0]]))

    def update_plan(self, view) -> None:
        cube_state = np.asarray(view["cube_state"], dtype=np.float32)
        cube_goal = np.asarray(view["cube_goal"], dtype=np.float32)
        ee_state = np.asarray(view["ee_state"], dtype=np.float32)
        self.pre_place_loc = cube_goal.copy()
        self.pre_place_loc[2] += self.pre_pick_place_threshold
        self.get_obs(cube_state, cube_goal, ee_state)
        _, self.curr_action = adaptive_action_selection.adapt_act_sel(
            self.ai_agent_task, [self.obs]
        )
        self.task = self.curr_action
        if self.curr_action == "pick":
            self.curr_goal = self.pre_place_loc
        self._zup_update(
            float(np.linalg.norm(self.pre_place_loc[:3] - cube_state[:3])),
            self.task == "pick",
            float(view.get("attached", 0.0)),
        )

    def reset_plan(self) -> None:
        self.task = "idle"
        self.curr_action = "idle"
        self.obs = 0
        self.pick_always = False
        self.place_always = False
        mdp_isCubeAt = state_action_templates.MDPIsCubeAtReal()
        self.ai_agent_task = [ai_agent.AiAgent(mdp_isCubeAt)]
        self._zup_reset()

    def check_task_success(self, view) -> bool:
        """Success = cube within 0.04 of goal while placing (task_planner.py:100-107)."""
        cube_state = np.asarray(view["cube_state"], dtype=np.float32)
        dist_cost = float(np.linalg.norm(self.curr_goal[:2] - cube_state[:2]))
        return self.task == "place" and dist_cost < 0.04


class PLANNER_PATROLLING(PLANNER_SIMPLE):
    """Cycle through a goal list. Parity: PLANNER_PATROLLING (task_planner.py:109-125)."""

    def __init__(self, goals) -> None:
        self.task = "navigation"
        self.goals = np.asarray(goals, dtype=np.float32)
        self.goal_id = 0
        self.curr_goal = self.goals[self.goal_id]
        self.dist_threshold = 0.1

    def reset_plan(self) -> None:
        self.goal_id = 0
        self.curr_goal = self.goals[self.goal_id]

    def update_plan(self, view) -> None:
        robot_pos = np.asarray(view["robot_pos"], dtype=np.float32)
        if np.linalg.norm(robot_pos - self.curr_goal[:2]) < 0.1:
            self.goal_id = (self.goal_id + 1) % self.goals.shape[0]
            self.curr_goal = self.goals[self.goal_id]
