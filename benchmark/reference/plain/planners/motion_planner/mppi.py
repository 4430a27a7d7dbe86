"""MPPI planner in torch: the halton-spline path and the simple (Williams)
path.

Port of ``m3p2i_aip_tpu/planners/motion_planner/mppi.py``: the planner state
lives in an explicit :class:`MPPIState` dataclass of tensors, the cached
Halton-spline deltas are precomputed once (numpy) and carried in the state,
the Savitzky-Golay filter is a precomputed [T, T] matrix, and task switches
arrive as :class:`TaskParams` tensors, never as a host branch.

The K rollouts go through an injected ``rollout(sim_state_k, acts, task)``
(``ops/rollout.py`` or ``ops/panda_rollout.py``, their plain versions),
and the multi-modal weights through ``ops/weights.py``; ``command`` is
``_command_impl`` itself (no mesh, no compiled program, no gradient
refinement: the cells run none).  After the first update, ``refine_iters`` more
rollouts re-sample the cached deltas at a shrinking scale around the new
means (the annealed refine ladder); the last rung optionally picks the argmin
sample instead of the weighted mean.  ``update_cov`` (single mode) and
``update_cov_per_mode`` (multi-modal) adapt the sampling scale from the
weighted second moment of the samples.  ``sampling_method=random`` replaces
the cached deltas by a fresh correlated Gaussian draw every tick, and
``mppi_mode=simple`` runs the reference's Williams update of one nominal
sequence ``U`` (``_command_simple``).

Random draws: the JAX planner draws its exploration jitter, its random
deltas, its simple-mode noise and its initial ``U`` with ``jax.random``,
which torch cannot reproduce.  Here the planner draws them from its own
``torch.Generator`` on the device (seeded from ``mppi.seed_val``), and
``command``/``_command_impl`` also take the tick's draw as an input so a test
can feed both packages the same numbers: the standard-normal jitter on the
halton path, the correlated draw ``noise_mu + z chol(noise_sigma)^T`` under
random sampling and in simple mode.

Seed batches: every planner step is written over leading dims, so an
``MPPIState`` whose fields carry a leading seed axis B (``init_state_batch``)
plans B seeded runs at once, one batched rollout launch per rollout.  The
real state then carries the same leading B, and ``TaskParams`` fields are
[B]-leading.  Seed b's exploration noise comes from its own generator,
seeded as the serial planner seeds its one, so seed b draws exactly what a
serial run with seed b draws.  The two contractions of the planner (the
K-sample weighted means and the Savitzky-Golay filter) accumulate in
float64 and round once to float32: a float32 matmul on the GPU sums in an
order that depends on how many seeds share the call, and those last-bit
differences grow, over a closed-loop run, into different trajectories.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from benchmark.reference.plain.ops.control import discounted_traj_cost, ensure_non_zero, scale_ctrl
from benchmark.reference.plain.ops.filters import savgol_matrix
from benchmark.reference.plain.ops.sampling import gaussian_halton_samples
from benchmark.reference.plain.ops.spline import bspline_interp_matrix
from benchmark.reference.plain.ops.weights import multimodal_weights, multimodal_weights_batched
from benchmark.reference.plain.utils.tree import tree_map, tree_stack


@dataclass
class TaskParams:
    """Per-tick task data, as tensors on the planner's device.

    ``task_id``: 0 navigation, 1 push, 2 pull, 3 push_pull, 4 reach, 5 pick,
    6 place, 7 ee_reach, 8 reposition, 9 push_reach.
    """

    task_id: torch.Tensor  # int32 scalar ([B] in a seed batch)
    goal: torch.Tensor  # [7] pos(3) + quat(4); 2D goals use [:2] ([B, 7])
    gripper: torch.Tensor  # int32: 0 none, 1 open, 2 close ([B])
    zup_gate: torch.Tensor  # f32 scalar ([B])


TASK_IDS = {
    "navigation": 0,
    "push": 1,
    "pull": 2,
    "push_pull": 3,
    "reach": 4,
    "pick": 5,
    "place": 6,
    "ee_reach": 7,
    "reposition": 8,
    "push_reach": 9,
    "idle": 0,
    "idle_success": 0,
    "idle_fail": 0,
    "reactive_pick": 4,
}


def make_task_params(
    task: str, goal, gripper_command: str = "none", zup_gate: float = 0.0, device="cpu"
) -> TaskParams:
    g = np.zeros(7, dtype=np.float32)
    goal = np.asarray(goal, dtype=np.float32).reshape(-1)
    g[: goal.shape[0]] = goal
    grip = {"none": 0, "open": 1, "close": 2}[gripper_command]
    goal = torch.as_tensor(g)
    if torch.device(device).type == "cuda":  # from pinned memory: no host sync inside a chunk's enqueue
        goal = goal.pin_memory().to(device, non_blocking=True)
    return TaskParams(
        task_id=torch.full((), TASK_IDS[task], dtype=torch.int32, device=device),
        goal=goal.to(device),
        gripper=torch.full((), grip, dtype=torch.int32, device=device),
        zup_gate=torch.full((), zup_gate, dtype=torch.float32, device=device),
    )


@dataclass
class MPPIState:
    """Planner state threaded through ``command`` calls.  In a seed batch
    every field carries a leading B (``beta`` is [B])."""

    mean_action: torch.Tensor  # [T, nu]
    mean_action_1: torch.Tensor
    mean_action_2: torch.Tensor
    best_traj: torch.Tensor
    best_traj_1: torch.Tensor
    best_traj_2: torch.Tensor
    U: torch.Tensor  # [T, nu] simple-mode nominal sequence
    beta: torch.Tensor  # single-mode adaptive inverse temperature
    weights: torch.Tensor  # [K] last importance weights
    cov_action: torch.Tensor  # [nu]
    cov_action_1: torch.Tensor
    cov_action_2: torch.Tensor
    halton_delta: torch.Tensor  # [K, T, nu] seeded Halton-spline deltas
    fric_scale_k: torch.Tensor  # [K, D] per-sample friction scales


class MPPI:
    """MPPI, halton-spline or simple.  Construction parity: MPPI.__init__
    (mppi.py:82-203).

    ``rollout(sim_state_k, acts, task) -> (cost_horizon [K, T], traj [K, T, 2])``
    rolls out all K samples from the broadcast real state.  ``graphs``: None
    (the default) compiles ``command`` (a CUDA graph on ``cuda``, the
    static-buffer body on the CPU), False runs it eagerly, True insists on
    CUDA graphs (raises on the CPU), as ``ReactiveTAMP``'s, which shares
    the planner's :class:`~m3p2i_aip_tpu_torch.tamp.graph_tick.TickGraphs`.
    """

    def __init__(self, cfg, rollout, fric_noise=None, device="cuda"):
        mcfg = cfg.mppi
        self.device = torch.device(device)
        self.env_type = cfg.env_type
        self.multi_modal = bool(cfg.multi_modal)
        self.cfg = mcfg
        self.mppi_mode = mcfg.mppi_mode
        self.sampling_method = mcfg.sampling_method
        self.lambda_ = mcfg.lambda_
        self.K = mcfg.num_samples
        self.half_K = self.K // 2
        self.T = mcfg.horizon
        self.filter_u = mcfg.filter_u
        self.sample_null_action = mcfg.sample_null_action
        self.u_scale = mcfg.u_scale

        noise_sigma = mcfg.noise_sigma or np.identity(int(mcfg.nx / 2)).tolist()
        self.noise_sigma = np.asarray(noise_sigma, dtype=np.float32)
        self.nu = self.noise_sigma.shape[0]
        self.noise_mu = np.asarray(mcfg.noise_mu or [0.0] * self.nu, dtype=np.float32)
        self.noise_sigma_inv = np.linalg.inv(self.noise_sigma)
        self._mu = self._t(self.noise_mu)
        self._chol = self._t(np.linalg.cholesky(self.noise_sigma).astype(np.float32))
        self._sigma_inv = self._t(self.noise_sigma_inv)

        u_max, u_min = mcfg.u_max, mcfg.u_min
        if u_max and not u_min:
            u_min = [-v for v in u_max]
        if u_min and not u_max:
            u_max = [-v for v in u_min]
        if u_min is None:  # unbounded controls
            u_min, u_max = [-np.inf] * self.nu, [np.inf] * self.nu
        self.u_min = self._t(np.asarray(u_min, np.float32))
        self.u_max = self._t(np.asarray(u_max, np.float32))

        gamma = mcfg.rollout_var_discount
        self.gamma_seq = self._t(np.cumprod([1.0] + [gamma] * (self.T - 1)).astype(np.float32))
        self.fine_noise_scale = mcfg.fine_noise_scale
        self.exploration_noise = float(mcfg.exploration_noise)
        self.beta_adapt = (
            self.env_type in ("panda_env", "boxer_env") if mcfg.beta_adapt is None else bool(mcfg.beta_adapt)
        )
        # STORM-lineage constants (mppi.py:168-203)
        self.knot_scale = 4
        self.n_knots = self.T // self.knot_scale
        self.ndims = self.n_knots * self.nu
        self.degree = 2
        self.step_size_mean = 0.98
        self.eta_u = float(mcfg.eta_u_bound)
        self.eta_l = float(mcfg.eta_l_bound)
        self.step_size_cov = 0.7  # (mppi.py:202)
        self.kappa = 0.005  # additive per-tick covariance drift (mppi.py:203)
        if mcfg.update_cov and (self.multi_modal or self.mppi_mode == "simple"):
            raise ValueError(
                "update_cov only applies to single-mode halton-spline MPPI (the reference's covariance update "
                "lives in _update_distribution, mppi.py:508-516, which the multi-modal and simple paths never "
                "reach); for the multi-modal path use update_cov_per_mode"
            )
        if mcfg.update_cov_per_mode and not self.multi_modal:
            raise ValueError("update_cov_per_mode requires multi_modal=True")
        self.scale_tril = self._t(np.sqrt(np.diagonal(self.noise_sigma)).astype(np.float32))
        self.seed_val = mcfg.seed_val
        self.refine_iters = int(mcfg.refine_iters or 0)
        self.refine_scale = float(mcfg.refine_scale)
        self.refine_decay = float(mcfg.refine_decay)
        self.refine_greedy = bool(mcfg.refine_greedy)
        if int(mcfg.grad_refine_steps or 0):
            raise ValueError("the reference has no gradient refinement (no cell runs it)")

        # Savitzky-Golay operator (window 9 order 2, mppi.py:190-193)
        sgf_window = min(9, self.T if self.T % 2 == 1 else self.T - 1)
        self._sgf = self._t(savgol_matrix(self.T, sgf_window, 2).astype(np.float32)).double()
        self.sample_mode = self._t((np.arange(self.K) >= self.half_K).astype(np.int32))
        self.rollout = rollout
        self.fric_noise = None if fric_noise is None else np.asarray(fric_noise)
        self.generator = torch.Generator(device=self.device)
        self.seed_generators: list = []  # one per seed of a batch (init_state_batch)
        self._seed_generator_sets: dict = {}  # seed count -> its generators, made once
        self.reseed(self.seed_val)

    def _t(self, x: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(x, device=self.device)

    def generators(self, lead: tuple) -> list:
        """The generators a step over a state with leading dims ``lead``
        draws from (the planner's, or one per seed of a batch): a compiled
        program registers them with its graph."""
        return list(self.seed_generators) if lead else [self.generator]

    def _rollout(self, sim_state_k, acts: torch.Tensor, task: TaskParams):
        """The rollout of all K samples (mppi.py:546-550): one call of
        ``self.rollout``.  Returns ([..., K, T], [..., K, T, 2])."""
        return self.rollout(sim_state_k, acts, task)

    def _make_halton_spline_deltas(self) -> np.ndarray:
        """[K, T, nu] Gaussian-Halton knots through the spline basis, the
        fine-noise quarter of each half-batch, and a zero row at K-1."""
        knots = gaussian_halton_samples(self.K, self.ndims, scramble=True, seed_val=self.seed_val).astype(
            np.float32
        )
        knots = knots.reshape(self.K, self.nu, self.n_knots)
        M = bspline_interp_matrix(self.n_knots, self.T, degree=self.degree, smoothing=0.5).astype(np.float32)
        samples = np.einsum("kun,tn->ktu", knots, M)
        for start in (0, self.half_K):
            half = self.half_K if self.K > 1 else self.K
            fine_lo = start + (3 * half) // 4
            samples[fine_lo : start + half] *= self.fine_noise_scale
        samples[-1] = 0.0
        return samples

    def _make_fric_scales(self) -> np.ndarray:
        """[K, D] per-sample friction multipliers 1 + U(-pct, pct)."""
        D = 0 if self.fric_noise is None else int(self.fric_noise.shape[0])
        if D == 0 or not np.any(self.fric_noise):
            return np.ones((self.K, max(D, 1)), dtype=np.float32)
        rng = np.random.default_rng(self.seed_val + 7919)
        u = rng.uniform(-1.0, 1.0, size=(self.K, D)).astype(np.float32)
        return 1.0 + u * self.fric_noise[None, :].astype(np.float32)

    @property
    def fric_inject(self) -> bool:
        return self.fric_noise is not None and bool(np.any(self.fric_noise))

    def reseed(self, seed_val: int) -> None:
        """Re-seed the sampler: new Halton deltas and friction scales (taken
        up by the next ``init_state``)."""
        self.seed_val = int(seed_val)
        self._delta = self._t(self._make_halton_spline_deltas())
        self._fric_scale = self._t(self._make_fric_scales())

    def init_state(self, generator: Optional[torch.Generator] = None) -> MPPIState:
        """Fresh planner state; also re-seeds the exploration generator (the
        planner's own, or ``generator``) with the planner's seed."""
        if generator is None:
            generator = self.generator
        generator.manual_seed(self.seed_val)
        z = torch.zeros(self.T, self.nu, dtype=torch.float32, device=self.device)
        if self.cfg.U_init is not None:
            U0 = self._t(np.asarray(self.cfg.U_init, np.float32))
        else:  # the reference samples U from the noise distribution (mppi.py:134)
            U0 = self._correlated(torch.randn(self.T, self.nu, generator=generator, device=self.device))
        cov = self._t(np.diagonal(self.noise_sigma).astype(np.float32))
        return MPPIState(
            mean_action=z,
            mean_action_1=z,
            mean_action_2=z,
            best_traj=z,
            best_traj_1=z,
            best_traj_2=z,
            U=U0,
            beta=torch.ones((), dtype=torch.float32, device=self.device),
            weights=torch.full((self.K,), 1.0 / self.K, dtype=torch.float32, device=self.device),
            cov_action=cov,
            cov_action_1=cov,
            cov_action_2=cov,
            halton_delta=self._delta,
            fric_scale_k=self._fric_scale,
        )

    def init_state_batch(self, seeds) -> MPPIState:
        """The stacked planner states of a seed batch: seed b's Halton deltas,
        friction scales and U0 draw are those of ``reseed(seeds[b])`` +
        ``init_state()``, and ``seed_generators[b]`` carries on from that
        draw, so each seed's per-tick noise is a serial run's.  The
        generators of a seed count are made once and re-seeded in place by
        every later batch of that count (a compiled tick keeps them
        registered with its CUDA graph)."""
        gens = self._seed_generator_sets.get(len(seeds))
        if gens is None:
            gens = self._seed_generator_sets[len(seeds)] = [torch.Generator(device=self.device) for _ in seeds]
        self.seed_generators = gens
        states = []
        for s, gen in zip(seeds, self.seed_generators):
            self.reseed(int(s))
            states.append(self.init_state(gen))
        return tree_stack(states)

    def _exploration_draw(self, shape) -> torch.Tensor:
        """A standard-normal [..., K, T, nu] draw: from the planner's
        generator, or with a leading seed axis one [K, T, nu] draw from each
        seed's generator, stacked."""
        if len(shape) == 3:
            return torch.randn(shape, generator=self.generator, device=self.device)
        if len(self.seed_generators) != shape[0]:
            raise ValueError(f"a batch of {shape[0]} seeds needs init_state_batch with as many seeds")
        return torch.stack(
            [torch.randn(shape[1:], generator=g, device=self.device) for g in self.seed_generators]
        )

    def _correlated(self, z: torch.Tensor) -> torch.Tensor:
        """``noise_mu + z @ chol(noise_sigma).T`` for a standard-normal ``z``
        [..., nu], as elementwise products summed in a fixed order, so a
        seed's draw has the same bits alone or in a batch."""
        acc = z[..., 0:1] * self._chol[:, 0]
        for j in range(1, self.nu):
            acc = acc + z[..., j : j + 1] * self._chol[:, j]
        return self._mu + acc

    def _correlated_draw(self, shape) -> torch.Tensor:
        """A [..., K, T, nu] draw from N(noise_mu, noise_sigma) (the
        reference's ``multivariate_normal``), from the generator(s) of
        ``_exploration_draw``."""
        return self._correlated(self._exploration_draw(shape))

    # --------------------------------------------------------------- helpers
    @staticmethod
    def _shift(seq: torch.Tensor) -> torch.Tensor:
        """Time-shift [..., T, nu] action sequences, repeating the last action."""
        return torch.cat([seq[..., 1:, :], seq[..., -1:, :]], dim=-2)

    @staticmethod
    def _take(actions: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        """``actions[..., idx, :, :]`` for a device index per leading slice
        (``actions`` [..., K, T, nu], ``idx`` [...]) without a host sync (a
        tensor index would read the index back to the host)."""
        return torch.take_along_dim(actions, idx[..., None, None, None], dim=-3).squeeze(-3)

    def _pick(self, actions: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return self._take(actions, torch.argmax(w, dim=-1))

    @staticmethod
    def _weighted_mean(w: torch.Tensor, actions: torch.Tensor) -> torch.Tensor:
        """sum_k w[..., k] actions[..., k, :, :], accumulated in float64 and
        rounded once, so a seed's mean is the same bits alone or in a batch."""
        return torch.einsum("...k,...ktu->...tu", w.double(), actions.double()).float()

    def _cov_update(self, cov, w, actions, mean) -> torch.Tensor:
        """The covariance EMA of ``update_cov`` (mppi.py:698-712) and of each
        mode under ``update_cov_per_mode`` (:663-689): the ``w``-weighted
        second moment of the samples about ``mean``, averaged over the
        horizon (summed in float64, as ``_weighted_mean``), smoothed by
        step_size_cov, plus the kappa drift.  [nu] ([B, nu] in a batch)."""
        delta = actions - mean[..., None, :, :]
        second = torch.einsum("...k,...ktu->...tu", w.double(), (delta**2).double()).mean(dim=-2).float()
        return (1.0 - self.step_size_cov) * cov + self.step_size_cov * second + self.kappa

    def _gripper_override(self, acts: torch.Tensor, task: TaskParams) -> torch.Tensor:
        """Panda gripper channels 7 and 8 forced to +1.5 (open) or -1.5
        (close) by the task's gripper command (mppi.py:498).  Writes in place
        into ``acts``, which callers pass freshly made."""
        if self.nu < 9:
            return acts
        grip = task.gripper.reshape(task.gripper.shape + (1, 1, 1))  # over [K, T, 2]
        val = torch.where(grip == 1, 1.5, torch.where(grip == 2, -1.5, 0.0))
        acts[..., 7:9] = torch.where(grip > 0, val, acts[..., 7:9])
        return acts

    # ---------------------------------------------------- weight computation
    def _exp_util(self, cost_horizon, beta):
        """Single-mode weights. Parity: MPPI._exp_util (mppi.py:430-456)."""
        traj_costs = discounted_traj_cost(cost_horizon, self.gamma_seq)
        total = traj_costs - torch.amin(traj_costs, dim=-1, keepdim=True)
        exp_ = torch.exp((-1.0 / beta[..., None]) * total)
        eta = torch.sum(exp_, dim=-1)
        weights = exp_ / eta[..., None]
        if self.beta_adapt:
            beta = torch.where(eta > 20.0, beta * 0.9, torch.where(eta < 10.0, beta * 1.2, beta))
        return weights, beta

    def _multi_modal_exp_util(self, cost_horizon):
        """Per-mode + global adaptive-beta weights (m3p2i.py:46-64); beta
        restarts at 1 on every call, as the reference's does.  [B, K, T] costs
        of a seed batch go through the batched weights."""
        weights_fn = multimodal_weights_batched if cost_horizon.dim() == 3 else multimodal_weights
        return weights_fn(cost_horizon, self.gamma_seq, self.half_K, self.eta_u, self.eta_l)

    # ---------------------------------------------------------------- update
    def _update_halton(self, state: MPPIState, cost_horizon, actions) -> MPPIState:
        """Distribution update. Parity: _update_distribution (mppi.py:485-503)
        and _update_multi_modal_distribution (m3p2i.py:66-92)."""
        keep = 1.0 - self.step_size_mean
        if self.multi_modal:
            w0, w1, w = self._multi_modal_exp_util(cost_horizon)
            new_mean = self._weighted_mean(w, actions)
            mean0, mean1 = self._weighted_mean(w0, actions), self._weighted_mean(w1, actions)
            state = dataclasses.replace(
                state,
                mean_action=keep * state.mean_action + self.step_size_mean * new_mean,
                mean_action_1=mean0,
                mean_action_2=mean1,
                best_traj_1=self._pick(actions, w0),
                best_traj_2=self._pick(actions, w1),
                weights=w,
            )
            if self.cfg.update_cov_per_mode:
                # each mode's EMA from its own masked weights; consumed as the
                # modes' relative scale in _command_halton
                state = dataclasses.replace(
                    state,
                    cov_action_1=self._cov_update(state.cov_action_1, w0, actions, mean0),
                    cov_action_2=self._cov_update(state.cov_action_2, w1, actions, mean1),
                )
            return state
        w, beta = self._exp_util(cost_horizon, state.beta)
        mean = keep * state.mean_action + self.step_size_mean * self._weighted_mean(w, actions)
        state = dataclasses.replace(state, mean_action=mean, best_traj=self._pick(actions, w), weights=w, beta=beta)
        if self.cfg.update_cov:
            state = dataclasses.replace(state, cov_action=self._cov_update(state.cov_action, w, actions, mean))
        return state

    # --------------------------------------------------------------- command
    def command(self, state: MPPIState, sim_state, task: TaskParams, noise=None):
        """One replanning step from the single real-env state (or, for a
        batched ``state``, from each seed's real-env state); ``noise``
        replaces the tick's draw.  Returns (action_sequence [T, nu],
        new_state, aux dict)."""
        return self._command_impl(state, sim_state, task, noise)

    def _command_impl(self, state: MPPIState, sim_state, task: TaskParams, noise=None):
        nb = state.mean_action.dim() - 2  # leading seed dims: 0, or 1 in a batch
        sim_state_k = tree_map(
            lambda x: x.unsqueeze(nb).expand(x.shape[:nb] + (self.K,) + x.shape[nb:]), sim_state
        )
        if self.fric_inject:
            sim_state_k = dataclasses.replace(sim_state_k, fric_scale=state.fric_scale_k)
        if self.mppi_mode == "simple":
            state, action, tps = self._command_simple(state, sim_state_k, task, noise)
        else:
            state, action, tps = self._command_halton(state, sim_state_k, task, noise)
        if self.filter_u:
            T = action.shape[-2]
            action = (self._sgf[:T, :T] @ action.double()).float()  # float64, as _weighted_mean
        # top-20 rollout positions for visualization (mppi.py:248-254)
        top_vals, top_idx = torch.topk(state.weights, min(20, self.K))
        top_trajs = torch.take_along_dim(tps, top_idx[..., None, None], dim=-3)
        aux = {"weights": state.weights, "top_trajs": top_trajs, "top_values": top_vals}
        return action, state, aux

    def _command_halton(self, state: MPPIState, sim_state_k, task: TaskParams, noise=None):
        """Shift, jitter (or a fresh random draw), per-mode sampling around
        the means, elites at 0 and half_K, null action at K-1, rollout,
        update (mppi.py:751-844).  ``noise`` [..., K, T, nu] replaces the
        generators' draw: standard-normal jitter on the cached deltas, or
        under random sampling the correlated deltas themselves.  Sample rows
        are written as [..., k, :, :], so a leading seed axis passes
        through."""
        state = dataclasses.replace(
            state,
            mean_action=self._shift(state.mean_action),
            mean_action_1=self._shift(state.mean_action_1),
            mean_action_2=self._shift(state.mean_action_2),
            best_traj=self._shift(state.best_traj),
            best_traj_1=self._shift(state.best_traj_1),
            best_traj_2=self._shift(state.best_traj_2),
        )
        delta = state.halton_delta
        if self.sampling_method == "random":
            # a fresh correlated draw every tick (mppi.py:762-769)
            delta = (self._correlated_draw(delta.shape) if noise is None else noise).clone()
            delta[..., -1, :, :] = 0.0  # in place on the fresh copy: keep the pure-mean sample
        elif self.exploration_noise > 0.0:
            # per-tick jitter on the cached deltas: breaks deterministic
            # replanning fixed points (see the JAX planner)
            if noise is None:
                noise = self._exploration_draw(delta.shape)
            delta = delta + self.exploration_noise * noise
            delta[..., -1, :, :] = 0.0  # in place on the fresh sum: keep the pure-mean sample
        scaled_delta = delta * self._sampling_scale(state)
        if self.multi_modal:
            mean_m = torch.where(
                (self.sample_mode == 0)[:, None, None],
                state.mean_action_1[..., None, :, :],
                state.mean_action_2[..., None, :, :],
            )
            act_seq = mean_m + scaled_delta
        else:
            act_seq = state.mean_action[..., None, :, :] + scaled_delta
        act_seq = scale_ctrl(act_seq, self.u_min, self.u_max, "clamp")
        # the row writes below go in place into the fresh act_seq
        if self.multi_modal:
            act_seq[..., 0, :, :] = state.best_traj_1  # per-mode elites (mppi.py:407-409)
            act_seq[..., self.half_K, :, :] = state.best_traj_2
        elif self.cfg.sample_best_traj:
            act_seq[..., 0, :, :] = state.best_traj
        act_seq = self._gripper_override(act_seq, task)
        if self.sample_null_action:
            act_seq[..., self.K - 1, :, :] = 0.0  # braking sample (mppi.py:300-302)

        cost_horizon, tps = self._rollout(sim_state_k, self.u_scale * act_seq, task)
        state = self._update_halton(state, cost_horizon, act_seq)
        state = self._sample_refine(state, sim_state_k, task)
        return state, state.mean_action, tps

    def _sampling_scale(self, state: MPPIState) -> torch.Tensor:
        """The deltas' scale (mppi.py:786-808): sqrt(cov_action) under
        ``update_cov``; under ``update_cov_per_mode`` each mode's half-batch
        at the nominal scale times its share of the two modes' EMAs, clamped
        to [0.25, 4] in variance; else the fixed sqrt(diag(noise_sigma)).
        Broadcasts against [..., K, T, nu]."""
        if self.cfg.update_cov:
            return torch.sqrt(state.cov_action)[..., None, None, :]
        if self.multi_modal and self.cfg.update_cov_per_mode:
            ref = 0.5 * (state.cov_action_1 + state.cov_action_2)
            base = self.scale_tril**2
            s1 = torch.sqrt(torch.clamp(state.cov_action_1 / ref, 0.25, 4.0) * base)
            s2 = torch.sqrt(torch.clamp(state.cov_action_2 / ref, 0.25, 4.0) * base)
            return torch.where((self.sample_mode == 0)[:, None, None], s1[..., None, None, :], s2[..., None, None, :])
        return self.scale_tril

    def _command_simple(self, state: MPPIState, sim_state_k, task: TaskParams, noise=None):
        """The reference's Williams update of the nominal sequence ``U``
        (mppi.py:992-1027): roll U, perturb it by the correlated draw
        (``noise`` replaces it), clamp, gripper override, null action,
        rollout; the action cost against noise_sigma^-1, beta = the least
        total cost, the exp weights of ``ensure_non_zero``, and U moved by
        the weighted post-clamp noise.  The totals, weights and U update are
        formed in float64 and rounded once, so a seed's U has the same bits
        alone or in a batch.  Returns the whole [T] U: the caller's filter
        acts on all of it."""
        U = torch.roll(state.U, -1, dims=-2)  # a plain roll (mppi.py:221), not _shift
        if noise is None:
            noise = self._correlated_draw(U.shape[:-2] + (self.K, self.T, self.nu))
        perturbed = scale_ctrl(U[..., None, :, :] + noise, self.u_min, self.u_max, "clamp")
        perturbed = self._gripper_override(perturbed, task)
        if self.sample_null_action:
            perturbed[..., self.K - 1, :, :] = 0.0  # in place on the fresh clamp
        cost_horizon, tps = self._rollout(sim_state_k, self.u_scale * perturbed, task)
        noise_b = perturbed - U[..., None, :, :]  # post-bounding noise (mppi.py:356)
        dev = torch.abs(noise_b) if self.cfg.noise_abs_cost else noise_b
        acc = dev[..., 0:1] * self._sigma_inv[0]  # dev @ noise_sigma^-1 in a fixed order
        for j in range(1, self.nu):
            acc = acc + dev[..., j : j + 1] * self._sigma_inv[j]
        action_cost = self.lambda_ * acc
        cost_total = torch.sum(cost_horizon.double(), dim=-1) + torch.sum(
            (U[..., None, :, :] * action_cost).double(), dim=(-2, -1)
        )
        beta = torch.amin(cost_total, dim=-1, keepdim=True)
        nz = ensure_non_zero(cost_total, beta, 1.0 / self.lambda_)
        weights = nz / torch.sum(nz, dim=-1, keepdim=True)
        U = U + torch.einsum("...k,...ktu->...tu", weights, noise_b.double()).float()
        return dataclasses.replace(state, U=U, weights=weights.float()), U, tps

    def _sample_refine(self, state: MPPIState, sim_state_k, task: TaskParams) -> MPPIState:
        """The annealed refine ladder (mppi.py:846): ``refine_iters`` rollouts
        of the cached deltas (no jitter) at scale refine_scale x
        refine_decay^i around the current means, each followed by the full
        distribution update, so a persistent single-mode beta adapts once per
        rung.  The last rung is the greedy argmin pick when
        ``refine_greedy``.  No null-action overwrite here: the K-1 zero-delta
        row stays the pure mean, so a rung never ranks the incumbent plan out
        of its own update."""
        for i in range(self.refine_iters):
            delta = state.halton_delta * (self.refine_scale * self.refine_decay**i * self.scale_tril)
            if self.multi_modal:
                mean_m = torch.where(
                    (self.sample_mode == 0)[:, None, None],
                    state.mean_action_1[..., None, :, :],
                    state.mean_action_2[..., None, :, :],
                )
                act_seq = mean_m + delta
            else:
                act_seq = state.mean_action[..., None, :, :] + delta
            act_seq = scale_ctrl(act_seq, self.u_min, self.u_max, "clamp")
            if self.multi_modal:
                # keep the per-mode elites, and ride the pure per-mode means at
                # slots 1 / half_K + 1 so the greedy pick is monotone per mode
                act_seq[..., 0, :, :] = state.best_traj_1
                act_seq[..., self.half_K, :, :] = state.best_traj_2
                act_seq[..., 1, :, :] = state.mean_action_1
                act_seq[..., self.half_K + 1, :, :] = state.mean_action_2
            elif self.cfg.sample_best_traj:
                act_seq[..., 0, :, :] = state.best_traj
            act_seq = self._gripper_override(act_seq, task)
            cost_horizon, _ = self._rollout(sim_state_k, self.u_scale * act_seq, task)
            if self.refine_greedy and i == self.refine_iters - 1:
                state = self._greedy_pick(state, cost_horizon, act_seq)
            else:
                state = self._update_halton(state, cost_horizon, act_seq)
        return state

    def _greedy_pick(self, state: MPPIState, cost_horizon, actions) -> MPPIState:
        """The mean plan(s) become the argmin sample, per mode when
        multi-modal (mppi.py:906)."""
        traj_costs = discounted_traj_cost(cost_horizon, self.gamma_seq)
        if self.multi_modal:
            m0 = self.sample_mode == 0
            return dataclasses.replace(
                state,
                mean_action=self._take(actions, torch.argmin(traj_costs, dim=-1)),
                mean_action_1=self._take(actions, torch.argmin(torch.where(m0, traj_costs, torch.inf), dim=-1)),
                mean_action_2=self._take(actions, torch.argmin(torch.where(~m0, traj_costs, torch.inf), dim=-1)),
            )
        return dataclasses.replace(state, mean_action=self._take(actions, torch.argmin(traj_costs, dim=-1)))
