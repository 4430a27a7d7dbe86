"""The planner modes beyond the halton-spline default, in the port, against
the JAX package on the CPU: ``mppi_mode=simple``, ``sampling_method=random``,
``update_cov`` and ``update_cov_per_mode``.

Each mode's one ``command`` tick and a gated ``run_chunked(6, chunk=3)``
are held to the JAX package's from the same start (the robot beside the box,
so contact is in play), with ``mppi.exploration_noise=0`` and K=16.  Random
sampling and simple mode draw from ``jax.random.multivariate_normal``, which
torch cannot reproduce: the tick test injects the JAX draw through
``command(..., noise=)``, and the chunk test hands the port the JAX
standard-normal draws tick by tick in place of its generator's (the port
forms ``noise_mu + z chol^T`` from them as JAX does).  The JAX planner state,
its initial ``U`` included, is carried across with ``utils/convert.py``.

Also: the golden Williams update of the port's simple mode against a numpy
recomputation (after tests/test_mppi_simple.py), with and without
``noise_abs_cost``; the construction errors the JAX package raises; and the
adapts-and-is-consumed checks of tests/test_tamp_integration.py for both
covariance updates.
"""
import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from m3p2i_aip_tpu.config.config_store import load_config as jax_load_config
from m3p2i_aip_tpu.tamp.sim_loop import SimLoop as JaxSimLoop
from m3p2i_aip_tpu_torch.config.config_store import MPPIConfig, load_config
from m3p2i_aip_tpu_torch.planners.motion_planner.mppi import MPPI, make_task_params
from m3p2i_aip_tpu_torch.tamp.reactive_tamp import ReactiveTAMP
from m3p2i_aip_tpu_torch.tamp.sim_loop import SimLoop
from m3p2i_aip_tpu_torch.utils import convert

COMMON = ["mppi.num_samples=16", "mppi.exploration_noise=0"]
NAV = ["task=navigation", "goal=[-3,3]"]
HYBRID = ["task=push_pull", "multi_modal=True", "goal=[-3.75,-3.75]"]
MODES = {
    "simple": [*NAV, "mppi.mppi_mode=simple", *COMMON],
    "random": [*NAV, "mppi.sampling_method=random", *COMMON],
    "update_cov": [*NAV, "mppi.update_cov=True", *COMMON],
    "update_cov_per_mode": [*HYBRID, "mppi.update_cov_per_mode=True", *COMMON],
}
DRAWS = ("simple", "random")  # the modes that draw from jax.random every tick
# test_torch_slice.py's bar and reason: f32 work in another summation order
# (the port's K-sample sums are float64) moves actions by ~1e-5 a tick; 1e-3
# bounds six closed-loop ticks of it and still fails on any formula drift.
ATOL = 1e-3
START_Q, START_QD = [0.0, 1.5], [0.0, -1.0]


def _leaves(x) -> dict:
    return {
        f.name: np.asarray(getattr(x, f.name))
        for f in dataclasses.fields(x)
        if f.metadata.get("pytree_node", True) and getattr(x, f.name) is not None
    }


@functools.lru_cache(maxsize=None)
def _loops(mode: str):
    overrides = MODES[mode]
    return JaxSimLoop(jax_load_config("config_point", overrides)), SimLoop(load_config("config_point", overrides), device="cpu")


def _reset(jloop, ploop):
    """Both loops at the same start state and planner state."""
    jloop.reset()
    ploop.reset()
    jloop.state = jloop.env.init_state().replace(
        q=jnp.asarray(START_Q, jnp.float32), qd=jnp.asarray(START_QD, jnp.float32)
    )
    jloop._view = jloop.env.view(jloop.state)
    ploop.state = convert.point_env_state_from_numpy(_leaves(jloop.state))
    ploop._view = ploop.env.view(ploop.state)
    ploop.tamp.mppi_state = convert.mppi_state_from_numpy(_leaves(jloop.tamp.mppi_state))


def _jax_normals(jmp, key, n: int) -> list:
    """The standard-normal [K, T, nu] draws under the JAX planner's next
    ``n`` multivariate-normal draws from ``key`` (one key split a tick)."""
    out = []
    for _ in range(n):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.normal(sub, (jmp.K, jmp.T, jmp.nu), jnp.float32)))
    return out


def _jax_draw(jmp, key) -> np.ndarray:
    """The JAX planner's correlated draw of its next tick."""
    _, sub = jax.random.split(key)
    return np.asarray(
        jax.random.multivariate_normal(
            sub, jnp.asarray(jmp.noise_mu), jnp.asarray(jmp.noise_sigma), shape=(jmp.K, jmp.T)
        ).astype(jnp.float32)
    )


@pytest.mark.parametrize("mode", list(MODES))
def test_command_tick_matches_jax_package(mode):
    """One ``command`` tick: the action sequence and every state field the
    mode writes."""
    jloop, ploop = _loops(mode)
    _reset(jloop, ploop)
    jmp, pmp = jloop.tamp.motion_planner, ploop.tamp.motion_planner
    jtask = jloop.tamp.tamp_interface_view(jloop._view)
    ptask = ploop.tamp.tamp_interface_view(ploop._view)
    noise = None
    if mode in DRAWS:
        noise = torch.as_tensor(_jax_draw(jmp, jloop.tamp.mppi_state.rng))
    jact, jms, _ = jmp.command(jloop.tamp.mppi_state, jloop.state, jtask)
    pact, pms, _ = pmp.command(ploop.tamp.mppi_state, ploop.state, ptask, noise=noise)
    np.testing.assert_allclose(pact.numpy(), np.asarray(jact), atol=ATOL, rtol=0)
    names = {
        # the Williams weights collapse onto the least-cost sample (lambda_ =
        # 0.5 on point costs); this start has no near tie for that sample,
        # so they compare at the same bar
        "simple": ("U", "weights"),
        "random": ("mean_action", "best_traj", "weights", "beta"),
        "update_cov": ("mean_action", "best_traj", "weights", "cov_action"),
        "update_cov_per_mode": ("mean_action", "mean_action_1", "mean_action_2", "weights", "cov_action_1",
                                "cov_action_2"),
    }[mode]
    for name in names:
        np.testing.assert_allclose(
            getattr(pms, name).numpy(), np.asarray(getattr(jms, name)), atol=ATOL, rtol=0, err_msg=name
        )
    if mode == "simple":
        assert float(pms.weights.max()) > 0.5  # the collapse the comment above describes
        assert not np.allclose(pms.U.numpy(), ploop.tamp.mppi_state.U.numpy())
    if mode.startswith("update_cov"):
        cov = pms.cov_action if mode == "update_cov" else pms.cov_action_1
        assert not np.allclose(cov.numpy(), 3.0)  # the EMA moved


@pytest.mark.parametrize("mode", list(MODES))
def test_run_chunked_matches_jax_package(mode):
    """``run_chunked(6, chunk=3)`` with the device gate on: per-tick views,
    the JAX draws handed to the port tick by tick."""
    jloop, ploop = _loops(mode)
    _reset(jloop, ploop)
    pmp = ploop.tamp.motion_planner
    if mode in DRAWS:
        draws = iter(_jax_normals(jloop.tamp.motion_planner, jloop.tamp.mppi_state.rng, 6))
        pmp._exploration_draw = lambda shape: torch.as_tensor(next(draws))
    try:
        jlog = jloop.run_chunked(6, chunk=3)
        plog = ploop.run_chunked(6, chunk=3)
    finally:
        pmp.__dict__.pop("_exploration_draw", None)
    assert plog.steps == jlog.steps == 6
    assert plog.task == jlog.task
    for name in ("robot_pos", "robot_vel", "box_pos"):
        np.testing.assert_allclose(
            np.asarray(getattr(plog, name)), np.asarray(getattr(jlog, name)), atol=ATOL, rtol=0, err_msg=name
        )
    for name in ("cov_action", "cov_action_1", "cov_action_2", "U"):
        np.testing.assert_allclose(
            getattr(ploop.tamp.mppi_state, name).numpy(), np.asarray(getattr(jloop.tamp.mppi_state, name)),
            atol=ATOL, rtol=0, err_msg=name,
        )
    assert np.linalg.norm(np.asarray(plog.robot_pos[-1]) - START_Q) > 0.05  # the robot moved


# ---------------------------------------------------------------- simple mode
_DT, _GOAL = 0.1, 1.0


@dataclasses.dataclass
class _Toy:
    s: torch.Tensor  # [1] position of a 1-D velocity integrator


def _toy_rollout(sim_state_k, acts, task):
    """s' = s + dt u, cost (s' - goal)^2, over [K, T, 1] actions."""
    s = sim_state_k.s[..., None, :] + _DT * torch.cumsum(acts, dim=-2)
    cost = torch.sum((s - _GOAL) ** 2, dim=-1)
    return cost, torch.cat([s, torch.zeros_like(s)], dim=-1)


def _toy_mppi(**kwargs) -> MPPI:
    """tests/test_mppi_simple.py's toy planner, in the port."""
    mcfg = MPPIConfig(
        num_samples=16, horizon=12, nx=2, mppi_mode="simple", noise_sigma=[[0.25]], u_min=[-1.0], u_max=[1.0],
        lambda_=0.5, sample_null_action=True, filter_u=False, **kwargs,
    )
    cfg = types.SimpleNamespace(env_type="point_env", multi_modal=False, mppi=mcfg)
    return MPPI(cfg, _toy_rollout, device="cpu")


@pytest.mark.parametrize("abs_cost", [False, True])
def test_simple_williams_update_golden(abs_cost):
    """The port's Williams update against an independent numpy
    recomputation (mppi.py:335-363 of the reference) on a drawn noise."""
    planner = _toy_mppi(noise_abs_cost=abs_cost)
    state = planner.init_state()
    K, T = planner.K, planner.T
    noise = np.random.default_rng(3).normal(0.0, 0.5, size=(K, T, 1)).astype(np.float32)
    task = make_task_params("navigation", [_GOAL, 0.0])
    _, new_state, _ = planner.command(state, _Toy(s=torch.zeros(1)), task, noise=torch.as_tensor(noise))

    U = np.roll(state.U.numpy(), -1, axis=0)
    perturbed = np.clip(U[None] + noise, -1.0, 1.0)
    perturbed[K - 1] = 0.0  # braking sample
    noise_b = perturbed - U[None]
    cost_total = np.zeros(K)
    for k in range(K):
        s = 0.0
        for t in range(T):
            s = s + _DT * perturbed[k, t, 0]
            cost_total[k] += (s - _GOAL) ** 2
    lam = planner.lambda_
    dev = np.abs(noise_b) if abs_cost else noise_b
    cost_total = cost_total + np.sum(U[None] * lam * (dev @ planner.noise_sigma_inv), axis=(1, 2))
    nz = np.exp((-1.0 / lam) * (cost_total - cost_total.min()))
    weights = nz / nz.sum()
    np.testing.assert_allclose(new_state.weights.numpy(), weights, atol=1e-4)
    np.testing.assert_allclose(new_state.U.numpy(), U + np.einsum("k,ktu->tu", weights, noise_b), atol=1e-4)


def test_simple_mode_drives_toward_goal():
    """Iterating ``command`` on the toy env, with the planner's own draws,
    moves the state to the goal (tests/test_mppi_simple.py's check)."""
    planner = _toy_mppi()
    state = planner.init_state()
    task = make_task_params("navigation", [_GOAL, 0.0])
    s = torch.zeros(1)
    for _ in range(60):
        actions, state, _ = planner.command(state, _Toy(s=s), task)
        s = s + _DT * actions[0]
    assert abs(float(s[0]) - _GOAL) < 0.1, f"settled at {float(s[0]):.3f}"


# --------------------------------------------------------------- construction
@pytest.mark.parametrize(
    "overrides, error",
    [
        (["multi_modal=True", "mppi.update_cov=True"], ValueError),
        (["mppi.mppi_mode=simple", "mppi.update_cov=True"], ValueError),
        (["mppi.update_cov_per_mode=True"], ValueError),
        (["mppi.grad_refine_steps=2"], None),
    ],
)
def test_construction_rejects_what_the_jax_package_rejects(overrides, error):
    """The JAX package's two ValueErrors (mppi.py:315-324); gradient
    refinement (``error`` None) both packages build, the port with its
    step count and rate (tests/test_torch_grad_refine.py runs it)."""
    cfg = ["mppi.num_samples=16", *overrides]
    if error is None:
        JaxSimLoop(jax_load_config("config_point", cfg))
        planner = ReactiveTAMP(load_config("config_point", cfg), device="cpu").motion_planner
        assert (planner.grad_refine_steps, planner.grad_refine_lr) == (2, 0.02)
        return
    with pytest.raises(error):
        JaxSimLoop(jax_load_config("config_point", cfg))
    with pytest.raises(error):
        ReactiveTAMP(load_config("config_point", cfg), device="cpu")


# ------------------------------------------------ covariance updates, in use
def _ticks(tamp, state, n: int) -> np.ndarray:
    """``n`` replans from one fixed real state (the JAX tests' ``run_tamp``
    loop); returns the last first action."""
    act = None
    for _ in range(n):
        task = tamp.tamp_interface_view(tamp.env.view(state))
        seq, tamp.mppi_state, _ = tamp.motion_planner.command(tamp.mppi_state, state, task)
        act = seq[0].numpy()
    return act


def _pair(overrides, flag: str):
    return [ReactiveTAMP(load_config("config_point", [*overrides, f"{flag}={on}"]), device="cpu") for on in (True, False)]


def test_update_cov_adapts_and_is_consumed():
    """tests/test_tamp_integration.py:195 in the port: cov_action leaves
    both its start and the pure-kappa drift, and the adapted scale changes
    the planned actions."""
    on, off = _pair([*NAV, "mppi.num_samples=32", "mppi.exploration_noise=0"], "mppi.update_cov")
    state = on.env.init_state()
    a_on, a_off = _ticks(on, state, 4), _ticks(off, state, 4)
    cov = on.mppi_state.cov_action.numpy()
    drift_only = 0.3**4 * 3.0 + 0.005 * sum(0.3**i for i in range(4))
    assert not np.allclose(cov, drift_only, atol=0.05), cov
    assert not np.allclose(cov, 3.0), "covariance did not adapt"
    assert not np.allclose(a_on, a_off, atol=1e-5)


def test_per_mode_cov_adapts_and_diverges():
    """tests/test_tamp_integration.py:513 in the port: each mode's EMA
    adapts from its own weights, the two diverge, and the adapted scales
    change the planned actions."""
    on, off = _pair([*HYBRID, "mppi.num_samples=32", "mppi.exploration_noise=0"], "mppi.update_cov_per_mode")
    state = on.env.init_state()
    a_on, a_off = _ticks(on, state, 6), _ticks(off, state, 6)
    c1, c2 = on.mppi_state.cov_action_1.numpy(), on.mppi_state.cov_action_2.numpy()
    assert np.all(np.isfinite(c1)) and np.all(c1 > 0)
    assert not np.allclose(c1, 3.0) and not np.allclose(c2, 3.0), (c1, c2)
    assert not np.allclose(c1, c2, rtol=0.05), "modes did not diverge"
    assert not np.allclose(a_on, a_off, atol=1e-5)
