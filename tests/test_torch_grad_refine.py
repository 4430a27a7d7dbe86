"""Gradient refinement (``mppi.grad_refine_steps > 0``) in the port against
the JAX package's ``_grad_refine`` (mppi.py:923-990), on the CPU.

The JAX package differentiates its XLA step and running cost with
``jax.grad``; the port differentiates the plain rollout's step and costs
(``rollout.chain``) with autograd, and no kernel has a backward.  Held here:

- the chain's gradient against ``jax.grad`` of the JAX package's plan cost
  (the closure of mppi.py:932-950, rebuilt on its ``F``, ``running_cost``
  and ``zero_ext``) on the seven panda starts of tests/test_pallas.py:335-363
  (multi-modal, three means, each scored under the mode of its chain) and
  on one point start beside the box.  The point's is NaN in every entry in
  both packages: the dyn-obs never moves, and the norm of its zero velocity
  in the ground friction (``pbd2d.ground_friction``, the speed cap of
  ``point_env.step``) differentiates to 0/0 (``ops/norm.py``), so the
  refinement zeroes the whole step and leaves a point-family plan as it is;
- the refined means of one ``_command_impl`` tick with
  ``grad_refine_steps=2`` (``refine_iters=0``, ``exploration_noise=0``,
  K=16, so the two ticks draw nothing) from one ``MPPIState`` carried
  across with ``utils/convert.py``, for the panda, the point and the albert;
- the three chains run as one batch equal three single chains; a
  non-finite gradient entry counts as 0; ``grad_refine_steps=0`` leaves a
  tick as it was.

Tolerances: a gradient within 1e-5 of its largest entry (floored at 1e-3,
so a vanishing gradient is held in absolute terms): the two packages run
the same f32 formulas in another summation order, and the observed gap is
~3e-7 of the largest entry.  The refined means within the family's tick
bar: 1e-4 for the panda and the albert (tests/test_torch_panda_slice.py,
tests/test_torch_albert_slice.py), 1e-3 for the point
(tests/test_torch_slice.py): a normalised step of 0.1 moves a mean by
centimetres, so any formula drift fails them.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from m3p2i_aip_tpu.config.config_store import load_config as jax_load_config
from m3p2i_aip_tpu.planners.motion_planner.mppi import make_task_params as jax_task
from m3p2i_aip_tpu.tamp.sim_loop import SimLoop as JaxSimLoop
from m3p2i_aip_tpu_torch.config.config_store import load_config
from m3p2i_aip_tpu_torch.ops import albert_rollout as ar
from m3p2i_aip_tpu_torch.ops import panda_rollout as pr
from m3p2i_aip_tpu_torch.planners.motion_planner.mppi import make_task_params
from m3p2i_aip_tpu_torch.tamp.sim_loop import SimLoop
from m3p2i_aip_tpu_torch.utils import convert
from m3p2i_aip_tpu_torch.utils.tree import tree_map

K = 16
GRAD_RTOL = 1e-5
REFINE = ["mppi.grad_refine_steps=2", "mppi.refine_iters=0"]
FAMILIES = {
    "panda": ("config_panda", ["multi_modal=True", f"mppi.num_samples={K}", "mppi.horizon=8",
                               "mppi.exploration_noise=0"], 1e-4),
    "point": ("config_point", ["task=push_pull", "multi_modal=True", "goal=[-3.75,-3.75]",
                               f"mppi.num_samples={K}", "mppi.exploration_noise=0"], 1e-3),
    "albert": ("config_albert", ["task=push_reach", "goal=[3.0,0.0,0.6]", f"mppi.num_samples={K}",
                                 "mppi.horizon=8", "mppi.exploration_noise=0"], 1e-4),
}
_FROM_NUMPY = {
    "panda": convert.panda_env_state_from_numpy,
    "point": convert.point_env_state_from_numpy,
    "albert": convert.albert_state_from_numpy,
}
POINT_START_Q, POINT_START_QD = [0.0, 1.5], [0.0, -1.0]


def _leaves(x) -> dict:
    return {
        f.name: np.asarray(getattr(x, f.name))
        for f in dataclasses.fields(x)
        if f.metadata.get("pytree_node", True) and getattr(x, f.name) is not None
    }


@functools.lru_cache(maxsize=None)
def _loops(family: str, refine: bool):
    config, overrides, _ = FAMILIES[family]
    overrides = overrides + (REFINE if refine else [])
    return JaxSimLoop(jax_load_config(config, overrides)), SimLoop(load_config(config, overrides), device="cpu")


def _start(family: str, jloop):
    """A start with contact in play: the panda's cube in the hand, the point
    robot beside the box, the albert base against its box."""
    base = jloop.env.init_state()
    if family == "panda":
        arrays = [np.asarray(x) for x in (base.body_pos, base.body_vel, base.body_om)]
        return base.replace(**{k: jnp.asarray(v) for k, v in pr.parity_overrides("attached", *arrays).items()})
    if family == "point":
        return base.replace(q=jnp.asarray(POINT_START_Q, jnp.float32), qd=jnp.asarray(POINT_START_QD, jnp.float32))
    over = ar.parity_overrides("contact", np.asarray(base.q), np.asarray(base.qd), np.asarray(jloop.env.params.box_init))
    return base.replace(**{k: jnp.asarray(v) for k, v in over.items()})


@functools.lru_cache(maxsize=None)
def _jax_grad(family: str):
    """``jax.grad`` of the JAX package's plan cost (mppi.py:932-950)."""
    mp = _loops(family, False)[0].tamp.motion_planner

    def plan_cost(mean, mode, s0, task):
        mean = mp._gripper_override(mean, task)

        def step_t(carry, u_t):
            s, ext = carry
            s = mp.F(s, mp.u_scale * u_t, ext)
            c, ext = mp.running_cost(s, u_t, task, mode)
            return (s, ext), c

        (_, _), costs = jax.lax.scan(step_t, (s0, mp.zero_ext()), mean)
        return jnp.sum(costs * mp.gamma_seq)

    return jax.jit(jax.grad(plan_cost))


def _port_grad(mp, pstate, ptask, means: np.ndarray, modes) -> np.ndarray:
    """The port's gradient of the chains' summed plan costs w.r.t. ``means``
    [N, T, nu] (the autograd step of ``MPPI._grad_refine``)."""
    sim_state_k = tree_map(lambda x: x.expand((mp.K,) + x.shape), pstate)
    leaf = torch.tensor(means, requires_grad=True)
    acts = mp._gripper_override(leaf.clone(), ptask)
    costs = mp._plan_costs(sim_state_k, mp.u_scale * acts, ptask, torch.as_tensor(modes, dtype=torch.int32))
    (g,) = torch.autograd.grad(torch.sum(costs * mp.gamma_seq), leaf)
    return g.numpy()


def _assert_grad_close(got, ref, label):
    """The same non-finite entries, and the finite ones within GRAD_RTOL of
    the largest."""
    finite = np.isfinite(ref)
    assert np.array_equal(np.isfinite(got), finite), label
    atol = GRAD_RTOL * max(float(np.max(np.abs(ref[finite]), initial=0.0)), 1e-3)
    np.testing.assert_allclose(got[finite], ref[finite], rtol=0, atol=atol, err_msg=label)


@pytest.mark.parametrize("case", [c[0] for c in pr.PARITY_CASES])
def test_panda_chain_gradient_matches_jax_grad(case):
    """The three chains' gradients from one panda start, each mean scored
    under its chain's mode (the global mean under mode 1 here)."""
    jloop, ploop = _loops("panda", False)
    _, start, task, grip, zup = next(c for c in pr.PARITY_CASES if c[0] == case)
    base = jloop.env.init_state()
    arrays = [np.asarray(x) for x in (base.body_pos, base.body_vel, base.body_om)]
    jstate = base.replace(**{k: jnp.asarray(v) for k, v in pr.parity_overrides(start, *arrays).items()})
    goal = pr.PARITY_GOAL if task == "pick" else np.zeros(7)
    gripper = {None: "none", -1.5: "close", 1.5: "open"}[grip]
    mp = ploop.tamp.motion_planner
    means = np.random.default_rng(3).uniform(-0.5, 0.5, size=(3, mp.T, 9)).astype(np.float32)
    modes = [1, 0, 1]
    jt = jax_task(task, goal, gripper, zup)
    ref = np.stack([np.asarray(_jax_grad("panda")(jnp.asarray(m), jnp.int32(md), jstate, jt)) for m, md in zip(means, modes)])
    got = _port_grad(mp, convert.panda_env_state_from_numpy(_leaves(jstate)), make_task_params(task, goal, gripper, zup),
                     means, modes)
    _assert_grad_close(got, ref, case)
    if gripper != "none":  # the overridden gripper channels carry no gradient
        assert not np.any(got[..., 7:9])


@pytest.mark.parametrize("mode", [0, 1])
def test_point_chain_gradient_matches_jax_grad(mode):
    """One point start beside the box, push_pull: the push (mode 0) and the
    pull chain (mode 1, with the suction force carried into the next step)."""
    jloop, ploop = _loops("point", False)
    jstate = _start("point", jloop)
    mp = ploop.tamp.motion_planner
    means = np.random.default_rng(5 + mode).uniform(-1.0, 1.0, size=(1, mp.T, mp.nu)).astype(np.float32)
    jt = jloop.tamp.tamp_interface_view(jloop.env.view(jstate))
    ref = np.asarray(_jax_grad("point")(jnp.asarray(means[0]), jnp.int32(mode), jstate, jt))[None]
    pstate = convert.point_env_state_from_numpy(_leaves(jstate))
    got = _port_grad(mp, pstate, ploop.tamp.tamp_interface_view(ploop.env.view(pstate)), means, [mode])
    _assert_grad_close(got, ref, f"point mode {mode}")
    assert np.isnan(got).all()  # the resting dyn-obs: see the module docstring


@pytest.mark.parametrize("family", list(FAMILIES))
def test_refined_tick_matches_jax_package(family):
    """One tick with ``grad_refine_steps=2`` from identical planner and env
    states: the action, the refined means; and the refinement moved them."""
    jloop, ploop = _loops(family, True)
    _, _, atol = FAMILIES[family]
    jloop.reset()
    ploop.reset()
    jstate = _start(family, jloop)
    pstate = _FROM_NUMPY[family](_leaves(jstate))
    jms = jloop.tamp.mppi_state
    pms = convert.mppi_state_from_numpy(_leaves(jms))
    jt = jloop.tamp.tamp_interface_view(jloop.env.view(jstate))
    pt = ploop.tamp.tamp_interface_view(ploop.env.view(pstate))
    jact, jout, _ = jloop.tamp.motion_planner.command(jms, jstate, jt)
    pact, pout, _ = ploop.tamp.motion_planner._command_impl(pms, pstate, pt)
    np.testing.assert_allclose(pact.numpy(), np.asarray(jact), atol=atol, rtol=0)
    names = ("mean_action", "mean_action_1", "mean_action_2") if ploop.tamp.motion_planner.multi_modal else ("mean_action",)
    for name in names:
        got, ref = getattr(pout, name).numpy(), np.asarray(getattr(jout, name))
        np.testing.assert_allclose(got, ref, atol=atol, rtol=0, err_msg=name)
        assert np.isfinite(got).all()
    # against the same tick without the refinement: the gradient steps moved
    # the panda's and the albert's plans, and left the point's as it was
    _, plain_loop = _loops(family, False)
    _, unrefined, _ = plain_loop.tamp.motion_planner._command_impl(convert.mppi_state_from_numpy(_leaves(jms)), pstate, pt)
    moved = float(torch.max(torch.abs(pout.mean_action - unrefined.mean_action)))
    if family == "point":
        assert moved == 0.0
    else:
        assert moved > 10 * atol


def test_three_chains_batched_equal_single_chains():
    """The batch of three chains (global mean, mode 0, mode 1) gives each
    chain the gradient it has alone, to within 1e-6 of the largest entry:
    the CPU's float32 kernels round a three-wide batch in another order
    (the forward costs differ by at most an ulp)."""
    jloop, ploop = _loops("panda", True)
    mp = ploop.tamp.motion_planner
    pstate = _FROM_NUMPY["panda"](_leaves(_start("panda", jloop)))
    task = make_task_params("pick", pr.PARITY_GOAL, "close", 0.0)
    means = np.random.default_rng(11).uniform(-0.5, 0.5, size=(3, mp.T, 9)).astype(np.float32)
    modes = [1, 0, 1]
    batched = _port_grad(mp, pstate, task, means, modes)
    for n in range(3):
        single = _port_grad(mp, pstate, task, means[n : n + 1], modes[n : n + 1])
        np.testing.assert_allclose(batched[n : n + 1], single, rtol=0, atol=1e-6 * float(np.max(np.abs(single))))


def test_seed_batch_refines_each_seed_as_alone():
    """A planner state with a leading seed axis (``BatchSimLoop``'s) refines
    each seed's three means as that seed's state alone, to the batched
    chain's bar above."""
    from m3p2i_aip_tpu_torch.utils.tree import tree_stack

    jloop, ploop = _loops("panda", True)
    mp = ploop.tamp.motion_planner
    base = _FROM_NUMPY["panda"](_leaves(_start("panda", jloop)))
    rng = np.random.default_rng(4)
    states, sims, tasks, singles = [], [], [], []
    for b, task_name in enumerate(("pick", "reach")):
        means = [torch.as_tensor(rng.uniform(-0.5, 0.5, size=(mp.T, mp.nu)).astype(np.float32)) for _ in range(3)]
        w = torch.as_tensor(rng.dirichlet(np.ones(mp.K)).astype(np.float32))
        state = dataclasses.replace(mp.init_state(), mean_action=means[0], mean_action_1=means[1],
                                    mean_action_2=means[2], weights=w)
        sim = tree_map(lambda x: x.expand((mp.K,) + x.shape), dataclasses.replace(base, q=base.q + 0.05 * b))
        task = make_task_params(task_name, pr.PARITY_GOAL, "close" if task_name == "pick" else "open", 0.0)
        states.append(state)
        sims.append(sim)
        tasks.append(task)
        singles.append(mp._grad_refine(state, sim, task))
    batched = mp._grad_refine(tree_stack(states), tree_stack(sims), tree_stack(tasks))
    for b, single in enumerate(singles):
        for name in ("mean_action", "mean_action_1", "mean_action_2"):
            np.testing.assert_allclose(getattr(batched, name)[b].numpy(), getattr(single, name).numpy(),
                                       rtol=0, atol=1e-6, err_msg=f"seed {b} {name}")


def test_nonfinite_gradient_entry_counts_as_zero():
    """A cost whose gradient is NaN in one entry (sqrt at 0 times 0, the
    where-branch trap's shape) refines the panda's three means as if that
    entry were 0."""
    jloop, ploop = _loops("panda", True)
    mp = ploop.tamp.motion_planner
    pstate = _FROM_NUMPY["panda"](_leaves(_start("panda", jloop)))
    task = make_task_params("pick", pr.PARITY_GOAL, "close", 0.0)
    sim_state_k = tree_map(lambda x: x.expand((mp.K,) + x.shape), pstate)
    means = torch.as_tensor(np.random.default_rng(2).uniform(-0.5, 0.5, size=(mp.T, mp.nu)).astype(np.float32))
    state = dataclasses.replace(mp.init_state(), mean_action=means, mean_action_1=means, mean_action_2=means)
    chain = mp.rollout.chain

    def trapped(sim_state_k, acts, task, mode):
        costs = chain(sim_state_k, acts, task, mode)
        return costs + torch.sqrt(acts[..., :1, 0] - acts[..., :1, 0].detach())  # d/du = 1 / (2 * 0): inf

    mp.rollout.chain = trapped
    try:
        got = mp._grad_refine(state, sim_state_k, task)
    finally:
        mp.rollout.chain = chain
    # the same steps by hand, with entry [0, 0] of every gradient set to 0
    means3 = torch.stack([means] * 3)
    modes = [int(torch.sum(state.weights[mp.half_K :]) > torch.sum(state.weights[: mp.half_K])), 0, 1]
    for _ in range(mp.grad_refine_steps):
        g = torch.as_tensor(_port_grad(mp, pstate, task, means3.numpy(), modes))
        assert np.isfinite(g.numpy()).all() and float(torch.abs(g[..., 0, 0]).max()) > 0
        g[..., 0, 0] = 0.0
        g = g / torch.clamp(torch.linalg.vector_norm(g, dim=(-2, -1), keepdim=True), min=1e-6)
        means3 = torch.clamp(means3 - mp.grad_refine_lr * g, mp.u_min, mp.u_max)
    means3[..., 7:9] = -1.5  # the close-gripper override after the refinement
    for n, name in enumerate(("mean_action", "mean_action_1", "mean_action_2")):
        assert torch.equal(getattr(got, name), means3[n]), name


def test_zero_steps_leaves_the_tick_unchanged():
    """``grad_refine_steps=0`` returns the planner state it is given, so a
    tick is bit for bit the tick without the refinement."""
    jloop, ploop = _loops("panda", False)
    mp = ploop.tamp.motion_planner
    assert mp.grad_refine_steps == 0
    pstate = _FROM_NUMPY["panda"](_leaves(_start("panda", jloop)))
    state = mp.init_state()
    assert mp._grad_refine(state, tree_map(lambda x: x.expand((mp.K,) + x.shape), pstate), None) is state


def test_norm_has_the_jax_gradient():
    """``ops/norm.vector_norm``: torch's value bit for bit, and
    ``jax.grad(jnp.linalg.norm)``'s gradient: x / |x| (within 1e-6), NaN at a
    zero vector where torch's own norm gives 0."""
    from m3p2i_aip_tpu_torch.ops.norm import vector_norm

    x = np.array([[3.0, -4.0], [0.0, 0.0], [1e-3, 2.0]], np.float32)
    assert torch.equal(vector_norm(torch.as_tensor(x), dim=-1), torch.linalg.vector_norm(torch.as_tensor(x), dim=-1))
    leaf = torch.tensor(x, requires_grad=True)
    (g,) = torch.autograd.grad(torch.sum(vector_norm(leaf, dim=-1, keepdim=True) * 2.0), leaf)
    ref = np.stack([np.asarray(jax.grad(lambda v: 2.0 * jnp.linalg.norm(v))(jnp.asarray(row))) for row in x])
    assert np.array_equal(np.isnan(g.numpy()), np.isnan(ref)) and np.isnan(ref[1]).all()
    np.testing.assert_allclose(g.numpy()[[0, 2]], ref[[0, 2]], atol=1e-6, rtol=0)
    (g0,) = torch.autograd.grad(torch.sum(torch.linalg.vector_norm(leaf, dim=-1)), leaf)
    assert not torch.isnan(g0).any()  # torch's own: 0 at the zero vector
