"""The batched kernels' plain versions (K1b-K4b, the ports of the TPU kernels'
``grid=(B,)`` calls) on the CPU, against the single plain versions and the
JAX package.

* Each batched plain version, reached through its wrapper and (for the
  rollouts) through the factory's rollout callable with a leading seed
  axis, equals its single plain version run per seed and stacked, exactly:
  the seed axis is pure bookkeeping.
* The batched weights against ``jax.vmap`` of ``multimodal_weights_pallas(
  ..., interpret=True)``, which reaches the kernel's ``custom_vmap`` rule
  ``_mmw_vmap`` (the grid=(B,) Pallas call) in interpret mode: atol 1e-6,
  sums within 1e-5 (tests/test_pallas.py:131-132).
* The batched point, panda and albert rollouts against ``jax.vmap`` of the
  JAX package's XLA rollouts (the scans of the vmapped ``step`` + objective
  that tests/test_pallas.py holds the kernels to), B = 3 seeds with their own
  start states, tasks and goals: point cost atol 1e-2 and trajectory 1e-3
  (tests/test_pallas.py:259-260), panda and albert 1e-4 with np.allclose's
  rtol 1e-5 (tests/test_pallas.py:688-691, :818-821).
* The batched wrappers reject wrong shapes, dtypes, layouts and devices on
  either device, before they dispatch.

Sizes: K=16, T=8 (panda T=4), B=3, inputs from numpy seeds.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from m3p2i_aip_tpu.config.config_store import load_config as jax_load_config
from m3p2i_aip_tpu.envs import make_env as jax_make_env
from m3p2i_aip_tpu.models import albert as jalbert
from m3p2i_aip_tpu.models import panda_env as jpa
from m3p2i_aip_tpu.models import panda_fk as jfk
from m3p2i_aip_tpu.ops.pallas_kernels import multimodal_weights_pallas
from m3p2i_aip_tpu.planners.motion_planner.cost_functions import AlbertObjective as JaxAlbertObjective
from m3p2i_aip_tpu.planners.motion_planner.cost_functions import PandaObjective as JaxPandaObjective
from m3p2i_aip_tpu.planners.motion_planner.cost_functions import PointObjective as JaxPointObjective
from m3p2i_aip_tpu.planners.motion_planner.mppi import make_task_params as jax_task
from m3p2i_aip_tpu_torch.ops import albert_rollout as ar
from m3p2i_aip_tpu_torch.ops import panda_rollout as pr
from m3p2i_aip_tpu_torch.ops import rollout as ro
from m3p2i_aip_tpu_torch.ops import weights
from m3p2i_aip_tpu_torch.planners.motion_planner.cost_functions import AlbertObjective
from m3p2i_aip_tpu_torch.planners.motion_planner.mppi import make_task_params
from m3p2i_aip_tpu_torch.utils import convert
from m3p2i_aip_tpu_torch.utils.tree import tree_map, tree_stack

K, T, T_PANDA = 16, 8, 4
W_ATOL, SUM_TOL = 1e-6, 1e-5
POINT_COST_ATOL, POINT_TRAJ_ATOL = 1e-2, 1e-3
ATOL, RTOL = 1e-4, 1e-5
# three point seeds: (q, qd, box position or None, task, goal)
POINT_SEEDS = [
    ([-0.3, 1.4], [0.5, 0.5], None, "push_pull", [-3.75, -3.75]),
    ([-0.05, 1.75], [0.0, 2.0], None, "pull", [1.0, 3.0]),
    ([-2.6, -2.9], [-1.0, -1.0], [-3.3, -3.2], "navigation", [-1.5, 1.5]),
]
PANDA_SEEDS = ["closing_near_cube", "attached_zup", "place_detach"]
ALBERT_SEEDS = ["ee_reach_rotated_base", "push_reach_contact", "reposition_keep_out"]


def _leaves(x) -> dict:
    return {
        f.name: np.asarray(getattr(x, f.name))
        for f in dataclasses.fields(x)
        if f.metadata.get("pytree_node", True) and getattr(x, f.name) is not None
    }


def _static(x) -> dict:
    return {f.name: getattr(x, f.name) for f in dataclasses.fields(x) if not f.metadata.get("pytree_node", True)}


def _jstack(trees):
    return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *trees)


def _broadcast_k(jstate, k: int):
    return jax.tree_util.tree_map(lambda x: jnp.broadcast_to(x, (k,) + x.shape), jstate)


# ---------------------------------------------------------------- weights
def test_batched_weights_plain_equals_single_plain_per_seed():
    rng = np.random.default_rng(3)
    cost = torch.as_tensor(rng.uniform(0, 40, size=(3, 37, T)).astype(np.float32))
    gamma = torch.as_tensor(np.cumprod([1.0] + [0.95] * (T - 1)).astype(np.float32))
    got = weights.multimodal_weights_batched(cost, gamma, 18)
    plain = weights.multimodal_weights_batched_plain(cost, gamma, 18)
    for b in range(3):
        single = weights.multimodal_weights_plain(cost[b], gamma, 18)
        for g, p, s in zip(got, plain, single):
            assert torch.equal(g[b], s) and torch.equal(p[b], s)


def test_cpu_batched_wrappers_launch_no_kernel():
    """A CPU tensor takes the batched plain version and leaves the launch
    counts alone."""
    before = weights.weights_batched_launches
    weights.multimodal_weights_batched(torch.rand(2, 16, T), torch.ones(T), 8)
    assert weights.weights_batched_launches == before


@pytest.mark.parametrize("spread", [50.0, 0.5])
def test_batched_weights_match_vmapped_pallas_interpret(spread):
    """Seeds with cost spreads 100x apart take different numbers of beta
    rounds: each seed's search stops on its own."""
    rng = np.random.default_rng(int(spread * 10))
    B, Kw = 3, 37
    scale = np.asarray([spread, spread * 0.01, spread * 3.0], np.float32)[:, None, None]
    cost = (rng.uniform(0, 1, size=(B, Kw, T)) * scale).astype(np.float32)
    gamma = np.cumprod([1.0] + [0.95] * (T - 1)).astype(np.float32)
    half = Kw // 2
    ref = jax.vmap(lambda c: multimodal_weights_pallas(c, jnp.asarray(gamma), half, 10.0, 3.0, interpret=True))(
        jnp.asarray(cost)
    )
    got = weights.multimodal_weights_batched(torch.as_tensor(cost), torch.as_tensor(gamma), half, 10.0, 3.0)
    for i, (g, r) in enumerate(zip(got, ref)):
        assert g.shape == (B, Kw)
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=W_ATOL, rtol=0, err_msg=f"w{i}")
        np.testing.assert_allclose(torch.sum(g, dim=-1).numpy(), 1.0, atol=SUM_TOL, rtol=0)


def test_batched_weights_with_a_tied_seed_match_vmapped_pallas_interpret():
    """A tied seed (64 rounds down, the cap) between random ones (a few
    rounds up or down): each seed's search exits on its own, and each seed
    equals the single plain version exactly."""
    rng = np.random.default_rng(7)
    B, Kw = 4, 37
    cost = rng.uniform(0, 1, size=(B, Kw, T)).astype(np.float32) * np.asarray([50.0, 1.0, 0.5, 5.0], np.float32)[
        :, None, None
    ]
    cost[1] = 1.43  # the tie
    gamma = np.cumprod([1.0] + [0.95] * (T - 1)).astype(np.float32)
    half = Kw // 2
    ref = jax.vmap(lambda c: multimodal_weights_pallas(c, jnp.asarray(gamma), half, 10.0, 3.0, interpret=True))(
        jnp.asarray(cost)
    )
    args = (torch.as_tensor(cost), torch.as_tensor(gamma), half, 10.0, 3.0)
    rounds = weights.beta_rounds(*args)[0]
    assert rounds[1].tolist() == [64, 64, 64] and (rounds[[0, 2, 3]] < 64).all()
    got = weights.multimodal_weights_batched(*args)
    for i, (g, r) in enumerate(zip(got, ref)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=W_ATOL, rtol=0, err_msg=f"w{i}")
        np.testing.assert_allclose(torch.sum(g, dim=-1).numpy(), 1.0, atol=SUM_TOL, rtol=0)
    for b in range(B):
        for g, s in zip(got, weights.multimodal_weights_plain(args[0][b], *args[1:])):
            assert torch.equal(g[b], s)


# ----------------------------------------------------------------- point
@functools.lru_cache(maxsize=None)
def _point():
    cfg = jax_load_config("config_point", ["multi_modal=True", f"mppi.num_samples={K}", f"mppi.horizon={T}"])
    jenv = jax_make_env(cfg)
    jobj = JaxPointObjective(jenv.params, cfg)
    mode = jnp.asarray((np.arange(K) >= K // 2).astype(np.int32))

    def xla_rollout(state_k, acts, task):
        ext0 = jax.vmap(lambda _: jenv.zero_ext())(jnp.arange(K))

        def step_t(carry, u_t):
            s, ext = carry
            s = jax.vmap(jenv.step)(s, u_t, ext)
            cost, ext = jax.vmap(jobj.compute, in_axes=(0, 0, None, 0))(s, u_t, task, mode)
            return (s, ext), (cost, s.q[:, :2])

        (_, _), (costs, tps) = jax.lax.scan(step_t, (state_k, ext0), jnp.swapaxes(acts, 0, 1))
        return jnp.swapaxes(costs, 0, 1), jnp.swapaxes(tps, 0, 1)

    params = convert.point_env_params_from_numpy(_leaves(jenv.params), _static(jenv.params))
    rollout = ro.make_point_rollout(params, float(cfg.kp_suction), K, T, True)
    return jenv, jax.jit(jax.vmap(xla_rollout)), rollout


def _point_inputs():
    jenv, _, _ = _point()
    rng = np.random.default_rng(11)
    jstates, jtasks, pstates, ptasks = [], [], [], []
    for q0, qd0, box, task, goal in POINT_SEEDS:
        s = jenv.init_state().replace(q=jnp.asarray(q0, jnp.float32), qd=jnp.asarray(qd0, jnp.float32))
        if box is not None:
            s = s.replace(dyn_pos=s.dyn_pos.at[1].set(jnp.asarray(box, jnp.float32)))
        fric = rng.uniform(0.7, 1.3, size=(K, s.dyn_pos.shape[0])).astype(np.float32)
        sk = _broadcast_k(s, K).replace(fric_scale=jnp.asarray(fric))
        jstates.append(sk)
        jtasks.append(jax_task(task, goal))
        pk = tree_map(lambda x: x.expand((K,) + x.shape), convert.point_env_state_from_numpy(_leaves(s)))
        pstates.append(dataclasses.replace(pk, fric_scale=torch.as_tensor(fric)))
        ptasks.append(make_task_params(task, goal))
    acts = rng.uniform(-3, 3, size=(len(POINT_SEEDS), K, T, jenv.nu)).astype(np.float32)
    return jstates, jtasks, tree_stack(pstates), tree_stack(ptasks), acts


def test_batched_point_rollout_equals_single_per_seed():
    _, _, rollout = _point()
    _, _, pk, ptask, acts = _point_inputs()
    acts = torch.as_tensor(acts)
    inputs = ro.rollout_inputs(pk, ptask)
    assert [tuple(x.shape) for x in inputs] == [(3, 4), (3, 2 * 2 + 6 * 2), (3, K, 2)]
    c_b, t_b = rollout(pk, acts, ptask)
    c_p, t_p = ro.point_rollout_batched_plain(rollout.spec, *inputs, acts)
    assert c_b.shape == (3, K, T) and t_b.shape == (3, K, T, 2)
    for b in range(3):
        c_s, t_s = rollout(tree_map(lambda x: x[b], pk), acts[b], tree_map(lambda x: x[b], ptask))
        assert torch.equal(c_b[b], c_s) and torch.equal(t_b[b], t_s), b
        assert torch.equal(c_p[b], c_s) and torch.equal(t_p[b], t_s), b


def test_batched_point_rollout_matches_vmapped_xla_rollout():
    _, xla_fn, rollout = _point()
    jstates, jtasks, pk, ptask, acts = _point_inputs()
    c_ref, t_ref = xla_fn(_jstack(jstates), jnp.asarray(acts), _jstack(jtasks))
    c_got, t_got = rollout(pk, torch.as_tensor(acts), ptask)
    np.testing.assert_allclose(c_got.numpy(), np.asarray(c_ref), atol=POINT_COST_ATOL, rtol=0)
    np.testing.assert_allclose(t_got.numpy(), np.asarray(t_ref), atol=POINT_TRAJ_ATOL, rtol=0)
    # the seeds are genuinely different rollouts
    assert not np.allclose(c_got[0].numpy(), c_got[1].numpy())


# ----------------------------------------------------------------- panda
@functools.lru_cache(maxsize=None)
def _panda():
    jcfg = jax_load_config("config_panda", ["multi_modal=True"])
    jenv = jax_make_env(jcfg)
    obj = JaxPandaObjective(jenv.params, jcfg)
    mode = (jnp.arange(K) >= K // 2).astype(jnp.int32)

    def xla_rollout(state_k, acts, task):
        ext0 = jax.vmap(lambda _: jpa.zero_ext(jenv.params))(jnp.arange(K))

        def step_t(carry, u_t):
            s, ext = carry
            s = jax.vmap(lambda st, u, e: jpa.step(jenv.params, st, u, e))(s, u_t, ext)
            cost, ext = jax.vmap(obj.compute, in_axes=(0, 0, None, 0))(s, u_t, task, mode)
            ee = jax.vmap(lambda st: jfk.fk(st.q, jenv.params.base_pos)["ee"][0][:2])(s)
            return (s, ext), (cost, ee)

        (_, _), (costs, tps) = jax.lax.scan(step_t, (state_k, ext0), jnp.swapaxes(acts, 0, 1))
        return jnp.swapaxes(costs, 0, 1), jnp.swapaxes(tps, 0, 1)

    params = convert.panda_env_params_from_numpy(_leaves(jenv.params), _static(jenv.params))
    rollout = pr.make_panda_rollout(params, float(jcfg.pre_height_diff), K, T_PANDA, True)
    return jenv, jax.jit(jax.vmap(xla_rollout)), rollout


def _panda_inputs():
    jenv, _, _ = _panda()
    cases = {c[0]: c[1:] for c in pr.PARITY_CASES}
    rng = np.random.default_rng(12)
    jstates, jtasks, pstates, ptasks, acts = [], [], [], [], []
    for name in PANDA_SEEDS:
        start, task, grip, zup = cases[name]
        base = jenv.init_state()
        arrays = [np.asarray(x) for x in (base.body_pos, base.body_vel, base.body_om)]
        s = base.replace(**{k: jnp.asarray(v) for k, v in pr.parity_overrides(start, *arrays).items()})
        goal = pr.PARITY_GOAL if task == "pick" else np.zeros(7)
        a = rng.uniform(-1.5, 1.5, size=(K, T_PANDA, 9)).astype(np.float32)
        if grip is not None:
            a[..., 7:9] = grip
        jstates.append(_broadcast_k(s, K))
        jtasks.append(jax_task(task, goal, "none", zup))
        pstates.append(tree_map(lambda x: x.expand((K,) + x.shape), convert.panda_env_state_from_numpy(_leaves(s))))
        ptasks.append(make_task_params(task, goal, "none", zup))
        acts.append(a)
    return jstates, jtasks, tree_stack(pstates), tree_stack(ptasks), np.stack(acts)


def test_batched_panda_rollout_equals_single_per_seed():
    _, _, rollout = _panda()
    _, _, pk, ptask, acts = _panda_inputs()
    acts = torch.as_tensor(acts)
    inputs = pr.rollout_inputs(pk, ptask)
    assert [tuple(x.shape) for x in inputs] == [(3, 10), (3, pr.STATE_LEN)]
    c_b, t_b = rollout(pk, acts, ptask)
    c_p, t_p = pr.panda_rollout_batched_plain(rollout.spec, *inputs, acts)
    for b in range(3):
        c_s, t_s = rollout(tree_map(lambda x: x[b], pk), acts[b], tree_map(lambda x: x[b], ptask))
        assert torch.equal(c_b[b], c_s) and torch.equal(t_b[b], t_s), b
        assert torch.equal(c_p[b], c_s) and torch.equal(t_p[b], t_s), b


def test_batched_panda_rollout_matches_vmapped_xla_rollout():
    _, xla_fn, rollout = _panda()
    jstates, jtasks, pk, ptask, acts = _panda_inputs()
    c_ref, t_ref = xla_fn(_jstack(jstates), jnp.asarray(acts), _jstack(jtasks))
    c_got, t_got = rollout(pk, torch.as_tensor(acts), ptask)
    assert c_got.shape == (3, K, T_PANDA)
    np.testing.assert_allclose(c_got.numpy(), np.asarray(c_ref), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(t_got.numpy(), np.asarray(t_ref), atol=ATOL, rtol=RTOL)


# ---------------------------------------------------------------- albert
@functools.lru_cache(maxsize=None)
def _albert():
    jcfg = jax_load_config("config_albert")
    jenv = jax_make_env(jcfg)
    p = jenv.params
    obj = JaxAlbertObjective(p, jcfg)

    def xla_rollout(state_k, acts, task):
        def step_t(s, u_t):
            s = jax.vmap(lambda st, u: jalbert.step(p, st, u))(s, u_t)
            cost, _ = jax.vmap(obj.compute, in_axes=(0, 0, None, None))(s, u_t, task, 0)
            return s, (cost, s.q[:, :2])

        _, (costs, tps) = jax.lax.scan(step_t, state_k, jnp.swapaxes(acts, 0, 1))
        return jnp.swapaxes(costs, 0, 1), jnp.swapaxes(tps, 0, 1)

    params = convert.albert_params_from_numpy(_leaves(p), _static(p))
    rollout = ar.make_albert_rollout(params, AlbertObjective(params), K, T)
    return jenv, jax.jit(jax.vmap(xla_rollout)), rollout


def _albert_inputs():
    jenv, _, _ = _albert()
    cases = {c[0]: c[1:] for c in ar.PARITY_CASES}
    rng = np.random.default_rng(13)
    jstates, jtasks, pstates, ptasks = [], [], [], []
    for name in ALBERT_SEEDS:
        start, task, goal = cases[name]
        base = jenv.init_state()
        over = ar.parity_overrides(start, np.asarray(base.q), np.asarray(base.qd), np.asarray(jenv.params.box_init))
        s = base.replace(**{k: jnp.asarray(v) for k, v in over.items()})
        jstates.append(_broadcast_k(s, K))
        jtasks.append(jax_task(task, goal))
        pstates.append(tree_map(lambda x: x.expand((K,) + x.shape), convert.albert_state_from_numpy(_leaves(s))))
        ptasks.append(make_task_params(task, goal))
    acts = rng.uniform(-1.5, 1.5, size=(len(ALBERT_SEEDS), K, T, 13)).astype(np.float32)
    acts[..., 11:13] *= 8.0  # the wheels at the config's authority, so the box moves
    return jstates, jtasks, tree_stack(pstates), tree_stack(ptasks), acts


def test_batched_albert_rollout_equals_single_per_seed():
    _, _, rollout = _albert()
    _, _, pk, ptask, acts = _albert_inputs()
    acts = torch.as_tensor(acts)
    inputs = ar.rollout_inputs(pk, ptask)
    assert [tuple(x.shape) for x in inputs] == [(3, ar.TASK_LEN), (3, ar.STATE_LEN)]
    c_b, t_b = rollout(pk, acts, ptask)
    c_p, t_p = ar.albert_rollout_batched_plain(rollout.spec, *inputs, acts)
    for b in range(3):
        c_s, t_s = rollout(tree_map(lambda x: x[b], pk), acts[b], tree_map(lambda x: x[b], ptask))
        assert torch.equal(c_b[b], c_s) and torch.equal(t_b[b], t_s), b
        assert torch.equal(c_p[b], c_s) and torch.equal(t_p[b], t_s), b


def test_batched_albert_rollout_matches_vmapped_xla_rollout():
    _, xla_fn, rollout = _albert()
    jstates, jtasks, pk, ptask, acts = _albert_inputs()
    c_ref, t_ref = xla_fn(_jstack(jstates), jnp.asarray(acts), _jstack(jtasks))
    c_got, t_got = rollout(pk, torch.as_tensor(acts), ptask)
    np.testing.assert_allclose(c_got.numpy(), np.asarray(c_ref), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(t_got.numpy(), np.asarray(t_ref), atol=ATOL, rtol=RTOL)


# ------------------------------------------------------ wrapper contracts
def _bad_inputs():
    """(label, call, bad variant) triples: each variant breaks one shape,
    dtype, layout or device rule of a batched wrapper."""
    _, _, prollout = _point()
    _, _, pk, ptask, acts = _point_inputs()
    acts = torch.as_tensor(acts)
    tv, s0, fk = ro.rollout_inputs(pk, ptask)
    pspec = prollout.spec
    _, _, parollout = _panda()
    _, _, pak, patask, pacts = _panda_inputs()
    pacts = torch.as_tensor(pacts)
    ptv, ps0 = pr.rollout_inputs(pak, patask)
    _, _, arollout = _albert()
    _, _, ak, atask, aacts = _albert_inputs()
    aacts = torch.as_tensor(aacts)
    atv, as0 = ar.rollout_inputs(ak, atask)
    cost, gamma = torch.rand(3, K, T), torch.ones(T)
    point = functools.partial(ro.point_rollout_batched, pspec)
    panda = functools.partial(pr.panda_rollout_batched, parollout.spec)
    albert = functools.partial(ar.albert_rollout_batched, arollout.spec)
    w = functools.partial(weights.multimodal_weights_batched, half_K=K // 2)
    return [
        ("point: unbatched acts", point, (tv[0], s0[0], fk[0], acts[0])),
        ("point: task of another batch", point, (tv[:2], s0, fk, acts)),
        ("point: float64 state", point, (tv, s0.double(), fk, acts)),
        ("point: strided friction", point, (tv, s0, fk.transpose(1, 2).contiguous().transpose(1, 2), acts)),
        ("point: meta device", point, (tv, s0, fk, acts.to("meta"))),
        ("panda: short state", panda, (ptv, ps0[:, :-1], pacts)),
        ("panda: integer task", panda, (ptv.int(), ps0, pacts)),
        ("albert: wrong channel count", albert, (atv, as0, aacts[..., :12])),
        ("albert: horizon of another scene", albert, (atv, as0, aacts[:, :, :-1])),
        ("weights: unbatched cost", w, (cost[0], gamma)),
        ("weights: gamma of another horizon", w, (cost, torch.ones(T + 1))),
        ("weights: strided cost", w, (cost.transpose(1, 2).contiguous().transpose(1, 2), gamma)),
    ]


@pytest.mark.parametrize("case", range(12))
def test_batched_wrappers_reject_bad_inputs(case):
    label, fn, args = _bad_inputs()[case]
    with pytest.raises(ValueError):
        fn(*args)
        pytest.fail(label)
