"""The port's albert rollout (K4's plain version, reached through the
``make_albert_rollout`` factory on CPU tensors) against the JAX package's XLA
rollout: the scan of the vmapped ``albert.step`` + ``AlbertObjective`` that
tests/test_pallas.py:726-737 holds the Pallas kernel to.

Full ``config_albert`` physics (substeps 2, the pushable box), K=16, T=12,
from the five cases of ``albert_rollout.PARITY_CASES``.  Parameters and
states are the JAX ones carried across with ``utils/convert.py``.  Bars: the
JAX package's own (tests/test_pallas.py:779-786), cost atol 2e-4 with rtol
1e-4 and trajectory atol 1e-5.
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
from m3p2i_aip_tpu.ops.pallas_albert_rollout import make_albert_rollout as make_pallas_rollout
from m3p2i_aip_tpu.planners.motion_planner.cost_functions import AlbertObjective as JaxObjective
from m3p2i_aip_tpu.planners.motion_planner.mppi import make_task_params as jax_task
from m3p2i_aip_tpu_torch.ops import albert_rollout as ar
from m3p2i_aip_tpu_torch.planners.motion_planner.cost_functions import AlbertObjective
from m3p2i_aip_tpu_torch.planners.motion_planner.mppi import make_task_params
from m3p2i_aip_tpu_torch.utils import convert
from m3p2i_aip_tpu_torch.utils.tree import tree_map

K, T = 16, 12
COST_ATOL, COST_RTOL, TRAJ_ATOL = 2e-4, 1e-4, 1e-5
CASES = {case[0]: case[1:] for case in ar.PARITY_CASES}


def _leaves(x) -> dict:
    return {
        f.name: np.asarray(getattr(x, f.name))
        for f in dataclasses.fields(x)
        if f.metadata.get("pytree_node", True) and getattr(x, f.name) is not None
    }


def _static(x) -> dict:
    return {f.name: getattr(x, f.name) for f in dataclasses.fields(x) if not f.metadata.get("pytree_node", True)}


@functools.lru_cache(maxsize=None)
def _packages():
    """The JAX scene, its objective, its jitted XLA rollout, and the port's
    rollout built on the carried-across params."""
    jcfg = jax_load_config("config_albert")
    jenv = jax_make_env(jcfg)
    p = jenv.params
    obj = JaxObjective(p, jcfg)

    def xla_rollout(state_k, acts, task):
        def step_t(s, u_t):
            s = jax.vmap(lambda st, u: jalbert.step(p, st, u))(s, u_t)
            cost, _ = jax.vmap(obj.compute, in_axes=(0, 0, None, None))(s, u_t, task, 0)
            return s, (cost, s.q[:, :2])

        _, (costs, tps) = jax.lax.scan(step_t, state_k, jnp.swapaxes(acts, 0, 1))
        return jnp.swapaxes(costs, 0, 1), jnp.swapaxes(tps, 0, 1)

    params = convert.albert_params_from_numpy(_leaves(p), _static(p))
    rollout = ar.make_albert_rollout(params, AlbertObjective(params), K, T)
    return jenv, obj, jax.jit(xla_rollout), rollout


def _start(jenv, start):
    base = jenv.init_state()
    over = ar.parity_overrides(start, np.asarray(base.q), np.asarray(base.qd), np.asarray(jenv.params.box_init))
    return base.replace(**{k: jnp.asarray(v) for k, v in over.items()})


def _acts(case):
    rng = np.random.default_rng(list(CASES).index(case))
    return rng.uniform(-1.5, 1.5, size=(K, T, 13)).astype(np.float32)


@pytest.mark.parametrize("case", list(CASES))
def test_plain_rollout_matches_xla_rollout(case):
    jenv, _, xla_rollout, rollout = _packages()
    start, task, goal = CASES[case]
    acts = _acts(case)
    jstate = _start(jenv, start)
    jk = jax.tree_util.tree_map(lambda x: jnp.broadcast_to(x, (K,) + x.shape), jstate)
    c_ref, t_ref = xla_rollout(jk, jnp.asarray(acts), jax_task(task, goal))

    pk = tree_map(lambda x: x.expand((K,) + x.shape), convert.albert_state_from_numpy(_leaves(jstate)))
    c_got, t_got = rollout(pk, torch.as_tensor(acts), make_task_params(task, goal))
    assert c_got.shape == (K, T) and t_got.shape == (K, T, 2)
    np.testing.assert_allclose(c_got.numpy(), np.asarray(c_ref), atol=COST_ATOL, rtol=COST_RTOL)
    np.testing.assert_allclose(t_got.numpy(), np.asarray(t_ref), atol=TRAJ_ATOL, rtol=0)


def _closure_fn(fn, name):
    """The function called ``name`` among the cells of ``fn``'s closure, one
    level of nested closures deep (the Pallas factory keeps its packer there)."""
    for cell in fn.__closure__ or ():
        obj = cell.cell_contents
        if callable(obj) and getattr(obj, "__name__", "") == name:
            return obj
        for inner in getattr(obj, "__closure__", None) or ():
            if getattr(inner.cell_contents, "__name__", "") == name:
                return inner.cell_contents
    raise LookupError(name)


@pytest.mark.parametrize("case", ["push_reach_contact", "ee_reach_rotated_base"])
def test_rollout_inputs_follow_the_pallas_layout(case):
    """``rollout_inputs`` packs the task vector and the 30-float start state in
    the order of the Pallas kernel's ``_pack`` (pallas_albert_rollout.py:365)."""
    jenv, obj, _, _ = _packages()
    start, task, goal = CASES[case]
    jstate = _start(jenv, start)
    jk = jax.tree_util.tree_map(lambda x: jnp.broadcast_to(x, (K,) + x.shape), jstate)
    pallas = make_pallas_rollout(jenv.params, obj, K, T, interpret=True)
    pack = _closure_fn(_closure_fn(pallas, "_single"), "_pack")
    k0 = 3.0
    ref_task, ref_acts, ref_state = pack(jk, jnp.asarray(_acts(case)), jax_task(task, goal), jnp.float32(k0), 128)

    pk = tree_map(lambda x: x.expand((K,) + x.shape), convert.albert_state_from_numpy(_leaves(jstate)))
    task_vec, state0 = ar.rollout_inputs(pk, make_task_params(task, goal), k0)
    assert state0.shape == (ar.STATE_LEN,) and task_vec.shape == (ar.TASK_LEN,)
    np.testing.assert_array_equal(state0.numpy(), np.asarray(ref_state)[:, 0])
    np.testing.assert_array_equal(task_vec.numpy(), np.asarray(ref_task))
    # the kernel reads acts [K, T, 13] where the Pallas kernel read [T, 13, Kp]
    np.testing.assert_array_equal(np.transpose(_acts(case), (1, 2, 0)), np.asarray(ref_acts)[:, :, :K])
