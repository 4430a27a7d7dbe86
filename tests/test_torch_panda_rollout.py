"""The port's panda rollout (K3's plain version, reached through the
``make_panda_rollout`` factory on CPU tensors) against the JAX package's XLA
rollout: the scan of the vmapped ``panda_env.step`` + ``PandaObjective``
that tests/test_pallas.py:302-320 holds the Pallas kernel to.

Full ``config_panda`` physics, K=16, T=4, from the seven start states of
tests/test_pallas.py:335-363, for multi_modal False and True.  Parameters
and states are the JAX ones carried across with ``utils/convert.py``.  Bar:
cost and trajectory within 1e-4 (the TPU's device bar for the kernel,
tests/test_pallas.py:688-691); both sides run the same f32 formulas, so
only summation order separates them.
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
from m3p2i_aip_tpu.models import panda_env as jpa
from m3p2i_aip_tpu.models import panda_fk as jfk
from m3p2i_aip_tpu.planners.motion_planner.cost_functions import PandaObjective as JaxObjective
from m3p2i_aip_tpu.planners.motion_planner.mppi import make_task_params as jax_task
from m3p2i_aip_tpu_torch.ops import panda_rollout as pr
from m3p2i_aip_tpu_torch.planners.motion_planner.mppi import make_task_params
from m3p2i_aip_tpu_torch.utils import convert
from m3p2i_aip_tpu_torch.utils.tree import tree_map

K, T = 16, 4
ATOL = 1e-4
# name -> (start, task, gripper action or None, zup_gate), tests/test_pallas.py:354-363
CASES = {case[0]: case[1:] for case in pr.PARITY_CASES}


def _leaves(x) -> dict:
    return {
        f.name: np.asarray(getattr(x, f.name))
        for f in dataclasses.fields(x)
        if f.metadata.get("pytree_node", True) and getattr(x, f.name) is not None
    }


def _static(x) -> dict:
    return {f.name: getattr(x, f.name) for f in dataclasses.fields(x) if not f.metadata.get("pytree_node", True)}


@functools.lru_cache(maxsize=None)
def _packages(multi_modal: bool):
    """The JAX scene, its jitted XLA rollout, and the port's rollout built
    on the carried-across params."""
    jcfg = jax_load_config("config_panda", [f"multi_modal={multi_modal}"])
    jenv = jax_make_env(jcfg)
    obj = JaxObjective(jenv.params, jcfg)
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
    rollout = pr.make_panda_rollout(params, float(jcfg.pre_height_diff), K, T, multi_modal)
    return jenv, jax.jit(xla_rollout), rollout


def _start(jenv, start):
    base = jenv.init_state()
    arrays = [np.asarray(x) for x in (base.body_pos, base.body_vel, base.body_om)]
    return base.replace(**{k: jnp.asarray(v) for k, v in pr.parity_overrides(start, *arrays).items()})


@pytest.mark.parametrize("multi_modal", [False, True])
@pytest.mark.parametrize("case", list(CASES))
def test_plain_rollout_matches_xla_rollout(multi_modal, case):
    jenv, xla_rollout, rollout = _packages(multi_modal)
    start, task, grip, zup = CASES[case]
    rng = np.random.default_rng(list(CASES).index(case))
    acts = rng.uniform(-1.5, 1.5, size=(K, T, 9)).astype(np.float32)
    if grip is not None:
        acts[..., 7:9] = grip
    goal = pr.PARITY_GOAL if task == "pick" else np.zeros(7)
    jstate = _start(jenv, start)
    jk = jax.tree_util.tree_map(lambda x: jnp.broadcast_to(x, (K,) + x.shape), jstate)
    c_ref, t_ref = xla_rollout(jk, jnp.asarray(acts), jax_task(task, goal, "none", zup))

    pk = tree_map(lambda x: x.expand((K,) + x.shape), convert.panda_env_state_from_numpy(_leaves(jstate)))
    c_got, t_got = rollout(pk, torch.as_tensor(acts), make_task_params(task, goal, "none", zup))
    assert c_got.shape == (K, T) and t_got.shape == (K, T, 2)
    np.testing.assert_allclose(c_got.numpy(), np.asarray(c_ref), atol=ATOL, rtol=0)
    np.testing.assert_allclose(t_got.numpy(), np.asarray(t_ref), atol=ATOL, rtol=0)


def test_global_offset_moves_the_mode_split():
    """``k0`` shifts the mode split by global sample index: with k0 = K/2
    the shard's first half has global indices in [K/2, K), mode 1 (the
    tilted side grasp), and its second half lies past K, mode 0 -- the two
    halves of a k0 = 0 call, swapped (identical actions on every row)."""
    jenv, _, rollout = _packages(True)
    state = tree_map(lambda x: x.expand((K,) + x.shape), convert.panda_env_state_from_numpy(_leaves(jenv.init_state())))
    acts = torch.as_tensor(np.tile(np.random.default_rng(9).uniform(-1, 1, size=(1, T, 9)).astype(np.float32), (K, 1, 1)))
    task = make_task_params("reach", np.zeros(7))
    c0, _ = rollout(state, acts, task)
    c1, _ = rollout(state, acts, task, k0=K // 2)
    assert torch.equal(c1, torch.cat([c0[K // 2 :], c0[: K // 2]]))
    assert not torch.equal(c0[0], c0[-1])
