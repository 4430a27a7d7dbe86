"""The port's rollout (K1's plain version, reached through the
``make_point_rollout`` factory on CPU tensors) against the JAX package's XLA
rollout: the scan of the vmapped ``point_env.step`` + ``PointObjective``
that tests/test_pallas.py:194-210 holds the Pallas kernel to.

Full ``config_point`` physics, K=16, T=15, from the six start states, plus
one case with per-sample friction scales != 1 and one with a global sample
offset k0 != 0; and the 3-dof heijn (omni) and boxer (diff-drive) bases,
which the kernel takes as launch arguments, from three of the starts.  Bars from tests/test_pallas.py:259-260: cost atol 1e-2 (the
binarized 1000-scale contact and crush terms tolerate no flip, and the
continuous terms agree far below it), trajectory atol 1e-3.
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
from m3p2i_aip_tpu.models import point_env as jpe
from m3p2i_aip_tpu.planners.motion_planner.cost_functions import PointObjective as JaxObjective
from m3p2i_aip_tpu.planners.motion_planner.mppi import make_task_params as jax_task
from m3p2i_aip_tpu_torch.ops import rollout as ro
from m3p2i_aip_tpu_torch.planners.motion_planner.mppi import make_task_params
from m3p2i_aip_tpu_torch.utils import convert
from m3p2i_aip_tpu_torch.utils.tree import tree_map

K, T = 16, 15
COST_ATOL, TRAJ_ATOL = 1e-2, 1e-3
OVERRIDES = ["task=push_pull", "multi_modal=True", "goal=[-3.75,-3.75]", f"mppi.num_samples={K}", f"mppi.horizon={T}"]
GOAL = [-3.75, -3.75]
STARTS = [
    ([-0.3, 1.4], [0.5, 0.5]),
    ([-3.7, -3.7], [-2.0, -2.0]),
    ([-0.05, 1.75], [0.0, 2.0]),
    ([0.0, 1.55], [0.0, 7.0]),
    ([-3.3, -3.3], [-6.0, -6.0]),
    ([-2.6, -2.9], [-1.0, -1.0], [-3.3, -3.2]),
]
# (config, start index, per-sample friction draw, k0)
CASES = (
    [("config_point", i, False, None) for i in range(len(STARTS))]
    + [("config_point", 2, True, None), ("config_point", 3, False, 8)]
    + [(c, i, False, None) for c in ("config_heijn", "config_boxer") for i in (1, 2, 3)]
)


def _leaves(x) -> dict:
    return {
        f.name: np.asarray(getattr(x, f.name))
        for f in dataclasses.fields(x)
        if f.metadata.get("pytree_node", True) and getattr(x, f.name) is not None
    }


def _static(x) -> dict:
    return {f.name: getattr(x, f.name) for f in dataclasses.fields(x) if not f.metadata.get("pytree_node", True)}


@functools.lru_cache(maxsize=None)
def _setup(config_name: str):
    cfg = jax_load_config(config_name, OVERRIDES)
    jenv = jax_make_env(cfg)
    jobj = JaxObjective(jenv.params, cfg)

    def xla_rollout(state_k, acts, task, mode):
        """MPPI._rollout semantics with an explicit per-sample mode."""
        ext0 = jax.vmap(lambda _: jenv.zero_ext())(jnp.arange(K))

        def step_t(carry, u_t):
            s, ext = carry
            s = jax.vmap(jenv.step)(s, u_t, ext)
            cost, ext = jax.vmap(jobj.compute, in_axes=(0, 0, None, 0))(s, u_t, task, mode)
            return (s, ext), (cost, s.q[:, :2])

        (_, _), (costs, tps) = jax.lax.scan(step_t, (state_k, ext0), jnp.swapaxes(acts, 0, 1))
        return jnp.swapaxes(costs, 0, 1), jnp.swapaxes(tps, 0, 1)

    params = convert.point_env_params_from_numpy(_leaves(jenv.params), _static(jenv.params))
    rollout = ro.make_point_rollout(
        params, float(cfg.kp_suction), K, T, True, boxer_continuous_align=cfg.mppi.boxer_continuous_align
    )
    return jenv, jax.jit(xla_rollout), rollout


@pytest.mark.parametrize("case", range(len(CASES)))
def test_rollout_matches_jax_xla_rollout(case):
    config_name, start, fric, k0 = CASES[case]
    jenv, xla_fn, rollout = _setup(config_name)
    entry = STARTS[start]
    q0, qd0 = list(entry[0]), list(entry[1])
    if jenv.params.robot_type != "point":  # 3-dof bases carry yaw in q[2]
        q0, qd0 = q0 + [0.3], qd0 + [0.5]
    rng = np.random.default_rng(100 + case)
    state = jenv.init_state().replace(q=jnp.asarray(q0, jnp.float32), qd=jnp.asarray(qd0, jnp.float32))
    if len(entry) == 3:
        state = state.replace(dyn_pos=state.dyn_pos.at[1].set(jnp.asarray(entry[2], jnp.float32)))
    sk = jax.tree_util.tree_map(lambda x: jnp.broadcast_to(x, (K,) + x.shape), state)
    if fric:
        sk = sk.replace(fric_scale=jnp.asarray(rng.uniform(0.7, 1.3, (K, 2)).astype(np.float32)))
    acts = rng.uniform(-3, 3, size=(K, T, jenv.nu)).astype(np.float32)
    gk = np.arange(K) + (k0 or 0)
    mode = ((gk >= K // 2) & (gk < K)).astype(np.int32)

    ch_ref, tps_ref = xla_fn(sk, jnp.asarray(acts), jax_task("push_pull", GOAL), jnp.asarray(mode))
    tsk = tree_map(lambda x: x.expand((K,) + x.shape), convert.point_env_state_from_numpy(_leaves(state)))
    tsk = dataclasses.replace(tsk, fric_scale=torch.as_tensor(np.array(sk.fric_scale)))
    ch, tps = rollout(tsk, torch.as_tensor(acts), make_task_params("push_pull", GOAL), k0)

    np.testing.assert_allclose(ch.numpy(), np.asarray(ch_ref), atol=COST_ATOL, rtol=0)
    np.testing.assert_allclose(tps.numpy(), np.asarray(tps_ref), atol=TRAJ_ATOL, rtol=0)
