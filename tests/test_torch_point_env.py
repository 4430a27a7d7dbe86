"""The port's point env and point costs against the JAX package, on the CPU.

Full ``config_point`` physics (substeps 2, pos_iters 2, all five statics)
from the six start states of tests/test_pallas.py:212-232: open space, the
arena wall junction, box contact, suction at the speed cap, a corner sprint,
and the box at the pocket mouth.  Inputs are made with numpy from a seed
and handed to both packages; the port's params are the JAX params carried
across with ``utils/convert.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from m3p2i_aip_tpu.config.config_store import load_config as jax_load_config
from m3p2i_aip_tpu.envs import make_env as jax_make_env
from m3p2i_aip_tpu.models import point_env as jpe
from m3p2i_aip_tpu.planners.motion_planner import cost_functions as jcf
from m3p2i_aip_tpu.planners.motion_planner.mppi import make_task_params as jax_task
from m3p2i_aip_tpu_torch.config.config_store import load_config
from m3p2i_aip_tpu_torch.envs import make_env
from m3p2i_aip_tpu_torch.models import point_env as pe
from m3p2i_aip_tpu_torch.planners.motion_planner.cost_functions import PointObjective
from m3p2i_aip_tpu_torch.planners.motion_planner.mppi import make_task_params
from m3p2i_aip_tpu_torch.utils import convert

OVERRIDES = ["task=push_pull", "multi_modal=True", "goal=[-3.75,-3.75]"]
STARTS = [
    ([-0.3, 1.4], [0.5, 0.5]),
    ([-3.7, -3.7], [-2.0, -2.0]),
    ([-0.05, 1.75], [0.0, 2.0]),
    ([0.0, 1.55], [0.0, 7.0]),
    ([-3.3, -3.3], [-6.0, -6.0]),
    ([-2.6, -2.9], [-1.0, -1.0], [-3.3, -3.2]),
]
# f32 state values agree to ~1e-7; contact forces are position corrections
# divided by the substep squared (x 1600), so at a few hundred newtons they
# carry ~1e-5 relative rounding: atol 1e-4 plus rtol 1e-5 covers both
ATOL, RTOL = 1e-4, 1e-5
STATE_FIELDS = ("q", "qd", "dyn_pos", "dyn_yaw", "dyn_vel", "dyn_om", "contact_force")


def _leaves(x) -> dict:
    return {
        f.name: np.asarray(getattr(x, f.name))
        for f in dataclasses.fields(x)
        if f.metadata.get("pytree_node", True) and getattr(x, f.name) is not None
    }


def _static(x) -> dict:
    return {f.name: getattr(x, f.name) for f in dataclasses.fields(x) if not f.metadata.get("pytree_node", True)}


@pytest.fixture(scope="module")
def envs():
    jenv = jax_make_env(jax_load_config("config_point", OVERRIDES))
    params = convert.point_env_params_from_numpy(_leaves(jenv.params), _static(jenv.params))
    return jenv, params, jax.jit(jenv.step)


def _start(jenv, entry):
    s = jenv.init_state().replace(q=jnp.asarray(entry[0], jnp.float32), qd=jnp.asarray(entry[1], jnp.float32))
    if len(entry) == 3:
        s = s.replace(dyn_pos=s.dyn_pos.at[1].set(jnp.asarray(entry[2], jnp.float32)))
    return s


def test_build_params_matches_jax_package(envs):
    """The port builds the same scene from the same YAMLs (static yaws may
    differ by one f32 ulp: numpy's and XLA's atan2 round differently)."""
    jenv, _, _ = envs
    params = make_env(load_config("config_point", OVERRIDES), device="cpu").params
    for name, ref in _leaves(jenv.params).items():
        np.testing.assert_allclose(getattr(params, name).numpy(), ref, atol=2e-7, rtol=0, err_msg=name)
    for name, ref in _static(jenv.params).items():
        assert getattr(params, name) == ref, name


@pytest.mark.parametrize("start", range(len(STARTS)))
def test_step_matches_jax_package(envs, start):
    """Four steps of random actions with suction-sized external forces."""
    jenv, params, jstep = envs
    rng = np.random.default_rng(start)
    js = _start(jenv, STARTS[start])
    ts = convert.point_env_state_from_numpy(_leaves(js))
    for _ in range(4):
        u = rng.uniform(-3, 3, 2).astype(np.float32)
        f = rng.uniform(-300, 300, 2).astype(np.float32)
        dyn = np.zeros((2, 2), np.float32)
        dyn[1] = -f
        js = jstep(js, jnp.asarray(u), jpe.PointExtForces(robot=jnp.asarray(f), dyn=jnp.asarray(dyn)))
        ts = pe.step(params, ts, torch.as_tensor(u), pe.PointExtForces(robot=torch.as_tensor(f), dyn=torch.as_tensor(dyn)))
        for name in STATE_FIELDS:
            np.testing.assert_allclose(
                getattr(ts, name).numpy(), np.asarray(getattr(js, name)), atol=ATOL, rtol=RTOL, err_msg=name
            )


@pytest.fixture(scope="module")
def batch(envs):
    """The six start states after one step, as one batch of K=12 (each state
    twice: once per mode).  The suction start backs away from the box, so
    the pull cost's suction engages there."""
    jenv, _, jstep = envs
    rng = np.random.default_rng(7)
    states = []
    for i, entry in enumerate(STARTS):
        u = rng.uniform(-3, 3, 2).astype(np.float32)
        if i == 3:
            u = np.asarray([0.0, -3.0], np.float32)
        states.append(jstep(_start(jenv, entry), jnp.asarray(u), jenv.zero_ext()))
    states = states + states
    stacked = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *states)
    mode = np.repeat(np.asarray([0, 1], np.int32), len(STARTS))
    u = rng.uniform(-3, 3, (len(states), 2)).astype(np.float32)
    return stacked, mode, u


@pytest.mark.parametrize("multi_modal", [True, False])
@pytest.mark.parametrize("task", ["navigation", "push", "pull", "push_pull", "reposition"])
def test_point_objective_matches_jax_package(envs, batch, task, multi_modal):
    """PointObjective.compute per task id (0/1/2/3/8) and mode, with its ext."""
    jenv, params, _ = envs
    stacked, mode, u = batch
    ov = ["task=push_pull", f"multi_modal={multi_modal}", "goal=[-3.75,-3.75]"]
    jobj = jcf.PointObjective(jenv.params, jax_load_config("config_point", ov))
    obj = PointObjective.from_cfg(params, load_config("config_point", ov))
    goal = [-3.75, -3.75]
    jcost, jext = jax.vmap(jobj.compute, in_axes=(0, 0, None, 0))(
        stacked, jnp.asarray(u), jax_task(task, goal), jnp.asarray(mode)
    )
    cost, ext = obj.compute(
        convert.point_env_state_from_numpy(_leaves(stacked)), torch.as_tensor(u), make_task_params(task, goal),
        torch.as_tensor(mode),
    )
    np.testing.assert_allclose(cost.numpy(), np.asarray(jcost), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(ext.robot.numpy(), np.asarray(jext.robot), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(ext.dyn.numpy(), np.asarray(jext.dyn), atol=ATOL, rtol=RTOL)
    if task in ("pull", "push_pull"):
        assert np.abs(np.asarray(jext.robot)).max() > 1.0  # the suction start engages
