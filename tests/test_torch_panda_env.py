"""The port's quaternion ops, panda FK, panda env step and panda costs
against the JAX package, on the CPU.

Full ``config_panda`` physics (dt 0.01, substeps 2, every static) from the
seven start states of tests/test_pallas.py:335-363: the rest pose, the
gripper closing near the cube, the cube attached, attached with the zup gate
on, a tumbling free cube, cubeA beside cubeB, and the gripper opening over
an attached cube.  Inputs are made with numpy from a seed and handed to both
packages; the port's params and states are the JAX ones carried across with
``utils/convert.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from m3p2i_aip_tpu.config.config_store import load_config as jax_load_config
from m3p2i_aip_tpu.envs import make_env as jax_make_env
from m3p2i_aip_tpu.models import panda_env as jpa
from m3p2i_aip_tpu.models import panda_fk as jfk
from m3p2i_aip_tpu.ops import quat as jq
from m3p2i_aip_tpu.planners.motion_planner.cost_functions import PandaObjective as JaxObjective
from m3p2i_aip_tpu.planners.motion_planner.mppi import make_task_params as jax_task
from m3p2i_aip_tpu_torch.config.config_store import load_config
from m3p2i_aip_tpu_torch.envs import make_env
from m3p2i_aip_tpu_torch.models import panda_env as pa
from m3p2i_aip_tpu_torch.models import panda_fk
from m3p2i_aip_tpu_torch.ops import panda_rollout as pr
from m3p2i_aip_tpu_torch.ops import quat as q_ops
from m3p2i_aip_tpu_torch.planners.motion_planner.cost_functions import PandaObjective
from m3p2i_aip_tpu_torch.planners.motion_planner.mppi import make_task_params
from m3p2i_aip_tpu_torch.utils import convert

# f32 state values agree to ~1e-6 after 20 steps; contact forces are
# position corrections divided by the substep squared (x 40000) or probe
# penetrations x 2000, so at tens of newtons they carry ~1e-5 relative
# rounding: atol 1e-4 plus rtol 1e-5 covers both
ATOL, RTOL = 1e-4, 1e-5
QUAT_ATOL = 1e-6
FK_ATOL = 1e-5
N_STEPS = 20
PICK_GOAL = list(pr.PARITY_GOAL)
CASE_NAMES = tuple(case[0] for case in pr.PARITY_CASES)
# the gripper action of each start (None: the seeded random one)
GRIPS = tuple(case[3] for case in pr.PARITY_CASES)


def _leaves(x) -> dict:
    return {
        f.name: np.asarray(getattr(x, f.name))
        for f in dataclasses.fields(x)
        if f.metadata.get("pytree_node", True) and getattr(x, f.name) is not None
    }


def _static(x) -> dict:
    return {f.name: getattr(x, f.name) for f in dataclasses.fields(x) if not f.metadata.get("pytree_node", True)}


def jax_starts(jenv):
    """The seven JAX start states of tests/test_pallas.py:335-363, in the
    order of ``panda_rollout.PARITY_CASES``."""
    base = jenv.init_state()
    arrays = [np.asarray(x) for x in (base.body_pos, base.body_vel, base.body_om)]
    return [
        base.replace(**{k: jnp.asarray(v) for k, v in pr.parity_overrides(case[1], *arrays).items()})
        for case in pr.PARITY_CASES
    ]


def _stack(states):
    return jax.tree_util.tree_map(lambda *x: jnp.stack(x), *states)


@pytest.fixture(scope="module")
def scene():
    jenv = jax_make_env(jax_load_config("config_panda", ["multi_modal=True"]))
    params = convert.panda_env_params_from_numpy(_leaves(jenv.params), _static(jenv.params))
    return jenv, params


# ------------------------------------------------------------------ quat ops

def _quats(rng, n=64):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _rotmats(rng, n=64):
    return np.asarray(jq.quat_to_rotmat(jnp.asarray(_quats(rng, n))))


QUAT_CASES = {
    "quat_to_rotmat": lambda m, r: (m.quat_to_rotmat, (_quats(r),)),
    "quat_mul": lambda m, r: (m.quat_mul, (_quats(r), _quats(r))),
    "quat_conj": lambda m, r: (m.quat_conj, (_quats(r),)),
    "quat_rotate": lambda m, r: (m.quat_rotate, (_quats(r), r.normal(size=(64, 3)).astype(np.float32))),
    "quat_inv_rotate": lambda m, r: (m.quat_inv_rotate, (_quats(r), r.normal(size=(64, 3)).astype(np.float32))),
    "quat_normalize": lambda m, r: (m.quat_normalize, (2.0 * _quats(r),)),
    "quat_integrate": lambda m, r: (
        lambda q, w: m.quat_integrate(q, w, 0.005), (_quats(r), 3.0 * r.normal(size=(64, 3)).astype(np.float32))
    ),
    "mat_to_quat": lambda m, r: (m.mat_to_quat, (_rotmats(r),)),
    "ori_cost_cube2goal": lambda m, r: (m.ori_cost_cube2goal, (_quats(r), _quats(r))),
    "ori_cost_ee2cube": lambda m, r: (m.ori_cost_ee2cube, (_quats(r), _quats(r))),
    "general_ori_cube2goal": lambda m, r: (m.general_ori_cube2goal, (_quats(r), _quats(r))),
    "general_ori_ee2cube_tilt0": lambda m, r: (m.general_ori_ee2cube, (_quats(r), _quats(r))),
    "general_ori_ee2cube_tilt": lambda m, r: (
        lambda a, b: m.general_ori_ee2cube(a, b, tilt_value=0.5), (_quats(r), _quats(r))
    ),
    "general_ori_ee2cube_mat": lambda m, r: (
        lambda a, b: m.general_ori_ee2cube_mat(a, b, tilt_value=0.5), (_rotmats(r), _quats(r))
    ),
}


@pytest.mark.parametrize("name", list(QUAT_CASES))
def test_quat_op_matches_jax_package(name):
    """Every quaternion / orientation op on 64 numpy-seeded inputs."""
    jfn, args = QUAT_CASES[name](jq, np.random.default_rng(7))
    pfn, _ = QUAT_CASES[name](q_ops, np.random.default_rng(7))
    ref = np.asarray(jfn(*(jnp.asarray(a) for a in args)))
    got = pfn(*(torch.as_tensor(np.array(a)) for a in args)).numpy()
    np.testing.assert_allclose(got, ref, atol=QUAT_ATOL, rtol=0)


# ------------------------------------------------------------------------ FK

def test_fk_matches_jax_package(scene):
    """Every link pose of 32 seeded joint vectors inside the limits."""
    jenv, params = scene
    rng = np.random.default_rng(3)
    q = rng.uniform(jfk.JOINT_LOWER, jfk.JOINT_UPPER, size=(32, 9)).astype(np.float32)
    ref = jfk.fk(jnp.asarray(q), jenv.params.base_pos)
    got = panda_fk.fk(torch.as_tensor(q), params.base_pos)
    assert set(got) == set(ref)
    for link, (pos, rot) in ref.items():
        np.testing.assert_allclose(got[link][0].numpy(), np.asarray(pos), atol=FK_ATOL, rtol=0, err_msg=link)
        np.testing.assert_allclose(got[link][1].numpy(), np.asarray(rot), atol=FK_ATOL, rtol=0, err_msg=link)


def test_build_params_matches_jax_package(scene):
    """The port builds the same panda scene from the same YAMLs."""
    jenv, _ = scene
    params = make_env(load_config("config_panda", ["multi_modal=True"]), device="cpu").params
    for name, ref in _leaves(jenv.params).items():
        np.testing.assert_array_equal(getattr(params, name).numpy(), ref, err_msg=name)
    for name, ref in _static(jenv.params).items():
        assert getattr(params, name) == ref, name


# ---------------------------------------------------------------- env step

@pytest.fixture(scope="module")
def trajectories(scene):
    """20 steps of seeded actions from the seven starts, in both packages
    (the seven as one batch: a vmapped JAX step, the port's batched step)."""
    jenv, params = scene
    rng = np.random.default_rng(11)
    acts = rng.uniform(-1.5, 1.5, size=(N_STEPS, 7, 9)).astype(np.float32)
    for i, g in enumerate(GRIPS):
        if g is not None:
            acts[:, i, 7:9] = g
    jstate = _stack(jax_starts(jenv))
    pstate = convert.panda_env_state_from_numpy(_leaves(jstate))
    jstep = jax.jit(jax.vmap(lambda s, u: jpa.step(jenv.params, s, u, jpa.zero_ext(jenv.params))))
    ext = pa.zero_ext(params, (7,))
    jtraj, ptraj = [], []
    for t in range(N_STEPS):
        jstate = jstep(jstate, jnp.asarray(acts[t]))
        pstate = pa.step(params, pstate, torch.as_tensor(acts[t]), ext)
        jtraj.append(_leaves(jstate))
        ptraj.append(pstate)
    return jtraj, ptraj


@pytest.mark.parametrize("case", range(7), ids=CASE_NAMES)
def test_step_matches_jax_package(trajectories, case):
    jtraj, ptraj = trajectories
    for t, (ref, got) in enumerate(zip(jtraj, ptraj)):
        for name, r in ref.items():
            np.testing.assert_allclose(
                getattr(got, name)[case].numpy(), r[case], atol=ATOL, rtol=RTOL, err_msg=f"{name} at step {t}"
            )


def test_step_releases_the_cube(trajectories):
    """The opening gripper over the attached cube releases it."""
    _, ptraj = trajectories
    assert float(ptraj[0].attached[6]) == 1.0
    assert float(ptraj[-1].attached[6]) == 0.0, "the opening gripper never released"


def _crafted(jenv, name):
    """Starts the seven leave out: cubeA at the closing fingertip (attach),
    and cubeA pressed 4 cm from cubeB's center (cube-cube contact)."""
    base = jenv.init_state()
    if name == "attach_at_fingertip":
        tip = jfk.fk(base.q, jenv.params.base_pos)["fingertip"][0]
        return base.replace(body_pos=base.body_pos.at[1].set(tip)), -1.5
    return base.replace(body_pos=base.body_pos.at[1].set(base.body_pos[2] + jnp.asarray([0.04, 0.0, 0.0]))), None


@pytest.mark.parametrize("name", ["attach_at_fingertip", "cubeA_pressing_cubeB"])
def test_crafted_step_matches_jax_package(scene, name):
    """10 steps from each crafted start in both packages; the grasp welds
    the cube (and the held cube follows the hand), the pressed cubes push
    apart with a contact force on cubeB."""
    jenv, params = scene
    jstate, grip = _crafted(jenv, name)
    pstate = convert.panda_env_state_from_numpy(_leaves(jstate))
    acts = np.random.default_rng(4).uniform(-1.5, 1.5, size=(10, 9)).astype(np.float32)
    if grip is not None:
        acts[:, 7:9] = grip
    jstep = jax.jit(lambda s, u: jpa.step(jenv.params, s, u, jpa.zero_ext(jenv.params)))
    force_b = 0.0
    for t in range(10):
        jstate = jstep(jstate, jnp.asarray(acts[t]))
        pstate = pa.step(params, pstate, torch.as_tensor(acts[t]), pa.zero_ext(params))
        for f, r in _leaves(jstate).items():
            np.testing.assert_allclose(getattr(pstate, f).numpy(), r, atol=ATOL, rtol=RTOL, err_msg=f"{f} at step {t}")
        force_b = max(force_b, float(pstate.contact_force[6].abs().max()))
    if name == "attach_at_fingertip":
        assert float(pstate.attached) == 1.0
    else:
        assert force_b > 1.0, "no cubeA-cubeB contact force"


def test_single_state_step_equals_batched_step(scene):
    """``step`` on one state (the real env) equals row 0 of the batched step."""
    jenv, params = scene
    state = convert.panda_env_state_from_numpy(_leaves(jax_starts(jenv)[1]))
    u = torch.as_tensor(np.random.default_rng(5).uniform(-1.5, 1.5, size=9).astype(np.float32))
    one = pa.step(params, state, u, pa.zero_ext(params))
    batched = pa.step(
        params, dataclasses.replace(state, **{f: getattr(state, f)[None] for f in _leaves(state)}),
        u[None], pa.zero_ext(params, (1,)),
    )
    for f in _leaves(one):
        assert torch.equal(getattr(one, f), getattr(batched, f)[0]), f


# -------------------------------------------------------------------- costs

def _cost_inputs(jenv):
    """The seven starts after three steps (contact forces and a moving cube
    in play), with their modes: the first three samples in mode 0."""
    states = _stack(jax_starts(jenv))
    rng = np.random.default_rng(2)
    step = jax.jit(jax.vmap(lambda s, u: jpa.step(jenv.params, s, u, jpa.zero_ext(jenv.params))))
    for _ in range(3):
        acts = rng.uniform(-1.5, 1.5, size=(7, 9)).astype(np.float32)
        acts[[1, 2, 3, 5], 7:9] = -1.5
        states = step(states, jnp.asarray(acts))
    return states, np.asarray([0, 0, 0, 1, 1, 1, 1], np.int32)


@pytest.mark.parametrize("multi_modal", [False, True])
@pytest.mark.parametrize("task", ["reach", "pick", "place"])
@pytest.mark.parametrize("zup_gate", [0.0, 1.0])
def test_objective_matches_jax_package(scene, multi_modal, task, zup_gate):
    jenv, params = scene
    jstates, modes = _cost_inputs(jenv)
    jcfg = jax_load_config("config_panda", [f"multi_modal={multi_modal}"])
    jtask = jax_task(task, PICK_GOAL, "close", zup_gate)
    ref = jax.vmap(JaxObjective(jenv.params, jcfg).compute, in_axes=(0, None, None, 0))(
        jstates, jnp.zeros(9), jtask, jnp.asarray(modes)
    )[0]
    obj = PandaObjective.from_cfg(params, load_config("config_panda", [f"multi_modal={multi_modal}"]))
    got, ext = obj.compute(
        convert.panda_env_state_from_numpy(_leaves(jstates)), torch.zeros(7, 9),
        make_task_params(task, PICK_GOAL, "close", zup_gate), torch.as_tensor(modes),
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=0)
    assert ext.body.shape == (7, 3, 3) and not ext.body.any()
