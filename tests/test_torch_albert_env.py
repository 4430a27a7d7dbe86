"""The port's albert model (params, step, FK) and AlbertObjective against the
JAX package, on the CPU.

Full ``config_albert`` physics (dt 0.05, substeps 2, the pushable box) from
the starts of ``albert_rollout.PARITY_CASES`` (tests/test_pallas.py:748-769):
the rest pose, the arm bent with the base rotated, and the base driving into
the box.  Inputs are made with numpy from a seed and handed to both packages;
the port's params and states are the JAX ones carried across with
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
from m3p2i_aip_tpu.models import albert as jalbert
from m3p2i_aip_tpu.models import panda_fk as jfk
from m3p2i_aip_tpu.planners.motion_planner.cost_functions import AlbertObjective as JaxObjective
from m3p2i_aip_tpu.planners.motion_planner.mppi import make_task_params as jax_task
from m3p2i_aip_tpu_torch.config.config_store import load_config
from m3p2i_aip_tpu_torch.envs import make_env
from m3p2i_aip_tpu_torch.models import albert
from m3p2i_aip_tpu_torch.ops import albert_rollout as ar
from m3p2i_aip_tpu_torch.planners.motion_planner.cost_functions import AlbertObjective
from m3p2i_aip_tpu_torch.planners.motion_planner.mppi import make_task_params
from m3p2i_aip_tpu_torch.utils import convert

# f32 states agree to ~1e-7 after 20 steps through contact; the costs are
# norms of O(1) m scaled by up to 30
ATOL = 1e-5
N_STEPS = 20
CASE_NAMES = tuple(case[0] for case in ar.PARITY_CASES)


def _leaves(x) -> dict:
    return {
        f.name: np.asarray(getattr(x, f.name))
        for f in dataclasses.fields(x)
        if f.metadata.get("pytree_node", True) and getattr(x, f.name) is not None
    }


def _static(x) -> dict:
    return {f.name: getattr(x, f.name) for f in dataclasses.fields(x) if not f.metadata.get("pytree_node", True)}


def _stack(states):
    return jax.tree_util.tree_map(lambda *x: jnp.stack(x), *states)


@pytest.fixture(scope="module")
def scene():
    jcfg = jax_load_config("config_albert")
    jenv = jax_make_env(jcfg)
    params = convert.albert_params_from_numpy(_leaves(jenv.params), _static(jenv.params))
    return jenv, jcfg, params


def jax_start(jenv, start):
    base = jenv.init_state()
    over = ar.parity_overrides(start, np.asarray(base.q), np.asarray(base.qd), np.asarray(jenv.params.box_init))
    return base.replace(**{k: jnp.asarray(v) for k, v in over.items()})


def test_build_params_matches_jax_package(scene):
    """The port builds the same albert scene from the same YAMLs."""
    jenv, _, _ = scene
    params = make_env(load_config("config_albert"), device="cpu").params
    assert params.has_box
    for name, ref in _leaves(jenv.params).items():
        np.testing.assert_array_equal(getattr(params, name).numpy(), ref, err_msg=name)
    for name, ref in _static(jenv.params).items():
        assert getattr(params, name) == ref, name


def test_parity_state_matches_the_jax_starts(scene):
    jenv, _, params = scene
    for _, start, _, _ in ar.PARITY_CASES:
        got, ref = ar.parity_state(params, start), _leaves(jax_start(jenv, start))
        for name, r in ref.items():
            np.testing.assert_array_equal(getattr(got, name).numpy(), r, err_msg=f"{start} {name}")


# ---------------------------------------------------------------------- step

@pytest.fixture(scope="module")
def trajectories(scene):
    """20 steps of seeded actions from the five starts, in both packages (the
    five as one batch: a vmapped JAX step, the port's batched step)."""
    jenv, _, params = scene
    rng = np.random.default_rng(11)
    acts = rng.uniform(-1.5, 1.5, size=(N_STEPS, len(CASE_NAMES), 13)).astype(np.float32)
    acts[..., 11:13] *= 6.0  # wheel speeds at the config's authority, so the box moves
    jstate = _stack([jax_start(jenv, case[1]) for case in ar.PARITY_CASES])
    pstate = convert.albert_state_from_numpy(_leaves(jstate))
    jstep = jax.jit(jax.vmap(lambda s, u: jalbert.step(jenv.params, s, u)))
    jtraj, ptraj = [], []
    for t in range(N_STEPS):
        jstate = jstep(jstate, jnp.asarray(acts[t]))
        pstate = albert.step(params, pstate, torch.as_tensor(acts[t]))
        jtraj.append(_leaves(jstate))
        ptraj.append(pstate)
    return jtraj, ptraj


@pytest.mark.parametrize("case", range(len(CASE_NAMES)), ids=CASE_NAMES)
def test_step_matches_jax_package(trajectories, case):
    jtraj, ptraj = trajectories
    for t, (ref, got) in enumerate(zip(jtraj, ptraj)):
        for name, r in ref.items():
            np.testing.assert_allclose(
                getattr(got, name)[case].numpy(), r[case], atol=ATOL, rtol=0, err_msg=f"{name} at step {t}"
            )


def test_contact_start_pushes_the_box(trajectories):
    """The base driving into the box moves it: the step test above is not a
    comparison of two parked boxes."""
    _, ptraj = trajectories
    case = CASE_NAMES.index("push_reach_contact")
    assert float(torch.linalg.vector_norm(ptraj[-1].box_pos[case] - torch.tensor([1.2, 0.0]))) > 0.02


def test_single_state_step_equals_batched_step(scene):
    """``step`` on one state (the real env) equals row 0 of the batched step."""
    _, _, params = scene
    state = ar.parity_state(params, "contact")
    u = torch.as_tensor(np.random.default_rng(5).uniform(-1.5, 1.5, size=13).astype(np.float32))
    one = albert.step(params, state, u)
    batched = albert.step(params, dataclasses.replace(state, **{f: getattr(state, f)[None] for f in _leaves(state)}), u[None])
    for f in _leaves(one):
        assert torch.equal(getattr(one, f), getattr(batched, f)[0]), f


# ------------------------------------------------------------------------ FK

def test_fk_matches_jax_package(scene):
    """Every link pose of 32 seeded base poses and joint vectors inside the
    limits (the chain starts at the base pose, the arm mount composed in)."""
    jenv, _, _ = scene
    rng = np.random.default_rng(3)
    q = np.concatenate(
        [rng.uniform(-3.0, 3.0, size=(32, 3)), rng.uniform(jfk.JOINT_LOWER, jfk.JOINT_UPPER, size=(32, 9))], axis=-1
    ).astype(np.float32)
    jstates = jax.vmap(lambda qi: jenv.init_state().replace(q=qi))(jnp.asarray(q))
    ref = jax.vmap(jalbert.fk)(jstates)
    got = albert.fk(dataclasses.replace(albert.init_state(scene[2]), q=torch.as_tensor(q)))
    assert set(got) == set(ref)
    for link, (pos, rot) in ref.items():
        np.testing.assert_allclose(got[link][0].numpy(), np.asarray(pos), atol=ATOL, rtol=0, err_msg=link)
        np.testing.assert_allclose(got[link][1].numpy(), np.asarray(rot), atol=ATOL, rtol=0, err_msg=link)


# -------------------------------------------------------------------- costs

TASKS = {
    "ee_reach": [2.0, 2.0, 0.6],
    "push_reach": [3.0, 0.0, 0.6],
    "reposition": [0.5, -0.5],
    "navigation": [1.5, 1.0],
}


def _cost_states(jenv):
    """The three starts and two crafted box-contact poses, each after three
    seeded steps: the base at the hover gate and inside the keep-out."""
    base = jenv.init_state()
    starts = [jax_start(jenv, s) for s in ("base", "bent", "contact")]
    starts += [base.replace(q=base.q.at[0].set(0.62)), base.replace(q=base.q.at[0:2].set(jnp.asarray([0.9, 0.2])))]
    states = _stack(starts)
    rng = np.random.default_rng(2)
    step = jax.jit(jax.vmap(lambda s, u: jalbert.step(jenv.params, s, u)))
    for _ in range(3):
        states = step(states, jnp.asarray(rng.uniform(-1.5, 1.5, size=(len(starts), 13)).astype(np.float32)))
    return states


@pytest.mark.parametrize("task", list(TASKS))
def test_objective_matches_jax_package(scene, task):
    jenv, jcfg, params = scene
    jstates = _cost_states(jenv)
    n = jstates.q.shape[0]
    ref, _ = jax.vmap(JaxObjective(jenv.params, jcfg).compute, in_axes=(0, None, None, None))(
        jstates, jnp.zeros(13), jax_task(task, TASKS[task]), 0
    )
    obj = AlbertObjective(params)
    got, ext = obj.compute(
        convert.albert_state_from_numpy(_leaves(jstates)), torch.zeros(n, 13), make_task_params(task, TASKS[task]), None
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=0)
    assert ext.shape == (n, 0)
    jobj = JaxObjective(jenv.params, jcfg)
    for name in ("contact_r", "approach_r", "hover_gate_r", "clearance_r"):
        assert getattr(obj, name) == getattr(jobj, name), name


# ------------------------------------------------- contact physics (port twin)

def test_box_contact_physics(scene):
    """The port twin of tests/test_albert.py:50-94: driving the base into the
    box moves it continuously (no tunnelling), friction stops it after
    release, and a base heading away leaves it untouched."""
    _, _, params = scene
    state = albert.init_state(params)
    box0 = state.box_pos.clone()
    q = state.q.clone()
    q[0:3] = torch.tensor([float(box0[0]) - 1.0, float(box0[1]), 0.0])
    state = dataclasses.replace(state, q=q)
    u_fwd = torch.zeros(13)
    u_fwd[11:13] = 12.0
    prev_x = float(box0[0])
    for _ in range(60):
        state = albert.step(params, state, u_fwd)
        bx = float(state.box_pos[0])
        assert bx - prev_x < 0.2, "box tunnelled"
        prev_x = bx
    pushed = float(state.box_pos[0] - box0[0])
    assert pushed > 0.3, f"box barely moved: {pushed:.3f}"
    assert abs(float(state.box_pos[1] - box0[1])) < 0.3  # head-on push

    for _ in range(40):
        state = albert.step(params, state, torch.zeros(13))
    assert float(torch.linalg.vector_norm(state.box_vel)) < 1e-2

    away = albert.init_state(params)
    q = away.q.clone()
    q[0:3] = torch.tensor([-2.0, 2.0, float(np.pi)])
    away = dataclasses.replace(away, q=q)
    for _ in range(40):
        away = albert.step(params, away, u_fwd)
    assert torch.allclose(away.box_pos, box0, atol=1e-6)
