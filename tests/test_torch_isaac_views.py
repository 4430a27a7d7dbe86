"""The Isaac-layout views and loaders of every family against the JAX package.

The two-terminal workflow carries one real state over RPC as the reference's
Isaac tensors: an interleaved dof state ``[q0, qd0, q1, qd1, ...]`` and a
root state ``[A, 13]`` (position, quaternion, linear and angular velocity
per actor).  For the point, heijn, boxer, panda and albert scenes, the
port's ``dof_state_view``, ``root_state_view``, ``load_dof_state`` and
``load_root_state`` equal the JAX package's on the same seeded state.  The
point family's root rows carry each box's yaw as a quaternion, so loading a
root goes yaw -> quaternion -> yaw, which float32 does not round-trip
exactly; it is held against the JAX package's round trip.
"""
import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from m3p2i_aip_tpu.config.config_store import load_config as jax_load_config
from m3p2i_aip_tpu.envs import make_env as jax_make_env
from m3p2i_aip_tpu.ops import quat as jax_quat
from m3p2i_aip_tpu_torch.config.config_store import load_config
from m3p2i_aip_tpu_torch.envs import make_env
from m3p2i_aip_tpu_torch.ops import quat

CONFIGS = ["config_point", "config_heijn", "config_boxer", "config_panda", "config_albert"]
NX = {"config_point": 4, "config_heijn": 6, "config_boxer": 6, "config_panda": 18, "config_albert": 24}
VIEW_ATOL = 1e-6  # copies of the state, and sin / cos / atan2 of one float32 in two libraries


@functools.lru_cache(maxsize=None)
def _envs(config_name: str):
    return jax_make_env(jax_load_config(config_name)), make_env(load_config(config_name), device="cpu")


def _seeded_states(config_name: str, seed: int = 0):
    """One random state of the scene, as a JAX state and the port's."""
    jenv, penv = _envs(config_name)
    jstate, pstate = jenv.init_state(), penv.init_state()
    rng = np.random.default_rng(seed)
    leaves = {}
    for f in dataclasses.fields(pstate):
        shape = tuple(getattr(pstate, f.name).shape)
        leaves[f.name] = rng.uniform(-np.pi, np.pi, size=shape).astype(np.float32)
    jstate = jstate.replace(**{k: jnp.asarray(v) for k, v in leaves.items()})
    pstate = dataclasses.replace(pstate, **{k: torch.as_tensor(v) for k, v in leaves.items()})
    return jstate, pstate


def _close(got: torch.Tensor, ref, atol: float = VIEW_ATOL, name: str = "") -> None:
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=atol, rtol=0, err_msg=name)


@pytest.mark.parametrize("config_name", CONFIGS)
def test_views_match_jax_package(config_name):
    jenv, penv = _envs(config_name)
    jstate, pstate = _seeded_states(config_name)
    assert penv.nx == jenv.nx == NX[config_name]
    dof = penv.dof_state_view(pstate)
    assert dof.shape == (NX[config_name],)
    _close(dof, jenv.dof_state_view(jstate), 0.0, "dof_state_view")
    root = penv.root_state_view(pstate)
    assert root.shape[-1] == 13
    _close(root, jenv.root_state_view(jstate), VIEW_ATOL, "root_state_view")


@pytest.mark.parametrize("config_name", CONFIGS)
def test_loaders_match_jax_package(config_name):
    """Each package loads the same dof and root tensors (the JAX package's
    views of another seeded state) into its init state."""
    jenv, penv = _envs(config_name)
    jsrc, _ = _seeded_states(config_name, seed=1)
    dof, root = np.array(jenv.dof_state_view(jsrc)), np.array(jenv.root_state_view(jsrc))
    jstate = jenv.load_root_state(jenv.load_dof_state(jenv.init_state(), jnp.asarray(dof)), jnp.asarray(root))
    pstate = penv.load_root_state(penv.load_dof_state(penv.init_state(), torch.as_tensor(dof)), torch.as_tensor(root))
    for f in dataclasses.fields(pstate):
        ref = getattr(jstate, f.name)
        if ref is not None:
            _close(getattr(pstate, f.name), ref, VIEW_ATOL, f.name)
    # the dofs and what the root carries round-trip through the port's views
    _close(penv.dof_state_view(pstate), dof, 0.0, "dof round trip")
    _close(penv.root_state_view(pstate), jenv.root_state_view(jstate), VIEW_ATOL, "root round trip")


def test_albert_root_is_the_constant_identity():
    """The albert's base moves in its dofs: its root view is one constant
    identity row and loading a root leaves the state as it was
    (``m3p2i_aip_tpu/envs.py:205-208``)."""
    _, penv = _envs("config_albert")
    _, pstate = _seeded_states("config_albert")
    root = penv.root_state_view(pstate)
    assert root.tolist() == [[0.0] * 6 + [1.0] + [0.0] * 6]
    assert penv.load_root_state(pstate, torch.ones(1, 13)) is pstate


def test_yaw_quaternion_round_trip_matches_jax_package():
    """quat_from_yaw / yaw_from_quat against the JAX package's on yaws over
    the whole circle: each within 1e-6, and the round trip within 1e-6 of
    the JAX round trip (neither is the identity in float32)."""
    yaw = np.linspace(-np.pi, np.pi, 2001, dtype=np.float32)
    q = quat.quat_from_yaw(torch.as_tensor(yaw))
    _close(q, jax_quat.quat_from_yaw(jnp.asarray(yaw)), VIEW_ATOL, "quat_from_yaw")
    _close(quat.yaw_from_quat(q), jax_quat.yaw_from_quat(jax_quat.quat_from_yaw(jnp.asarray(yaw))), VIEW_ATOL)
    inner = np.abs(yaw) < np.pi - 1e-3  # away from the +-pi seam, the round trip stays near the identity
    np.testing.assert_allclose(quat.yaw_from_quat(q).numpy()[inner], yaw[inner], atol=1e-5, rtol=0)
