"""Carry the JAX package's parameters and states into the port's types.

Each function takes the JAX pytree as a dict of numpy arrays (its leaves,
e.g. ``{f.name: np.asarray(getattr(x, f.name)) for f in fields(x)}``) plus,
for the params, its static fields, and returns the port's dataclass with
tensors on ``device``.  The port never sees a jax array: whoever calls these
does the ``np.asarray`` on the JAX side.

The state functions are shape-agnostic: the leaves of a JAX batch (the
vmapped states of ``m3p2i_aip_tpu/tamp/batch_loop.py``, every leaf with a
leading seed axis B) become the port's batched states, as
``tamp/batch_loop.py`` holds them.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from m3p2i_aip_tpu_torch.models.albert import AlbertParams, AlbertState
from m3p2i_aip_tpu_torch.models.panda_env import PandaEnvParams, PandaEnvState
from m3p2i_aip_tpu_torch.models.point_env import PointEnvParams, PointEnvState
from m3p2i_aip_tpu_torch.planners.motion_planner.mppi import MPPIState, TaskParams

_INT_FIELDS = {"task_id", "gripper"}


def _tensor(name: str, value, device) -> torch.Tensor:
    dtype = torch.int32 if name in _INT_FIELDS else torch.float32
    return torch.as_tensor(np.array(value), dtype=dtype, device=device)


def _build(cls, arrays: dict, device, static: dict = ()):
    names = {f.name for f in dataclasses.fields(cls)}
    kwargs = {k: _tensor(k, v, device) for k, v in arrays.items() if k in names}
    kwargs.update({k: v for k, v in dict(static).items() if k in names})
    return cls(**kwargs)


def point_env_params_from_numpy(arrays: dict, static: dict, device="cpu") -> PointEnvParams:
    """``PointEnvParams`` from the JAX params' array leaves and static fields."""
    return _build(PointEnvParams, arrays, device, static)


def point_env_state_from_numpy(arrays: dict, device="cpu") -> PointEnvState:
    return _build(PointEnvState, arrays, device)


def panda_env_params_from_numpy(arrays: dict, static: dict, device="cpu") -> PandaEnvParams:
    """``PandaEnvParams`` from the JAX params' array leaves and static fields
    (the drive limits, which the JAX params do not carry, are filled in)."""
    return _build(PandaEnvParams, arrays, device, static)


def panda_env_state_from_numpy(arrays: dict, device="cpu") -> PandaEnvState:
    return _build(PandaEnvState, arrays, device)


def albert_params_from_numpy(arrays: dict, static: dict, device="cpu") -> AlbertParams:
    """``AlbertParams`` from the JAX params' array leaves and static fields."""
    return _build(AlbertParams, arrays, device, static)


def albert_state_from_numpy(arrays: dict, device="cpu") -> AlbertState:
    return _build(AlbertState, arrays, device)


def mppi_state_from_numpy(arrays: dict, device="cpu") -> MPPIState:
    """``MPPIState`` (a single or a [B]-leading batched one), every leaf
    carried: the means and elites, simple mode's ``U``, ``beta`` and the
    three covariances included, so one tick of any mode starts from the JAX
    state.  The JAX PRNG key (``rng``) has no counterpart and is dropped —
    the port's planner draws from its own ``torch.Generator`` (one per seed
    in a batch)."""
    return _build(MPPIState, arrays, device)


def task_params_from_numpy(arrays: dict, device="cpu") -> TaskParams:
    return _build(TaskParams, arrays, device)
