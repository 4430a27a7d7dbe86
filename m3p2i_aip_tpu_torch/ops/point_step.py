"""The point family's real-env step as ONE launch of its CUDA kernel
(``csrc/point_step.cu``), and the point env's ``step`` that picks it.

The plain version is ``models/point_env.step`` itself, unchanged: the CPU,
the plain rollout, the gradient-refinement chains (which differentiate
through it) and the benchmark's reference keep calling it.  The kernel
replaces no TPU kernel (the JAX package's step is XLA code); on the card it
stands in for the plain step's ~4,600 small kernels a tick, bit for bit
(``tests/test_torch_cuda.py``).

:func:`make_step` gives the env its ``step(state, u, ext)``: the plain step
for a scene off the card, the kernel for a scene on a card.  On a card a
scene beyond the kernel's limits (1 <= D <= 4 dynamic and 1 <= S <= 16
static boxes, the point rollout kernel's: ``rollout.check_scene``) raises,
as the rollout kernel does.  Any leading batch dims of the state are one launch: a single state
(the closed loop) counts in ``step_launches``, a batch (the seed batch's
[B] states) in ``step_batched_launches``.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from m3p2i_aip_tpu_torch.models import point_env
from m3p2i_aip_tpu_torch.ops import cuda_build
from m3p2i_aip_tpu_torch.ops.rollout import MAX_DYN, check_scene

N_SCALARS = 11  # csrc/point_step.cu enum Scalar
DYN_STRIDE = 6  # hx, hy, inv_mass, inv_inertia, ang_rad, friction
STAT_STRIDE = 7  # x, y, cos, sin, hx, hy, friction
# an actor's force row (csrc/point_step.cu kRowRobot / kRowDyn / kRowStat)
ROW_NONE, ROW_ROBOT, ROW_DYN, ROW_STAT = -1, 0, 1, 1 + MAX_DYN
_ROBOT_TYPES = {"point": 0, "heijn": 1, "boxer": 2}
# the kernel's operands, in csrc/point_step.cu's enum Input / enum Output order
INPUTS = ("q", "qd", "dyn_pos", "dyn_yaw", "dyn_vel", "dyn_om", "fric_scale", "u", "ext_robot", "ext_dyn")
OUTPUTS = ("q", "qd", "dyn_pos", "dyn_yaw", "dyn_vel", "dyn_om", "contact_force")

# Number of CUDA kernel launches for one state and for a batch of states
# (CPU calls run the plain step and do not count).
step_launches = 0
step_batched_launches = 0


def param_buffer(p: point_env.PointEnvParams) -> torch.Tensor:
    """The kernel's scene constants on ``p``'s device (layout: ``enum
    Scalar``, the dyn / static strides and the actor rows of
    ``csrc/point_step.cu``).  The scalars are the plain step's python
    floats, formed in double and rounded once to float32 as a tensor op
    rounds them; each box's angular radius and each static's cos / sin are
    the plain step's own tensor ops on the same device, so the kernel reads
    the values the plain step computes."""
    h = p.dt / p.substeps
    wm_r = 1.0 / p.robot_mass
    scalars = [
        h,
        float(np.exp(-p.drive_rate * p.dt / p.substeps)),
        wm_r * h,
        wm_r,
        p.robot_radius,
        p.robot_friction,
        p.max_dyn_speed,
        p.arena_bound,
        p.arena_bound - p.robot_radius,
        p.wheel_radius,
        p.wheel_base,
    ]
    dyn = torch.stack(
        [p.dyn_half[:, 0], p.dyn_half[:, 1], p.dyn_inv_mass, p.dyn_inv_inertia, torch.mean(p.dyn_half, dim=-1),
         p.dyn_friction],
        dim=-1,
    )
    stat = torch.stack(
        [p.stat_pos[:, 0], p.stat_pos[:, 1], torch.cos(p.stat_yaw), torch.sin(p.stat_yaw), p.stat_half[:, 0],
         p.stat_half[:, 1], p.stat_friction],
        dim=-1,
    )
    rows = [ROW_NONE] * p.num_actors
    rows[p.robot_actor_idx] = ROW_ROBOT
    for k, a in enumerate(p.dyn_actor_idx):
        rows[a] = ROW_DYN + k
    for k, a in enumerate(p.stat_actor_idx):
        rows[a] = ROW_STAT + k
    f32 = dict(dtype=torch.float32, device=p.device)
    return torch.cat([torch.tensor(scalars, **f32), dyn.flatten(), stat.flatten(), torch.tensor(rows, **f32)])


def _rows(x: torch.Tensor, lead: tuple, tail: tuple, device: torch.device, who: str = "point_step"):
    """``x`` broadcast to ``lead + tail`` as one row a state: (tensor, the
    floats between two states' rows).  A view where the lead dims have one
    stride and each row is contiguous (a strided action row, a broadcast
    input: stride 0), else a copy.  ``who`` names the caller in the error."""
    if x.dtype != torch.float32 or x.device != device:
        raise ValueError(f"{who}: every tensor must be float32 on {device}, got {x.dtype} on {x.device}")
    r = x.expand(lead + tail).reshape(-1, math.prod(tail))
    if r.shape[1] > 1 and r.stride(1) != 1:
        r = r.contiguous()
    return r, r.stride(0)


def point_step(params: point_env.PointEnvParams, buf: torch.Tensor, state: point_env.PointEnvState,
               u: torch.Tensor, ext: point_env.PointExtForces) -> point_env.PointEnvState:
    """``point_env.step(params, state, u, ext)`` in ONE launch of the kernel
    on the current stream of the tensors' card, into fresh outputs;
    ``buf`` is :func:`param_buffer` on that card.  Raises on what the
    kernel does not take."""
    global step_launches, step_batched_launches
    dev = state.q.device
    if dev.type != "cuda":
        raise ValueError(f"point_step: unsupported device {dev}")
    D, A = params.dyn_half.shape[0], params.num_actors
    check_scene("point_step", D, params.stat_pos.shape[0])
    n_q, n_u = point_env.robot_nq(params), point_env.robot_nu(params)
    lead = tuple(state.q.shape[:-1])
    B = math.prod(lead)
    shapes = {"q": (n_q,), "qd": (n_q,), "dyn_pos": (D, 2), "dyn_yaw": (D,), "dyn_vel": (D, 2), "dyn_om": (D,),
              "fric_scale": (D,), "u": (n_u,), "ext_robot": (2,), "ext_dyn": (D, 2), "contact_force": (A, 3)}
    given = dict(vars(state), u=u, ext_robot=ext.robot, ext_dyn=ext.dyn)
    inputs = [_rows(given[name], lead, shapes[name], dev) for name in INPUTS]
    if buf.device != dev or buf.dtype != torch.float32 or buf.dim() != 1:
        raise ValueError(f"point_step: the param buffer must be a float32 vector on {dev}")
    z = dict(dtype=torch.float32, device=dev)
    out = point_env.PointEnvState(**{f: torch.empty(*lead, *shapes[f], **z) for f in OUTPUTS},
                                  fric_scale=state.fric_scale)
    outputs = [getattr(out, f) for f in OUTPUTS]
    lib = cuda_build.load_kernels()
    with torch.cuda.device(dev):  # the launch goes to the context of the tensors' card
        err = lib.m3p2i_point_step(
            buf.data_ptr(),
            (ctypes.c_void_p * len(inputs))(*(x.data_ptr() for x, _ in inputs)),
            (ctypes.c_longlong * len(inputs))(*(s for _, s in inputs)),
            (ctypes.c_void_p * len(outputs))(*(x.data_ptr() for x in outputs)),
            B, D, params.stat_pos.shape[0], A, params.substeps, params.pos_iters,
            _ROBOT_TYPES[params.robot_type], n_q, n_u, buf.numel(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"point_step kernel launch failed: cudaError {err}")
    if lead:
        step_batched_launches += 1
    else:
        step_launches += 1
    return out


def make_step(params: point_env.PointEnvParams):
    """The point env's ``step(state, u, ext)``: ``point_env.step`` for a
    scene off the card; on a card :func:`point_step`, its param buffer built
    here, once, after raising for a scene the kernel does not take."""
    if params.device.type != "cuda":
        return lambda state, u, ext: point_env.step(params, state, u, ext)
    check_scene("point_step", params.dyn_half.shape[0], params.stat_pos.shape[0])
    buf = param_buffer(params)
    return lambda state, u, ext: point_step(params, buf, state, u, ext)
