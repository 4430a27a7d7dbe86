"""The panda's real-env step as ONE launch of its CUDA kernel
(``csrc/panda_step.cu``), and the panda env's ``step`` that picks it.

The plain version is ``models/panda_env.step`` itself, unchanged: the CPU,
the plain rollout, the gradient-refinement chains (which differentiate
through it) and the benchmark's reference keep calling it.  The kernel
replaces no TPU kernel (the JAX package's step is XLA code); on the card it
stands in for the plain step's ~1,880 small kernels a tick, bit for bit the
plain step on one state (``tests/test_torch_cuda.py``).

:func:`make_step` gives the env its ``step(state, u, ext)``: the plain step
for a scene off the card, the kernel for a scene on a card.  On a card a
scene beyond the kernel's limits (1 <= S <= 8 statics, the panda rollout
kernel's, and the supports they give) raises.  Any leading batch dims of the
state are one launch, each state stepped as the plain step steps it alone: a
single state (the closed loop) counts in ``panda_step_launches``, a batch
(the seed batch's [B] states) in ``panda_step_batched_launches``.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from m3p2i_aip_tpu_torch.models import panda_env
from m3p2i_aip_tpu_torch.ops import cuda_build
from m3p2i_aip_tpu_torch.ops.panda_rollout import MAX_STAT
from m3p2i_aip_tpu_torch.ops.point_step import _rows

N_SCALARS = 12  # csrc/panda_step.cu enum Scalar
JOINT_STRIDE = 4  # lower, upper, velocity limit, acceleration limit x h
BODY_STRIDE = 6  # half x, y, z, mass, gravity flag, r_eff
STAT_STRIDE = 6  # min x, y, z, max x, y, z
SUP_STRIDE = 5  # min x, y, max x, y, top z
# an actor's force row (csrc/panda_step.cu kRowRobot / kRowDyn / kRowStat)
ROW_NONE, ROW_ROBOT, ROW_DYN, ROW_STAT = -1, 0, 1, 1 + len(panda_env.DYN_NAMES)
# the kernel's operands, in csrc/panda_step.cu's enum Input / enum Output order
INPUTS = ("q", "qd", "body_pos", "body_quat", "body_vel", "body_om", "attached", "attach_pos", "attach_rot", "u",
          "ext_body")
OUTPUTS = ("q", "qd", "body_pos", "body_quat", "body_vel", "body_om", "attached", "attach_pos", "attach_rot",
           "contact_force")

# Number of CUDA kernel launches for one state and for a batch of states
# (CPU calls run the plain step and do not count).
panda_step_launches = 0
panda_step_batched_launches = 0


def check_scene(fn: str, S: int, P: int) -> None:
    """Raise unless the kernel takes a scene of ``S`` statics and ``P``
    supports (the statics' top faces and the ground)."""
    if not (1 <= S <= MAX_STAT and 1 <= P <= MAX_STAT + 1):
        raise ValueError(f"{fn}: scene has S={S}, P={P}; the kernel takes 1 <= S <= {MAX_STAT}, "
                         f"1 <= P <= {MAX_STAT + 1}")


def param_buffer(p: panda_env.PandaEnvParams) -> torch.Tensor:
    """The kernel's scene constants on ``p``'s device (layout: ``enum
    Scalar``, the joint, body, static and support strides and the actor rows
    of ``csrc/panda_step.cu``).  The python floats are formed in double and
    rounded once to float32 as a tensor op rounds them, and a tensor over a
    python scalar takes the scalar's float32 reciprocal; the held finger
    width, the release gap, the bodies' sphere radii and the joints'
    acceleration step are the plain step's own tensor ops on the same device,
    so the kernel reads the values the plain step computes."""
    h = p.dt / p.substeps
    one = np.float32(1.0)
    half_w = p.body_half[1, 0]
    f32 = dict(dtype=torch.float32, device=p.device)
    scalars = torch.tensor([
        h,
        1.0 - float(np.exp(-p.drive_rate * p.dt / p.substeps)),
        float(one / np.float32(h)),
        float(one / np.float32(h * h)),
        p.grasp_range,
        panda_env.GROUND_MU * panda_env.GRAVITY * h,
    ], **f32)
    derived = torch.stack([half_w * 0.96, 2.0 * half_w + 0.005, torch.mean(p.body_half[1])])
    joints = torch.stack([p.joint_lower, p.joint_upper, p.joint_vel_limit, p.joint_accel_limit * h], dim=-1)
    body = torch.cat([p.body_half, p.body_mass[:, None], p.body_gravity[:, None],
                      torch.mean(p.body_half, dim=-1)[:, None]], dim=-1)
    stat = torch.cat([p.stat_min, p.stat_max], dim=-1)
    sup = torch.cat([p.sup_min, p.sup_max, p.sup_z[:, None]], dim=-1)
    rows = [ROW_NONE] * p.num_actors
    rows[p.robot_actor_idx] = ROW_ROBOT
    for k, a in enumerate(p.dyn_actor_idx):
        rows[a] = ROW_DYN + k
    for k, a in enumerate(p.stat_actor_idx):
        rows[a] = ROW_STAT + k
    return torch.cat([scalars, derived, p.base_pos.to(torch.float32), joints.flatten(), body.flatten(),
                      stat.flatten(), sup.flatten(), torch.tensor(rows, **f32)])


def panda_step(params: panda_env.PandaEnvParams, buf: torch.Tensor, state: panda_env.PandaEnvState,
               u: torch.Tensor, ext: panda_env.PandaExtForces) -> panda_env.PandaEnvState:
    """``panda_env.step(params, state, u, ext)`` in ONE launch of the kernel
    on the current stream of the tensors' card, into fresh outputs; ``buf``
    is :func:`param_buffer` on that card.  Raises on what the kernel does not
    take."""
    global panda_step_launches, panda_step_batched_launches
    dev = state.q.device
    if dev.type != "cuda":
        raise ValueError(f"panda_step: unsupported device {dev}")
    S, P, A = params.stat_min.shape[0], params.sup_z.shape[0], params.num_actors
    check_scene("panda_step", S, P)
    lead = tuple(state.q.shape[:-1])
    B = math.prod(lead)
    shapes = {"q": (9,), "qd": (9,), "body_pos": (3, 3), "body_quat": (3, 4), "body_vel": (3, 3),
              "body_om": (3, 3), "attached": (), "attach_pos": (3,), "attach_rot": (3, 3), "u": (9,),
              "ext_body": (3, 3), "contact_force": (A, 3)}
    given = dict(vars(state), u=u, ext_body=ext.body)
    inputs = [_rows(given[name], lead, shapes[name], dev, "panda_step") for name in INPUTS]
    if buf.device != dev or buf.dtype != torch.float32 or buf.dim() != 1:
        raise ValueError(f"panda_step: the param buffer must be a float32 vector on {dev}")
    z = dict(dtype=torch.float32, device=dev)
    out = panda_env.PandaEnvState(**{f: torch.empty(lead + shapes[f], **z) for f in OUTPUTS})
    outputs = [getattr(out, f) for f in OUTPUTS]
    lib = cuda_build.load_kernels()
    with torch.cuda.device(dev):  # the launch goes to the context of the tensors' card
        err = lib.m3p2i_panda_step(
            buf.data_ptr(),
            (ctypes.c_void_p * len(inputs))(*(x.data_ptr() for x, _ in inputs)),
            (ctypes.c_longlong * len(inputs))(*(s for _, s in inputs)),
            (ctypes.c_void_p * len(outputs))(*(x.data_ptr() for x in outputs)),
            B, S, P, A, params.substeps, buf.numel(), torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"panda_step kernel launch failed: cudaError {err}")
    if lead:
        panda_step_batched_launches += 1
    else:
        panda_step_launches += 1
    return out


def make_step(params: panda_env.PandaEnvParams):
    """The panda env's ``step(state, u, ext)``: ``panda_env.step`` for a
    scene off the card; on a card :func:`panda_step`, its param buffer built
    here, once, after raising for a scene the kernel does not take."""
    if params.device.type != "cuda":
        return lambda state, u, ext: panda_env.step(params, state, u, ext)
    check_scene("panda_step", params.stat_min.shape[0], params.sup_z.shape[0])
    buf = param_buffer(params)
    return lambda state, u, ext: panda_step(params, buf, state, u, ext)
