"""The least time the H100 could take for each kernel's work, frozen for
the benchmark (a copy of the port's ``analysis/roofline.py`` counts).

A kernel's bound is the larger of the bytes it must move (each input read
once, each output written once) over the card's memory rate and the f32
operations it does over the card's f32 rate outside the tensor cores.  The
peaks are NVIDIA's data sheet for the H100 SXM at its full 700 W: 3.35 TB/s
and 67 TFLOP/s; a share of a bound is stated beside the card's power limit.

Operations are counted from the kernels' sources, each add, multiply,
compare or select, division, square root, sine, cosine and exponential as
one, so the bound is a lower bound.  Where the work depends on the data,
the count is that of the given inputs: the point rollout and the point
step project only their live contacts (counted by the reference's plain
rollout and step on the same inputs), and the weights' beta searches run
the rounds these costs need (the reference's ``beta_rounds``).
"""
from __future__ import annotations

import numpy as np

# H100 SXM data-sheet peaks: device memory rate and f32 rate outside the tensor cores
PEAK_BYTES_S, PEAK_F32_S = 3.35e12, 67e12
CIRCLE_TEST_OPS, CORNER_TEST_OPS = 55, 120  # circle_vs_obb (csrc/pbd2d.cuh), corners_vs_obb (point_rollout.cu)
RESOLVE_OPS = 90  # the projection of one contact or corner (resolve, csrc/pbd2d.cuh)
PANDA_FK_OPS = 330  # seven joints with a sin/cos each, the hand, the fingers (panda_fk.cuh)
# the point step kernel's scene constants (csrc/point_step.cu): its scalars, six a box, seven a static, one an actor
STEP_SCALARS, STEP_DYN_STRIDE, STEP_STAT_STRIDE = 11, 6, 7


def tensor_bytes(*tensors) -> int:
    return sum(x.numel() * x.element_size() for x in tensors)


def bound_ms(n_bytes: float, n_ops: float) -> float:
    """Bytes moved once over the memory rate, or f32 operations over the
    f32 rate, whichever is longer, in ms."""
    return max(n_bytes / PEAK_BYTES_S, n_ops / PEAK_F32_S) * 1e3


def point_step_ops(p, D: int, S: int) -> float:
    """One state's step of the point physics, its contacts' projections
    left out: per position iteration the contact tests of the five Jacobi
    passes (robot vs boxes, box pairs, boxes vs statics, robot vs statics,
    robot vs held boxes) for every contact; per substep the drive, ground
    friction and integration.  K1 runs it each step of each sample, K5
    once a state."""
    per_iter = (
        2 * D * (2 + CIRCLE_TEST_OPS) + D * (D - 1) * (2 + CORNER_TEST_OPS)
        + D * S * (CORNER_TEST_OPS + 10) + S * CIRCLE_TEST_OPS
    )
    return p.substeps * (40 + 40 * D + p.pos_iters * per_iter + 4)


def point_rollout_ops(spec, K: int, live: int) -> float:
    """K1 on K samples: each step's :func:`point_step_ops`, the costs with
    the wall-crush probe, and one projection for each of the ``live``
    contacts (pen > 0)."""
    S = spec.S
    return K * spec.T * (point_step_ops(spec.env_params, spec.D, S) + 150 + 55 * S) + RESOLVE_OPS * live


def point_step_bound_ms(p, state, u, ext, stepped, live: int) -> float:
    """K5 on one state: its scene constants, the state with its friction
    scales, the action and the external forces read once, the stepped state
    and its contact forces written once; :func:`point_step_ops` and one
    projection for each of the ``live`` contacts."""
    D, S = p.dyn_half.shape[0], p.stat_pos.shape[0]
    consts = 4 * (STEP_SCALARS + STEP_DYN_STRIDE * D + STEP_STAT_STRIDE * S + p.num_actors)
    read = tensor_bytes(state.q, state.qd, state.dyn_pos, state.dyn_yaw, state.dyn_vel, state.dyn_om,
                        state.fric_scale, u, ext.robot, ext.dyn)
    written = tensor_bytes(stepped.q, stepped.qd, stepped.dyn_pos, stepped.dyn_yaw, stepped.dyn_vel, stepped.dyn_om,
                           stepped.contact_force)
    return bound_ms(consts + read + written, point_step_ops(p, D, S) + RESOLVE_OPS * live)


def weights_ops(cost, half_K: int, rounds) -> float:
    """K2 on [..., K, T] costs: the cost-to-go, the group minima, each
    group's beta search for the rounds it needs plus the round that finds
    it (``rounds`` [n, 3], from ``beta_rounds``), four operations a sample a
    round, then the normalised weights."""
    K, T = cost.shape[-2:]
    n = cost[..., 0, 0].numel()
    rounds = np.asarray(rounds).reshape(-1, 3)
    sizes = np.asarray([min(half_K, K), K - min(half_K, K), K])
    return n * (2 * K * T + 3 * K + 2 * K * 4) + 4 * float(((rounds + 1) * sizes).sum())


def weights_bound_ms(cost, gamma, half_K: int, rounds) -> float:
    """K2 / K2b: the costs and the discount read, the [..., 3, K] weights
    written, :func:`weights_ops`."""
    return bound_ms(tensor_bytes(cost, gamma) + 3 * cost[..., 0].numel() * 4, weights_ops(cost, half_K, rounds))


def panda_rollout_ops(spec, K: int) -> float:
    """K3: per substep the 9-joint drive, the FK, the grasp test, the cube's
    quaternion, three bodies against the supports and statics, the held
    cube and the seven arm probes; per step the costs."""
    S = spec.S
    bodies = 3 * (28 + 8 * (S + 1) + 57 * S)
    per_sub = 108 + PANDA_FK_OPS + 10 + 35 + bodies + 60 + 7 * 3 * 45 + 55
    return K * spec.T * (spec.env_params.substeps * per_sub + 200)


def rollout_bound_ms(spec, inputs, n_samples: int, n_ops: float) -> float:
    """A rollout kernel: its parameter buffer and ``inputs`` read, the
    [..., K, T] costs and [..., K, T, 2] points of ``n_samples`` samples
    written, ``n_ops`` operations."""
    return bound_ms(tensor_bytes(spec.params_buf, *inputs) + n_samples * spec.T * 3 * 4, n_ops)
