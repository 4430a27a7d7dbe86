"""The least time the H100 could take for each kernel's work: bytes and f32
operations counted from the kernels' code at a call's shapes.

A kernel's bound is the larger of the bytes it must move (each input read
once, each output written once) over the card's memory rate and the f32
operations it does over the card's f32 rate outside the tensor cores.  The
peaks are NVIDIA's data sheet for the H100 SXM at its full 700 W: 3.35 TB/s
and 67 TFLOP/s.  A card set to a lower power limit runs slower under load,
so a bound is stated beside the card's limit.

Operations are counted from the CUDA sources, each add, multiply, compare or
select, division, square root, sine, cosine and exponential as one, so the
bound is a lower bound (a transcendental costs the card more).  Where the
work depends on the data, the count is that of the given inputs: the point
rollout projects only its live contacts (:func:`live_contacts`), and the
weights' beta searches run the rounds these costs need
(``weights.beta_rounds``).
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

# H100 SXM data-sheet peaks: device memory rate and f32 rate outside the tensor cores
PEAK_BYTES_S, PEAK_F32_S = 3.35e12, 67e12
CIRCLE_TEST_OPS, CORNER_TEST_OPS = 55, 120  # circle_vs_obb (csrc/pbd2d.cuh), corners_vs_obb (point_rollout.cu)
RESOLVE_OPS = 90  # the projection of one contact or corner (resolve, csrc/pbd2d.cuh)
CIRCLE_CONTACT_OPS = CIRCLE_TEST_OPS + RESOLVE_OPS  # a contact the albert kernel always projects
PANDA_FK_OPS = 330  # seven joints with a sin/cos each, the hand, the fingers (panda_fk.cuh)


def tensor_bytes(*tensors) -> int:
    return sum(x.numel() * x.element_size() for x in tensors)


def bound(n_bytes: float, n_ops: float) -> dict:
    """{"bound_ms", "bound_by"}: bytes moved once over the memory rate, or
    f32 operations over the f32 rate, whichever is longer."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES_S, n_ops / PEAK_F32_S
    return {"bound_ms": max(t_bytes, t_ops) * 1e3, "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


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
    contacts (pen > 0, counted by :func:`live_contacts` on the same
    inputs), since a contact that is not live projects to zero and needs no
    projection."""
    S = spec.S
    return K * spec.T * (point_step_ops(spec.env_params, spec.D, S) + 150 + 55 * S) + RESOLVE_OPS * live


@contextlib.contextmanager
def live_contacts():
    """Inside the block, each contact that the plain point rollout projects
    live (pen > 0: a robot-circle contact or one corner of a box) is
    counted; the yielded list holds one device count per projection call
    (:func:`total` sums them)."""
    from m3p2i_aip_tpu_torch.sim import pbd2d

    resolve, live = pbd2d.resolve_contact, []

    def counted(contact, *args, **kwargs):
        live.append(torch.count_nonzero(contact.pen > 0))
        return resolve(contact, *args, **kwargs)

    pbd2d.resolve_contact = counted
    try:
        yield live
    finally:
        pbd2d.resolve_contact = resolve


def total(live: list) -> int:
    return int(torch.stack(live).sum()) if live else 0


def weights_ops(args) -> float:
    """K2 on the [..., K, T] costs of ``args`` (cost, gamma, half_K, eta_u,
    eta_l): the cost-to-go, the group minima, each group's beta search for
    the rounds it needs (``weights.beta_rounds``, the plain version's round
    by round; the kernel stops each group at its own first round inside
    [eta_l, eta_u]) plus the round that finds it there, four operations a
    sample a round (the shift, the division, the exponential, the add), then
    the normalised weights."""
    from m3p2i_aip_tpu_torch.ops import weights

    cost, _, half_K = args[:3]
    K, T = cost.shape[-2:]
    n = cost[..., 0, 0].numel()
    rounds = weights.beta_rounds(*args)[0].reshape(-1, 3)
    sizes = np.asarray([min(half_K, K), K - min(half_K, K), K])
    return n * (2 * K * T + 3 * K + 2 * K * 4) + 4 * float(((rounds + 1) * sizes).sum())


def weights_bound(args) -> dict:
    """K2 / K2b's bound on ``args``: the costs and the discount read, the
    [..., 3, K] weights written, :func:`weights_ops`."""
    cost, gamma = args[:2]
    return bound(tensor_bytes(cost, gamma) + 3 * cost[..., 0].numel() * 4, weights_ops(args))


def panda_rollout_ops(spec, K: int) -> float:
    """K3: per substep the 9-joint drive, the FK, the grasp test, the cube's
    quaternion, three bodies against the supports and statics, the held cube,
    and the seven arm probes against the table, shelf and cubeB; per step the
    costs."""
    S = spec.S
    bodies = 3 * (28 + 8 * (S + 1) + 57 * S)
    per_sub = 108 + PANDA_FK_OPS + 10 + 35 + bodies + 60 + 7 * 3 * 45 + 55
    return K * spec.T * (spec.env_params.substeps * per_sub + 200)


def panda_step_ops(p, S: int) -> float:
    """One state's panda step (K6): per substep the 9-joint drive, the FK
    with its 3x3 products, the grasp test, three bodies' gravity,
    integration, quaternion, support search and settling, their pushout
    against the S statics, the held cube, the seven probes against the S
    statics and cubeB and cubeA against cubeB, and the force sums."""
    bodies = 3 * (28 + 30 + 8 * (S + 1) + 57 * S)
    per_sub = 108 + PANDA_FK_OPS + 10 + 35 + bodies + 60 + 7 * (S + 1) * 45 + 55 + 12 * S
    return p.substeps * per_sub + 3 * p.num_actors


def albert_rollout_ops(spec, K: int) -> float:
    """K4: per substep the base and arm drive with the clip, and with a box
    its ground friction, integration and two base-vs-box contact passes; per
    step the base-composed FK and the costs."""
    per_sub = 87 + (26 + 2 * (2 + CIRCLE_CONTACT_OPS) if spec.env_params.has_box else 0)
    return K * spec.T * (spec.env_params.substeps * per_sub + 2 + PANDA_FK_OPS + 60)


def rollout_bound(spec, inputs, n_samples: int, n_ops: float) -> dict:
    """A rollout kernel's bound: its parameter buffer and ``inputs`` (the
    actions last) read, the [..., K, T] costs and [..., K, T, 2] trajectory
    points of ``n_samples`` samples written, ``n_ops`` operations."""
    return bound(tensor_bytes(spec.params_buf, *inputs) + n_samples * spec.T * 3 * 4, n_ops)
