"""The albert MPPI rollout: plain PyTorch version and the wrapper of its CUDA
kernel (``csrc/albert_rollout.cu``).

Port of ``m3p2i_aip_tpu/ops/pallas_albert_rollout.py`` (``_albert_kernel``
:55 and its factory ``make_albert_rollout`` :290).  One call rolls K
13-channel action sequences through T steps of ``models/albert.step`` from
ONE start state, scoring each step with ``AlbertObjective.compute`` and
recording the base's xy.  With a leading seed axis (``sim_state_k`` fields
[B, K, ...], ``acts`` [B, K, T, 13], a batched TaskParams) the same callable
rolls B seeds out in ONE launch of the batched kernel
(``albert_rollout_batched``, the port of the TPU kernel's ``grid=(B,)``
call, ``pallas_albert_rollout.py:425``).

``make_albert_rollout`` returns ``rollout(sim_state_k, acts, task, k0=None)
-> (cost_horizon [K, T], traj_points [K, T, 2])``: ``acts`` arrive already
``u_scale``-scaled and all K states are the broadcast start state.  The
albert is single-mode, so ``k0`` only rides along in the task vector.  The
callable launches on the device of ``acts``, with the scene's constants
copied there once.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from types import SimpleNamespace

import numpy as np
import torch

from m3p2i_aip_tpu_torch.models import albert
from m3p2i_aip_tpu_torch.ops import cuda_build
from m3p2i_aip_tpu_torch.planners.motion_planner.cost_functions import AlbertObjective
from m3p2i_aip_tpu_torch.utils.tree import tree_map

STATE_LEN = 30  # q(12), qd(12), box x, y, yaw, vx, vy, om
TASK_LEN = 5  # task_id, goal x, y, z, k0
N_U = 13
_N_SCALARS = 16  # csrc/albert_rollout.cu N_SCALARS

# Number of CUDA kernel launches made by ``albert_rollout`` and by
# ``albert_rollout_batched`` (CPU calls run the plain versions and do not
# count).
albert_rollout_launches = 0
albert_rollout_batched_launches = 0

# The five start cases that hold the rollout to its references
# (tests/test_pallas.py:748-769): (name, start, task, goal).
PARITY_CASES = (
    ("ee_reach", "base", "ee_reach", (2.0, 2.0, 0.6)),
    ("ee_reach_rotated_base", "bent", "ee_reach", (1.0, -1.5, 0.9)),
    ("push_reach_contact", "contact", "push_reach", (3.0, 0.0, 0.6)),
    ("reposition_keep_out", "contact", "reposition", (0.5, -0.5)),
    ("navigation", "base", "navigation", (1.5, 1.0)),
)


def parity_overrides(start: str, q, qd, box_init) -> dict:
    """The fields a parity ``start`` sets on the scene's init state, as numpy
    arrays, from numpy copies of that state's q, qd and the scene's box_init
    (each package applies them to its own state)."""
    q, qd = np.array(q, dtype=np.float32), np.array(qd, dtype=np.float32)
    if start == "contact":  # base beside the box, driving into it
        q[0] = float(box_init[0]) - 0.56
        qd[0] = 0.8
        return {
            "q": q, "qd": qd,
            "box_vel": np.array([0.1, -0.05], np.float32),
            "box_om": np.float32(0.4),
        }
    if start == "bent":  # arm bent mid-range, base rotated
        q[2], q[4], q[6] = 0.9, -1.2, 0.7
        qd[11] = 0.5
        return {"q": q, "qd": qd}
    if start != "base":
        raise ValueError(f"unknown parity start {start!r}")
    return {}


def parity_state(params: albert.AlbertParams, start: str) -> albert.AlbertState:
    """The port's parity ``start`` state from its scene's init state."""
    base = albert.init_state(params)
    overrides = parity_overrides(start, base.q.cpu().numpy(), base.qd.cpu().numpy(), params.box_init.cpu().numpy())
    return replace(base, **{k: torch.as_tensor(v, device=params.device) for k, v in overrides.items()})


@dataclass
class AlbertRolloutSpec:
    """Everything one scene's rollout needs, built once per scene."""

    env_params: albert.AlbertParams
    objective: AlbertObjective
    K: int
    T: int
    params_buf: torch.Tensor  # [_N_SCALARS] kernel constants, see _param_buffer


def _param_buffer(p: albert.AlbertParams, objective: AlbertObjective) -> np.ndarray:
    """The kernel's constant buffer (layout: ``enum Scalar`` of
    ``csrc/albert_rollout.cu``).  Python scalars (h, the drive decay, the
    wheel geometry, the cost radii) are formed in double and rounded once, as
    the plain version's python-scalar arithmetic is; the box constants are
    formed in float32 by the same tensor expressions ``albert.step`` uses."""
    scalars = np.zeros(_N_SCALARS, np.float32)
    scalars[:6] = [
        p.dt / p.substeps,
        np.exp(-p.drive_rate * p.dt / p.substeps),
        albert.WHEEL_RADIUS,
        albert.WHEEL_BASE,
        1.0 / p.base_mass,
        p.base_radius,
    ]
    if p.has_box:
        half = p.box_half.cpu()
        fric = p.box_friction.cpu()
        scalars[6:13] = [
            float((fric + 1.0) * 0.5),
            float(torch.mean(half)),
            float((0.05 + fric) / 2),
            float(half[0]),
            float(half[1]),
            float(p.box_inv_mass),
            float(p.box_inv_inertia),
        ]
    scalars[13:16] = [objective.approach_r, objective.hover_gate_r, objective.clearance_r]
    return scalars


def pack_state(state: albert.AlbertState) -> torch.Tensor:
    """A start state as the kernel's flat [30] row (``pallas_albert_rollout
    .py:365-389``; one row per seed of a batched state): q(12), qd(12), box
    x, y, yaw, vx, vy, om."""
    return torch.cat(
        [state.q, state.qd, state.box_pos, state.box_yaw[..., None], state.box_vel, state.box_om[..., None]],
        dim=-1,
    )


def unpack_state(state0: torch.Tensor, K: int) -> albert.AlbertState:
    """The K broadcast states of a packed row [30], or the K states of K
    packed rows [K, 30]."""
    lead = state0.shape[:-1]

    def rows(a: int, b: int, shape=()):
        return state0[..., a:b].reshape(lead + shape).expand((K,) + shape)

    return albert.AlbertState(
        q=rows(0, 12, (12,)),
        qd=rows(12, 24, (12,)),
        box_pos=rows(24, 26, (2,)),
        box_yaw=rows(26, 27),
        box_vel=rows(27, 29, (2,)),
        box_om=rows(29, 30),
    )


def rollout_inputs(sim_state_k, task, k0=None):
    """(task_vec [5], state0 [30]) of the kernel from the broadcast rollout
    states, the TaskParams and the global sample offset ``k0``, or, for
    states and a task with a leading seed axis, [B, 5] and [B, 30].
    task_vec = [task_id, goal x, y, z, k0]."""
    nb = sim_state_k.q.dim() - 2  # the seed dims in front of the K axis
    state0 = pack_state(tree_map(lambda x: x.select(nb, 0), sim_state_k))
    lead = state0.shape[:-1]
    k0v = torch.full(lead + (1,), 0.0 if k0 is None else float(k0), dtype=torch.float32, device=state0.device)
    task_vec = torch.cat(
        [task.task_id.to(torch.float32)[..., None], task.goal[..., :3].to(torch.float32), k0v], dim=-1
    )
    return task_vec, state0


def albert_rollout_plain(spec: AlbertRolloutSpec, task_vec, state0, acts):
    """The rollout as plain tensor code: a loop over T of the batched
    ``albert.step`` and ``AlbertObjective.compute`` (the EE from
    ``albert.fk``).  ``task_vec`` [5] and ``state0`` [30] as
    :func:`rollout_inputs` makes them; ``acts`` [K, T, 13]."""
    p = spec.env_params
    state = unpack_state(state0, acts.shape[0])
    task = SimpleNamespace(task_id=task_vec[..., 0], goal=task_vec[..., 1:4])
    costs, points = [], []
    for t in range(spec.T):
        u_t = acts[:, t]
        state = albert.step(p, state, u_t)
        ee = albert.fk(state)["ee"][0]
        cost, _ = spec.objective.compute(state, u_t, task, None, ee_pos=ee)
        costs.append(cost)
        points.append(state.q[:, :2])
    return torch.stack(costs, dim=1), torch.stack(points, dim=1)


def _check_batch(fn: str, spec: AlbertRolloutSpec, task_vec, state0, acts) -> None:
    """Raise unless B seeds' inputs have the kernel's shapes and are
    contiguous float32 tensors on one device."""
    if acts.dim() != 4:
        raise ValueError(f"{fn}: acts has shape {tuple(acts.shape)}, expected [B, K, T, {N_U}]")
    B, K = acts.shape[:2]
    expect = {
        "task_vec": (task_vec, (B, TASK_LEN)),
        "state0": (state0, (B, STATE_LEN)),
        "acts": (acts, (B, K, spec.T, N_U)),
        "params_buf": (spec.params_buf, (_N_SCALARS,)),
    }
    for name, (x, shape) in expect.items():
        if tuple(x.shape) != shape:
            raise ValueError(f"{fn}: {name} has shape {tuple(x.shape)}, expected {shape}")
        if x.dtype != torch.float32 or not x.is_contiguous() or x.device != acts.device:
            raise ValueError(f"{fn}: {name} must be contiguous float32 on {acts.device}")


def _launch(fn: str, spec: AlbertRolloutSpec, task_vec, state0, acts):
    """ONE launch of the kernel on the current stream for B seeds' inputs
    (the seed on the grid's y axis); raises on anything it does not take."""
    if acts.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {acts.device}")
    _check_batch(fn, spec, task_vec, state0, acts)
    B, K = acts.shape[:2]
    cost = torch.empty(B, K, spec.T, dtype=torch.float32, device=acts.device)
    traj = torch.empty(B, K, spec.T, 2, dtype=torch.float32, device=acts.device)
    lib = cuda_build.load_kernels()
    with torch.cuda.device(acts.device):  # the launch goes to the context of the tensors' card
        err = lib.m3p2i_albert_rollout(
            spec.params_buf.data_ptr(), task_vec.data_ptr(), state0.data_ptr(), acts.data_ptr(),
            cost.data_ptr(), traj.data_ptr(), B, K, spec.T, spec.env_params.substeps,
            int(spec.env_params.has_box), spec.params_buf.numel(),
            torch.cuda.current_stream(acts.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"{fn} kernel launch failed: cudaError {err}")
    return cost, traj


def albert_rollout(spec: AlbertRolloutSpec, task_vec, state0, acts):
    """The rollout of ``acts`` [K, T, 13] from ``state0``.

    A CPU tensor runs :func:`albert_rollout_plain`; a CUDA tensor launches
    the kernel on the current stream (a team of warp lanes per sample; the batched
    kernel's body with one seed) or raises.
    """
    global albert_rollout_launches
    if acts.device.type == "cpu":
        return albert_rollout_plain(spec, task_vec, state0, acts)
    cost, traj = _launch("albert_rollout", spec, task_vec[None], state0[None], acts[None])
    albert_rollout_launches += 1
    return cost[0], traj[0]


def albert_rollout_batched_plain(spec: AlbertRolloutSpec, task_vec, state0, acts):
    """B seeds' rollouts as plain tensor code: :func:`albert_rollout_plain`
    per seed, stacked.  ``task_vec`` [B, 5], ``state0`` [B, 30], ``acts``
    [B, K, T, 13]."""
    outs = [albert_rollout_plain(spec, *args) for args in zip(task_vec, state0, acts)]
    return torch.stack([c for c, _ in outs]), torch.stack([t for _, t in outs])


def albert_rollout_batched(spec: AlbertRolloutSpec, task_vec, state0, acts):
    """The rollouts of B seeds' ``acts`` [B, K, T, 13] from their own
    ``state0`` [B, 30] and tasks [B, 5].

    The inputs are checked on either device; then a CPU tensor runs
    :func:`albert_rollout_batched_plain` and a CUDA tensor launches the
    kernel ONCE for the whole batch or raises.
    """
    global albert_rollout_batched_launches
    if acts.device.type == "cpu":
        _check_batch("albert_rollout_batched", spec, task_vec, state0, acts)
        return albert_rollout_batched_plain(spec, task_vec, state0, acts)
    cost, traj = _launch("albert_rollout_batched", spec, task_vec, state0, acts)
    albert_rollout_batched_launches += 1
    return cost, traj


def make_albert_rollout(env_params: albert.AlbertParams, objective: AlbertObjective, K: int, T: int):
    """The rollout callable of an albert scene (see module docstring).
    ``objective`` supplies the contact-envelope radii, so the kernel's and the
    plain version's costs share them."""
    spec = AlbertRolloutSpec(
        env_params=env_params,
        objective=objective,
        K=int(K),
        T=int(T),
        params_buf=torch.as_tensor(_param_buffer(env_params, objective), device=env_params.device),
    )

    on_device = {spec.params_buf.device: spec}  # the spec with its constants on each device a shard runs on

    def rollout(sim_state_k, acts, task, k0=None):
        if acts.device not in on_device:
            on_device[acts.device] = replace(spec, params_buf=spec.params_buf.to(acts.device))
        wrapper = albert_rollout_batched if acts.dim() == 4 else albert_rollout  # a leading seed axis?
        return wrapper(on_device[acts.device], *rollout_inputs(sim_state_k, task, k0), acts.contiguous())

    def chain(sim_state_k, acts, task, mode):
        """The plain rollout's costs [N, T] of N sequences ``acts`` [N, T, 13]
        from the start state of ``sim_state_k`` (the albert's costs take no
        mode): the differentiable chain of gradient refinement (no kernel
        has a backward).  A seed batch's B x N sequences [B, N, T, 13] run as
        one plain rollout, each row with its seed's start state and task."""
        task_vec, state0 = rollout_inputs(sim_state_k, task)
        if acts.dim() == 3:
            return albert_rollout_plain(spec, task_vec, state0, acts)[0]
        B, N = acts.shape[:2]
        rows = lambda x: x.repeat_interleave(N, dim=0)  # noqa: E731 (row b N + n takes seed b's)
        return albert_rollout_plain(spec, rows(task_vec), rows(state0), acts.flatten(0, 1))[0].unflatten(0, (B, N))

    rollout.spec = spec
    rollout.chain = chain
    return rollout
