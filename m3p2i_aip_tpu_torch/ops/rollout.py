"""The point-family MPPI rollout: plain PyTorch version and the wrapper of
its CUDA kernel (``csrc/point_rollout.cu``).

Port of ``m3p2i_aip_tpu/ops/pallas_rollout.py`` (``_rollout_kernel`` and its
factory ``make_point_rollout``).  One call rolls K action sequences through T
steps of ``models/point_env.step`` from ONE start state, scoring each step
with ``PointObjective.compute`` and carrying the pull cost's suction force
into the next step.

``make_point_rollout`` keeps the JAX factory's signature and returns
``rollout(sim_state_k, acts, task, k0=None) -> (cost_horizon [K, T],
traj_points [K, T, 2])``: ``acts`` arrive already ``u_scale``-scaled, all K
states are the broadcast start state except their ``fric_scale`` rows, and
``k0`` is the global index of the first sample (a shard of a mesh,
``parallel/mesh.py``, keeps the mode assignment by global index).  The
callable launches on the device of ``acts``, with the scene's constants
copied there once.

With a leading seed axis (``sim_state_k`` fields [B, K, ...], ``acts``
[B, K, T, n_u], a batched TaskParams) the same callable rolls B seeds out in
ONE launch of the batched kernel (``point_rollout_batched``, the port of
the TPU kernel's ``grid=(B,)`` call, ``pallas_rollout.py:802``) and returns
[B, K, T] costs and [B, K, T, 2] points.  The seed-batch runner shards
seeds, not K, so it leaves ``k0`` at 0 for every seed.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from types import SimpleNamespace

import numpy as np
import torch

from m3p2i_aip_tpu_torch.models import point_env
from m3p2i_aip_tpu_torch.ops import cuda_build
from m3p2i_aip_tpu_torch.planners.motion_planner.cost_functions import PointObjective
from m3p2i_aip_tpu_torch.utils.tree import tree_map

# compile-time maxima of the kernel (csrc/point_rollout.cu kMaxD / kMaxS)
MAX_DYN = 4
MAX_STAT = 16
_N_SCALARS = 16  # csrc/point_rollout.cu N_SCALARS
_ROBOT_TYPES = {"point": 0, "heijn": 1, "boxer": 2}

# Number of CUDA kernel launches made by ``point_rollout`` and by
# ``point_rollout_batched`` (CPU calls run the plain versions and do not
# count).
rollout_launches = 0
rollout_batched_launches = 0


@dataclass
class RolloutSpec:
    """Everything one scene's rollout needs, built once per scene."""

    env_params: point_env.PointEnvParams
    objective: PointObjective
    K: int  # total sample count (the mode split is K // 2)
    T: int
    n_q: int
    n_u: int
    box_slot: int
    dynobs_slot: int
    multi_modal: bool
    boxer_continuous_align: bool
    params_buf: torch.Tensor  # [N_SCALARS + 6 D + 7 S] kernel constants

    @property
    def D(self) -> int:
        return int(self.env_params.dyn_half.shape[0])

    @property
    def S(self) -> int:
        return int(self.env_params.stat_pos.shape[0])


def _param_buffer(p: point_env.PointEnvParams, kp_suction: float, box_slot: int) -> np.ndarray:
    """The kernel's constant buffer (layout: ``enum Scalar`` and the dyn /
    static strides of ``csrc/point_rollout.cu``).  Products and differences
    of python scalars are formed in double and rounded once, as the JAX
    package forms them at trace time."""
    half = p.dyn_half.cpu().numpy()
    h = p.dt / p.substeps
    wm_r = 1.0 / p.robot_mass
    rr = p.robot_radius
    scalars = np.zeros(_N_SCALARS, np.float64)
    scalars[:14] = [
        h,
        np.exp(-p.drive_rate * p.dt / p.substeps),
        wm_r * h,
        wm_r,
        rr,
        p.robot_friction,
        p.max_dyn_speed,
        kp_suction,
        p.arena_bound,
        p.arena_bound - rr,
        p.arena_bound - rr - 0.05,
        p.arena_bound - (2.0 * rr + float(half[box_slot, 0])),
        p.wheel_radius,
        p.wheel_base,
    ]
    dyn = np.stack(
        [
            half[:, 0],
            half[:, 1],
            p.dyn_inv_mass.cpu().numpy(),
            p.dyn_inv_inertia.cpu().numpy(),
            np.mean(half, axis=-1),
            p.dyn_friction.cpu().numpy(),
        ],
        axis=-1,
    ).astype(np.float32)
    yaw = p.stat_yaw.cpu().numpy().astype(np.float64)
    stat = np.concatenate(
        [
            p.stat_pos.cpu().numpy(),
            np.cos(yaw)[:, None],
            np.sin(yaw)[:, None],
            p.stat_half.cpu().numpy(),
            p.stat_friction.cpu().numpy()[:, None],
        ],
        axis=-1,
    ).astype(np.float32)
    return np.concatenate([scalars.astype(np.float32), dyn.reshape(-1), stat.reshape(-1)])


def pack_state(state: point_env.PointEnvState) -> torch.Tensor:
    """A start state as the kernel's flat row: q, qd, dyn_pos (x0, y0, x1,
    ...), dyn_yaw, dyn_vel, dyn_om (one row per seed of a batched state)."""
    return torch.cat(
        [
            state.q, state.qd, state.dyn_pos.flatten(-2), state.dyn_yaw,
            state.dyn_vel.flatten(-2), state.dyn_om,
        ],
        dim=-1,
    )


def rollout_inputs(sim_state_k, task, k0=None):
    """(task_vec, state0, fric_k) of the kernel from the broadcast rollout
    states, the TaskParams and the global sample offset ``k0``: [4],
    [n_state] and [K, D], or, for states and a task with a leading seed
    axis, [B, 4], [B, n_state] and [B, K, D]."""
    nb = sim_state_k.q.dim() - 2  # the seed dims in front of the K axis
    state0 = pack_state(tree_map(lambda x: x.select(nb, 0), sim_state_k))
    lead = state0.shape[:-1]
    k0v = torch.full(lead + (1,), 0.0 if k0 is None else float(k0), dtype=torch.float32, device=state0.device)
    task_vec = torch.cat([task.task_id.to(torch.float32)[..., None], task.goal[..., :2], k0v], dim=-1)
    fric_k = sim_state_k.fric_scale.to(torch.float32).contiguous()
    return task_vec, state0, fric_k


def point_rollout_plain(spec: RolloutSpec, task_vec, state0, fric_k, acts, mode=None):
    """The rollout as plain tensor code: a loop over T of the batched
    ``point_env.step`` and ``PointObjective.compute``.

    ``task_vec`` = [task_id, goal_x, goal_y, k0] (float32, device);
    ``state0`` the packed start state; ``fric_k`` [K, D]; ``acts`` [K, T, n_u].
    ``mode`` [K] scores each sample under a given mode instead of the one
    its global index gives it (the chains of gradient refinement), and then
    ``task_vec`` [K, 4] and ``state0`` [K, n_state] may give each sample a
    task and a start state of its own.
    """
    p, D, n_q = spec.env_params, spec.D, spec.n_q
    K = acts.shape[0]
    o = 2 * n_q
    lead = state0.shape[:-1]  # () or, with per-sample start states, (K,)

    def rows(a: int, b: int, shape):
        return state0[..., a:b].reshape(lead + shape).expand((K,) + shape)

    state = point_env.PointEnvState(
        q=rows(0, n_q, (n_q,)),
        qd=rows(n_q, o, (n_q,)),
        dyn_pos=rows(o, o + 2 * D, (D, 2)),
        dyn_yaw=rows(o + 2 * D, o + 3 * D, (D,)),
        dyn_vel=rows(o + 3 * D, o + 5 * D, (D, 2)),
        dyn_om=rows(o + 5 * D, o + 6 * D, (D,)),
        contact_force=torch.zeros(K, p.num_actors, 3, dtype=acts.dtype, device=acts.device),
        fric_scale=fric_k,
    )
    if mode is None:
        gk = torch.arange(K, device=acts.device, dtype=torch.float32) + task_vec[3]
        mode = ((gk >= spec.K // 2) & (gk < spec.K)).to(torch.int32)
    task = SimpleNamespace(task_id=task_vec[..., 0], goal=task_vec[..., 1:3])
    ext = point_env.zero_ext(p, (K,))
    costs, points = [], []
    for t in range(spec.T):
        u_t = acts[:, t]
        state = point_env.step(p, state, u_t, ext)
        cost, ext = spec.objective.compute(state, u_t, task, mode)
        costs.append(cost)
        points.append(state.q[:, :2])
    return torch.stack(costs, dim=1), torch.stack(points, dim=1)


def _check_batch(fn: str, spec: RolloutSpec, task_vec, state0, fric_k, acts) -> None:
    """Raise unless B seeds' inputs have the kernel's shapes and are
    contiguous float32 tensors on one device."""
    if acts.dim() != 4:
        raise ValueError(f"{fn}: acts has shape {tuple(acts.shape)}, expected [B, K, T, n_u]")
    B, K = acts.shape[:2]
    D, S = spec.D, spec.S
    expect = {
        "task_vec": (task_vec, (B, 4)),
        "state0": (state0, (B, 2 * spec.n_q + 6 * D)),
        "fric_k": (fric_k, (B, K, D)),
        "acts": (acts, (B, K, spec.T, spec.n_u)),
        "params_buf": (spec.params_buf, (_N_SCALARS + 6 * D + 7 * S,)),
    }
    for name, (x, shape) in expect.items():
        if tuple(x.shape) != shape:
            raise ValueError(f"{fn}: {name} has shape {tuple(x.shape)}, expected {shape}")
        if x.dtype != torch.float32 or not x.is_contiguous() or x.device != acts.device:
            raise ValueError(f"{fn}: {name} must be contiguous float32 on {acts.device}")


def check_scene(fn: str, D: int, S: int) -> None:
    """Raise unless the point kernels (this rollout's and the real-env
    step's, ``ops/point_step.py``) take a scene of ``D`` dynamic and ``S``
    static boxes: 1 to their compile-time maxima."""
    if not (1 <= D <= MAX_DYN and 1 <= S <= MAX_STAT):
        raise ValueError(f"{fn}: scene has D={D}, S={S}; the kernel takes 1 <= D <= {MAX_DYN}, 1 <= S <= {MAX_STAT}")


def _launch(fn: str, spec: RolloutSpec, task_vec, state0, fric_k, acts):
    """ONE launch of the kernel on the current stream for B seeds' inputs
    (the seed on the grid's y axis); raises on anything it does not take."""
    if acts.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {acts.device}")
    _check_batch(fn, spec, task_vec, state0, fric_k, acts)
    B, K, T, n_u = acts.shape
    D, S = spec.D, spec.S
    check_scene(fn, D, S)
    cost = torch.empty(B, K, T, dtype=torch.float32, device=acts.device)
    traj = torch.empty(B, K, T, 2, dtype=torch.float32, device=acts.device)
    lib = cuda_build.load_kernels()
    p = spec.env_params
    with torch.cuda.device(acts.device):  # the launch goes to the context of the tensors' card
        err = lib.m3p2i_point_rollout(
            spec.params_buf.data_ptr(), task_vec.data_ptr(), state0.data_ptr(),
            fric_k.data_ptr(), acts.data_ptr(), cost.data_ptr(), traj.data_ptr(),
            B, K, spec.K, T, D, S, p.substeps, p.pos_iters, spec.box_slot, spec.dynobs_slot,
            _ROBOT_TYPES[p.robot_type], spec.n_q, n_u, int(spec.multi_modal),
            int(spec.boxer_continuous_align), spec.params_buf.numel(),
            torch.cuda.current_stream(acts.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"{fn} kernel launch failed: cudaError {err}")
    return cost, traj


def point_rollout(spec: RolloutSpec, task_vec, state0, fric_k, acts):
    """The rollout of ``acts`` [K, T, n_u] from ``state0``.

    A CPU tensor runs :func:`point_rollout_plain`; a CUDA tensor launches the
    kernel on the current stream (a team of warp lanes per sample; the
    batched kernel's body with one seed) or raises.
    """
    global rollout_launches
    if acts.device.type == "cpu":
        return point_rollout_plain(spec, task_vec, state0, fric_k, acts)
    cost, traj = _launch("point_rollout", spec, task_vec[None], state0[None], fric_k[None], acts[None])
    rollout_launches += 1
    return cost[0], traj[0]


def point_rollout_batched_plain(spec: RolloutSpec, task_vec, state0, fric_k, acts):
    """B seeds' rollouts as plain tensor code: :func:`point_rollout_plain`
    per seed, stacked.  ``task_vec`` [B, 4], ``state0`` [B, n_state],
    ``fric_k`` [B, K, D], ``acts`` [B, K, T, n_u]."""
    outs = [point_rollout_plain(spec, *args) for args in zip(task_vec, state0, fric_k, acts)]
    return torch.stack([c for c, _ in outs]), torch.stack([t for _, t in outs])


def point_rollout_batched(spec: RolloutSpec, task_vec, state0, fric_k, acts):
    """The rollouts of B seeds' ``acts`` [B, K, T, n_u] from their own
    ``state0`` [B, n_state], tasks [B, 4] and friction scales [B, K, D].

    The inputs are checked on either device; then a CPU tensor runs
    :func:`point_rollout_batched_plain` and a CUDA tensor launches the
    kernel ONCE for the whole batch or raises.
    """
    global rollout_batched_launches
    if acts.device.type == "cpu":
        _check_batch("point_rollout_batched", spec, task_vec, state0, fric_k, acts)
        return point_rollout_batched_plain(spec, task_vec, state0, fric_k, acts)
    cost, traj = _launch("point_rollout_batched", spec, task_vec, state0, fric_k, acts)
    rollout_batched_launches += 1
    return cost, traj


def make_point_rollout(
    env_params: point_env.PointEnvParams,
    kp_suction: float,
    K: int,
    T: int,
    multi_modal: bool,
    boxer_continuous_align: bool = True,
):
    """The rollout callable of a point-family scene (see module docstring)."""
    names = list(env_params.actor_names)
    if "box" not in names or "dyn-obs" not in names:
        raise ValueError("make_point_rollout: the scene needs a 'box' and a 'dyn-obs' actor")
    box_slot = env_params.dyn_actor_idx.index(names.index("box"))
    spec = RolloutSpec(
        env_params=env_params,
        objective=PointObjective(env_params, kp_suction, multi_modal, boxer_continuous_align),
        K=int(K),
        T=int(T),
        n_q=point_env.robot_nq(env_params),
        n_u=point_env.robot_nu(env_params),
        box_slot=box_slot,
        dynobs_slot=env_params.dyn_actor_idx.index(names.index("dyn-obs")),
        multi_modal=bool(multi_modal),
        boxer_continuous_align=bool(boxer_continuous_align),
        params_buf=torch.as_tensor(
            _param_buffer(env_params, kp_suction, box_slot), device=env_params.device
        ),
    )

    on_device = {spec.params_buf.device: spec}  # the spec with its constants on each device a shard runs on

    def rollout(sim_state_k, acts, task, k0=None):
        if acts.device not in on_device:
            on_device[acts.device] = replace(spec, params_buf=spec.params_buf.to(acts.device))
        wrapper = point_rollout_batched if acts.dim() == 4 else point_rollout  # a leading seed axis?
        return wrapper(on_device[acts.device], *rollout_inputs(sim_state_k, task, k0), acts.contiguous())

    def chain(sim_state_k, acts, task, mode):
        """The plain rollout's costs [N, T] of N sequences ``acts`` [N, T,
        n_u] from the start state of ``sim_state_k`` (its sample 0's friction
        scales), sequence n scored under ``mode[n]``: the differentiable
        chain of gradient refinement (no kernel has a backward).  A seed
        batch's B x N sequences [B, N, T, n_u] run as one plain rollout, each
        row with its seed's start state, task and friction scales."""
        task_vec, state0, fric_k = rollout_inputs(sim_state_k, task)
        if acts.dim() == 3:
            return point_rollout_plain(spec, task_vec, state0, fric_k[:1].expand(acts.shape[0], -1), acts, mode)[0]
        B, N = acts.shape[:2]
        rows = lambda x: x.repeat_interleave(N, dim=0)  # noqa: E731 (row b N + n takes seed b's)
        fric = fric_k[:, 0].repeat_interleave(N, dim=0)
        return point_rollout_plain(spec, rows(task_vec), rows(state0), fric, acts.flatten(0, 1),
                                   mode.flatten())[0].unflatten(0, (B, N))

    rollout.spec = spec
    rollout.chain = chain
    return rollout
