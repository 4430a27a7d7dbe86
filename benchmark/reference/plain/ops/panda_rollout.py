"""The panda MPPI rollout: plain PyTorch version and the wrapper of its CUDA
kernel (``csrc/panda_rollout.cu``).

Port of ``m3p2i_aip_tpu/ops/pallas_panda_rollout.py`` (``_panda_kernel`` :185
and its factory ``make_panda_rollout`` :676).  One call rolls K 9-channel
action sequences through T steps of ``models/panda_env.step`` from ONE start
state, scoring each step with ``PandaObjective.compute`` and recording the
EE's xy.

``make_panda_rollout`` returns ``rollout(sim_state_k, acts, task, k0=None)
-> (cost_horizon [K, T], traj_points [K, T, 2])``: ``acts`` arrive already
``u_scale``-scaled with the gripper channels overridden, all K states are the
broadcast start state, and ``k0`` is the global index of the first sample
(a shard of a mesh, ``parallel/mesh.py``, keeps the mode assignment by
global index).  The callable launches on the device of ``acts``, with the
scene's constants copied there once.

The kernel carries cubeA's orientation as a quaternion, as ``panda_env.step``
does (the TPU kernel used a rotation matrix and Rodrigues), and does not
carry the orientation or spin of dyn-obs and cubeB, which feed no output:
its packed start state is the 56 floats of :func:`pack_state`.

With a leading seed axis (``sim_state_k`` fields [B, K, ...], ``acts``
[B, K, T, 9], a batched TaskParams) the same callable rolls B seeds out in
ONE launch of the batched kernel (``panda_rollout_batched``, the port of the
TPU kernel's ``grid=(B,)`` call, ``pallas_panda_rollout.py:851``).
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from types import SimpleNamespace

import numpy as np
import torch

from benchmark.reference.plain.models import panda_env, panda_fk
from benchmark.reference.plain.planners.motion_planner.cost_functions import PandaObjective
from benchmark.reference.plain.utils.tree import tree_map

MAX_STAT = 8  # csrc/panda_rollout.cu kMaxS
STATE_LEN = 56  # pack_state
_N_SCALARS = 16  # csrc/panda_rollout.cu N_SCALARS

# Number of CUDA kernel launches made by ``panda_rollout`` and by
# ``panda_rollout_batched`` (CPU calls run the plain versions and do not
# count).
panda_rollout_launches = 0
panda_rollout_batched_launches = 0

# The seven start cases that hold the rollout to its references
# (tests/test_pallas.py:335-363): (name, start, task, gripper action or None,
# zup_gate).  A "pick" case aims at PARITY_GOAL, the others at zeros.
PARITY_GOAL = (0.4, 0.3, 1.3, 0.0, 0.0, 0.383, 0.924)
PARITY_CASES = (
    ("rest", "base", "reach", None, 0.0),
    ("closing_near_cube", "base", "reach", -1.5, 0.0),  # attach fires
    ("attached", "attached", "pick", -1.5, 0.0),
    ("attached_zup", "attached", "pick", -1.5, 1.0),  # the zup_gate term live
    ("tumbling", "tumbling", "reach", None, 0.0),  # orientation integration
    ("near_cubeB", "near_cubeB", "pick", -1.5, 0.0),  # cube-cube and probe contacts
    ("place_detach", "attached", "place", 1.5, 0.0),  # gripper opening: detach
)


def parity_overrides(start: str, body_pos, body_vel, body_om) -> dict:
    """The fields a parity ``start`` sets on the scene's init state, as numpy
    arrays, from numpy copies of that state's [3, 3] body_pos / body_vel /
    body_om (each package applies them to its own state)."""
    pos, vel, om = (np.array(x, dtype=np.float32) for x in (body_pos, body_vel, body_om))
    if start == "attached":  # cubeA welded 8 cm below the hand
        return {
            "attached": np.float32(1.0),
            "attach_pos": np.array([0.0, 0.0, 0.08], np.float32),
            "attach_rot": np.eye(3, dtype=np.float32),
        }
    if start == "tumbling":  # free cubeA 20 cm up, spinning and sliding
        pos[1, 2] += np.float32(0.2)
        om[1] = [2.0, -1.5, 3.0]
        vel[1] = [0.2, -0.1, 0.0]
        return {"body_pos": pos, "body_vel": vel, "body_om": om}
    if start == "near_cubeB":  # cubeA 6 cm beside cubeB
        pos[1] = pos[2] + np.array([0.06, 0.0, 0.0], np.float32)
        return {"body_pos": pos}
    if start != "base":
        raise ValueError(f"unknown parity start {start!r}")
    return {}


def parity_state(base: panda_env.PandaEnvState, start: str) -> panda_env.PandaEnvState:
    """The port's parity ``start`` state from its scene's init state."""
    arrays = (x.cpu().numpy() for x in (base.body_pos, base.body_vel, base.body_om))
    overrides = parity_overrides(start, *arrays)
    dev = base.q.device
    return replace(base, **{k: torch.as_tensor(v, device=dev) for k, v in overrides.items()})


@dataclass
class PandaRolloutSpec:
    """Everything one scene's rollout needs, built once per scene."""

    env_params: panda_env.PandaEnvParams
    objective: PandaObjective
    K: int  # total sample count (the mode split is K // 2)
    T: int
    multi_modal: bool
    table_slot: int  # static index of the table
    shelf_slot: int  # static index of the shelf stand
    params_buf: torch.Tensor  # kernel constants, see _param_buffer

    @property
    def S(self) -> int:
        return int(self.env_params.stat_min.shape[0])


def _param_buffer(p: panda_env.PandaEnvParams, pre_height_diff: float) -> np.ndarray:
    """The kernel's constant buffer (layout: ``enum Scalar`` and the body /
    static / support strides of ``csrc/panda_rollout.cu``).  Products of
    python scalars are formed in double and rounded once, as the plain
    version's python-scalar arithmetic is."""
    h = p.dt / p.substeps
    tilt = PandaObjective.tilt_cos_theta
    scalars = np.zeros(_N_SCALARS, np.float64)
    scalars[:12] = [
        h,
        1.0 - float(np.exp(-p.drive_rate * p.dt / p.substeps)),
        h * h,
        p.grasp_range,
        pre_height_diff,
        -pre_height_diff * tilt,
        pre_height_diff * (1 - tilt**2) ** 0.5,
        tilt,
        panda_env.GROUND_MU * panda_env.GRAVITY * h,
        *p.base_pos.cpu().numpy().astype(np.float64),
    ]
    half = p.body_half.cpu()
    body = torch.cat(
        [half, p.body_mass.cpu()[:, None], p.body_gravity.cpu()[:, None], torch.mean(half, dim=-1)[:, None]],
        dim=-1,
    )
    stat = torch.cat([p.stat_min, p.stat_max], dim=-1).cpu()
    sup = torch.cat([p.sup_min, p.sup_max, p.sup_z[:, None]], dim=-1).cpu()
    return np.concatenate(
        [scalars.astype(np.float32), body.numpy().reshape(-1), stat.numpy().reshape(-1), sup.numpy().reshape(-1)]
    ).astype(np.float32)


def pack_state(state: panda_env.PandaEnvState) -> torch.Tensor:
    """A start state as the kernel's flat [56] row (one row per seed of a
    batched state): q, qd, body_pos (3x3), body_vel (3x3), cubeA om, cubeA
    quat, attached, attach_pos, attach_rot."""
    return torch.cat(
        [
            state.q, state.qd, state.body_pos.flatten(-2), state.body_vel.flatten(-2),
            state.body_om[..., 1, :], state.body_quat[..., 1, :], state.attached[..., None],
            state.attach_pos, state.attach_rot.flatten(-2),
        ],
        dim=-1,
    )


def unpack_state(state0: torch.Tensor, K: int, p: panda_env.PandaEnvParams) -> panda_env.PandaEnvState:
    """The K broadcast states of a packed row [56], or the K states of K
    packed rows [K, 56] (dyn-obs and cubeB at rest orientation; no output
    depends on it)."""
    lead = state0.shape[:-1]

    def rows(a: int, b: int, shape=()):
        return state0[..., a:b].reshape(lead + shape).expand((K,) + shape)

    quat = torch.zeros(lead + (3, 4), dtype=state0.dtype, device=state0.device)
    quat[..., 3] = 1.0
    quat[..., 1, :] = state0[..., 39:43]
    om = torch.zeros(lead + (3, 3), dtype=state0.dtype, device=state0.device)
    om[..., 1, :] = state0[..., 36:39]
    return panda_env.PandaEnvState(
        q=rows(0, 9, (9,)),
        qd=rows(9, 18, (9,)),
        body_pos=rows(18, 27, (3, 3)),
        body_vel=rows(27, 36, (3, 3)),
        body_om=om.expand(K, 3, 3),
        body_quat=quat.expand(K, 3, 4),
        attached=rows(43, 44),
        attach_pos=rows(44, 47, (3,)),
        attach_rot=rows(47, 56, (3, 3)),
        contact_force=torch.zeros(K, p.num_actors, 3, dtype=state0.dtype, device=state0.device),
    )


def rollout_inputs(sim_state_k, task, k0=None):
    """(task_vec [10], state0 [56]) of the kernel from the broadcast rollout
    states, the TaskParams and the global sample offset ``k0``, or, for
    states and a task with a leading seed axis, [B, 10] and [B, 56].
    task_vec = [task_id, goal pos (3), goal quat (4, xyzw), k0, zup_gate]."""
    nb = sim_state_k.q.dim() - 2  # the seed dims in front of the K axis
    state0 = pack_state(tree_map(lambda x: x.select(nb, 0), sim_state_k))
    lead = state0.shape[:-1]
    k0v = torch.full(lead + (1,), 0.0 if k0 is None else float(k0), dtype=torch.float32, device=state0.device)
    task_vec = torch.cat(
        [
            task.task_id.to(torch.float32)[..., None], task.goal.to(torch.float32), k0v,
            task.zup_gate.to(torch.float32)[..., None],
        ],
        dim=-1,
    )
    return task_vec, state0


def panda_rollout_plain(spec: PandaRolloutSpec, task_vec, state0, acts, mode=None):
    """The rollout as plain tensor code: a loop over T of the batched
    ``panda_env.step`` and ``PandaObjective.compute``, with the EE's xy from
    ``fk``.  ``task_vec`` [10] and ``state0`` [56] as :func:`rollout_inputs`
    makes them; ``acts`` [K, T, 9].  ``mode`` [K] scores each sample under a
    given mode instead of the one its global index gives it (the chains of
    gradient refinement), and then ``task_vec`` [K, 10] and ``state0``
    [K, 56] may give each sample a task and a start state of its own."""
    p = spec.env_params
    K = acts.shape[0]
    state = unpack_state(state0, K, p)
    if mode is None:
        gk = torch.arange(K, device=acts.device, dtype=torch.float32) + task_vec[8]
        mode = ((gk >= spec.K // 2) & (gk < spec.K)).to(torch.int32)
    task = SimpleNamespace(task_id=task_vec[..., 0], goal=task_vec[..., 1:8], zup_gate=task_vec[..., 9])
    ext = panda_env.zero_ext(p, (K,))
    costs, points = [], []
    for t in range(spec.T):
        u_t = acts[:, t]
        state = panda_env.step(p, state, u_t, ext)
        links = panda_fk.fk(state.q, p.base_pos)
        cost, ext = spec.objective.compute(state, u_t, task, mode, links)
        costs.append(cost)
        points.append(links["ee"][0][:, :2])
    return torch.stack(costs, dim=1), torch.stack(points, dim=1)


def _check_batch(fn: str, spec: PandaRolloutSpec, task_vec, state0, acts) -> None:
    """Raise unless B seeds' inputs have the kernel's shapes and are
    contiguous float32 tensors on one device."""
    if acts.dim() != 4:
        raise ValueError(f"{fn}: acts has shape {tuple(acts.shape)}, expected [B, K, T, 9]")
    B, K = acts.shape[:2]
    S = spec.S
    expect = {
        "task_vec": (task_vec, (B, 10)),
        "state0": (state0, (B, STATE_LEN)),
        "acts": (acts, (B, K, spec.T, 9)),
        "params_buf": (spec.params_buf, (_N_SCALARS + 3 * 6 + 6 * S + 5 * (S + 1),)),
    }
    for name, (x, shape) in expect.items():
        if tuple(x.shape) != shape:
            raise ValueError(f"{fn}: {name} has shape {tuple(x.shape)}, expected {shape}")
        if x.dtype != torch.float32 or not x.is_contiguous() or x.device != acts.device:
            raise ValueError(f"{fn}: {name} must be contiguous float32 on {acts.device}")


def panda_rollout(spec: PandaRolloutSpec, task_vec, state0, acts):
    """The rollout of ``acts`` [K, T, 9] from ``state0``.

    A CPU tensor runs :func:`panda_rollout_plain`; a CUDA tensor launches the
    kernel on the current stream (a team of warp lanes per sample; the
    batched kernel's body with one seed) or raises.
    """
    return panda_rollout_plain(spec, task_vec, state0, acts)


def panda_rollout_batched_plain(spec: PandaRolloutSpec, task_vec, state0, acts):
    """B seeds' rollouts as plain tensor code: :func:`panda_rollout_plain`
    per seed, stacked.  ``task_vec`` [B, 10], ``state0`` [B, 56], ``acts``
    [B, K, T, 9]."""
    outs = [panda_rollout_plain(spec, *args) for args in zip(task_vec, state0, acts)]
    return torch.stack([c for c, _ in outs]), torch.stack([t for _, t in outs])


def panda_rollout_batched(spec: PandaRolloutSpec, task_vec, state0, acts):
    """The rollouts of B seeds' ``acts`` [B, K, T, 9] from their own
    ``state0`` [B, 56] and tasks [B, 10].

    The inputs are checked on either device; then a CPU tensor runs
    :func:`panda_rollout_batched_plain` and a CUDA tensor launches the
    kernel ONCE for the whole batch or raises.
    """
    _check_batch("panda_rollout_batched", spec, task_vec, state0, acts)
    return panda_rollout_batched_plain(spec, task_vec, state0, acts)


def make_panda_rollout(env_params: panda_env.PandaEnvParams, pre_height_diff: float, K: int, T: int, multi_modal: bool):
    """The rollout callable of a panda scene (see module docstring)."""
    names = list(env_params.actor_names)
    stat = list(env_params.stat_actor_idx)
    spec = PandaRolloutSpec(
        env_params=env_params,
        objective=PandaObjective(env_params, pre_height_diff, multi_modal),
        K=int(K),
        T=int(T),
        multi_modal=bool(multi_modal),
        table_slot=stat.index(names.index("table")),
        shelf_slot=stat.index(names.index("shelf_stand")),
        params_buf=torch.as_tensor(_param_buffer(env_params, float(pre_height_diff)), device=env_params.device),
    )

    on_device = {spec.params_buf.device: spec}  # the spec with its constants on each device a shard runs on

    def rollout(sim_state_k, acts, task, k0=None):
        if acts.device not in on_device:
            on_device[acts.device] = replace(spec, params_buf=spec.params_buf.to(acts.device))
        wrapper = panda_rollout_batched if acts.dim() == 4 else panda_rollout  # a leading seed axis?
        return wrapper(on_device[acts.device], *rollout_inputs(sim_state_k, task, k0), acts.contiguous())

    rollout.spec = spec
    return rollout
