"""The point env's real-env step on the CPU, and the host side of its CUDA
kernel (``ops/point_step.py``; the kernel itself is held to the plain step
on the card in tests/test_torch_cuda.py).

* On the CPU the env's ``step`` is ``models/point_env.step``: the same
  tensors for the point, heijn and boxer bases, one state and a batch, and
  no kernel launch counted.
* ``make_step`` takes the kernel for a scene on a card within the kernel's
  limits (the shipped scenes, D = 4 / S = 16) and raises beyond them (a
  seventeenth static, a fifth box), through the point rollout kernel's own
  check; off the card every scene takes the plain step.
* The param buffer holds each scene constant at the offset the kernel
  reads (the ``enum Scalar`` order of ``csrc/point_step.cu``, the box and
  static rows, each actor's force row).
* Each operand reaches the kernel as rows with one stride: a strided
  action row and a broadcast input as views, other layouts as a copy.
"""
import dataclasses
import math
import re

import numpy as np
import pytest
import torch

from m3p2i_aip_tpu_torch.config.config_store import load_config
from m3p2i_aip_tpu_torch.envs import make_env
from m3p2i_aip_tpu_torch.models import point_env
from m3p2i_aip_tpu_torch.ops import cuda_build
from m3p2i_aip_tpu_torch.ops import point_step as ps
from m3p2i_aip_tpu_torch.ops import rollout as ro
from m3p2i_aip_tpu_torch.sim.sim_config import ActorCfg, load_env_cfgs

CONFIGS = ["config_point", "config_heijn", "config_boxer"]


def _inputs(params, lead, rng):
    """A state of the scene (batched over ``lead``) with random velocities,
    friction scales, suction forces and an action."""
    nq, nu, D = point_env.robot_nq(params), point_env.robot_nu(params), params.dyn_half.shape[0]
    f = lambda *shape: torch.as_tensor(rng.uniform(-1, 1, lead + shape).astype(np.float32))  # noqa: E731
    state = point_env.init_state(params)
    state = dataclasses.replace(
        state,
        q=state.q + 2.0 * f(nq), qd=f(nq), dyn_pos=state.dyn_pos + 0.2 * f(D, 2), dyn_yaw=f(D), dyn_vel=f(D, 2),
        dyn_om=f(D), contact_force=state.contact_force.expand(lead + state.contact_force.shape),
        fric_scale=1.0 + 0.3 * f(D),
    )
    return state, 3.0 * f(nu), point_env.PointExtForces(robot=40.0 * f(2), dyn=60.0 * f(D, 2))


@pytest.mark.parametrize("lead", [(), (3,)], ids=["one", "batch3"])
@pytest.mark.parametrize("config_name", CONFIGS)
def test_cpu_step_is_the_plain_step(config_name, lead):
    """On the CPU the env's step returns point_env.step's tensors exactly,
    step after step, and launches nothing."""
    env = make_env(load_config(config_name), device="cpu")
    state, u, ext = _inputs(env.params, lead, np.random.default_rng(len(lead)))
    before = (ps.step_launches, ps.step_batched_launches)
    for _ in range(5):
        got = env.step(state, u, ext)
        ref = point_env.step(env.params, state, u, ext)
        for f in dataclasses.fields(ref):
            assert torch.equal(getattr(got, f.name), getattr(ref, f.name)), f.name
        state = got
    assert (ps.step_launches, ps.step_batched_launches) == before


def _box(name, pos, size, fixed):
    return ActorCfg(type="box", name=name, size=list(size) + [0.1], init_pos=list(pos) + [0.0],
                    init_ori=[0.0, 0.0, 0.0, 1.0], fixed=fixed, friction=0.6)


def _scene(extra_boxes: int, extra_statics: int):
    """config_point's scene (D = 2, S = 5) with more dynamic and static boxes."""
    cfg = load_config("config_point")
    actors = load_env_cfgs(cfg.env_type)
    actors += [_box(f"crate-{i}", [-3.0 + 0.6 * i, -2.0], [0.3, 0.3], False) for i in range(extra_boxes)]
    actors += [_box(f"pillar-{i}", [-3.0 + 0.5 * i, 3.0], [0.2, 0.2], True) for i in range(extra_statics)]
    return point_env.build_params(actors, cfg.sim)


class _OnACard(point_env.PointEnvParams):
    """A scene whose device reads as a card, its tensors on the CPU: what
    ``make_step`` decides from."""

    @property
    def device(self):
        return torch.device("cuda")


# (extra dynamic boxes, extra statics, whether the kernel takes the scene)
SCENES = {"shipped": (0, 0, True), "maxima": (2, 11, True), "17 statics": (0, 12, False), "5 boxes": (3, 0, False)}


def _same(a, b) -> bool:
    return all(torch.equal(getattr(a, f.name), getattr(b, f.name)) for f in dataclasses.fields(b))


@pytest.mark.parametrize("scene", list(SCENES))
def test_step_takes_the_kernel_within_its_limits(monkeypatch, scene):
    """A scene on a card takes the kernel up to D = 4 and S = 16 and raises
    beyond, by the check that holds the point rollout kernel to the same
    limits; off the card every scene takes the plain step."""
    extra_d, extra_s, kernel = SCENES[scene]
    params = _scene(extra_d, extra_s)
    D, S = params.dyn_half.shape[0], params.stat_pos.shape[0]
    assert kernel == (D <= ro.MAX_DYN and S <= ro.MAX_STAT)
    launched = []
    monkeypatch.setattr(ps, "param_buffer", lambda p: "buffer")
    monkeypatch.setattr(ps, "point_step", lambda p, buf, s, u, e: launched.append(buf) or point_env.step(p, s, u, e))
    card = _OnACard(**{f.name: getattr(params, f.name) for f in dataclasses.fields(params)})
    state, u, ext = _inputs(params, (), np.random.default_rng(0))
    ref = point_env.step(params, state, u, ext)
    if kernel:
        assert _same(ps.make_step(card)(state, u, ext), ref) and launched == ["buffer"]
    else:
        limits = f"scene has D={D}, S={S}; the kernel takes 1 <= D <= 4, 1 <= S <= 16"
        with pytest.raises(ValueError, match=f"^point_step: {limits}$"):
            ps.make_step(card)
        with pytest.raises(ValueError, match=f"^point_rollout: {limits}$"):
            ro.check_scene("point_rollout", D, S)
        assert launched == []
    assert _same(ps.make_step(params)(state, u, ext), ref) and len(launched) == kernel


def _scalar_names() -> list:
    text = (cuda_build.CSRC_DIR / "point_step.cu").read_text()
    body = re.search(r"enum Scalar \{(.*?)\};", text, re.S).group(1)
    names = [e.split("=")[0].strip() for e in body.split(",") if e.strip()]
    return names[: names.index("N_SCALARS")]


@pytest.mark.parametrize("scene", ["config_point", "config_heijn", "config_boxer", "maxima"])
def test_param_buffer_holds_each_constant_where_the_kernel_reads_it(scene):
    """The scalars in the source's ``enum Scalar`` order, rounded once from
    the plain step's python floats; then each box's row (half sizes,
    inverse mass and inertia, mean half size, friction), each static's (x,
    y, cos and sin of its yaw, half sizes, friction), and each actor's
    force row."""
    p = _scene(2, 11) if scene == "maxima" else make_env(load_config(scene), device="cpu").params
    buf = ps.param_buffer(p).numpy()
    D, S, A, n = p.dyn_half.shape[0], p.stat_pos.shape[0], p.num_actors, ps.N_SCALARS
    assert buf.dtype == np.float32 and buf.size == n + ps.DYN_STRIDE * D + ps.STAT_STRIDE * S + A
    h, wm_r = p.dt / p.substeps, 1.0 / p.robot_mass
    want = {
        "P_H": h, "P_DECAY": np.exp(-p.drive_rate * p.dt / p.substeps), "P_WMR_H": wm_r * h, "P_WMR": wm_r,
        "P_RR": p.robot_radius, "P_ROBOT_FRIC": p.robot_friction, "P_MAX_SPEED": p.max_dyn_speed,
        "P_ARENA": p.arena_bound, "P_ARENA_LIM": p.arena_bound - p.robot_radius, "P_WHEEL_R": p.wheel_radius,
        "P_WHEEL_B": p.wheel_base,
    }
    names = _scalar_names()
    assert sorted(names) == sorted(want) and len(names) == n
    np.testing.assert_array_equal(buf[:n], np.float32([want[k] for k in names]))
    dyn = buf[n : n + ps.DYN_STRIDE * D].reshape(D, ps.DYN_STRIDE)
    half = p.dyn_half.numpy()
    np.testing.assert_array_equal(dyn, np.stack([half[:, 0], half[:, 1], p.dyn_inv_mass.numpy(),
                                                 p.dyn_inv_inertia.numpy(), (half[:, 0] + half[:, 1]) / 2,
                                                 p.dyn_friction.numpy()], -1))
    stat = buf[n + ps.DYN_STRIDE * D : n + ps.DYN_STRIDE * D + ps.STAT_STRIDE * S].reshape(S, ps.STAT_STRIDE)
    np.testing.assert_array_equal(stat, torch.stack(
        [p.stat_pos[:, 0], p.stat_pos[:, 1], torch.cos(p.stat_yaw), torch.sin(p.stat_yaw), p.stat_half[:, 0],
         p.stat_half[:, 1], p.stat_friction], -1).numpy())
    rows = buf[n + ps.DYN_STRIDE * D + ps.STAT_STRIDE * S :]
    assert rows[p.robot_actor_idx] == ps.ROW_ROBOT
    assert [rows[a] for a in p.dyn_actor_idx] == [ps.ROW_DYN + k for k in range(D)]
    assert [rows[a] for a in p.stat_actor_idx] == [ps.ROW_STAT + k for k in range(S)]
    others = set(range(A)) - {p.robot_actor_idx, *p.dyn_actor_idx, *p.stat_actor_idx}
    assert others and all(rows[a] == ps.ROW_NONE for a in others)  # the goal and axis markers


# (what, tensor, lead, row shape, a view of it?, its row stride)
def _row_cases():
    action_seq = torch.arange(20 * 15 * 2, dtype=torch.float32).reshape(20, 15, 2)
    batch = torch.arange(20 * 4, dtype=torch.float32).reshape(20, 2, 2)
    return {
        "one state": (torch.zeros(2), (), (2,), True, None),
        "contiguous batch": (batch, (20,), (2, 2), True, 4),
        "strided action rows": (action_seq[:, 0, :], (20,), (2,), True, 30),
        "broadcast input": (torch.ones(2, 2), (20,), (2, 2), True, 0),
        "rows not contiguous": (batch.transpose(1, 2), (20,), (2, 2), False, 4),
    }


@pytest.mark.parametrize("case", list(_row_cases()))
def test_operand_rows(case):
    """An operand as one row a state with one stride: a view wherever the
    layout allows (no copy node in a captured tick), else a copy; the rows
    hold the operand's values either way."""
    x, lead, tail, view, stride = _row_cases()[case]
    rows, got_stride = ps._rows(x, lead, tail, x.device)
    assert (rows.data_ptr() == x.data_ptr()) == view
    if stride is not None:
        assert got_stride == stride
    assert rows.shape == (math.prod(lead), math.prod(tail)) and rows.stride(1) == 1 and rows.stride(0) == got_stride
    assert torch.equal(rows, x.expand(*lead, *tail).reshape(rows.shape))  # row b at b x stride, as the kernel reads
    with pytest.raises(ValueError):
        ps._rows(x.double(), lead, tail, x.device)
