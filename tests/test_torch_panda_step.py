"""The panda env's real-env step on the CPU, and the host side of its CUDA
kernel (``ops/panda_step.py``; the kernel itself is held to the plain step
on the card in tests/test_torch_cuda.py).

* On the CPU the env's ``step`` is ``models/panda_env.step``: the same
  tensors in the table and the shelf scene, one state and a batch, and no
  kernel launch counted.
* ``make_step`` takes the kernel for a scene on a card within the kernel's
  limits (the shipped scenes, S = 8 statics) and raises beyond them (a
  ninth static); off the card every scene takes the plain step.
* The param buffer holds each scene constant at the offset the kernel
  reads (the ``enum Scalar`` order of ``csrc/panda_step.cu``, the joint,
  body, static and support rows, each actor's force row).
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
from m3p2i_aip_tpu_torch.models import panda_env
from m3p2i_aip_tpu_torch.ops import cuda_build
from m3p2i_aip_tpu_torch.ops import panda_step as pps
from m3p2i_aip_tpu_torch.sim.sim_config import ActorCfg, load_env_cfgs

SCENES = {"table": [], "shelf": ["cube_on_shelf=True"]}


def _inputs(params, lead, rng):
    """A state of the scene (batched over ``lead``) with random joints,
    velocities, body motion and forces, cubeA held in half of the states,
    and a random action."""
    f = lambda *shape: torch.as_tensor(rng.uniform(-1, 1, lead + shape).astype(np.float32))  # noqa: E731
    state = panda_env.init_state(params)
    quat = f(3, 4)
    state = dataclasses.replace(
        state,
        q=state.q + 0.5 * f(9), qd=f(9), body_pos=state.body_pos + 0.02 * f(3, 3),
        body_quat=quat / torch.linalg.vector_norm(quat, dim=-1, keepdim=True), body_vel=0.2 * f(3, 3),
        body_om=f(3, 3), attached=(f() > 0).to(torch.float32), attach_pos=0.05 * f(3),
        attach_rot=state.attach_rot.expand(lead + (3, 3)),
        contact_force=state.contact_force.expand(lead + state.contact_force.shape),
    )
    return state, 2.0 * f(9), panda_env.PandaExtForces(body=f(3, 3))


@pytest.mark.parametrize("lead", [(), (3,)], ids=["one", "batch3"])
@pytest.mark.parametrize("scene", list(SCENES))
def test_cpu_step_is_the_plain_step(scene, lead):
    """On the CPU the env's step returns panda_env.step's tensors exactly,
    step after step, and launches nothing."""
    env = make_env(load_config("config_panda", SCENES[scene]), device="cpu")
    state, u, ext = _inputs(env.params, lead, np.random.default_rng(len(lead)))
    before = (pps.panda_step_launches, pps.panda_step_batched_launches)
    for _ in range(5):
        got = env.step(state, u, ext)
        ref = panda_env.step(env.params, state, u, ext)
        for f in dataclasses.fields(ref):
            assert torch.equal(getattr(got, f.name), getattr(ref, f.name)), f.name
        state = got
    assert (pps.panda_step_launches, pps.panda_step_batched_launches) == before


def _scene(extra_statics: int):
    """config_panda's scene (S = 3) with more fixed posts."""
    cfg = load_config("config_panda")
    actors = load_env_cfgs(cfg.env_type) + [
        ActorCfg(type="box", name=f"post-{i}", size=[0.04, 0.04, 0.1], init_pos=[0.3, -0.5 + 0.1 * i, 1.1],
                 fixed=True)
        for i in range(extra_statics)
    ]
    return panda_env.build_params(actors, cfg.sim)


class _OnACard(panda_env.PandaEnvParams):
    """A scene whose device reads as a card, its tensors on the CPU: what
    ``make_step`` decides from."""

    @property
    def device(self):
        return torch.device("cuda")


# (extra statics, whether the kernel takes the scene)
LIMITS = {"shipped": (0, True), "maxima": (5, True), "9 statics": (6, False)}


def _same(a, b) -> bool:
    return all(torch.equal(getattr(a, f.name), getattr(b, f.name)) for f in dataclasses.fields(b))


@pytest.mark.parametrize("scene", list(LIMITS))
def test_step_takes_the_kernel_within_its_limits(monkeypatch, scene):
    """A scene on a card takes the kernel up to S = 8 statics (the panda
    rollout kernel's limit) and raises beyond; off the card every scene
    takes the plain step."""
    extra, kernel = LIMITS[scene]
    params = _scene(extra)
    S, P = params.stat_min.shape[0], params.sup_z.shape[0]
    assert (S, P) == (3 + extra, 4 + extra) and kernel == (S <= 8)
    launched = []
    monkeypatch.setattr(pps, "param_buffer", lambda p: "buffer")
    monkeypatch.setattr(pps, "panda_step", lambda p, buf, s, u, e: launched.append(buf) or panda_env.step(p, s, u, e))
    card = _OnACard(**{f.name: getattr(params, f.name) for f in dataclasses.fields(params)})
    state, u, ext = _inputs(params, (), np.random.default_rng(0))
    ref = panda_env.step(params, state, u, ext)
    if kernel:
        assert _same(pps.make_step(card)(state, u, ext), ref) and launched == ["buffer"]
    else:
        with pytest.raises(ValueError, match=rf"^panda_step: scene has S={S}, P={P}; the kernel takes 1 <= S <= 8, "
                                             r"1 <= P <= 9$"):
            pps.make_step(card)
        assert launched == []
    assert _same(pps.make_step(params)(state, u, ext), ref) and len(launched) == kernel


def _scalar_names() -> list:
    text = (cuda_build.CSRC_DIR / "panda_step.cu").read_text()
    body = re.search(r"enum Scalar \{(.*?)\};", text, re.S).group(1)
    names = [e.split("=")[0].strip() for e in body.split(",") if e.strip()]
    return names[: names.index("N_SCALARS")]


@pytest.mark.parametrize("scene", ["table", "shelf", "maxima"])
def test_param_buffer_holds_each_constant_where_the_kernel_reads_it(scene):
    """The scalars in the source's ``enum Scalar`` order: the python floats
    rounded once, the reciprocals of h and h^2 in float32 (a tensor over a
    python scalar), the held finger width, the release gap and cubeA's
    sphere radius as the plain step's tensor ops form them, the base; then
    each joint's limits and acceleration step, each body's half sizes, mass,
    gravity flag and sphere radius, each static's box, each support's
    footprint and height, and each actor's force row."""
    p = _scene(5) if scene == "maxima" else make_env(load_config("config_panda", SCENES[scene]), device="cpu").params
    buf = pps.param_buffer(p).numpy()
    S, P, A, n = p.stat_min.shape[0], p.sup_z.shape[0], p.num_actors, pps.N_SCALARS
    strides = (9 * pps.JOINT_STRIDE, 3 * pps.BODY_STRIDE, S * pps.STAT_STRIDE, P * pps.SUP_STRIDE)
    assert buf.dtype == np.float32 and buf.size == n + sum(strides) + A
    h = p.dt / p.substeps
    half_w = p.body_half[1, 0]
    want = {
        "P_H": np.float32(h), "P_ONE_M_DECAY": np.float32(1.0 - np.exp(-p.drive_rate * p.dt / p.substeps)),
        "P_INV_H": np.float32(1.0) / np.float32(h), "P_INV_H2": np.float32(1.0) / np.float32(h * h),
        "P_GRASP": np.float32(p.grasp_range), "P_MU_G_H": np.float32(panda_env.GROUND_MU * panda_env.GRAVITY * h),
        "P_HELD_FINGER": (half_w * 0.96).numpy(), "P_RELEASE_GAP": (2.0 * half_w + 0.005).numpy(),
        "P_R_AB": torch.mean(p.body_half[1]).numpy(),
        "P_BASE_X": p.base_pos[0].numpy(), "P_BASE_Y": p.base_pos[1].numpy(), "P_BASE_Z": p.base_pos[2].numpy(),
    }
    names = _scalar_names()
    assert sorted(names) == sorted(want) and len(names) == n
    np.testing.assert_array_equal(buf[:n], np.float32([want[k] for k in names]))
    o = np.cumsum((n,) + strides)
    joints = buf[o[0]:o[1]].reshape(9, pps.JOINT_STRIDE)
    np.testing.assert_array_equal(joints, torch.stack(
        [p.joint_lower, p.joint_upper, p.joint_vel_limit, p.joint_accel_limit * h], -1).numpy())
    body = buf[o[1]:o[2]].reshape(3, pps.BODY_STRIDE)
    np.testing.assert_array_equal(body[:, :3], p.body_half.numpy())
    np.testing.assert_array_equal(body[:, 3:5], torch.stack([p.body_mass, p.body_gravity], -1).numpy())
    np.testing.assert_array_equal(body[:, 5], torch.mean(p.body_half, dim=-1).numpy())
    stat = buf[o[2]:o[3]].reshape(S, pps.STAT_STRIDE)
    np.testing.assert_array_equal(stat, torch.cat([p.stat_min, p.stat_max], -1).numpy())
    sup = buf[o[3]:o[4]].reshape(P, pps.SUP_STRIDE)
    np.testing.assert_array_equal(sup, torch.cat([p.sup_min, p.sup_max, p.sup_z[:, None]], -1).numpy())
    rows = buf[o[4]:]
    assert rows[p.robot_actor_idx] == pps.ROW_ROBOT
    assert [rows[a] for a in p.dyn_actor_idx] == [pps.ROW_DYN + k for k in range(3)]
    assert [rows[a] for a in p.stat_actor_idx] == [pps.ROW_STAT + k for k in range(S)]
    assert set(range(A)) == {p.robot_actor_idx, *p.dyn_actor_idx, *p.stat_actor_idx}


# (what, tensor, lead, row shape, a view of it?, its row stride)
def _row_cases():
    action_seq = torch.arange(20 * 12 * 9, dtype=torch.float32).reshape(20, 12, 9)
    bodies = torch.arange(20 * 9, dtype=torch.float32).reshape(20, 3, 3)
    return {
        "one state": (torch.zeros(3, 4), (), (3, 4), True, None),
        "one attached flag": (torch.ones(()), (), (), True, None),
        "contiguous batch": (bodies, (20,), (3, 3), True, 9),
        "strided action rows": (action_seq[:, 0, :], (20,), (9,), True, 108),
        "broadcast input": (torch.eye(3), (20,), (3, 3), True, 0),
        "rows not contiguous": (bodies.transpose(1, 2), (20,), (3, 3), False, 9),
    }


@pytest.mark.parametrize("case", list(_row_cases()))
def test_operand_rows(case):
    """An operand as one row a state with one stride: a view wherever the
    layout allows (no copy node in a captured tick), else a copy; the rows
    hold the operand's values either way, and anything but float32 on the
    launch's device raises in the panda step's name."""
    x, lead, tail, view, stride = _row_cases()[case]
    rows, got_stride = pps._rows(x, lead, tail, x.device, "panda_step")
    assert (rows.data_ptr() == x.data_ptr()) == view
    if stride is not None:
        assert got_stride == stride
    assert rows.shape == (math.prod(lead), math.prod(tail)) and rows.stride(0) == got_stride
    assert rows.shape[1] == 1 or rows.stride(1) == 1
    assert torch.equal(rows, x.expand(lead + tail).reshape(rows.shape))  # row b at b x stride, as the kernel reads
    with pytest.raises(ValueError, match="^panda_step: every tensor must be float32"):
        pps._rows(x.double(), lead, tail, x.device, "panda_step")
