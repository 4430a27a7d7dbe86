"""The port's run tooling: the ASCII view, offline frames, live teleop, the
TensorBoard trace, and checkpoint / resume.

A checkpoint of the port resumes bit for bit with the exploration noise on
(the planner's generator state travels with it), and a checkpoint written
by the JAX package resumes in the port: three JAX ticks, then three more in
each package, equal at ``ATOL`` with ``mppi.exploration_noise=0``.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from m3p2i_aip_tpu.config.config_store import load_config as jax_load_config
from m3p2i_aip_tpu.envs import make_env as jax_make_env
from m3p2i_aip_tpu.tamp.sim_loop import SimLoop as JaxSimLoop
from m3p2i_aip_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from m3p2i_aip_tpu.utils.render import render_point_env as jax_render_point_env
from m3p2i_aip_tpu_torch.config.config_store import load_config
from m3p2i_aip_tpu_torch.envs import make_env
from m3p2i_aip_tpu_torch.tamp.sim_loop import SimLoop, TickLog
from m3p2i_aip_tpu_torch.utils import convert
from m3p2i_aip_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from m3p2i_aip_tpu_torch.utils.profiling import trace
from m3p2i_aip_tpu_torch.utils.render import render_point_env, save_frames, save_trajectory_plot
from m3p2i_aip_tpu_torch.utils.teleop import SHOVE_KEYS, KeyboardTeleop

ATOL = 1e-3  # tests/test_torch_slice.py:31-36, over six closed-loop ticks
MAIN_PATH = ["task=push_pull", "multi_modal=True", "goal=[-3.75,-3.75]", "mppi.num_samples=16"]
RESUME = {
    "point": ("config_point", MAIN_PATH),  # exploration noise 0.15 of the point YAML
    "panda": ("config_panda", ["mppi.num_samples=16", "mppi.refine_iters=1"]),
}


def _leaves(x) -> dict:
    return {f.name: np.asarray(getattr(x, f.name)) for f in dataclasses.fields(x) if getattr(x, f.name) is not None}


def _trajs():
    trajs = np.zeros((3, 5, 2), dtype=np.float32)
    trajs[:, :, 0] = np.linspace(-2.0, 2.0, 5)[None, :]
    trajs[:, :, 1] = 2.5
    return trajs


def test_render_ascii_with_overlay_matches_jax_package():
    """The ASCII view (R robot, B box, D dyn-obs, # statics, . planned
    points) is the JAX package's character for character."""
    penv = make_env(load_config("config_point"), device="cpu")
    jenv = jax_make_env(jax_load_config("config_point"))
    out = render_point_env(penv, penv.init_state(), trajs=torch.as_tensor(_trajs()))
    assert all(ch in out for ch in "RBD#.")
    assert out == jax_render_point_env(jenv, jenv.init_state(), trajs=_trajs())
    assert "." not in render_point_env(penv, penv.init_state())


def test_save_frames_and_plot(tmp_path, capsys):
    """Frames and a GIF of a synthetic point log (tests/test_utils.py:160),
    a trajectory PNG; on the panda, one line and None."""
    pytest.importorskip("matplotlib")
    env = make_env(load_config("config_point"), device="cpu")
    log = TickLog()
    for t in range(8):
        log.robot_pos.append(np.asarray([0.1 * t, 0.0]))
        log.box_pos.append(np.asarray([0.1 * t + 0.5, 0.2]))
    out = save_frames(env, log, str(tmp_path / "frames"), every=2, goal=np.asarray([1.0, 1.0]))
    assert out is not None
    assert sorted(f for f in os.listdir(tmp_path / "frames") if f.endswith(".png")) == [
        f"frame_{t:05d}.png" for t in (0, 2, 4, 6)
    ]
    png = save_trajectory_plot(env, log, str(tmp_path / "run.png"), top_trajs=torch.as_tensor(_trajs()))
    assert png is not None and os.path.getsize(png) > 0
    panda = make_env(load_config("config_panda"), device="cpu")
    capsys.readouterr()
    assert save_frames(panda, log, str(tmp_path / "panda")) is None
    assert capsys.readouterr().out.strip() == "save_frames: frames are drawn for the point family only, not panda_env"
    assert not (tmp_path / "panda").exists()


def test_keyboard_teleop_inert_off_a_tty():
    with KeyboardTeleop() as keys:
        assert not keys.active and keys.poll() == []  # pytest's stdin is not a tty
    with KeyboardTeleop(enabled=False) as keys:
        assert not keys.active and keys.poll() == []
    assert set(SHOVE_KEYS) == {"i", "j", "k", "l"}


def test_trace_writes_a_tensorboard_trace(tmp_path):
    with trace(str(tmp_path / "trace")) as logdir:
        torch.ones(8).sum()
    assert os.listdir(logdir)


@pytest.mark.parametrize("family", list(RESUME))
def test_port_checkpoint_resumes_bit_for_bit(family, tmp_path):
    """Three ticks, a checkpoint, a fresh loop loads it and ticks three more:
    every state leaf, the host planner's task and the planner state equal
    six uninterrupted ticks bit for bit, with the exploration noise on."""
    config_name, overrides = RESUME[family]
    ref = SimLoop(load_config(config_name, overrides), device="cpu")
    assert ref.tamp.motion_planner.exploration_noise > 0
    ref.warmup(2)
    start = ref.state
    for i in range(3):
        ref.tick(i)
    path = save_checkpoint(str(tmp_path / "ckpt"), ref.tamp, ref.state)
    assert path.endswith(".npz")
    for i in range(3, 6):
        ref.tick(i)

    loop = SimLoop(load_config(config_name, overrides), device="cpu")
    loop.state = start  # a fresh loop elsewhere in its run
    loop.state = load_checkpoint(path, loop.tamp, loop.state, device="cpu")
    for i in range(3, 6):
        loop.tick(i)
    for name, value in _leaves(ref.state).items():
        assert np.array_equal(np.asarray(getattr(loop.state, name)), value), name
    for name, value in _leaves(ref.tamp.mppi_state).items():
        assert np.array_equal(np.asarray(getattr(loop.tamp.mppi_state, name)), value), name
    assert loop.tamp.task_planner.task == ref.tamp.task_planner.task
    assert vars(loop.tamp.task_planner).keys() == vars(ref.tamp.task_planner).keys()


def test_checkpoint_keys_the_loop_lacks_or_misses(tmp_path):
    """A saved key with no field is ignored, a field with no saved key (or a
    ``None`` leaf, saved as an object array) keeps its fresh value."""
    loop = SimLoop(load_config("config_point", MAIN_PATH), device="cpu")
    data = dict(np.load(save_checkpoint(str(tmp_path / "full"), loop.tamp, loop.state)))
    data.pop("sim/fric_scale")
    data["mppi/fric_scale_k"] = np.asarray(None, dtype=object)
    data["mppi/rng"] = np.zeros(2, np.uint32)
    np.savez(tmp_path / "partial.npz", **data)
    fresh = SimLoop(load_config("config_point", MAIN_PATH), device="cpu")
    fric_k, fric = fresh.tamp.mppi_state.fric_scale_k, fresh.state.fric_scale
    state = load_checkpoint(str(tmp_path / "partial.npz"), fresh.tamp, fresh.state, device="cpu")
    assert state.fric_scale is fric and fresh.tamp.mppi_state.fric_scale_k is fric_k
    assert torch.equal(state.q, loop.state.q)


def test_checkpoint_refuses_a_device_the_loop_is_not_on(tmp_path):
    loop = SimLoop(load_config("config_point", MAIN_PATH), device="cpu")
    path = save_checkpoint(str(tmp_path / "ckpt.npz"), loop.tamp, loop.state)
    with pytest.raises((RuntimeError, ValueError), match="CUDA|device"):
        load_checkpoint(path, loop.tamp, loop.state, device="cuda")


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    """The JAX package's loop ticks three times and saves; the port's fresh
    loop loads that file (its ``mppi/rng`` ignored, its own generator and
    host extras absent); both tick three more, equal at ATOL."""
    overrides = MAIN_PATH + ["mppi.exploration_noise=0"]
    jloop = JaxSimLoop(jax_load_config("config_point", overrides))
    jloop.warmup(2)
    for i in range(3):
        jloop.tick(i)
    path = jax_save_checkpoint(str(tmp_path / "jax_ckpt"), jloop.tamp, jloop.state)
    assert "mppi/rng" in np.load(path).files

    ploop = SimLoop(load_config("config_point", overrides), device="cpu")
    ploop.state = load_checkpoint(path, ploop.tamp, ploop.state, device="cpu")
    for got, ref in ((ploop.state, convert.point_env_state_from_numpy(_leaves(jloop.state))),
                     (ploop.tamp.mppi_state, convert.mppi_state_from_numpy(_leaves(jloop.tamp.mppi_state)))):
        for f in dataclasses.fields(ref):
            assert torch.equal(getattr(got, f.name), getattr(ref, f.name)), f.name
    assert ploop.tamp.task_planner.task == "push_pull"
    for i in range(3, 6):
        jloop.tick(i)
        ploop.tick(i)
        np.testing.assert_allclose(ploop.log.robot_pos[-1], jloop.log.robot_pos[-1], atol=ATOL, rtol=0)
        np.testing.assert_allclose(ploop.log.box_pos[-1], jloop.log.box_pos[-1], atol=ATOL, rtol=0)
    assert np.linalg.norm(ploop.log.robot_pos[-1] - jloop.log.robot_pos[0]) > 0.01
