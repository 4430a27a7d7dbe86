"""The compiled control tick (``tamp/graph_tick.py``) on the CPU.

On the CPU there is no CUDA graph: the compiled tick runs its body over the
static buffers (carry copied in, the next carry written back in place, a
device tick counter), which is what a capture records on the card.  Here:

* that static-buffer tick, run for N ticks, equals the eager chunk
  (``graphs=False``) bit for bit, every chunk output and the final carry:
  the point main path with the gate on over ticks 0-120 (the dyn-obs square
  wave crosses both of its edges, at 26 and 75) and off, the heijn base,
  the albert push_reach, the panda table pick, and B=3 point and panda
  batches with seed 0 pre-latched by ``done0``;
* the same ticks through the JAX package's ``run_chunk`` /
  ``run_chunk_panda`` with ``mppi.exploration_noise=0`` (the JAX planner
  and env states carried in with ``utils/convert.py``), within
  tests/test_pallas.py's bars: the planar families' trajectory bar 1e-3
  (:259-260) on every view, the panda's and albert's 1e-4 (:379-384,
  :818-821);
* the device counter's dyn-obs sign equals the host index's for ticks
  0-400; ``graphs=True`` on the CPU raises; a checkpoint taken through the
  static buffers resumes bit for bit; ``reset`` re-seeds in place and
  re-captures nothing, and a batch that returns to a seed count replays
  the generators its program registered; gradient refinement and a planner
  sharded over one device compile, and a planner sharded over distinct
  devices runs the eager tick by rule.

Sizes: K=8, T=8 (the panda T=4).
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from m3p2i_aip_tpu.config.config_store import load_config as jax_load_config
from m3p2i_aip_tpu.tamp.sim_loop import SimLoop as JaxSimLoop
from m3p2i_aip_tpu_torch.config.config_store import load_config
from m3p2i_aip_tpu_torch.envs import make_env, update_dyn_obs_device
from m3p2i_aip_tpu_torch.parallel import make_mesh, shard_planner
from m3p2i_aip_tpu_torch.tamp import graph_tick
from m3p2i_aip_tpu_torch.tamp.batch_loop import BatchSimLoop
from m3p2i_aip_tpu_torch.tamp.reactive_tamp import ReactiveTAMP
from m3p2i_aip_tpu_torch.tamp.sim_loop import SimLoop
from m3p2i_aip_tpu_torch.utils import convert
from m3p2i_aip_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint

SMALL = ["mppi.num_samples=8", "mppi.horizon=8"]
HYBRID = ["task=push_pull", "multi_modal=True", "goal=[-3.75,-3.75]"]
# (config, overrides, warm-up, ticks, gate): the single-loop cases
CASES = {
    "point_gated_0_120": ("config_point", [*HYBRID, *SMALL], 10, 121, True),
    "point_gate_off": ("config_point", [*HYBRID, *SMALL], 10, 12, False),
    "heijn_push": ("config_heijn", ["task=push", "goal=[-1,-1]", *SMALL], 10, 12, True),
    "albert_push_reach": ("config_albert", ["task=push_reach", "goal=[3.0,0.0,0.6]", *SMALL], 10, 12, True),
    "panda_table": ("config_panda", ["mppi.num_samples=8", "mppi.horizon=4"], 10, 12, True),
}
BATCH_CASES = {
    "point": ("config_point", [*HYBRID, *SMALL]),
    "panda": ("config_panda", ["multi_modal=True", "mppi.num_samples=8", "mppi.horizon=4"]),
}
BATCH_TICKS = 8
PLANAR_TRAJ_ATOL = 1e-3  # tests/test_pallas.py:259-260: the planar rollouts' trajectory bar
PANDA_ALBERT_ATOL = 1e-4  # tests/test_pallas.py:379-384 (panda), :818-821 (albert)


def _leaves(x) -> dict:
    return {
        f.name: np.asarray(getattr(x, f.name))
        for f in dataclasses.fields(x)
        if f.metadata.get("pytree_node", True) and getattr(x, f.name) is not None
    }


def _assert_same(a, b, where: str) -> None:
    """Every tensor of ``a`` and ``b`` (the same structure) equal bit for bit."""
    la, lb = graph_tick._leaves(a), graph_tick._leaves(b)
    assert len(la) == len(lb), where
    for i, (x, y) in enumerate(zip(la, lb)):
        assert x.dtype == y.dtype and torch.equal(x, y), f"{where}: leaf {i} differs"


def _settled(tamp: ReactiveTAMP, warmup: int):
    """The scene after ``warmup`` zero-action steps (every case's start)."""
    env = tamp.env
    state, u = env.init_state(), torch.zeros(env.nu)
    for _ in range(warmup):
        state = env.step(state, u, env.zero_ext())
    return state


def _chunk(tamp: ReactiveTAMP, state, ticks: int, gate: bool):
    """One chunk of ``ticks`` from the planner's fresh state (tick 0)."""
    if tamp.env.env_type == "panda_env":
        return tamp.run_chunk_panda(tamp.mppi_state, state, 0, tamp.zup_zs0(), ticks)
    task = tamp.tamp_interface(state)
    return tamp._run_chunk_impl(tamp.mppi_state, state, task, 0, ticks, gate=gate)


@functools.lru_cache(maxsize=None)
def _static_run(case: str):
    config_name, overrides, warmup, ticks, gate = CASES[case]
    tamp = ReactiveTAMP(load_config(config_name, overrides), device="cpu")
    assert tamp.ticks.mode == graph_tick.STATIC
    return tamp, _chunk(tamp, _settled(tamp, warmup), ticks, gate)


@pytest.mark.parametrize("case", list(CASES))
def test_static_tick_equals_eager_chunk(case):
    """N ticks of the static-buffer tick against the eager chunk from the
    same planner and env state: bit for bit."""
    config_name, overrides, warmup, ticks, gate = CASES[case]
    tamp, got = _static_run(case)
    eager = ReactiveTAMP(load_config(config_name, overrides), device="cpu", graphs=False)
    assert eager.ticks.mode == graph_tick.EAGER and not eager.ticks.programs
    ref = _chunk(eager, _settled(eager, warmup), ticks, gate)
    _assert_same(got, ref, case)
    (prog,) = tamp.ticks.programs.values()
    assert prog.graph is None and prog.key[1] is None  # no graph on the CPU; one program, no seed axis


def _jax_chunk(case: str):
    """The JAX package's chunk of the same ticks, and the port's static
    chunk from the JAX states, both with the exploration noise off."""
    config_name, overrides, warmup, ticks, gate = CASES[case]
    overrides = [*overrides, "mppi.exploration_noise=0"]
    jloop = JaxSimLoop(jax_load_config(config_name, overrides))
    jloop.warmup(warmup)
    tamp = ReactiveTAMP(load_config(config_name, overrides), device="cpu")
    from_numpy = {"panda_env": convert.panda_env_state_from_numpy, "albert_env": convert.albert_state_from_numpy}.get(
        tamp.env.env_type, convert.point_env_state_from_numpy)
    state = from_numpy(_leaves(jloop.state))
    tamp.mppi_state = convert.mppi_state_from_numpy(_leaves(jloop.tamp.mppi_state))
    jt = jloop.tamp
    if tamp.env.env_type == "panda_env":
        out = jt.run_chunk_panda(jt.mppi_state, jloop.state, 0, jt.zup_zs0(), ticks)
        return tamp, tamp.run_chunk_panda(tamp.mppi_state, state, 0, tamp.zup_zs0(), ticks), out
    jt.device_gate = gate
    out = jt.run_chunk(jt.mppi_state, jloop.state, jt.tamp_interface_view(jloop._view), 0, ticks)
    task = tamp.tamp_interface(state)
    return tamp, tamp._run_chunk_impl(tamp.mppi_state, state, task, 0, ticks, gate=gate), out


@pytest.mark.parametrize("case", ["point_gated_0_120", "heijn_push", "albert_push_reach", "panda_table"])
def test_static_tick_matches_jax_package(case):
    """The static-buffer chunk against the JAX package's jitted chunk: every
    tick's view within the family's bar, and the same ticks counted."""
    tamp, got, ref = _jax_chunk(case)
    if tamp.env.env_type == "panda_env":
        views, jviews = got[5], ref[5]
        assert np.array_equal(got[6].numpy(), np.asarray(ref[6]))  # the stages
    else:
        views, jviews = got[2], ref[2]
        assert int(got[3]) == int(ref[3]) == CASES[case][3]  # n_ticks: no latch in these runs
    atol = PLANAR_TRAJ_ATOL if tamp.env.env_type == "point_env" else PANDA_ALBERT_ATOL
    assert views.shape == jviews.shape
    np.testing.assert_allclose(views.numpy(), np.asarray(jviews), atol=atol, rtol=0)
    assert np.abs(views.numpy()[-1] - views.numpy()[0]).max() > 1e-3  # the scene moved


def _batch(config_name: str, overrides: list, graphs):
    batch = BatchSimLoop(load_config(config_name, overrides), [0, 1, 2], device="cpu", graphs=graphs)
    batch.warmup(10)
    tamp, done0 = batch.tamp, torch.tensor([True, False, False])
    if batch.is_panda:
        out = tamp._run_chunk_panda_impl(batch.mppi_state, batch.state, batch._stage, batch._zs, BATCH_TICKS,
                                         done0=done0)
    else:
        for b, tp in enumerate(batch.planners):
            tp.update_plan(batch.views[b])
        out = tamp._run_chunk_impl(batch.mppi_state, batch.state, batch._stacked_task_params(), 0, BATCH_TICKS,
                                   gate=True, done0=done0)
    return batch, out


@pytest.mark.parametrize("family", list(BATCH_CASES))
def test_static_batch_tick_equals_eager_chunk(family):
    """A B=3 batch with seed 0 pre-latched: the static-buffer tick equals
    the eager chunk bit for bit, the latched seed frozen in both."""
    config_name, overrides = BATCH_CASES[family]
    batch, got = _batch(config_name, overrides, None)
    _, ref = _batch(config_name, overrides, False)
    _assert_same(got, ref, family)
    (prog,) = [p for key, p in batch.tamp.ticks.programs.items() if key[-1] != "step"]  # the warm-up's step aside
    assert prog.key[1] == 3
    rs = got[1]
    assert torch.equal(rs.q[0], batch.state.q[0])  # seed 0 entered done: untouched
    assert not torch.equal(rs.q[1], batch.state.q[1])


def test_device_counter_dyn_obs_sign_equals_host_index():
    """The compiled tick's int64 counter gives the host index's sign on
    every tick of four square-wave periods."""
    env = make_env(load_config("config_point"), device="cpu")
    state = env.init_state()
    for i in range(401):
        host = update_dyn_obs_device(env, state, i).dyn_pos
        dev = update_dyn_obs_device(env, state, torch.tensor(i, dtype=torch.int64)).dyn_pos
        assert torch.equal(host, dev), i


def test_graphs_true_on_the_cpu_raises():
    with pytest.raises(ValueError, match="CUDA"):
        ReactiveTAMP(load_config("config_point", SMALL), device="cpu", graphs=True)
    with pytest.raises(ValueError, match="CUDA"):
        graph_tick.resolve_mode(True, torch.device("cpu"))
    assert graph_tick.resolve_mode(None, torch.device("cuda")) == graph_tick.GRAPH
    assert graph_tick.resolve_mode(False, torch.device("cuda")) == graph_tick.EAGER


def test_checkpoint_through_static_buffers_resumes_bit_for_bit(tmp_path):
    """Four static-buffer ticks, a checkpoint, four more; a fresh loop loads
    the checkpoint and ticks four: the same states and log rows, with the
    exploration noise on (the generator travels with the checkpoint)."""
    cfg = ["task=push_pull", "multi_modal=True", "goal=[-3.75,-3.75]", *SMALL]
    ref = SimLoop(load_config("config_point", cfg), device="cpu")
    ref.warmup(5)
    for i in range(4):
        ref.tick(i)
    path = save_checkpoint(str(tmp_path / "ckpt"), ref.tamp, ref.state)
    for i in range(4, 8):
        ref.tick(i)
    loop = SimLoop(load_config("config_point", cfg), device="cpu")
    loop.state = load_checkpoint(path, loop.tamp, loop.state, device="cpu")
    for i in range(4, 8):
        loop.tick(i)
    assert ref.tamp.motion_planner.exploration_noise > 0
    _assert_same((ref.state, ref.tamp.mppi_state), (loop.state, loop.tamp.mppi_state), "resumed")
    assert np.array_equal(np.asarray(ref.log.robot_pos[4:]), np.asarray(loop.log.robot_pos))
    assert ref.tamp.ticks.mode == loop.tamp.ticks.mode == graph_tick.STATIC


def test_reset_reseeds_in_place_and_keeps_the_programs():
    """After ``reset`` the same programs run (nothing is made anew) and the
    run equals a fresh loop's; a batch re-seeded with as many seeds keeps
    its generators."""
    cfg = load_config("config_point", [*HYBRID, *SMALL])
    loop = SimLoop(cfg, device="cpu")
    loop.warmup(5)
    loop.run_chunked(4, chunk=2)
    programs = dict(loop.tamp.ticks.programs)
    gen = loop.tamp.motion_planner.generator
    loop.reset(3)
    loop.warmup(5)
    again = loop.run_chunked(4, chunk=2)
    assert loop.tamp.ticks.programs == programs and loop.tamp.motion_planner.generator is gen
    fresh = SimLoop(load_config("config_point", [*HYBRID, *SMALL, "mppi.seed_val=3"]), device="cpu")
    fresh.warmup(5)
    ref = fresh.run_chunked(4, chunk=2)
    assert np.array_equal(np.asarray(again.robot_pos), np.asarray(ref.robot_pos))

    batch = BatchSimLoop(cfg, [0, 1], device="cpu")
    gens = list(batch.tamp.motion_planner.seed_generators)
    batch.reset([5, 6])
    assert all(a is b for a, b in zip(gens, batch.tamp.motion_planner.seed_generators))


def _batch_positions(batch, seeds) -> list:
    batch.reset(seeds)
    batch.warmup(5)
    return [np.asarray(g.robot_pos) for g in batch.run_chunked(4, chunk=2)]


def test_batch_returning_to_a_seed_count_keeps_its_program_generators():
    """B=3, then B=2, then B=3 again on one batch: the B=3 program replays
    the generators it registered (those the planner draws from), and the
    second B=3 run equals a fresh batch's bit for bit."""
    cfg = load_config("config_point", [*HYBRID, *SMALL])
    batch = BatchSimLoop(cfg, [0, 1, 2], device="cpu")
    _batch_positions(batch, [0, 1, 2])
    _batch_positions(batch, [3, 4])
    got = _batch_positions(batch, [0, 1, 2])
    mp = batch.tamp.motion_planner
    (prog,) = [p for key, p in batch.tamp.ticks.programs.items() if key[1] == 3]
    assert len(prog.generators) == 3 and all(a is b for a, b in zip(prog.generators, mp.seed_generators))
    ref = _batch_positions(BatchSimLoop(cfg, [0, 1, 2], device="cpu"), [0, 1, 2])
    for a, b in zip(got, ref):
        assert np.array_equal(a, b)


def test_program_refuses_generators_it_did_not_register():
    """A planner whose seed generators were swapped after its tick was made
    raises at the next chunk rather than replaying the old generators."""
    batch = BatchSimLoop(load_config("config_point", [*HYBRID, *SMALL]), [0, 1, 2], device="cpu")
    batch.warmup(5)
    batch.run_chunked(2, chunk=2)
    mp = batch.tamp.motion_planner
    mp.seed_generators = [torch.Generator(device="cpu") for _ in mp.seed_generators]
    with pytest.raises(RuntimeError, match="other generators"):
        batch.run_chunked(2, chunk=2)


def test_grad_refine_and_a_one_card_mesh_compile(capsys):
    """A gradient-refining planner and a planner sharded over one device
    (a mesh of repeated ``cpu``) both run the compiled tick, saying nothing."""
    tamp = ReactiveTAMP(load_config("config_point", [*SMALL, "mppi.grad_refine_steps=1"]), device="cpu")
    assert tamp.ticks.mode == graph_tick.STATIC and tamp._compiled()
    tamp = ReactiveTAMP(load_config("config_point", SMALL), device="cpu")
    shard_planner(tamp.motion_planner, make_mesh([torch.device("cpu")] * 2))
    assert tamp.ticks.mode == graph_tick.STATIC and tamp._compiled()
    assert capsys.readouterr().err == ""


def test_mesh_over_distinct_devices_runs_eager_by_rule(capsys):
    """A planner sharded over distinct devices runs the eager tick, and says
    why once (a graph across cards cannot be checked on one card)."""
    tamp = ReactiveTAMP(load_config("config_point", SMALL), device="cpu")
    shard_planner(tamp.motion_planner, make_mesh([torch.device("cpu"), torch.device("cuda", 0)]))
    assert tamp.ticks.mode == graph_tick.STATIC and not tamp._compiled()
    assert "distinct cards" in capsys.readouterr().err
    assert not tamp._compiled() and capsys.readouterr().err == ""  # said once


def test_copy_into_checks_the_structure():
    dst = (torch.zeros(2), {"a": torch.zeros(3)})
    graph_tick.copy_into(dst, (torch.ones(2), {"a": torch.full((3,), 2.0)}))
    assert torch.equal(dst[0], torch.ones(2)) and torch.equal(dst[1]["a"], torch.full((3,), 2.0))
    with pytest.raises(ValueError, match="structure"):
        graph_tick.copy_into(dst, (torch.ones(2),))

