"""The programs compiled besides the tick (``tamp/graph_tick.py``) on the CPU.

On the CPU a compiled program runs its body over its static buffers, which
is what a capture records on the card.  Here, each against its eager twin
(``graphs=False``) bit for bit, and where stated against the JAX package:

* the env step (``graph_tick.env_steps``: warm-ups and settles) for the
  point, panda and albert over a 150-step warm-up, at B=1 and B=3, and the
  panda settle of ``SimLoop`` and of a B=3 ``BatchSimLoop``;
* the sim client's step (``scripts/sim.py`` ``ClientStep``): 401 ticks of
  ``drive`` send the eager client's views tick for tick (the dyn-obs sign of
  the device counter is ``update_dyn_obs``'s over ticks 0-400), and the
  suction grant, a device input, is honoured both ways;
* the planner's command (``MPPI.command``, the JAX package's jitted
  ``MPPI._command``; behind ``run_tamp`` too): ten calls with the
  generator's draws through ``run_tamp_sequence`` and ten chained direct
  calls (point, panda, albert, a B=3 seed batch, a standalone ``M3P2I``
  and tests/test_torch_planner_modes.py's toy planner), no returned tensor
  aliasing the program's buffers, ``set_mesh`` dropping the captured
  command; and with ``exploration_noise=0`` within tests/test_pallas.py's
  bars of the JAX ``MPPI.command`` (planar 1e-3, :259-260; panda 1e-4,
  :379-384), through ``run_tamp_sequence`` and directly;
* gradient refinement inside the tick (``graph_tick.repeat``): the panda's
  and the point's static ticks, a B=3 refined batch within 1e-5 of three
  single runs (the batch-vs-serial bar, tests/test_pallas.py:475), and the
  refined command within the bars of the JAX package's;
* a sample-sharded planner over a mesh of repeated ``cpu``: its static tick.

The checks run ``scripts/graph_ab.py``'s parity runs at a small size.
Sizes: K=8, T=8 (the panda T=4).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from m3p2i_aip_tpu.config.config_store import load_config as jax_load_config
from m3p2i_aip_tpu.tamp.sim_loop import SimLoop as JaxSimLoop
from m3p2i_aip_tpu_torch.config.config_store import load_config
from m3p2i_aip_tpu_torch.envs import make_env, update_dyn_obs
from m3p2i_aip_tpu_torch.ops.rollout import make_point_rollout
from m3p2i_aip_tpu_torch.parallel import make_mesh, shard_planner
from m3p2i_aip_tpu_torch.planners.motion_planner.m3p2i import M3P2I
from m3p2i_aip_tpu_torch.planners.motion_planner.mppi import make_task_params
from m3p2i_aip_tpu_torch.scripts import graph_ab
from m3p2i_aip_tpu_torch.scripts.sim import ClientStep, client_views, drive
from m3p2i_aip_tpu_torch.tamp import graph_tick
from m3p2i_aip_tpu_torch.tamp.batch_loop import BatchSimLoop
from m3p2i_aip_tpu_torch.tamp.reactive_tamp import ReactiveTAMP
from m3p2i_aip_tpu_torch.tamp.sim_loop import SimLoop, real_suction_ext
from m3p2i_aip_tpu_torch.utils import convert
from m3p2i_aip_tpu_torch.utils.tree import tree_map
from test_torch_planner_modes import _GOAL, _Toy, _toy_mppi

SMALL = ["mppi.num_samples=8", "mppi.horizon=8"]
PANDA_SMALL = ["mppi.num_samples=8", "mppi.horizon=4"]
HYBRID = ["task=push_pull", "multi_modal=True", "goal=[-3.75,-3.75]"]
FAMILIES = {
    "point": ("config_point", [*HYBRID, *SMALL]),
    "panda": ("config_panda", ["multi_modal=True", *PANDA_SMALL]),
    "albert": ("config_albert", ["task=push_reach", "goal=[3.0,0.0,0.6]", *SMALL]),
}
REFINE = ["mppi.grad_refine_steps=2", "mppi.refine_iters=0"]
NOISE_OFF = "mppi.exploration_noise=0"
BARS = {"point": 1e-3, "panda": 1e-4}  # tests/test_pallas.py:259-260 (planar trajectories), :379-384 (panda)
BATCH_ATOL = 1e-5  # a batch against serial runs (tests/test_pallas.py:475)
CLIENT_TICKS = 401  # ticks 0-400: the dyn-obs square wave crosses both edges four times


def _assert_same(a, b, where: str) -> None:
    """Every tensor of ``a`` and ``b`` (the same structure) equal bit for bit."""
    la, lb = graph_tick._leaves(a), graph_tick._leaves(b)
    assert len(la) == len(lb), where
    for i, (x, y) in enumerate(zip(la, lb)):
        assert x.dtype == y.dtype and torch.equal(x, y), f"{where}: leaf {i} differs"


def _seeds(state, B: int):
    """B copies of ``state``, seed b's joint or base positions moved by 0.01 b."""
    batch = tree_map(lambda x: x.expand((B,) + x.shape).clone(), state)
    batch.q.add_(0.01 * torch.arange(B, dtype=torch.float32)[:, None])
    return batch


# ------------------------------------------------------------------ the env step
@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_static_warmup_equals_eager_steps(family, B):
    config_name, overrides = FAMILIES[family]
    env = make_env(load_config(config_name, overrides), "cpu")
    state = env.init_state() if B == 1 else _seeds(env.init_state(), B)
    lead = () if B == 1 else (B,)
    zero_u = torch.zeros(lead + (env.nu,))
    ext = env.zero_ext(lead) if lead else env.zero_ext()
    ticks = graph_tick.TickGraphs(torch.device("cpu"), None)
    got = graph_tick.env_steps(ticks, env, state, zero_u, ext, 150)
    ref = state
    for _ in range(150):
        ref = env.step(ref, zero_u, ext)
    _assert_same(got, ref, f"{family} B={B}")
    (key,) = ticks.programs
    assert key == (env.env_type, None if B == 1 else B, "step")


def test_static_settle_equals_eager_settle():
    """The panda settle (open gripper) of one loop and of a B=3 batch."""
    config_name, overrides = FAMILIES["panda"]
    loops = [SimLoop(load_config(config_name, overrides), device="cpu", graphs=g) for g in (None, False)]
    for loop in loops:
        loop.warmup(20)
        loop.settle(150)
    _assert_same(loops[0].state, loops[1].state, "panda settle")
    assert loops[0].tamp.ticks.mode == graph_tick.STATIC and len(loops[0].tamp.ticks.programs) == 1
    batches = [BatchSimLoop(load_config(config_name, overrides), [0, 1, 2], device="cpu", graphs=g)
               for g in (None, False)]
    for batch in batches:
        batch.warmup(20)
        batch.state = _seeds(tree_map(lambda x: x[0], batch.state), 3)
        batch.settle(150)
    _assert_same(batches[0].state, batches[1].state, "panda batch settle")
    assert ("panda_env", 3, "step") in batches[0].tamp.ticks.programs
    for got, ref in zip(batches[0].views, batches[1].views):
        assert all(np.array_equal(np.asarray(got[k]), np.asarray(ref[k])) for k in ref), "views"


# ---------------------------------------------------------------- the sim client
class _Planner:
    """A deterministic stand-in for the planner server: an action from the
    tick index, the suction grant alternating, every view it is sent kept."""

    def __init__(self, nu: int) -> None:
        self.nu, self.sent, self.i = nu, [], 0

    def run_tamp(self, dof, root):
        self.sent.append((np.array(dof), np.array(root)))
        self.i += 1
        return np.full(self.nu, 0.5 * np.sin(0.1 * self.i), np.float32)

    def get_suction(self):
        return self.i % 2

    def get_trajs(self):
        return None


def test_client_sends_the_eager_views_over_ticks_0_400():
    """``drive`` compiled and eager, 401 ticks: the same views tick for
    tick (the dyn-obs row moves with ``update_dyn_obs``'s sign at every
    tick) and the same final state."""
    cfg = load_config("config_point", ["task=pull", "goal=[0,0]"])
    runs = []
    for graphs in (None, False):
        planner = _Planner(2)
        env, state, _, _ = drive(load_config("config_point", ["task=pull", "goal=[0,0]"]), planner,
                                 n_ticks=CLIENT_TICKS, pace=False, device="cpu", graphs=graphs)
        runs.append((planner.sent, state))
    (sent, state), (sent_ref, state_ref) = runs
    assert len(sent) == len(sent_ref) == CLIENT_TICKS
    for i, ((dof, root), (dof_r, root_r)) in enumerate(zip(sent, sent_ref)):
        assert dof.tobytes() == dof_r.tobytes() and root.tobytes() == root_r.tobytes(), f"tick {i}"
    _assert_same(state, state_ref, "final state")
    env = make_env(cfg, "cpu")
    dyn = env.params.dyn_actor_idx[env.dyn_obs_slot]
    moves = np.diff(np.stack([root[dyn, :2] for _, root in sent]), axis=0)
    signs = np.sign(moves[:, 0])
    ref = [1.0 if 25 < i % 100 < 75 else -1.0 for i in range(1, CLIENT_TICKS)]  # the wave of ticks 1-400
    assert np.array_equal(signs, ref)


@pytest.mark.parametrize("suction", [True, False])
def test_client_step_honours_the_suction_grant(suction):
    """The robot 0.3 m from the box, commanded away from it, on a pull: the
    compiled step applies suction exactly when granted, as the host's
    ``real_suction_ext`` does with ``cfg.suction_active``."""
    cfg = load_config("config_point", ["task=pull", "goal=[0,0]"])
    env = make_env(cfg, "cpu")
    state = env.init_state()
    box = state.dyn_pos[env.box_slot]
    state = dataclasses.replace(state, q=box + torch.tensor([0.3, 0.0]))
    action = np.array([1.0, 0.0], np.float32)
    step = ClientStep(graph_tick.TickGraphs(torch.device("cpu"), None), cfg, env, state)
    got = step(action, suction)
    cfg.suction_active = suction
    ref = update_dyn_obs(env, state, 0)
    ext = real_suction_ext(cfg, env, ref, torch.as_tensor(action))
    assert bool(torch.any(ext.robot != 0)) == suction  # the condition holds: only the grant decides
    ref = env.step(ref, torch.as_tensor(action), ext)
    _assert_same(got, ref, "the step")
    assert torch.equal(step._views, client_views(env, update_dyn_obs(env, ref, 1)))


# ---------------------------------------------------------------- the command
def _planner_pair(config_name: str, overrides: list):
    return [ReactiveTAMP(load_config(config_name, overrides), device="cpu", graphs=g) for g in (None, False)]


@pytest.mark.parametrize("family", list(FAMILIES))
def test_static_command_equals_eager_command(family):
    """Ten ``run_tamp_sequence`` calls with the generator's draws, the real
    state stepped by each call's first action: the actions, the planner
    state and the top trajectories bit for bit."""
    config_name, overrides = FAMILIES[family]
    tamps = _planner_pair(config_name, overrides)
    state = tamps[1].env.init_state()
    for call in range(10):
        acts = [t.run_tamp_sequence(state) for t in tamps]
        assert torch.equal(acts[0], acts[1]), f"call {call}"
        _assert_same(tamps[0].mppi_state, tamps[1].mppi_state, f"call {call}")
        assert torch.equal(tamps[0].get_trajs(), tamps[1].get_trajs()), f"call {call}"
        assert tamps[0].get_suction() == tamps[1].get_suction()
        state = tamps[1].env.step(state, acts[1][0], tamps[1].env.zero_ext())
    assert tamps[0].ticks.mode == graph_tick.STATIC and tamps[0].ticks is tamps[0].motion_planner.ticks
    assert [key[:4] for key in tamps[0].ticks.programs] == [("command", None, None, 0)]  # the planner's program


def _leaves(x) -> dict:
    return {f.name: np.asarray(getattr(x, f.name)) for f in dataclasses.fields(x)
            if f.metadata.get("pytree_node", True) and getattr(x, f.name) is not None}


def _jax_pair(config_name: str, overrides: list):
    """The JAX loop and the port's static planner from one start state and
    planner state (carried with ``utils/convert.py``)."""
    jloop = JaxSimLoop(jax_load_config(config_name, overrides))
    tamp = ReactiveTAMP(load_config(config_name, overrides), device="cpu")
    from_numpy = {"point_env": convert.point_env_state_from_numpy,
                  "panda_env": convert.panda_env_state_from_numpy}[tamp.env.env_type]
    jstate = jloop.env.init_state()
    if tamp.env.env_type == "point_env":  # the robot next to the box: contact and suction in play
        jstate = jstate.replace(q=jnp.asarray([0.0, 1.5], jnp.float32), qd=jnp.asarray([0.0, -1.0], jnp.float32))
    tamp.mppi_state = convert.mppi_state_from_numpy(_leaves(jloop.tamp.mppi_state))
    return jloop, jstate, tamp, from_numpy(_leaves(jstate))


@pytest.mark.parametrize("refine", [False, True], ids=["plain", "grad_refine"])
@pytest.mark.parametrize("family", ["point", "panda"])
def test_static_command_matches_jax_command(family, refine):
    """Two ``run_tamp_sequence`` calls of the static command from the JAX
    package's state, ``exploration_noise=0``: within the family's bar of
    the JAX ``MPPI.command``'s actions (with gradient refinement too)."""
    config_name = {"point": "config_point", "panda": "config_panda"}[family]
    overrides = [*({"point": HYBRID, "panda": ["multi_modal=True"]}[family]),
                 "mppi.num_samples=16", NOISE_OFF, *(REFINE if refine else [])]
    jloop, jstate, tamp, pstate = _jax_pair(config_name, overrides)
    for call in range(2):
        jact = np.asarray(jloop.tamp.run_tamp_sequence(jstate))
        pact = tamp.run_tamp_sequence(pstate).numpy()
        np.testing.assert_allclose(pact, jact, atol=BARS[family], rtol=0, err_msg=f"call {call}")
    assert [key[:2] for key in tamp.ticks.programs] == [("command", None)]


def _chain(planner, state, real_state, task, step, n: int = 10) -> list:
    """``n`` chained ``planner.command`` calls, the real state moved by
    ``step(real_state, actions)`` after each; every call's outputs."""
    out = []
    for _ in range(n):
        action, state, aux = planner.command(state, real_state, task)
        out.append((action, state, aux))
        real_state = step(real_state, action)
    return out


def _env_chain(tamp, B: int = 1) -> list:
    """Ten direct commands of ``tamp``'s planner from its start scene (a
    B-seed batch when ``B`` > 1), the env stepped by each first action."""
    mp, env = tamp.motion_planner, tamp.env
    real = env.init_state()
    task = tamp.tamp_interface(real)
    state = tamp.mppi_state
    if B > 1:
        real, state = _seeds(real, B), mp.init_state_batch(list(range(B)))
        task = tree_map(lambda x: x.expand((B,) + x.shape), task)
    ext = env.zero_ext((B,)) if B > 1 else env.zero_ext()
    return _chain(mp, state, real, task, lambda r, a: env.step(r, a[..., 0, :], ext))


@pytest.mark.parametrize("family, B", [("point", 1), ("panda", 1), ("albert", 1), ("point", 3)])
def test_direct_command_static_equals_eager(family, B):
    """Ten chained ``MPPI.command`` calls, compiled (static) against
    ``graphs=False``: actions, planner states and aux bit for bit, one
    program for the chain."""
    config_name, overrides = FAMILIES[family]
    tamps = _planner_pair(config_name, overrides)
    got, ref = (_env_chain(t, B) for t in tamps)
    _assert_same(got, ref, f"{family} B={B}")
    assert [key[:2] for key in tamps[0].ticks.programs] == [("command", None if B == 1 else B)]
    assert not tamps[1].ticks.programs


def _toy_chain(planner) -> list:
    task = make_task_params("navigation", [_GOAL, 0.0])
    return _chain(planner, planner.init_state(), _Toy(s=torch.zeros(1)), task, lambda r, a: _Toy(s=r.s + 0.1 * a[0]))


@pytest.mark.parametrize("planner", ["m3p2i", "toy"])
def test_standalone_planner_command_static_equals_eager(planner):
    """A planner built on its own makes its own programs from its device: a
    standalone ``M3P2I`` on the point hybrid and the toy planner, ten
    chained commands each, compiled against ``graphs=False``."""
    runs = []
    for graphs in (None, False):
        if planner == "toy":
            mp = _toy_mppi()
            mp.ticks = graph_tick.TickGraphs(mp.device, graphs)
            runs.append((mp, _toy_chain(mp)))
            continue
        cfg = load_config(*FAMILIES["point"][:1], FAMILIES["point"][1])
        env = make_env(cfg, "cpu")
        rollout = make_point_rollout(env.params, float(cfg.kp_suction), cfg.mppi.num_samples, cfg.mppi.horizon, True)
        mp = M3P2I(cfg, rollout, device="cpu", graphs=graphs)
        real = env.init_state()
        task = make_task_params(cfg.task, cfg.goal)
        runs.append((mp, _chain(mp, mp.init_state(), real, task,
                                lambda r, a: env.step(r, a[0], env.zero_ext()))))
    (mp, got), (eager, ref) = runs
    _assert_same(got, ref, planner)
    assert mp.ticks.mode == graph_tick.STATIC and len(mp.ticks.programs) == 1 and not eager.ticks.programs


def test_command_returns_the_callers_own_tensors():
    """No returned tensor shares memory with the program's buffers; a state
    held from call 1 is unchanged by calls 2-10; two calls from one state
    (no exploration noise) return equal results."""
    config_name, overrides = FAMILIES["point"]
    tamp = ReactiveTAMP(load_config(config_name, [*overrides, NOISE_OFF]), device="cpu")
    mp, env = tamp.motion_planner, tamp.env
    real = env.init_state()
    task = tamp.tamp_interface(real)
    first = mp.command(tamp.mppi_state, real, task)
    kept = graph_tick.clone(first)
    (prog,) = mp.ticks.programs.values()
    buffers = {x.untyped_storage().data_ptr() for x in graph_tick._leaves((prog.carry, prog.inputs, prog.outputs))}
    rest = _chain(mp, first[1], real, task, lambda r, a: env.step(r, a[0], env.zero_ext()), n=9)
    for call, out in enumerate([first, *rest]):
        shared = [x.shape for x in graph_tick._leaves(out) if x.untyped_storage().data_ptr() in buffers]
        assert not shared, f"call {call + 1} returns views of the program's buffers: {shared}"
    _assert_same(first, kept, "call 1's outputs after calls 2-10")
    again = [mp.command(first[1], real, task) for _ in range(2)]
    _assert_same(again[0], again[1], "two calls from one state")


def test_set_mesh_drops_the_compiled_command():
    """A planner that has compiled its command, then sharded over 4
    repeated ``cpu`` devices: its programs are gone, and its next command
    equals a fresh sharded planner's bit for bit."""
    config_name, overrides = FAMILIES["point"]
    tamps = [ReactiveTAMP(load_config(config_name, overrides), device="cpu") for _ in range(2)]
    real = tamps[0].env.init_state()
    task = tamps[0].tamp_interface(real)
    state, draws = tamps[0].mppi_state, tamps[0].motion_planner.generator.get_state()
    tamps[0].motion_planner.command(state, real, task)
    tamps[0].motion_planner.generator.set_state(draws)  # the draws of a fresh planner
    assert tamps[0].ticks.programs
    for tamp in tamps:
        shard_planner(tamp.motion_planner, make_mesh([torch.device("cpu")] * 4))
    assert not tamps[0].ticks.programs
    got, ref = (t.motion_planner.command(state, real, task) for t in tamps)
    _assert_same(got, ref, "the sharded command")
    ((key, prog),) = tamps[0].ticks.programs.items()
    assert key[2].size == 4 and prog.graph is None


@pytest.mark.parametrize("family", ["point", "panda"])
def test_direct_command_matches_jax_command(family):
    """Two chained direct ``MPPI.command`` calls of the compiled (static)
    planner from the JAX package's states, ``exploration_noise=0``: within
    the family's bar of the JAX package's jitted ``MPPI.command``, actions
    and means."""
    config_name = {"point": "config_point", "panda": "config_panda"}[family]
    overrides = [*({"point": HYBRID, "panda": ["multi_modal=True"]}[family]), "mppi.num_samples=16", NOISE_OFF]
    jloop, jstate, tamp, pstate = _jax_pair(config_name, overrides)
    jtask, ptask = jloop.tamp.tamp_interface(jstate), tamp.tamp_interface(pstate)
    jms, pms = jloop.tamp.mppi_state, tamp.mppi_state
    for call in range(2):
        jact, jms, _ = jloop.tamp.motion_planner.command(jms, jstate, jtask)
        pact, pms, _ = tamp.motion_planner.command(pms, pstate, ptask)
        jact = np.asarray(jact)
        np.testing.assert_allclose(pact.numpy()[: jact.shape[0]], jact, atol=BARS[family], rtol=0,
                                   err_msg=f"call {call}")
        for name in ("mean_action", "mean_action_1", "mean_action_2"):
            np.testing.assert_allclose(getattr(pms, name).numpy(), np.asarray(getattr(jms, name)),
                                       atol=BARS[family], rtol=0, err_msg=f"call {call} {name}")
    assert [key[:2] for key in tamp.ticks.programs] == [("command", None)]


# ------------------------------------------------------------ gradient refinement
@pytest.mark.parametrize("family", ["point", "panda"])
def test_grad_refined_static_tick_equals_eager_tick(family):
    config_name, overrides = FAMILIES[family]
    runs = [graph_ab.run_loop(config_name, [*overrides, *REFINE], g, 10, 4, 2, True, device="cpu")
            for g in (False, None)]
    graph_ab.parity(f"{family} grad-refine", *runs)
    assert runs[1]["loop"].tamp.ticks.mode == graph_tick.STATIC


def test_grad_refined_batch_equals_single_runs():
    """A B=3 refined panda batch, one chunk of 2 ticks, against three serial
    runs: each seed's means within the batch-vs-serial bar (the seed batch's
    chains run as one plain rollout of B x 3 rows)."""
    config_name, overrides = FAMILIES["panda"]
    cfg = [*overrides, *REFINE]
    batch = BatchSimLoop(load_config(config_name, cfg), [0, 1, 2], device="cpu")
    batch.warmup(10)
    batch.run_chunked(2, chunk=2)
    for b in range(3):
        loop = SimLoop(load_config(config_name, cfg), device="cpu")
        loop.reset(b)
        loop.warmup(10)
        loop.run_chunked(2, chunk=2)
        for name in ("mean_action", "mean_action_1", "mean_action_2"):
            np.testing.assert_allclose(getattr(batch.mppi_state, name)[b].numpy(),
                                       getattr(loop.tamp.mppi_state, name).numpy(), rtol=0, atol=BATCH_ATOL,
                                       err_msg=f"seed {b} {name}")


# ------------------------------------------------------------------- sharding
def test_one_device_sharded_static_tick_equals_eager_tick():
    config_name, overrides = FAMILIES["point"]
    runs = [graph_ab.run_loop(config_name, overrides, g, 10, 6, 3, True, device="cpu", shards=4)
            for g in (False, None)]
    graph_ab.parity("point x4 shards", *runs)
    tamp = runs[1]["loop"].tamp
    assert tamp.motion_planner.mesh.size == 4 and tamp._compiled() and tamp.ticks.programs


def test_two_terminals_in_process_static_equal_eager():
    """``graph_ab``'s in-process two terminals (the client's steps and the
    server's command compiled) against both eager, six point ticks."""
    label, config_name, overrides, _ = graph_ab.TWO_TERMINAL[0]
    runs = [graph_ab.run_two_terminal(config_name, [*overrides, *SMALL], g, 6, device="cpu") for g in (False, None)]
    graph_ab.parity(label, *runs)
    assert runs[1]["log"]["ticks"] == 6
