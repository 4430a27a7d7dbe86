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
* the planner's command (``ReactiveTAMP._command``, behind ``run_tamp``):
  ten calls with the generator's draws, and with ``exploration_noise=0``
  within tests/test_pallas.py's bars of the JAX ``MPPI.command``
  (planar 1e-3, :259-260; panda 1e-4, :379-384);
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
from m3p2i_aip_tpu_torch.scripts import graph_ab
from m3p2i_aip_tpu_torch.scripts.sim import ClientStep, client_views, drive
from m3p2i_aip_tpu_torch.tamp import graph_tick
from m3p2i_aip_tpu_torch.tamp.batch_loop import BatchSimLoop
from m3p2i_aip_tpu_torch.tamp.reactive_tamp import ReactiveTAMP
from m3p2i_aip_tpu_torch.tamp.sim_loop import SimLoop, real_suction_ext
from m3p2i_aip_tpu_torch.utils import convert
from m3p2i_aip_tpu_torch.utils.tree import tree_map

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
    assert tamps[0].ticks.mode == graph_tick.STATIC and list(tamps[0].ticks.programs) == [("command", None)]


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
    assert ("command", None) in tamp.ticks.programs


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
