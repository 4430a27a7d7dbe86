"""The closed-loop kernel check of ``chip_smoke.py`` (``_closed_loop_check``)
on the CPU, with the plain point, panda and albert rollouts at K = 8, T = 3
standing in for a kernel, each at its family's bars (the albert's are
tighter): the check passes an output equal to the plain version's, fails on
a sample that no nudge of its own actions explains and names it, and lets a
sample through only when a nudge of all that sample's actions by at most
``NUDGE_ULPS`` ulp carries the plain version to the kernel's output
there."""
import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke
from m3p2i_aip_tpu_torch.config.config_store import load_config
from m3p2i_aip_tpu_torch.envs import make_env
from m3p2i_aip_tpu_torch.ops import albert_rollout as ar
from m3p2i_aip_tpu_torch.ops import panda_rollout as pr
from m3p2i_aip_tpu_torch.ops import rollout as ro
from m3p2i_aip_tpu_torch.planners.motion_planner.mppi import make_task_params
from m3p2i_aip_tpu_torch.tamp.reactive_tamp import ReactiveTAMP
from m3p2i_aip_tpu_torch.utils.tree import tree_map

B, K, T = 2, 8, 3


def _with_spec(plain, spec):
    plain.spec = spec
    return plain


def _point():
    """(plain, inputs): the batched plain point rollout and two seeds'
    inputs from the push_pull start with their own random actions."""
    cfg = load_config("config_point", ["task=push_pull", "multi_modal=True", "goal=[-3.75,-3.75]"])
    env = make_env(cfg, device="cpu")
    spec = ro.make_point_rollout(env.params, float(cfg.kp_suction), K, T, True).spec
    sk = tree_map(lambda x: x.expand((K,) + x.shape), env.init_state())
    row = ro.rollout_inputs(sk, make_task_params("push_pull", [-3.75, -3.75], device="cpu"))
    acts = np.random.default_rng(0).uniform(-3, 3, size=(B, K, T, env.nu)).astype(np.float32)
    inputs = chip_smoke._stack_rows([row] * B, torch.as_tensor(acts))
    return _with_spec(lambda *x: ro.point_rollout_batched_plain(spec, *x), spec), inputs


def _panda():
    """(plain, inputs): the batched plain panda rollout and two seeds'
    inputs from the near_cubeB parity start (pick) with random actions."""
    cfg = load_config("config_panda")
    env = make_env(cfg, device="cpu")
    spec = pr.make_panda_rollout(env.params, float(cfg.pre_height_diff), K, T, False).spec
    sk = tree_map(lambda x: x.expand((K,) + x.shape), pr.parity_state(env.init_state(), "near_cubeB"))
    row = pr.rollout_inputs(sk, make_task_params("pick", pr.PARITY_GOAL, "none", 0.0, device="cpu"))
    acts = np.random.default_rng(1).uniform(-1.5, 1.5, size=(B, K, T, 9)).astype(np.float32)
    inputs = chip_smoke._stack_rows([row] * B, torch.as_tensor(acts))
    return _with_spec(lambda *x: pr.panda_rollout_batched_plain(spec, *x), spec), inputs


def _albert():
    """(plain, inputs): the batched plain albert rollout and two seeds'
    inputs from the push_reach_contact parity start (the base driving into
    the box) with random actions, the wheels at the config's authority."""
    tamp = ReactiveTAMP(load_config("config_albert"), device="cpu")
    spec = ar.make_albert_rollout(tamp.env.params, tamp.objective, K, T).spec
    name, start, task_name, goal = ar.PARITY_CASES[2]
    sk = tree_map(lambda x: x.expand((K,) + x.shape), ar.parity_state(tamp.env.params, start))
    row = ar.rollout_inputs(sk, make_task_params(task_name, goal, device="cpu"))
    acts = np.random.default_rng(2).uniform(-1.5, 1.5, size=(B, K, T, 13)).astype(np.float32)
    acts[..., 11:13] *= 8.0
    inputs = chip_smoke._stack_rows([row] * B, torch.as_tensor(acts))
    return _with_spec(lambda *x: ar.albert_rollout_batched_plain(spec, *x), spec), inputs


FAMILIES = {"point": _point, "panda": _panda, "albert": _albert}
BARS = {"point": chip_smoke.PLANAR_BARS, "panda": chip_smoke.PLANAR_BARS, "albert": chip_smoke.ALBERT_BARS}
FLAT = {"point": chip_smoke._point_plain_flat, "panda": chip_smoke._panda_plain_flat,
        "albert": chip_smoke._albert_plain_flat}


BATCHED = {"point": ro.point_rollout_batched_plain, "panda": pr.panda_rollout_batched_plain,
           "albert": ar.albert_rollout_batched_plain}
K0_COLUMN = {"point": 3, "panda": 8, "albert": 4}  # the global offset's column of each task vector


@pytest.mark.parametrize("family", list(FAMILIES))
def test_flat_plain_equals_the_plain_version_per_call(family):
    """``phase_every_call`` lays B recorded calls side by side in one plain
    rollout; on the CPU that equals the plain version run per call bit for
    bit, for calls from different start states, with different goals, and
    at different global offsets: here two shards of a 2K-sample rollout,
    call 1 at offset K/2 (the multi-modal point's mode boundary inside it)."""
    plain, (task_vec, state0, *rest) = FAMILIES[family]()
    spec = dataclasses.replace(plain.spec, K=2 * K)
    state0, task_vec = state0.clone(), task_vec.clone()
    state0[1, :2] += 0.05  # call 1 from another start
    task_vec[1, 1] += 0.25  # with another goal
    task_vec[1, K0_COLUMN[family]] = K // 2  # at another offset
    inputs = (task_vec, state0, *rest)
    ref = BATCHED[family](spec, *inputs)
    for got, want in zip(FLAT[family](spec, *inputs), ref):
        assert torch.equal(got, want)
    assert not torch.equal(ref[1][0], ref[1][1])


@pytest.mark.parametrize("family", list(FAMILIES))
def test_an_output_equal_to_plain_passes_with_nothing_beyond(family):
    plain, inputs = FAMILIES[family]()
    assert chip_smoke._closed_loop_check(family, plain, inputs, plain(*inputs), bars=BARS[family]) == (0, 0)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_an_unexplained_sample_fails_and_is_named(family):
    """Seed 1, sample 3's cost off by 1.0 at one step: the plain version
    moves nowhere under nudges of that sample's actions, so the check
    raises and names the sample."""
    plain, inputs = FAMILIES[family]()
    cost, traj = plain(*inputs)
    cost = cost.clone()
    cost[1, 3, 1] += 1.0
    with pytest.raises(AssertionError, match=r"1 unexplained samples: seed 1 sample 3 \(cost err 1\.000e\+00"):
        chip_smoke._closed_loop_check(family, plain, inputs, (cost, traj), bars=BARS[family])


def test_the_albert_bars_catch_what_the_planar_bars_let_through():
    """The albert rollout's seed 0, sample 6 trajectory moved by 5e-4 at one
    step: beyond the albert bar (1e-4), inside the planar one (1e-3; a move
    of 1e-3 itself would sit on its edge).  Under the albert bars no nudge of that
    sample's actions explains it, so the check raises and names it; under
    the planar bars nothing is beyond."""
    plain, inputs = _albert()
    cost, traj = plain(*inputs)
    traj = traj.clone()
    traj[0, 6, 1, 0] += 5e-4
    assert chip_smoke._closed_loop_check("albert", plain, inputs, (cost, traj)) == (0, 0)
    with pytest.raises(AssertionError, match=r"1 unexplained samples: seed 0 sample 6 "):
        chip_smoke._closed_loop_check("albert", plain, inputs, (cost, traj), bars=chip_smoke.ALBERT_BARS)


def _gate(ulps: int, jump: float = 1000.0):
    """A stub plain version on a contact gate: every action sits at 1.25,
    and a sample's cost jumps by ``jump`` once any of its actions has moved
    ``ulps`` ulp or more (an ulp is 2**-23 in [1, 2))."""

    def plain(*inputs):
        acts = inputs[-1]
        moved = (torch.abs(acts - 1.25) >= (ulps - 0.5) * 2.0**-23).flatten(-2).any(-1)
        cost = jump * moved[..., None].expand(moved.shape + (T,)).float()
        return cost, torch.zeros(cost.shape + (2,))

    return plain


@pytest.mark.parametrize("ulps", [1, 3, chip_smoke.NUDGE_ULPS + 1])
def test_a_sample_is_explained_by_a_nudge_of_its_own_actions(ulps):
    """The kernel's seed 0, sample 5 is 1000 off: the check passes if the
    plain version jumps there when that sample's actions move by at most
    NUDGE_ULPS ulp (tried at 1, 2, ... ulp), and fails beyond that."""
    _, inputs = _point()
    inputs = inputs[:-1] + (torch.full_like(inputs[-1], 1.25),)
    plain = _gate(ulps)
    cost, traj = plain(*inputs)
    cost = cost.clone()
    cost[0, 5] += 1000.0
    if ulps <= chip_smoke.NUDGE_ULPS:
        assert chip_smoke._closed_loop_check("gate", plain, inputs, (cost, traj)) == (1, 1)
    else:
        with pytest.raises(AssertionError, match="seed 0 sample 5"):
            chip_smoke._closed_loop_check("gate", plain, inputs, (cost, traj))


def test_an_albert_sample_a_one_ulp_nudge_explains_passes():
    """At the albert bars, the kernel's seed 1, sample 4 cost is 1e-3 off:
    beyond the albert bar, and the stub plain version jumps there by the
    same 1e-3 when that sample's actions move one ulp, so the check passes
    with the sample explained; at the planar bars it is not even beyond."""
    _, inputs = _albert()
    inputs = inputs[:-1] + (torch.full_like(inputs[-1], 1.25),)
    plain = _gate(1, jump=1e-3)
    cost, traj = plain(*inputs)
    cost = cost.clone()
    cost[1, 4] += 1e-3
    assert chip_smoke._closed_loop_check("albert gate", plain, inputs, (cost, traj), bars=chip_smoke.ALBERT_BARS) == (1, 1)
    assert chip_smoke._closed_loop_check("albert gate", plain, inputs, (cost, traj)) == (0, 0)


def _step_gate(*x):
    """A stub plain version on a gate that only one step's actions reach:
    a sample's cost jumps by 1000 where its step-1 actions differ from its
    step-0 actions, which a nudge of all its actions never makes happen."""
    acts = x[-1]
    moved = (acts[..., 1, :] != acts[..., 0, :]).any(-1)
    cost = 1000.0 * moved[..., None].expand(moved.shape + (T,)).float()
    return cost, torch.zeros(cost.shape + (2,))


# "one step": the kernel's sample sits on a gate that no nudge of all its
# actions opens; "elsewhere": a one-ulp nudge moves the plain version's sample
# beyond the bars, but to 1000, not to the kernel's 500
@pytest.mark.parametrize("case", ["one step", "elsewhere"])
def test_a_sample_no_nudge_carries_to_the_kernel_fails(case):
    _, inputs = _point()
    inputs = inputs[:-1] + (torch.full_like(inputs[-1], 1.25),)
    plain, off = (_step_gate, 1000.0) if case == "one step" else (_gate(1), 500.0)
    cost, traj = plain(*inputs)
    cost = cost.clone()
    cost[1, 2] += off
    with pytest.raises(AssertionError, match="seed 1 sample 2"):
        chip_smoke._closed_loop_check(case, plain, inputs, (cost, traj))
