"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Runs only with ``M3P2I_TEST_CUDA=1`` on a machine with a CUDA GPU:

    M3P2I_TEST_CUDA=1 python -m pytest tests/test_torch_cuda.py -q

Elsewhere every test skips (the kernels have no CPU mode; their plain
versions are what the CPU suite holds against the JAX package).  Bars: the
weights at atol 1e-6 with sums within 1e-5, the point and panda rollouts at
cost atol 1e-2 and trajectory atol 1e-3 (tests/test_pallas.py:131-132,
:259-260, :379-384), the albert rollout at atol 1e-4 in both
(tests/test_pallas.py:818-821).
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from m3p2i_aip_tpu_torch.config.config_store import load_config
from m3p2i_aip_tpu_torch.envs import make_env
from m3p2i_aip_tpu_torch.models import panda_env, panda_fk, point_env
from m3p2i_aip_tpu_torch.ops import albert_rollout as ar
from m3p2i_aip_tpu_torch.ops import panda_rollout as pr
from m3p2i_aip_tpu_torch.ops import panda_step as pps
from m3p2i_aip_tpu_torch.ops import point_step as ps
from m3p2i_aip_tpu_torch.ops import rollout as ro
from m3p2i_aip_tpu_torch.ops import weights
from m3p2i_aip_tpu_torch.planners.motion_planner.mppi import make_task_params
from m3p2i_aip_tpu_torch.sim.sim_config import ActorCfg, load_env_cfgs
from m3p2i_aip_tpu_torch.tamp import graph_tick
from m3p2i_aip_tpu_torch.tamp.reactive_tamp import ReactiveTAMP
from m3p2i_aip_tpu_torch.utils.tree import tree_map

pytestmark = pytest.mark.cuda

POINT_MAIN = ["task=push_pull", "multi_modal=True", "goal=[-3.75,-3.75]"]
STARTS = [
    ([-0.3, 1.4], [0.5, 0.5]),
    ([-3.7, -3.7], [-2.0, -2.0]),
    ([0.0, 1.55], [0.0, 7.0]),
]


@pytest.fixture(scope="module")
def cuda():
    if os.environ.get("M3P2I_TEST_CUDA", "") != "1":
        pytest.skip("CUDA kernel tests run with M3P2I_TEST_CUDA=1")
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


# 200 = the main path, 37 = odd halves, 1500 > 1024 = the strided samples,
# 5 = one parent warp, 1024 = 32 full parent warps, 4096 = four passes a team,
# 16384 = the cost-to-go in opted-in shared memory, 65536 = in global scratch
@pytest.mark.parametrize("K", [200, 37, 1500, 5, 1024, 4096, 16384, 65536])
def test_weights_kernel_matches_plain(cuda, K):
    rng = np.random.default_rng(K)
    cost = torch.as_tensor(rng.uniform(0, 50, size=(K, 15)).astype(np.float32), device=cuda)
    gamma = torch.as_tensor(np.cumprod([1.0] + [0.95] * 14).astype(np.float32), device=cuda)
    before = weights.weights_launches
    got = weights.multimodal_weights(cost, gamma, K // 2)
    ref = weights.multimodal_weights_plain(cost, gamma, K // 2)
    assert weights.weights_launches == before + 1
    for g, r in zip(got, ref):
        assert float(torch.max(torch.abs(g - r))) <= 1e-6
        assert abs(float(torch.sum(g)) - 1.0) < 1e-5


def _capped_cost(case: str, K: int):
    """[K, 15] costs whose searches hit the 64-round cap: "tied" (every beta
    goes down), "small_group" (half_K = 2: group 0 goes up; the rest random)."""
    if case == "tied":
        return np.full((K, 15), 1.43, np.float32)
    return np.random.default_rng(K).uniform(0, 50, size=(K, 15)).astype(np.float32)


@pytest.mark.parametrize("K", [5, 200, 1500])
@pytest.mark.parametrize("case", ["tied", "small_group"])
def test_weights_kernel_capped_searches_match_plain(cuda, case, K):
    cost = torch.as_tensor(_capped_cost(case, K), device=cuda)
    gamma = torch.as_tensor(np.cumprod([1.0] + [0.95] * 14).astype(np.float32), device=cuda)
    half = K // 2 if case == "tied" else 2
    assert (weights.beta_rounds(cost, gamma, half)[0] == weights.BETA_ITERS).any()
    got = weights.multimodal_weights(cost, gamma, half)
    for g, r in zip(got, weights.multimodal_weights_plain(cost, gamma, half)):
        assert float(torch.max(torch.abs(g - r))) <= 1e-6
        assert abs(float(torch.sum(g)) - 1.0) < 1e-5


@pytest.mark.parametrize("config_name", ["config_point", "config_heijn", "config_boxer"])
def test_rollout_kernel_matches_plain(cuda, config_name):
    tamp = ReactiveTAMP(load_config(config_name, POINT_MAIN), device=cuda)
    mp, env = tamp.motion_planner, tamp.env
    spec = mp.rollout.spec
    rng = np.random.default_rng(0)
    for q0, qd0 in STARTS:
        if env.params.robot_type != "point":
            q0, qd0 = q0 + [0.3], qd0 + [0.5]
        state = dataclasses.replace(
            env.init_state(), q=torch.tensor(q0, device=cuda), qd=torch.tensor(qd0, device=cuda)
        )
        task = tamp.tamp_interface_view(env.view(state))
        sk = tree_map(lambda x: x.expand((mp.K,) + x.shape), state)
        acts = torch.as_tensor(rng.uniform(-3, 3, size=(mp.K, mp.T, env.nu)).astype(np.float32), device=cuda)
        inputs = ro.rollout_inputs(sk, task)
        c_k, t_k = ro.point_rollout(spec, *inputs, acts)
        c_p, t_p = ro.point_rollout_plain(spec, *inputs, acts)
        assert float(torch.max(torch.abs(c_k - c_p))) <= 1e-2, q0
        assert float(torch.max(torch.abs(t_k - t_p))) <= 1e-3, q0


def _box(name, pos, size, fixed, yaw_deg=0.0):
    half = np.radians(yaw_deg) / 2
    return ActorCfg(
        type="box", name=name, size=list(size) + [0.1], init_pos=list(pos) + [0.0],
        init_ori=[0.0, 0.0, float(np.sin(half)), float(np.cos(half))], fixed=fixed, friction=0.6,
    )


def _point_scene_at_the_maxima(device):
    """config_point's scene grown to the kernel's compile-time maxima,
    D = 4 dynamic and S = 16 static boxes: two crates pressed against the box
    and the dyn-obs, and eleven pillars, three of them pressed against the
    boxes, so pass 2 and every round of pass 3 see live contacts."""
    cfg = load_config("config_point", POINT_MAIN)
    actors = load_env_cfgs(cfg.env_type) + [
        _box("crate-a", [0.35, 2.0], [0.4, 0.4], False),
        _box("crate-b", [-2.0, 2.35], [0.4, 0.4], False, 20.0),
        _box("pillar-0", [0.0, 2.5], [0.3, 0.3], True),
        _box("pillar-1", [0.3, 1.7], [0.3, 0.3], True, 30.0),
        _box("pillar-2", [-2.0, 1.7], [0.3, 0.3], True),
        _box("pillar-3", [-1.0, -1.0], [0.3, 0.3], True),
        _box("pillar-4", [1.0, -1.0], [0.3, 0.3], True, 45.0),
        _box("pillar-5", [-1.0, 1.0], [0.3, 0.3], True),
        _box("pillar-6", [1.0, 1.0], [0.3, 0.3], True),
        _box("pillar-7", [3.0, -3.0], [0.3, 0.3], True),
        _box("pillar-8", [-3.0, 3.0], [0.3, 0.3], True),
        _box("pillar-9", [2.5, 0.0], [0.2, 1.0], True),
        _box("pillar-10", [-2.5, 0.0], [0.2, 1.0], True, 15.0),
    ]
    params = point_env.build_params(actors, cfg.sim, device=device)
    rollout = ro.make_point_rollout(params, float(cfg.kp_suction), cfg.mppi.num_samples, cfg.mppi.horizon, True)
    return params, rollout.spec


def test_rollout_kernel_matches_plain_at_the_maxima(cuda):
    """D = 4 and S = 16: every team loop of the kernel runs its most rounds
    (pass 2 both rounds, pass 3 two rounds a box, pass 4 two)."""
    params, spec = _point_scene_at_the_maxima(cuda)
    assert (spec.D, spec.S) == (ro.MAX_DYN, ro.MAX_STAT)
    K, T = spec.K, spec.T
    rng = np.random.default_rng(3)
    for q0, qd0 in STARTS + [([-2.0, 2.8], [0.0, -3.0])]:
        state = dataclasses.replace(
            point_env.init_state(params), q=torch.tensor(q0, device=cuda), qd=torch.tensor(qd0, device=cuda)
        )
        sk = tree_map(lambda x: x.expand((K,) + x.shape), state)
        fric = torch.as_tensor(rng.uniform(0.7, 1.3, size=(K, spec.D)).astype(np.float32), device=cuda)
        sk = dataclasses.replace(sk, fric_scale=fric)
        inputs = ro.rollout_inputs(sk, make_task_params("push_pull", [-3.75, -3.75], device=cuda))
        acts = torch.as_tensor(rng.uniform(-3, 3, size=(K, T, 2)).astype(np.float32), device=cuda)
        before = ro.rollout_launches
        c_k, t_k = ro.point_rollout(spec, *inputs, acts)
        assert ro.rollout_launches == before + 1
        c_p, t_p = ro.point_rollout_plain(spec, *inputs, acts)
        assert float(torch.max(torch.abs(c_k - c_p))) <= 1e-2, q0
        assert float(torch.max(torch.abs(t_k - t_p))) <= 1e-3, q0


# config_point: the shipped S = 5; config_heijn: the omni base's yaw channel;
# config_boxer: the differential drive; "maxima": D = 4, S = 16, pass 3's
# second round of statics
@pytest.mark.parametrize("scene", ["config_point", "config_heijn", "config_boxer", "maxima"])
def test_point_kernel_equals_plain_bit_for_bit(cuda, scene):
    """K1 adds its contact corrections in the order PyTorch's CUDA
    reductions add the plain version's sums at their layouts, and divides
    as PyTorch's CUDA division does (csrc/point_rollout.cu, head note), so
    on the card its output is the plain version's bit for bit.  A change of
    layout in models/point_env.step, or a torch whose reductions add in
    another order, shows here first."""
    if scene == "maxima":
        params, spec = _point_scene_at_the_maxima(cuda)
        init, nu, view = point_env.init_state(params), 2, None
    else:
        tamp = ReactiveTAMP(load_config(scene, POINT_MAIN), device=cuda)
        spec, init, nu = tamp.motion_planner.rollout.spec, tamp.env.init_state(), tamp.env.nu
        view = lambda s: tamp.tamp_interface_view(tamp.env.view(s))  # noqa: E731
    K, T = spec.K, spec.T
    rng = np.random.default_rng(9)
    for q0, qd0 in STARTS + [([-2.0, 2.8], [0.0, -3.0])]:
        q0, qd0 = q0 + [0.3] * (init.q.shape[0] - 2), qd0 + [0.5] * (init.q.shape[0] - 2)
        state = dataclasses.replace(init, q=torch.tensor(q0, device=cuda), qd=torch.tensor(qd0, device=cuda))
        sk = tree_map(lambda x: x.expand((K,) + x.shape), state)
        fric = torch.as_tensor(rng.uniform(0.7, 1.3, size=(K, spec.D)).astype(np.float32), device=cuda)
        sk = dataclasses.replace(sk, fric_scale=fric)
        task = make_task_params("push_pull", [-3.75, -3.75], device=cuda) if view is None else view(state)
        inputs = ro.rollout_inputs(sk, task)
        acts = torch.as_tensor(rng.uniform(-3, 3, size=(K, T, nu)).astype(np.float32), device=cuda)
        c_k, t_k = ro.point_rollout(spec, *inputs, acts)
        c_p, t_p = ro.point_rollout_plain(spec, *inputs, acts)
        assert torch.equal(c_k, c_p) and torch.equal(t_k, t_p), (
            q0, int((c_k != c_p).sum()), int((t_k != t_p).any(-1).sum()))


@pytest.mark.parametrize("mode", ["mppi.mppi_mode=simple", "mppi.sampling_method=random"])
def test_planner_mode_tick_on_the_kernel_matches_plain(cuda, mode):
    """One simple-mode and one random-sampling tick at K=200 x T=15 on the
    card (un-smoothed Gaussian actions into K1): the planner with K1 against
    the same planner with K1's plain version, on the same draw, within the
    point bars."""
    tamp = ReactiveTAMP(load_config("config_point", ["task=navigation", "goal=[-3,3]", mode]), device=cuda)
    mp, env = tamp.motion_planner, tamp.env
    state = dataclasses.replace(
        env.init_state(), q=torch.tensor([0.0, 1.5], device=cuda), qd=torch.tensor([0.0, -1.0], device=cuda)
    )
    task = tamp.tamp_interface_view(env.view(state))
    noise = mp._correlated_draw((mp.K, mp.T, mp.nu))
    before = ro.rollout_launches
    act_k, ms_k, _ = mp.command(tamp.mppi_state, state, task, noise=noise)
    assert ro.rollout_launches == before + 1
    spec, kernel_rollout = mp.rollout.spec, mp.rollout
    mp.rollout = lambda sk, acts, tk, k0=None: ro.point_rollout_plain(spec, *ro.rollout_inputs(sk, tk, k0), acts)
    try:
        act_p, ms_p, _ = mp.command(tamp.mppi_state, state, task, noise=noise)
    finally:
        mp.rollout = kernel_rollout
    assert torch.isfinite(act_k).all()
    assert float(torch.max(torch.abs(act_k - act_p))) <= 1e-3
    field = "U" if "simple" in mode else "mean_action"
    assert float(torch.max(torch.abs(getattr(ms_k, field) - getattr(ms_p, field)))) <= 1e-3


# 37 and 1500: samples past K in the last block (teams that leave at the
# ragged edge); 4000: the K1b sample count of a B=20 batch in one launch
@pytest.mark.parametrize("K", [37, 1500, 4000])
def test_rollout_kernel_matches_plain_at_other_sample_counts(cuda, K):
    tamp = ReactiveTAMP(load_config("config_point", POINT_MAIN), device=cuda)
    env, T = tamp.env, tamp.motion_planner.T
    spec = ro.make_point_rollout(env.params, float(tamp.cfg.kp_suction), K, T, True).spec
    rng = np.random.default_rng(K)
    state = dataclasses.replace(
        env.init_state(), q=torch.tensor([-0.3, 1.4], device=cuda), qd=torch.tensor([0.5, 0.5], device=cuda)
    )
    sk = tree_map(lambda x: x.expand((K,) + x.shape), state)
    sk = dataclasses.replace(
        sk, fric_scale=torch.as_tensor(rng.uniform(0.7, 1.3, size=(K, 2)).astype(np.float32), device=cuda)
    )
    inputs = ro.rollout_inputs(sk, tamp.tamp_interface_view(env.view(state)))
    acts = torch.as_tensor(rng.uniform(-3, 3, size=(K, T, env.nu)).astype(np.float32), device=cuda)
    c_k, t_k = ro.point_rollout(spec, *inputs, acts)
    c_p, t_p = ro.point_rollout_plain(spec, *inputs, acts)
    assert c_k.shape == (K, T) and t_k.shape == (K, T, 2)
    assert float(torch.max(torch.abs(c_k - c_p))) <= 1e-2
    assert float(torch.max(torch.abs(t_k - t_p))) <= 1e-3


@pytest.mark.parametrize("multi_modal", [False, True])
def test_panda_rollout_kernel_matches_plain(cuda, multi_modal):
    """K3 on the seven parity starts; in the multi-modal scene also K2 on
    each K3 cost horizon with the panda planner's constants."""
    tamp = ReactiveTAMP(load_config("config_panda", [f"multi_modal={multi_modal}"]), device=cuda)
    mp = tamp.motion_planner
    spec, K, T = mp.rollout.spec, mp.K, mp.T
    rng = np.random.default_rng(1)
    base = tamp.env.init_state()
    for name, start, task_name, grip, zup in pr.PARITY_CASES:
        state = pr.parity_state(base, start)
        goal = pr.PARITY_GOAL if task_name == "pick" else [0.0] * 7
        task = make_task_params(task_name, goal, "none", zup, device=cuda)
        acts = rng.uniform(-1.5, 1.5, size=(K, T, 9)).astype(np.float32)
        if grip is not None:
            acts[..., 7:9] = grip
        acts = torch.as_tensor(acts, device=cuda)
        inputs = pr.rollout_inputs(tree_map(lambda x: x.expand((K,) + x.shape), state), task)
        before = pr.panda_rollout_launches
        c_k, t_k = pr.panda_rollout(spec, *inputs, acts)
        assert pr.panda_rollout_launches == before + 1
        c_p, t_p = pr.panda_rollout_plain(spec, *inputs, acts)
        assert float(torch.max(torch.abs(c_k - c_p))) <= 1e-2, name
        assert float(torch.max(torch.abs(t_k - t_p))) <= 1e-3, name
        if multi_modal:
            args = (c_k, mp.gamma_seq, mp.half_K, mp.eta_u, mp.eta_l)
            for g, r in zip(weights.multimodal_weights(*args), weights.multimodal_weights_plain(*args)):
                assert float(torch.max(torch.abs(g - r))) <= 1e-6, name
                assert abs(float(torch.sum(g)) - 1.0) < 1e-5, name


def _panda_case(spec, state, task_name, K, T, rng, device):
    """A panda kernel input from ``state`` with random actions, the gripper
    closing: (task_vec, state0, acts)."""
    goal = pr.PARITY_GOAL if task_name == "pick" else [0.0] * 7
    inputs = pr.rollout_inputs(tree_map(lambda x: x.expand((K,) + x.shape), state),
                               make_task_params(task_name, goal, "none", 1.0, device=device))
    acts = rng.uniform(-1.5, 1.5, size=(K, T, 9)).astype(np.float32)
    acts[..., 7:9] = -1.5
    return inputs + (torch.as_tensor(acts, device=device),)


# 37: teams past K in the last block (they leave at the ragged edge); 1500:
# 188 blocks, past one block a SM
@pytest.mark.parametrize("K", [37, 1500])
def test_panda_rollout_kernel_matches_plain_at_other_sample_counts(cuda, K):
    cfg = load_config("config_panda", ["multi_modal=True"])
    env = make_env(cfg, device=cuda)
    T = cfg.mppi.horizon
    spec = pr.make_panda_rollout(env.params, cfg.pre_height_diff, K, T, True).spec
    rng = np.random.default_rng(K)
    for start in ("near_cubeB", "attached"):
        inputs = _panda_case(spec, pr.parity_state(env.init_state(), start), "pick", K, T, rng, cuda)
        c_k, t_k = pr.panda_rollout(spec, *inputs)
        c_p, t_p = pr.panda_rollout_plain(spec, *inputs)
        assert c_k.shape == (K, T) and t_k.shape == (K, T, 2)
        assert float(torch.max(torch.abs(c_k - c_p))) <= 1e-2, start
        assert float(torch.max(torch.abs(t_k - t_p))) <= 1e-3, start


def _panda_scene_at_the_maxima(cfg, device) -> panda_env.PandaEnvParams:
    """config_panda's scene grown to the kernels' kMaxS = 8 statics: five
    posts, four of them pressed against cubeA, cubeB and the dyn-obs."""
    posts = [([0.24, -0.2, 1.1], [0.04, 0.04, 0.15]), ([0.16, 0.2, 1.1], [0.04, 0.04, 0.15]),
             ([0.35, 0.14, 1.735], [0.06, 0.06, 0.06]), ([0.2, -0.27, 1.1], [0.06, 0.04, 0.15]),
             ([0.25, 0.2, 1.1], [0.04, 0.04, 0.15])]
    actors = load_env_cfgs(cfg.env_type) + [
        ActorCfg(type="box", name=f"post-{i}", size=size, init_pos=pos, fixed=True) for i, (pos, size) in enumerate(posts)
    ]
    return panda_env.build_params(actors, cfg.sim, cube_on_shelf=cfg.cube_on_shelf, device=device)


def test_panda_rollout_kernel_matches_plain_at_the_maxima(cuda):
    """config_panda's scene grown to the kernel's kMaxS = 8 statics: five
    posts, four pressed against cubeA, cubeB and the dyn-obs, so all three
    pushout rounds see live contacts, through the kernel's run-time-S
    instantiation (the shipped scenes have S = 3)."""
    cfg = load_config("config_panda", ["multi_modal=True"])
    params = _panda_scene_at_the_maxima(cfg, cuda)
    K, T = cfg.mppi.num_samples, cfg.mppi.horizon
    spec = pr.make_panda_rollout(params, cfg.pre_height_diff, K, T, True).spec
    assert spec.S == pr.MAX_STAT
    rng = np.random.default_rng(4)
    for start in ("near_cubeB", "attached"):
        inputs = _panda_case(spec, pr.parity_state(panda_env.init_state(params), start), "pick", K, T, rng, cuda)
        before = pr.panda_rollout_launches
        c_k, t_k = pr.panda_rollout(spec, *inputs)
        assert pr.panda_rollout_launches == before + 1
        c_p, t_p = pr.panda_rollout_plain(spec, *inputs)
        assert float(torch.max(torch.abs(c_k - c_p))) <= 1e-2, start
        assert float(torch.max(torch.abs(t_k - t_p))) <= 1e-3, start


# K: 128 = the shipped width, 37 = a ragged last team and block, 1500 = many
# blocks; T: 12 = the shipped horizon (a full FK round and a partial one),
# 5 = one partial round, 1 = a round of one step
@pytest.mark.parametrize("T", [12, 5, 1])
@pytest.mark.parametrize("K", [128, 37, 1500])
def test_albert_rollout_kernel_matches_plain(cuda, K, T):
    """K4 on the five parity cases."""
    tamp = ReactiveTAMP(load_config("config_albert"), device=cuda)
    mp = tamp.motion_planner
    assert (mp.K, mp.T) == (128, 12)
    spec = ar.make_albert_rollout(tamp.env.params, tamp.objective, K, T).spec
    rng = np.random.default_rng(2)
    for name, start, task_name, goal in ar.PARITY_CASES:
        task = make_task_params(task_name, goal, device=cuda)
        acts = rng.uniform(-1.5, 1.5, size=(K, T, 13)).astype(np.float32)
        acts[..., 11:13] *= 8.0  # the wheels at the config's +-12 authority
        acts = torch.as_tensor(acts, device=cuda)
        state = ar.parity_state(tamp.env.params, start)
        inputs = ar.rollout_inputs(tree_map(lambda x: x.expand((K,) + x.shape), state), task)
        before = ar.albert_rollout_launches
        c_k, t_k = ar.albert_rollout(spec, *inputs, acts)
        assert ar.albert_rollout_launches == before + 1
        c_p, t_p = ar.albert_rollout_plain(spec, *inputs, acts)
        assert float(torch.max(torch.abs(c_k - c_p))) <= 1e-4, name
        assert float(torch.max(torch.abs(t_k - t_p))) <= 1e-4, name


def test_albert_rollout_kernel_at_run_time_substeps(cuda):
    """K4 at 3 substeps (the albert scenes run 2; the kernel reads the
    count at run time) on the five parity cases at K=128 x T=12."""
    tamp = ReactiveTAMP(load_config("config_albert"), device=cuda)
    params = dataclasses.replace(tamp.env.params, substeps=3)
    spec = ar.make_albert_rollout(params, tamp.objective, 128, 12).spec
    rng = np.random.default_rng(3)
    for name, start, task_name, goal in ar.PARITY_CASES:
        acts = rng.uniform(-1.5, 1.5, size=(128, 12, 13)).astype(np.float32)
        acts[..., 11:13] *= 8.0
        acts = torch.as_tensor(acts, device=cuda)
        state = ar.parity_state(params, start)
        inputs = ar.rollout_inputs(tree_map(lambda x: x.expand((128,) + x.shape), state),
                                   make_task_params(task_name, goal, device=cuda))
        c_k, t_k = ar.albert_rollout(spec, *inputs, acts)
        c_p, t_p = ar.albert_rollout_plain(spec, *inputs, acts)
        assert float(torch.max(torch.abs(c_k - c_p))) <= 1e-4, name
        assert float(torch.max(torch.abs(t_k - t_p))) <= 1e-4, name


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    cost = torch.rand(15, 40, device=cuda).T  # not contiguous
    with pytest.raises(ValueError):
        weights.multimodal_weights(cost, torch.ones(15, device=cuda), 20)
    with pytest.raises(ValueError):
        weights.multimodal_weights(torch.rand(40, 15, device=cuda, dtype=torch.float64), torch.ones(15, device=cuda), 20)
    with pytest.raises(ValueError):  # more seeds than a launch's blocks
        weights.multimodal_weights_batched(torch.rand(weights.MAX_B + 1, 2, 2, device=cuda), torch.ones(2, device=cuda),
                                           1)
    cfg = load_config("config_panda")
    env = make_env(cfg, device=cuda)
    spec = pr.make_panda_rollout(env.params, cfg.pre_height_diff, 8, 4, False).spec
    sk = tree_map(lambda x: x.expand((8,) + x.shape), env.init_state())
    task_vec, state0 = pr.rollout_inputs(sk, make_task_params("reach", [0.0] * 7, device=cuda))
    acts = torch.zeros(9, 4, 8, device=cuda).permute(2, 1, 0)  # not contiguous
    with pytest.raises(ValueError):
        pr.panda_rollout(spec, task_vec, state0, acts)
    with pytest.raises(ValueError):
        pr.panda_rollout(spec, task_vec, state0[:-1], acts.contiguous())
    cfg = load_config("config_albert")
    tamp = ReactiveTAMP(cfg, device=cuda)
    spec = ar.make_albert_rollout(tamp.env.params, tamp.objective, 8, 4).spec
    sk = tree_map(lambda x: x.expand((8,) + x.shape), tamp.env.init_state())
    task_vec, state0 = ar.rollout_inputs(sk, make_task_params("ee_reach", [2.0, 2.0, 0.8], device=cuda))
    acts = torch.zeros(13, 4, 8, device=cuda).permute(2, 1, 0)  # not contiguous
    with pytest.raises(ValueError):
        ar.albert_rollout(spec, task_vec, state0, acts)
    with pytest.raises(ValueError):
        ar.albert_rollout(spec, task_vec, state0[:-1], acts.contiguous())
    with pytest.raises(ValueError):
        ar.albert_rollout(spec, task_vec, state0, acts.contiguous().double())


# ------------------------------------------------- batched kernels K1b-K4b
# B = 4 seeds with their own start states and tasks (K1b also B = 20); each
# batched kernel is held against its batched plain version at its single
# kernel's bars, and against B single launches on the same inputs exactly:
# a single launch is the batched body with B = 1, and no kernel's arithmetic
# depends on the seed count.
SERIAL_ATOL = 0.0


def _check_batched(batched, plain, single, inputs, cost_atol, traj_atol, counter):
    """Launch ``batched`` once, compare with ``plain`` and with ``single``
    per seed; ``counter`` reads the batched launch count."""
    before = counter()
    c_k, t_k = batched(*inputs)
    assert counter() == before + 1
    c_p, t_p = plain(*inputs)
    assert float(torch.max(torch.abs(c_k - c_p))) <= cost_atol
    assert float(torch.max(torch.abs(t_k - t_p))) <= traj_atol
    for b in range(c_k.shape[0]):
        c_s, t_s = single(*(x[b] for x in inputs))
        assert float(torch.max(torch.abs(c_k[b] - c_s))) <= SERIAL_ATOL, b
        assert float(torch.max(torch.abs(t_k[b] - t_s))) <= SERIAL_ATOL, b


def test_batched_weights_kernel_matches_plain_and_single(cuda):
    rng = np.random.default_rng(5)
    scale = np.asarray([50.0, 0.5, 5.0, 200.0], np.float32)[:, None, None]  # beta rounds differ per seed
    cost = torch.as_tensor((rng.uniform(0, 1, size=(4, 200, 15)) * scale).astype(np.float32), device=cuda)
    gamma = torch.as_tensor(np.cumprod([1.0] + [0.95] * 14).astype(np.float32), device=cuda)
    before = weights.weights_batched_launches
    got = weights.multimodal_weights_batched(cost, gamma, 100)
    assert weights.weights_batched_launches == before + 1
    ref = weights.multimodal_weights_batched_plain(cost, gamma, 100)
    for g, r in zip(got, ref):
        assert float(torch.max(torch.abs(g - r))) <= 1e-6
        assert float(torch.max(torch.abs(torch.sum(g, dim=-1) - 1.0))) < 1e-5
    for b in range(4):
        for g, s in zip(got, weights.multimodal_weights(cost[b], gamma, 100)):
            assert float(torch.max(torch.abs(g[b] - s))) <= SERIAL_ATOL, b


def test_batched_weights_kernel_with_a_tied_seed_equals_single(cuda):
    """A tied seed (the cap) among random ones: each seed exits on its own,
    and the batch equals one launch per seed exactly."""
    rng = np.random.default_rng(6)
    cost = rng.uniform(0, 50, size=(5, 200, 15)).astype(np.float32)
    cost[2] = 1.43
    cost[4, :, :] *= 0.01  # a few rounds up
    cost = torch.as_tensor(cost, device=cuda)
    gamma = torch.as_tensor(np.cumprod([1.0] + [0.95] * 14).astype(np.float32), device=cuda)
    got = weights.multimodal_weights_batched(cost, gamma, 100)
    ref = weights.multimodal_weights_batched_plain(cost, gamma, 100)
    for g, r in zip(got, ref):
        assert float(torch.max(torch.abs(g - r))) <= 1e-6
    for b in range(5):
        for g, s in zip(got, weights.multimodal_weights(cost[b], gamma, 100)):
            assert float(torch.max(torch.abs(g[b] - s))) <= SERIAL_ATOL, b


@pytest.mark.parametrize("B", [4, 20])  # 20: the n=20 batch's width
def test_batched_point_kernel_matches_plain_and_single(cuda, B):
    """K1b on B seeds (seed b from the start and task b % 4, its own friction
    draw) against its plain version and against one K1 launch per seed:
    equal bit for bit, since each lane adds the team's corrections in one
    fixed order."""
    tamp = ReactiveTAMP(load_config("config_point", POINT_MAIN), device=cuda)
    mp, env = tamp.motion_planner, tamp.env
    spec = mp.rollout.spec
    rng = np.random.default_rng(6)
    starts = STARTS + [([-3.3, -3.3], [-6.0, -6.0])]
    tasks = [("push_pull", [-3.75, -3.75]), ("pull", [1.0, 3.0]), ("push", [-1.0, -1.0]), ("navigation", [1.5, 1.0])]
    rows = []
    for b in range(B):
        (q0, qd0), (task_name, goal) = starts[b % 4], tasks[b % 4]
        state = dataclasses.replace(env.init_state(), q=torch.tensor(q0, device=cuda), qd=torch.tensor(qd0, device=cuda))
        sk = tree_map(lambda x: x.expand((mp.K,) + x.shape), state)
        fric = torch.as_tensor(rng.uniform(0.7, 1.3, size=(mp.K, 2)).astype(np.float32), device=cuda)
        sk = dataclasses.replace(sk, fric_scale=fric)
        rows.append(ro.rollout_inputs(sk, make_task_params(task_name, goal, device=cuda)))
    acts = torch.as_tensor(rng.uniform(-3, 3, size=(B, mp.K, mp.T, env.nu)).astype(np.float32), device=cuda)
    inputs = tuple(torch.stack(xs) for xs in zip(*rows)) + (acts,)
    _check_batched(
        lambda *a: ro.point_rollout_batched(spec, *a), lambda *a: ro.point_rollout_batched_plain(spec, *a),
        lambda *a: ro.point_rollout(spec, *a), inputs, 1e-2, 1e-3, lambda: ro.rollout_batched_launches,
    )


@pytest.mark.parametrize("B", [4, 20])  # 20: the n=20 batch's width
def test_batched_panda_kernel_matches_plain_and_single(cuda, B):
    """K3b on B seeds (seed b from parity case 1 + b, cyclically) against
    its plain version and against one K3 launch per seed: equal bit for
    bit, since each lane adds the team's contacts in one fixed order."""
    tamp = ReactiveTAMP(load_config("config_panda", ["multi_modal=True"]), device=cuda)
    mp = tamp.motion_planner
    spec, K, T = mp.rollout.spec, mp.K, mp.T
    rng = np.random.default_rng(7)
    base = tamp.env.init_state()
    rows, acts = [], []
    for b in range(B):
        name, start, task_name, grip, zup = pr.PARITY_CASES[(1 + b) % len(pr.PARITY_CASES)]
        goal = pr.PARITY_GOAL if task_name == "pick" else [0.0] * 7
        sk = tree_map(lambda x: x.expand((K,) + x.shape), pr.parity_state(base, start))
        rows.append(pr.rollout_inputs(sk, make_task_params(task_name, goal, "none", zup, device=cuda)))
        a = rng.uniform(-1.5, 1.5, size=(K, T, 9)).astype(np.float32)
        if grip is not None:
            a[..., 7:9] = grip
        acts.append(a)
    inputs = tuple(torch.stack(xs) for xs in zip(*rows)) + (torch.as_tensor(np.stack(acts), device=cuda),)
    _check_batched(
        lambda *a: pr.panda_rollout_batched(spec, *a), lambda *a: pr.panda_rollout_batched_plain(spec, *a),
        lambda *a: pr.panda_rollout(spec, *a), inputs, 1e-2, 1e-3, lambda: pr.panda_rollout_batched_launches,
    )


@pytest.mark.parametrize("B", [4, 20])  # 20: the n=20 batch's width
def test_batched_albert_kernel_matches_plain_and_single(cuda, B):
    """K4b on B seeds (seed b from parity case b, cyclically) against its
    plain version and against one K4 launch per seed: equal bit for bit,
    since every lane of a team runs one thread's operations."""
    tamp = ReactiveTAMP(load_config("config_albert"), device=cuda)
    mp = tamp.motion_planner
    spec, K, T = mp.rollout.spec, mp.K, mp.T
    rng = np.random.default_rng(8)
    rows = []
    for b in range(B):
        name, start, task_name, goal = ar.PARITY_CASES[b % len(ar.PARITY_CASES)]
        sk = tree_map(lambda x: x.expand((K,) + x.shape), ar.parity_state(tamp.env.params, start))
        rows.append(ar.rollout_inputs(sk, make_task_params(task_name, goal, device=cuda)))
    acts = rng.uniform(-1.5, 1.5, size=(B, K, T, 13)).astype(np.float32)
    acts[..., 11:13] *= 8.0
    inputs = tuple(torch.stack(xs) for xs in zip(*rows)) + (torch.as_tensor(acts, device=cuda),)
    _check_batched(
        lambda *a: ar.albert_rollout_batched(spec, *a), lambda *a: ar.albert_rollout_batched_plain(spec, *a),
        lambda *a: ar.albert_rollout(spec, *a), inputs, 1e-4, 1e-4, lambda: ar.albert_rollout_batched_launches,
    )


# ------------------------------------------------- the real-env step (K5)
# The step kernel follows models/point_env.step bit for bit as K1 follows the
# plain rollout: it adds each sum in the order PyTorch's CUDA reductions add
# it at the plain step's layouts, which are the rollout's without the K axis
# (one robot) or with a seed axis in its place (the batch).  These orders are
# measured first, at both layouts, with numpy's float32 adds in the order the
# kernel takes (csrc/point_rollout.cu's head note).


def _acc4(values):
    """A thread's reduction: element i into accumulator i % 4, then the four in order."""
    acc = [np.float32(0.0)] * 4
    for i, v in enumerate(values):
        acc[i % 4] = np.float32(acc[i % 4] + v)
    return np.float32(np.float32(np.float32(acc[0] + acc[1]) + acc[2]) + acc[3])


def _tree32(values):
    """A warp's reduction over the innermost dims: element e on lane e % 32,
    then the lanes folded by shuffles down 16, 8, 4, 2, 1."""
    lanes = [np.float32(0.0)] * 32
    for e, v in enumerate(values):
        lanes[e % 32] = np.float32(lanes[e % 32] + v)
    for off in (16, 8, 4, 2, 1):
        lanes = [np.float32(lanes[l] + lanes[l + off]) if l + off < 32 else lanes[l] for l in range(32)]
    return lanes[0]


def _norm2(values):
    return np.sqrt(np.float32(np.float32(values[0] * values[0]) + np.float32(values[1] * values[1])))


# (the step's sum, the summed tensor's trailing shape, the reduced dims, the
# order), D = 2 or 4 boxes and S = 5 or 16 statics
SUM_ORDERS = {
    "pass 1 robot rows": (lambda D, S: (D, 2), (-2,), _acc4),
    "pass 2 corner rows": (lambda D, S: (4, 2), (-2,), _acc4),
    "pass 2 corner yaws": (lambda D, S: (4,), (-1,), _tree32),
    "pass 3 box rows": (lambda D, S: (D, S, 4, 2), (-3, -2), _acc4),
    "pass 3 box yaws": (lambda D, S: (D, S, 4), (-2, -1), _tree32),
    "pass 3 static rows": (lambda D, S: (D, S, 4, 2), (-4, -2), _acc4),
    "pass 4 robot rows": (lambda D, S: (S, 2), (-2,), _acc4),
    "speeds": (lambda D, S: (D, 2), (-1,), _norm2),
}


@pytest.mark.parametrize("lead", [(), (20,)], ids=["one", "batch20"])
@pytest.mark.parametrize("name", list(SUM_ORDERS))
def test_plain_step_sum_orders(cuda, name, lead):
    """Each sum of models/point_env.step, at its layout without and with a
    leading seed axis, adds in the order the step kernel takes: on values
    of mixed magnitudes and signs with live and dead (+-0) entries, every
    output equal bit for bit."""
    shape_of, dims, order = SUM_ORDERS[name]
    rng = np.random.default_rng(20)
    for D, S in ((2, 5), (4, 16)):
        shape = lead + shape_of(D, S)
        for _ in range(8):
            x = (rng.standard_normal(shape) * 10.0 ** rng.uniform(-6, 3, shape)).astype(np.float32)
            x[rng.random(shape) < 0.3] = 0.0
            x[rng.random(shape) < 0.1] = -0.0
            t = torch.as_tensor(x, device=cuda)
            got = (torch.linalg.vector_norm(t, dim=-1) if order is _norm2 else torch.sum(t, dim=dims)).cpu().numpy()
            moved = np.moveaxis(x, dims, range(-len(dims), 0))  # the reduced dims last, in their order
            flat = moved.reshape(moved.shape[: moved.ndim - len(dims)] + (-1,))  # the last reduced dim fastest
            want = np.array([order(r) for r in flat.reshape(-1, flat.shape[-1])], np.float32).reshape(got.shape)
            assert np.array_equal(got.view(np.int32), want.view(np.int32)), (name, lead, D, S)


# starts in contact in config_point's scene (the dyn-obs is slot 0, the box
# slot 1; the static obs at [2, 2], the walls' inner faces at +-3.95):
# (robot xy, robot velocity, {slot: (x, y, yaw)})
STEP_STARTS = {
    "box_into_wall": ([0.0, 3.42], [0.0, 2.0], {1: (0.0, 3.8, 0.0)}),
    "box_on_box": ([-0.38, 2.0], [2.0, 0.0], {0: (0.38, 2.05, 0.2)}),
    "robot_on_static": ([1.67, 2.0], [2.5, 0.3], {}),
    "box_on_static": ([1.29, 2.0], [2.0, 0.0], {1: (1.68, 2.0, 0.1)}),
    "arena_corner": ([3.9, -3.9], [3.0, -3.0], {}),
}
STEP_TICKS = 25


def _step_case(params, B, rng, device):
    """B states from STEP_STARTS in turn, each with its own random box and
    robot velocities, friction scales (0.7-1.3), suction forces (half of
    them zero) and action: (state, u, ext); a single state for B = 1."""
    nq, nu, D = point_env.robot_nq(params), point_env.robot_nu(params), params.dyn_half.shape[0]
    rows = []
    for b in range(B):
        q, qd, boxes = list(STEP_STARTS.values())[b % len(STEP_STARTS)]
        state = point_env.init_state(params)
        pos, yaw = state.dyn_pos.cpu().numpy().copy(), np.zeros(D, np.float32)
        for slot, (x, y, a) in boxes.items():
            pos[slot], yaw[slot] = (x, y), a
        f = lambda *shape: rng.uniform(-1, 1, shape).astype(np.float32)  # noqa: E731
        gate = lambda *shape: f(*shape) * (rng.random() < 0.5)  # noqa: E731
        rows.append(dict(
            q=q + list(rng.uniform(-np.pi, np.pi, nq - 2)), qd=qd + list(f(nq - 2)), dyn_pos=pos, dyn_yaw=yaw,
            dyn_vel=f(D, 2), dyn_om=f(D), fric_scale=rng.uniform(0.7, 1.3, D), u=3.0 * f(nu),
            ext_robot=40.0 * gate(2), ext_dyn=60.0 * gate(D, 2),
        ))
    t = {k: torch.as_tensor(np.stack([np.asarray(r[k], np.float32) for r in rows]), device=device) for k in rows[0]}
    if B == 1:
        t = {k: v[0] for k, v in t.items()}
    state = point_env.PointEnvState(
        q=t["q"], qd=t["qd"], dyn_pos=t["dyn_pos"], dyn_yaw=t["dyn_yaw"], dyn_vel=t["dyn_vel"], dyn_om=t["dyn_om"],
        contact_force=torch.zeros(*t["q"].shape[:-1], params.num_actors, 3, device=device),
        fric_scale=t["fric_scale"],
    )
    return state, t["u"], point_env.PointExtForces(robot=t["ext_robot"], dyn=t["ext_dyn"])


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32)


def _check_step_bit_for_bit(params, step, B, seed, device):
    """STEP_TICKS steps of the kernel from a _step_case, each against the
    plain step from the same state: every field equal bit for bit."""
    state, u, ext = _step_case(params, B, np.random.default_rng(seed), device)
    counter = "step_batched_launches" if B > 1 else "step_launches"
    live = 0
    for tick in range(STEP_TICKS):
        before = getattr(ps, counter)
        got = step(state, u, ext)
        assert getattr(ps, counter) == before + 1
        ref = point_env.step(params, state, u, ext)
        for f in dataclasses.fields(ref):
            a, r = getattr(got, f.name), getattr(ref, f.name)
            assert a.shape == r.shape and torch.equal(_bits(a), _bits(r)), (
                f.name, tick, int((_bits(a) != _bits(r)).sum()), float((a - r).abs().max()))
        live += int((ref.contact_force != 0).any(-1).sum())
        state = got
    assert live > 0  # the starts are in contact


@pytest.mark.parametrize("B", [1, 20])
@pytest.mark.parametrize("config_name", ["config_point", "config_heijn", "config_boxer"])
def test_step_kernel_equals_plain_bit_for_bit(cuda, config_name, B):
    """The real-env step kernel against models/point_env.step on the card,
    for the point, heijn and boxer bases, one state and a batch of 20: every
    field of every step bit for bit, from starts in contact (the robot
    pushing the box into a wall, box against box, robot against a static,
    box against a static, the arena clamp) with suction forces and friction
    scales."""
    env = make_env(load_config(config_name, POINT_MAIN), device=cuda)
    _check_step_bit_for_bit(env.params, env.step, B, 7 + B, cuda)


@pytest.mark.parametrize("B", [1, 20])
def test_step_kernel_equals_plain_at_the_maxima(cuda, B):
    """D = 4, S = 16 (pass 2 both rounds, passes 3 and 4 two rounds of
    statics, three rotated pillars): bit for bit."""
    params, _ = _point_scene_at_the_maxima(cuda)
    assert (params.dyn_half.shape[0], params.stat_pos.shape[0]) == (ro.MAX_DYN, ro.MAX_STAT)
    _check_step_bit_for_bit(params, ps.make_step(params), B, 11 + B, cuda)


def test_step_over_the_kernel_limits_raises(cuda):
    """A seventeenth static on the card: the env's step is not made and the
    kernel's wrapper raises, as the point rollout kernel's does; no launch."""
    cfg = load_config("config_point", POINT_MAIN)
    actors = load_env_cfgs(cfg.env_type) + [_box(f"pillar-{i}", [-3.0 + 0.5 * i, -3.0], [0.2, 0.2], True)
                                            for i in range(12)]
    params = point_env.build_params(actors, cfg.sim, device=cuda)
    assert params.stat_pos.shape[0] == ro.MAX_STAT + 1
    state, u, ext = _step_case(params, 1, np.random.default_rng(1), cuda)
    before = (ps.step_launches, ps.step_batched_launches)
    with pytest.raises(ValueError, match="the kernel takes 1 <= D <= 4, 1 <= S <= 16"):
        ps.make_step(params)
    with pytest.raises(ValueError, match="the kernel takes 1 <= D <= 4, 1 <= S <= 16"):
        ps.point_step(params, ps.param_buffer(params), state, u, ext)
    assert (ps.step_launches, ps.step_batched_launches) == before


def test_compiled_point_tick_launches_the_step_kernel_once(cuda):
    """The compiled point tick: its capture records one step launch beside
    K1 and K2 and fewer than 300 graph nodes, and a compiled chunk equals
    the eager chunk bit for bit."""
    cfg = load_config("config_point", POINT_MAIN)

    def chunk(tamp):
        env = tamp.env
        state = env.init_state()
        for _ in range(10):
            state = env.step(state, torch.zeros(env.nu, device=cuda), env.zero_ext())
        return tamp._run_chunk_impl(tamp.mppi_state, state, tamp.tamp_interface(state), 0, 12, gate=False)

    tamp = ReactiveTAMP(cfg, device=cuda)
    got = chunk(tamp)
    (prog,) = tamp.ticks.programs.values()
    assert prog.graph is not None
    assert prog.stats["launches"] == {"rollout_launches": 1, "weights_launches": 1, "step_launches": 1}
    assert prog.stats["nodes"] < 300, prog.stats["nodes"]
    ref = chunk(ReactiveTAMP(cfg, device=cuda, graphs=False))
    got, ref = graph_tick._leaves(got), graph_tick._leaves(ref)
    assert len(got) == len(ref)
    for i, (a, b) in enumerate(zip(got, ref)):
        assert torch.equal(_bits(a), _bits(b)) if a.dtype == torch.float32 else torch.equal(a, b), i


# ------------------------------------------------- the panda's real-env step (K6)
# The panda step kernel follows models/panda_env.step bit for bit on one
# state: it adds each sum in the order PyTorch's CUDA reductions add it and
# forms each 3x3 product in the order cuBLAS forms it for one state.  Those
# orders are measured first; cuBLAS forms some products of a batch of states
# in another order, so a batched launch is held to the plain step of each
# state alone and to B single launches.


def _fma(a, b, c):
    """float32 fma(a, b, c): the product is exact in float64."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64) + np.asarray(c, np.float64)).astype(np.float32)


def _dot_single(a, b):
    """fma(a1, b1, a0 b0) + a2 b2 over the last axis."""
    return (_fma(a[..., 1], b[..., 1], (a[..., 0] * b[..., 0]).astype(np.float32))
            + (a[..., 2] * b[..., 2]).astype(np.float32)).astype(np.float32)


def _dot_fused(a, b):
    """fma(a2, b2, fma(a1, b1, a0 b0)) over the last axis."""
    return _fma(a[..., 2], b[..., 2], _fma(a[..., 1], b[..., 1], (a[..., 0] * b[..., 0]).astype(np.float32)))


def _tree_norm(x):
    """The innermost-dim norm of 2, 3 or 4 values: lane e holds element e,
    the lanes folded by shuffles down (x0^2 + x2^2) + (x1^2 + x3^2)."""
    sq = (x * x).astype(np.float32)
    even = sq[..., 0] if x.shape[-1] < 3 else (sq[..., 0] + sq[..., 2]).astype(np.float32)
    odd = sq[..., 1] if x.shape[-1] < 4 else (sq[..., 1] + sq[..., 3]).astype(np.float32)
    return np.sqrt((even + odd).astype(np.float32))


# (the plain step's product, its operands' shapes without the batch, the
# product, the order for one state, the order for a batch of 20)
PANDA_PRODUCTS = {
    "FK matrix-vector": (((3, 3), (3,)), lambda a, b: a @ b, _dot_single, _dot_single),
    "FK and held-cube matrix-matrix": (((3, 3), (3, 3)), lambda a, b: a @ b, _dot_single, _dot_fused),
    "grasp row-vector": (((1, 3), (3, 3)), lambda a, b: a @ b, _dot_single, _dot_fused),
    "held-cube column-vector": (((3, 3), (3, 1)), lambda a, b: a @ b, _dot_single, _dot_single),
    "grasp transposed": (((3, 3), (3, 3)), lambda a, b: a.transpose(-1, -2) @ b, _dot_fused, _dot_fused),
}


@pytest.mark.parametrize("lead", [(), (20,)], ids=["one", "batch20"])
@pytest.mark.parametrize("name", list(PANDA_PRODUCTS))
def test_panda_plain_step_product_orders(cuda, name, lead):
    """Each 3x3 product of models/panda_env.step (and panda_fk.fk) on the
    card, with the operands' batch as the plain step has it (the FK's
    constant factors unbatched): one state's products as the kernel forms
    them, a batch's partly in the other order."""
    (sa, sb), prod, single, batch = PANDA_PRODUCTS[name]
    order = single if lead == () else batch
    rng = np.random.default_rng(23)
    lead_b = () if name == "FK matrix-vector" or (name.startswith("FK and") and lead == ()) else lead
    for _ in range(16):
        a = (rng.standard_normal(lead + sa) * 10.0 ** rng.uniform(-2, 1, lead + sa)).astype(np.float32)
        b = (rng.standard_normal(lead_b + sb) * 10.0 ** rng.uniform(-2, 1, lead_b + sb)).astype(np.float32)
        got = prod(torch.as_tensor(a, device=cuda), torch.as_tensor(b, device=cuda)).cpu().numpy()
        at = np.swapaxes(a, -1, -2) if name == "grasp transposed" else a
        bm = b[..., None] if b.ndim == len(lead_b) + 1 else b
        want = order(at[..., :, None, :], np.swapaxes(bm, -1, -2)[..., None, :, :])
        want = want.reshape(got.shape)
        assert np.array_equal(got.view(np.int32), want.view(np.int32)), (name, lead)


# (the step's reduction, the reduced tensor's trailing shape, the reduction,
# its order) at S = 3 and 8 statics
PANDA_SUMS = {
    "pushout over statics": (lambda S: (3, S, 3), lambda t: torch.sum(t, dim=-2),
                             lambda x: np.apply_along_axis(_acc4, -1, np.moveaxis(x, -2, -1))),
    "static forces over bodies": (lambda S: (3, S, 3), lambda t: torch.sum(t, dim=-3),
                                  lambda x: np.apply_along_axis(_acc4, -1, np.moveaxis(x, -3, -1))),
    "probe forces over statics": (lambda S: (S, 3), lambda t: torch.sum(t, dim=-2),
                                  lambda x: np.apply_along_axis(_acc4, -1, np.moveaxis(x, -2, -1))),
    "3-vector norms": (lambda S: (3, S, 3), lambda t: torch.linalg.vector_norm(t, dim=-1), _tree_norm),
    "quaternion norms": (lambda S: (3, 4), lambda t: torch.linalg.vector_norm(t, dim=-1), _tree_norm),
    "xy speeds": (lambda S: (3, 3), lambda t: torch.linalg.vector_norm(t[..., :2], dim=-1),
                  lambda x: _tree_norm(x[..., :2])),
}


@pytest.mark.parametrize("lead", [(), (20,)], ids=["one", "batch20"])
@pytest.mark.parametrize("name", list(PANDA_SUMS))
def test_panda_plain_step_sum_orders(cuda, name, lead):
    """Each sum and norm of models/panda_env.step at its layout, without and
    with a leading seed axis, in the order the panda step kernel takes, on
    values of mixed magnitudes and signs with zeros: bit for bit."""
    shape_of, reduce, order = PANDA_SUMS[name]
    rng = np.random.default_rng(24)
    for S in (3, 8):
        shape = lead + shape_of(S)
        for _ in range(6):
            x = (rng.standard_normal(shape) * 10.0 ** rng.uniform(-6, 3, shape)).astype(np.float32)
            x[rng.random(shape) < 0.3] = 0.0
            got = reduce(torch.as_tensor(x, device=cuda)).cpu().numpy()
            want = np.asarray(order(x), np.float32).reshape(got.shape)
            assert np.array_equal(got.view(np.int32), want.view(np.int32)), (name, lead, S)


PANDA_SCENES = {"table": [], "shelf": ["cube_on_shelf=True"]}
PANDA_SCRIPT_T = 240


def _unit(v: np.ndarray) -> np.ndarray:
    return (v / np.linalg.norm(v)).astype(np.float32)


def _pressing_qs(params, rng, device) -> list:
    """For each static that some of 4,000 random joint vectors within the
    limits press a probe into (a probe sphere 5 mm deep in the box), the
    first such joint vector."""
    lo, hi = params.joint_lower.cpu().numpy(), params.joint_upper.cpu().numpy()
    q = torch.as_tensor(rng.uniform(lo, hi, (4000, 9)).astype(np.float32), device=device)
    links = panda_fk.fk(q, params.base_pos)
    probes = torch.stack([links[n][0] for n in ("link4", "link5", "link6", "hand", "leftfinger", "rightfinger",
                                                "fingertip")], dim=-2)  # [N, 7, 3]
    found = []
    for s in range(params.stat_min.shape[0]):
        pen, _ = panda_env.sphere_vs_aabb(probes, 0.05, params.stat_min[s], params.stat_max[s])
        hits = torch.nonzero((pen > 0.005).any(-1)).flatten()
        if hits.numel() > 0:
            found.append(q[int(hits[0])])
    return found


class _PandaScript:
    """A scripted run of one panda state over PANDA_SCRIPT_T steps, from
    ``offset`` on: a free reach, a grasp of cubeA put at the fingertip, a
    carry with the fingers clamped, an opening release (below, then above
    the release gap), cubeA dropped on cubeB and on the table, a closing
    gripper far from cubeA, cubeA pushing cubeB, and the arm pressing into
    each static in turn; random forces on the bodies every other step
    outside the push.  ``(t, state) -> (state, u, ext)``: the state may be
    moved before the step."""

    def __init__(self, params, rng, offset: int, pressing: list):
        self.p, self.rng, self.offset, self.pressing = params, rng, offset, pressing
        self.joints = np.zeros(7, np.float32)

    def phase(self, t: int) -> int:
        return (t + self.offset) % PANDA_SCRIPT_T

    def __call__(self, t: int, state):
        p, rng, t = self.p, self.rng, self.phase(t)
        dev = p.device
        tensor = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)  # noqa: E731
        pos, quat = state.body_pos.clone(), state.body_quat.clone()
        vel, om, q, qd = state.body_vel.clone(), state.body_om.clone(), state.q.clone(), state.qd.clone()
        if t == 30:  # cubeA at the fingertip, turned
            tip = panda_fk.fk(state.q, p.base_pos)["fingertip"][0]
            pos[1] = tip + tensor(0.01 * _unit(rng.standard_normal(3)))
            quat[1], vel[1], om[1] = tensor(_unit(rng.standard_normal(4))), 0.0, 0.0
        if t == 110:  # cubeA above cubeB
            pos[1] = pos[2] + tensor([0.005, -0.004, 0.08])
            vel[1], om[1] = 0.0, tensor(rng.uniform(-0.5, 0.5, 3))
        if t == 130:  # cubeA above the table
            pos[1], vel[1] = tensor([0.0, -0.3, 1.09]), 0.0
        if t == 160:  # cubeA beside cubeB, moving into it
            pos[1] = pos[2] + tensor([0.04, 0.005, 0.0])
            vel[1] = tensor([-0.1, 0.0, 0.0])
        if t >= 180 and (t - 180) % 20 == 0:  # the arm pressing into static k
            q, qd = self.pressing[(t - 180) // 20 % len(self.pressing)].clone(), torch.zeros_like(qd)
        if t % 10 == 0:
            scale = {0: 0.5, 3: 0.2, 5: 0.8, 9: 0.5, 11: 0.5, 13: 0.5, 14: 0.3, 16: 0.1}.get(t // 10, 0.1)
            self.joints = rng.uniform(-scale, scale, 7).astype(np.float32)
        closing = 30 <= t < 90 or 145 <= t < 160
        fingers = -0.1 if closing else 0.05
        u = tensor(list(self.joints) + [fingers, fingers])
        push = 160 <= t < 180
        body = rng.normal(0.0, 0.5, (3, 3)) if t % 2 == 0 and not push else np.zeros((3, 3))
        state = dataclasses.replace(state, q=q, qd=qd, body_pos=pos, body_quat=quat, body_vel=vel, body_om=om)
        return state, u, panda_env.PandaExtForces(body=tensor(body))


def _stack(trees):
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def _row(tree, b: int):
    return tree_map(lambda x: x[b], tree)


def _assert_bits(got, ref, what) -> None:
    for f in dataclasses.fields(ref):
        a, r = getattr(got, f.name), getattr(ref, f.name)
        assert a.shape == r.shape and torch.equal(_bits(a), _bits(r)), (
            what, f.name, int((_bits(a) != _bits(r)).sum()), float((a - r).abs().max()))


def _panda_coverage(params, t_phase, state, u, ref, seen: set) -> None:
    """Mark what the step from ``state`` exercised (its plain result ``ref``)."""
    att0, att1 = float(state.attached), float(ref.attached)
    seen.add("attach" if att0 < 0.5 < att1 else "release" if att1 < 0.5 < att0 else "")
    if float(u[7]) < 0.0 and att0 < 0.5 and att1 < 0.5:
        seen.add("closing far")
    if float(u[7]) > 0.0 and att0 > 0.5 and att1 > 0.5:
        seen.add("opening held")
    if 50 <= t_phase < 90 and att1 > 0.5:
        seen.add("carry")
    if float(state.body_vel[1, 2]) < 0.0 and float(ref.body_vel[1, 2]) == 0.0:
        top_b = float(ref.body_pos[2, 2] + params.body_half[2, 2])
        seen.add("lands on cubeB" if float(ref.body_pos[1, 2]) > top_b else "lands on the table")
    if 160 <= t_phase < 180 and not torch.equal(ref.body_pos[2, :2], state.body_pos[2, :2]):
        seen.add("pushes cubeB")
    for k, a in enumerate(params.stat_actor_idx):
        if t_phase >= 180 and bool((ref.contact_force[a] != 0).any()):
            seen.add(f"presses static {k}")


def _check_panda_step(params, step, B: int, steps: int, seed: int, device) -> set:
    """``steps`` scripted steps of B states through ``step`` (the kernel),
    each from the state the kernel gave: every field bit for bit the plain
    step of each state alone, and a batch bit for bit B single launches.
    Returns what the single-state steps exercised."""
    rng = np.random.default_rng(seed)
    pressing = _pressing_qs(params, rng, device)
    scripts = [_PandaScript(params, np.random.default_rng(seed * 1000 + b), 37 * b, pressing) for b in range(B)]
    rows = [panda_env.init_state(params) for _ in range(B)]
    counter = "panda_step_batched_launches" if B > 1 else "panda_step_launches"
    seen: set = set()
    for t in range(steps):
        inputs = [script(t, row) for script, row in zip(scripts, rows)]
        batch = inputs[0] if B == 1 else tuple(_stack(x) if dataclasses.is_dataclass(x[0]) else torch.stack(x)
                                               for x in zip(*inputs))
        before = getattr(pps, counter)
        got = step(*batch)
        assert getattr(pps, counter) == before + 1
        for b, (state, u, ext) in enumerate(inputs):
            ref = panda_env.step(params, state, u, ext)
            row = got if B == 1 else _row(got, b)
            _assert_bits(row, ref, (t, b))
            if B > 1:
                _assert_bits(row, step(state, u, ext), (t, b, "single launch"))
            else:
                _panda_coverage(params, scripts[b].phase(t), state, u, ref, seen)
        rows = [got] if B == 1 else [_row(got, b) for b in range(B)]
    return seen - {""}


@pytest.mark.parametrize("scene", list(PANDA_SCENES))
def test_panda_step_kernel_equals_plain_bit_for_bit(cuda, scene):
    """K6 against models/panda_env.step on the card, the table and the shelf
    scene, one state over the 240-step script: every field of every step bit
    for bit, through the attach, the carry with the finger clamp, the
    release below and above the gap, cubeA landing on cubeB and on the
    table, a closing gripper far from cubeA, cubeA pushing cubeB, the probes
    pressing into every static, and random body forces."""
    env = make_env(load_config("config_panda", PANDA_SCENES[scene]), device=cuda)
    seen = _check_panda_step(env.params, env.step, 1, PANDA_SCRIPT_T, 5, cuda)
    want = {"attach", "release", "closing far", "opening held", "carry", "lands on cubeB", "lands on the table",
            "pushes cubeB"} | {f"presses static {k}" for k in range(env.params.stat_min.shape[0])}
    assert want <= seen, want - seen


@pytest.mark.parametrize("B, steps", [(3, PANDA_SCRIPT_T), (20, 48)])
def test_batched_panda_step_kernel_equals_plain_and_single(cuda, B, steps):
    """K6b at B = 3 over the whole script and at B = 20 (each state at its
    own phase of it): each state bit for bit the plain step on that state
    alone and a single launch."""
    env = make_env(load_config("config_panda"), device=cuda)
    _check_panda_step(env.params, env.step, B, steps, 6 + B, cuda)


def test_panda_step_kernel_at_the_maxima(cuda):
    """S = 8 statics (the pushout's sums over five to eight statics, three
    rounds of first-round tests): bit for bit, one state and B = 3."""
    params = _panda_scene_at_the_maxima(load_config("config_panda"), cuda)
    assert params.stat_min.shape[0] == pr.MAX_STAT
    step = pps.make_step(params)
    _check_panda_step(params, step, 1, 120, 8, cuda)
    _check_panda_step(params, step, 3, 60, 9, cuda)


@pytest.mark.parametrize("B", [1, 3])
def test_panda_step_graph_replay_equals_eager(cuda, B):
    """The step captured in a CUDA graph (``graph_tick.env_steps``, the
    settle's and the sim client's program): one launch a replay, counted by
    graph_tick as the launches a replay stands for, and the replayed steps
    bit for bit the eager ones."""
    env = make_env(load_config("config_panda"), device=cuda)
    script = _PandaScript(env.params, np.random.default_rng(B), 20, _pressing_qs(env.params, np.random.default_rng(0),
                                                                                  cuda))
    state, u, ext = script(0, env.init_state())
    if B > 1:
        state, u, ext = _stack([state] * B), torch.stack([u] * B), _stack([ext] * B)
    eager = state
    for _ in range(12):
        eager = env.step(eager, u, ext)
    name = "panda_step_batched_launches" if B > 1 else "panda_step_launches"
    own, replayed = getattr(pps, name), graph_tick.replayed_launches.get(name, 0)
    ticks = graph_tick.TickGraphs(cuda, None)
    got = graph_tick.env_steps(ticks, env, state, u, ext, 12)
    _assert_bits(got, eager, "replayed")
    (stats,) = ticks.stats()
    # the kernel and the copies of the stepped state into the carry
    assert stats["launches"] == {name: 1} and stats["nodes"] <= 1 + len(dataclasses.fields(state)), stats
    assert getattr(pps, name) - own == 1  # the eager warm-up; the capture launches nothing
    assert graph_tick.replayed_launches.get(name, 0) - replayed == 11


def test_panda_step_over_the_kernel_limits_raises(cuda):
    """A ninth static on the card: the env's step is not made and the
    kernel's wrapper raises; no launch."""
    cfg = load_config("config_panda")
    actors = load_env_cfgs(cfg.env_type) + [
        ActorCfg(type="box", name=f"post-{i}", size=[0.04, 0.04, 0.1], init_pos=[0.3, -0.5 + 0.1 * i, 1.1], fixed=True)
        for i in range(6)
    ]
    params = panda_env.build_params(actors, cfg.sim, device=cuda)
    assert params.stat_min.shape[0] == pr.MAX_STAT + 1
    state = panda_env.init_state(params)
    u, ext = torch.zeros(9, device=cuda), panda_env.zero_ext(params)
    before = (pps.panda_step_launches, pps.panda_step_batched_launches)
    with pytest.raises(ValueError, match="the kernel takes 1 <= S <= 8"):
        pps.make_step(params)
    with pytest.raises(ValueError, match="the kernel takes 1 <= S <= 8"):
        pps.panda_step(params, pps.param_buffer(params), state, u, ext)
    assert (pps.panda_step_launches, pps.panda_step_batched_launches) == before


def test_compiled_panda_tick_launches_the_step_kernel_once(cuda):
    """The compiled panda tick of the panda-pick cell (multi-modal, the
    refine ladder): its capture records one K6 launch beside K3 x4 and K2 x3
    and fewer than 700 graph nodes, and a compiled chunk equals the eager
    chunk bit for bit."""
    cfg = load_config("config_panda", ["multi_modal=True"])

    def chunk(tamp):
        env = tamp.env
        state = env.init_state()
        for _ in range(10):
            state = env.step(state, torch.zeros(env.nu, device=cuda), env.zero_ext())
        stage = torch.zeros((), dtype=torch.int32, device=cuda)
        return tamp._run_chunk_panda_impl(tamp.mppi_state, state, stage, tamp.zup_zs0(), 12)

    tamp = ReactiveTAMP(cfg, device=cuda)
    got = chunk(tamp)
    (prog,) = [p for p in tamp.ticks.programs.values() if p.graph is not None]
    assert prog.stats["launches"] == {"panda_rollout_launches": 4, "weights_launches": 3, "panda_step_launches": 1}
    assert prog.stats["nodes"] < 700, prog.stats["nodes"]
    ref = chunk(ReactiveTAMP(cfg, device=cuda, graphs=False))
    got, ref = graph_tick._leaves(got), graph_tick._leaves(ref)
    assert len(got) == len(ref)
    for i, (a, b) in enumerate(zip(got, ref)):
        assert torch.equal(_bits(a), _bits(b)) if a.dtype == torch.float32 else torch.equal(a, b), i
