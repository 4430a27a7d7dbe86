"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Runs only with ``M3P2I_TEST_CUDA=1`` on a machine with a CUDA GPU:

    M3P2I_TEST_CUDA=1 python -m pytest tests/test_torch_cuda.py -q

Elsewhere every test skips (the kernels have no CPU mode; their plain
versions are what the CPU suite holds against the JAX package).  Bars: the
weights at atol 1e-6 with sums within 1e-5, the rollout at cost atol 1e-2
and trajectory atol 1e-3 (tests/test_pallas.py:131-132, :259-260).
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from m3p2i_aip_tpu_torch.config.config_store import load_config
from m3p2i_aip_tpu_torch.ops import rollout as ro
from m3p2i_aip_tpu_torch.ops import weights
from m3p2i_aip_tpu_torch.tamp.reactive_tamp import ReactiveTAMP
from m3p2i_aip_tpu_torch.utils.tree import tree_map

pytestmark = pytest.mark.cuda

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


# 200 = the main path, 37 = odd halves, 1500 > 1024 = the strided block loop
@pytest.mark.parametrize("K", [200, 37, 1500])
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


@pytest.mark.parametrize("config_name", ["config_point", "config_heijn", "config_boxer"])
def test_rollout_kernel_matches_plain(cuda, config_name):
    tamp = ReactiveTAMP(
        load_config(config_name, ["task=push_pull", "multi_modal=True", "goal=[-3.75,-3.75]"]), device=cuda
    )
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


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    cost = torch.rand(15, 40, device=cuda).T  # not contiguous
    with pytest.raises(ValueError):
        weights.multimodal_weights(cost, torch.ones(15, device=cuda), 20)
    with pytest.raises(ValueError):
        weights.multimodal_weights(torch.rand(40, 15, device=cuda, dtype=torch.float64), torch.ones(15, device=cuda), 20)
