"""The port's multi-modal weights (K2's plain version, and its wrapper on a
CPU tensor) against the JAX package's Pallas weights kernel in interpret mode
and its XLA ``_multi_modal_exp_util``.

Bars from tests/test_pallas.py:131-132: weights within atol 1e-6 and every
weight vector summing to 1 within 1e-5 (f32 sums over K in a different
order differ by a few ulp; the beta decisions themselves must agree).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from m3p2i_aip_tpu.config.config_store import load_config as jax_load_config
from m3p2i_aip_tpu.ops.pallas_kernels import multimodal_weights_pallas
from m3p2i_aip_tpu.planners.motion_planner.mppi import MPPI
from m3p2i_aip_tpu_torch.ops import weights

T = 15
ATOL, SUM_TOL = 1e-6, 1e-5


@functools.lru_cache(maxsize=None)
def _jax_planner(K: int):
    cfg = jax_load_config(
        "config_point",
        ["task=push_pull", "multi_modal=True", f"mppi.num_samples={K}", f"mppi.horizon={T}"],
    )
    mp = MPPI(cfg, dynamics=None, running_cost=None, zero_ext=None)
    mp.use_pallas = False  # the XLA path
    return mp, jax.jit(mp._multi_modal_exp_util)


# K=200 is the main path's width, 37 an odd K with unequal mode halves;
# cost spreads of 50 and 0.5 push beta down and up respectively
@pytest.mark.parametrize("K", [200, 37])
@pytest.mark.parametrize("spread", [50.0, 0.5])
def test_multimodal_weights_match_jax_package(K, spread):
    mp, xla_fn = _jax_planner(K)
    rng = np.random.default_rng(K)
    cost = rng.uniform(0, spread, size=(K, T)).astype(np.float32)
    gamma = np.array(mp.gamma_seq)

    refs = {
        "pallas_interpret": multimodal_weights_pallas(
            jnp.asarray(cost), mp.gamma_seq, mp.half_K, mp.eta_u, mp.eta_l, interpret=True
        ),
        "xla": xla_fn(jnp.asarray(cost)),
    }
    args = (torch.as_tensor(cost), torch.as_tensor(gamma), mp.half_K, mp.eta_u, mp.eta_l)
    ports = {"plain": weights.multimodal_weights_plain(*args), "wrapper_cpu": weights.multimodal_weights(*args)}
    for pname, got in ports.items():
        for g in got:
            assert abs(float(torch.sum(g)) - 1.0) < SUM_TOL, pname
        for rname, ref in refs.items():
            for i, (g, r) in enumerate(zip(got, ref)):
                np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=ATOL, rtol=0, err_msg=f"{pname} vs {rname} w{i}")


def _capped_case(case: str):
    """(K, [K, T] costs) whose searches run into the 64-round cap: "tied",
    every sample's cost equal, so eta = n > eta_u at any beta and beta goes
    down 64 times; "small_group", K = 5 with half_K = 2, where group 0's two
    samples can never sum to eta_l = 3 and its beta goes up 64 times."""
    if case == "tied":
        return 200, np.full((200, T), 1.43, np.float32)
    return 5, np.random.default_rng(5).uniform(0, 50, size=(5, T)).astype(np.float32)


@pytest.mark.parametrize("case", ["tied", "small_group"])
def test_capped_searches_match_jax_package(case):
    """The searches that hit the cap (the panda's place_detach costs tie)
    against the Pallas kernel in interpret mode and the XLA path; a tie's
    weights are exactly 1/n in any summation order."""
    K, cost = _capped_case(case)
    mp, xla_fn = _jax_planner(K)
    refs = {
        "pallas_interpret": multimodal_weights_pallas(
            jnp.asarray(cost), mp.gamma_seq, mp.half_K, mp.eta_u, mp.eta_l, interpret=True
        ),
        "xla": xla_fn(jnp.asarray(cost)),
    }
    args = (torch.as_tensor(cost), torch.as_tensor(np.array(mp.gamma_seq)), mp.half_K, mp.eta_u, mp.eta_l)
    got = weights.multimodal_weights(*args)
    for i, g in enumerate(got):
        assert abs(float(torch.sum(g)) - 1.0) < SUM_TOL
        for rname, ref in refs.items():
            np.testing.assert_allclose(g.numpy(), np.asarray(ref[i]), atol=ATOL, rtol=0, err_msg=f"{rname} w{i}")
    if case == "tied":
        for g, n in zip(got, (mp.half_K, K - mp.half_K, K)):
            assert torch.equal(g[g > 0], torch.full((n,), 1.0 / n))


def _repeated(factor: float, n: int) -> np.float32:
    b = np.float32(1.0)
    for _ in range(n):
        b = np.float32(b * np.float32(factor))
    return b


@pytest.mark.parametrize("case", ["tied", "small_group", "uniform"])
def test_beta_rounds_counts_the_kernels_rounds(case):
    """``beta_rounds``, the round counter of the smoke's bound and
    histograms: a tie runs 64 rounds down to beta = 0.9f ** 64 by repeated
    products; K = 5 with half_K = 2 runs group 0 64 rounds up; the smoke's
    uniform(0, 50) input at K = 200 x T = 15 stops after 19 / 15 / 17
    rounds, every one up."""
    if case == "uniform":
        K, cost = 200, np.random.default_rng(0).uniform(0, 50, size=(200, T)).astype(np.float32)
    else:
        K, cost = _capped_case(case)
    gamma = torch.as_tensor(np.cumprod([1.0] + [0.95] * (T - 1)).astype(np.float32))
    rounds, turns, beta = weights.beta_rounds(torch.as_tensor(cost), gamma, K // 2)
    assert not turns.any()
    if case == "tied":
        assert rounds.tolist() == [64, 64, 64]
        assert (beta == _repeated(0.9, 64)).all()
    elif case == "small_group":
        assert rounds[0] == 64 and beta[0] == _repeated(1.2, 64)
        assert rounds[2] < 64
    else:
        assert rounds.tolist() == [19, 15, 17]
        assert beta.tolist() == [_repeated(1.2, n) for n in (19, 15, 17)]
    # a batch counts each seed as alone
    batched = weights.beta_rounds(torch.as_tensor(np.stack([cost, cost])), gamma, K // 2)
    assert batched[0].tolist() == [rounds.tolist()] * 2


def test_cpu_wrapper_launches_no_kernel():
    """A CPU tensor takes the plain version and leaves the launch count alone."""
    before = weights.weights_launches
    cost = torch.rand(16, T)
    weights.multimodal_weights(cost, torch.ones(T), 8)
    assert weights.weights_launches == before


# 16384: the sharded sweep's largest K (scripts/bench_sharded.py), past the
# 12288 samples the kernel once took; spreads as above
@pytest.mark.parametrize("spread", [50.0, 0.5])
def test_weights_at_large_K_match_jax_package(spread):
    """The plain version and the CPU wrapper at K = 16384 against the JAX
    package's XLA weights (the path its sharded planner takes at any K)."""
    K = 16384
    mp, xla_fn = _jax_planner(K)
    cost = np.random.default_rng(K).uniform(0, spread, size=(K, T)).astype(np.float32)
    ref = xla_fn(jnp.asarray(cost))
    args = (torch.as_tensor(cost), torch.as_tensor(np.array(mp.gamma_seq)), mp.half_K, mp.eta_u, mp.eta_l)
    for pname, got in {"plain": weights.multimodal_weights_plain(*args),
                       "wrapper_cpu": weights.multimodal_weights(*args)}.items():
        for i, (g, r) in enumerate(zip(got, ref)):
            assert abs(float(torch.sum(g)) - 1.0) < SUM_TOL, pname
            np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=ATOL, rtol=0, err_msg=f"{pname} w{i}")
