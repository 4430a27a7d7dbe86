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


def test_cpu_wrapper_launches_no_kernel():
    """A CPU tensor takes the plain version and leaves the launch count alone."""
    before = weights.weights_launches
    cost = torch.rand(16, T)
    weights.multimodal_weights(cost, torch.ones(T), 8)
    assert weights.weights_launches == before
