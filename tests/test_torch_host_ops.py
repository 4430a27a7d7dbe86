"""Host-side pieces of the PyTorch port against the JAX package: the Halton
sampler, the spline and Savitzky-Golay operators, and config composition.

These are numpy copies, so they must agree exactly (or, for the reference's
own captured Halton golden, within its 1e-5 erfinv tolerance).
"""
import dataclasses
import os

import numpy as np
import pytest

from m3p2i_aip_tpu import ops as jops
from m3p2i_aip_tpu.config.config_store import load_config as jax_load_config
from m3p2i_aip_tpu_torch.config.config_store import load_config
from m3p2i_aip_tpu_torch.ops import filters, sampling, spline


def test_gaussian_halton_matches_reference_captured_golden():
    """Same fixture and bar as tests/test_ops.py:273: 1e-5 covers the erfinv
    implementation delta of the captured reference run."""
    path = os.path.join(os.path.dirname(__file__), "goldens", "reference_halton_gauss.npz")
    fixture = np.load(path)
    assert fixture.files
    for key in fixture.files:
        n, d = (int(x) for x in key.split("_")[1].split("x"))
        got = sampling.gaussian_halton_samples(n, d, scramble=False)
        np.testing.assert_allclose(got, fixture[key], atol=1e-5, rtol=0, err_msg=key)


@pytest.mark.parametrize("seed", [0, 123])
def test_scrambled_halton_equals_jax_package(seed):
    """The port's numpy path is bit-identical to the JAX package's sampler
    (which routes through its C++ core when built)."""
    got = sampling.gaussian_halton_samples(200, 6, scramble=True, seed_val=seed)
    ref = jops.gaussian_halton_samples(200, 6, scramble=True, seed_val=seed)
    assert np.array_equal(got, ref)


@pytest.mark.parametrize("n,window,order", [(15, 9, 2), (12, 9, 2), (30, 9, 2), (7, 5, 3)])
def test_savgol_matrix_equals_jax_package(n, window, order):
    assert np.array_equal(filters.savgol_matrix(n, window, order), jops.savgol_matrix(n, window, order))


@pytest.mark.parametrize("n_knots,horizon", [(3, 15), (3, 12), (7, 30)])
def test_bspline_matrix_equals_jax_package(n_knots, horizon):
    got = spline.bspline_interp_matrix(n_knots, horizon, degree=2, smoothing=0.5)
    ref = jops.bspline_interp_matrix(n_knots, horizon, degree=2, smoothing=0.5)
    assert np.array_equal(got, ref)


@pytest.mark.parametrize(
    "name,overrides",
    [
        ("config_point", []),
        ("config_point", ["task=push_pull", "multi_modal=True", "goal=[-3.75,-3.75]"]),
        ("config_point", ["mppi.num_samples=16", "mppi.exploration_noise=0", "fric_noise=0.4"]),
        ("config_point", ["actors=['box']", "initial_actor_positions=[[3.75, 3.75]]"]),
        ("config_boxer", ["mppi=boxer_parity"]),
        ("config_heijn", ["task=pull"]),
    ],
)
def test_load_config_composes_like_jax_package(name, overrides):
    got = dataclasses.asdict(load_config(name, overrides))
    ref = dataclasses.asdict(jax_load_config(name, overrides))
    assert got == ref
