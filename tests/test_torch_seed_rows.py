"""The per-seed lines ``chip_smoke.py`` prints for each n=20 batch
(``_seed_rows``), on the CPU: one line per seed, with its entry of each of
``analysis.per_seed``'s arrays (the row schemas of ``analysis.run_logger``),
the panda's cube xyz and the seed's success tick; and ``summarize``, the
mean and std of those arrays, against the JAX package's."""
import numpy as np
import pytest

import chip_smoke
from m3p2i_aip_tpu_torch.analysis import per_seed, summarize


def _rows(family: str, n: int) -> np.ndarray:
    rng = np.random.default_rng(0)
    width = {"point": 19, "panda": 15, "albert": 11}[family]
    rows = rng.uniform(0.0, 1.0, size=(n, width))
    if family != "albert":  # unit quaternions where the schema has them
        q = slice(8, 12) if family == "point" else slice(4, 8)
        rows[:, q] /= np.linalg.norm(rows[:, q], axis=1, keepdims=True)
        if family == "panda":
            rows[:, 11:15] /= np.linalg.norm(rows[:, 11:15], axis=1, keepdims=True)
    return rows


@pytest.mark.parametrize("family", ["point", "panda", "albert"])
def test_one_line_per_seed_with_its_numbers(family):
    rows = _rows(family, 3)
    steps = [47, None, 12]
    arrays = per_seed(rows, family)
    cubes = rows[:, 1:4] if family == "panda" else None
    lines = chip_smoke._seed_rows(arrays, steps, cubes)
    assert [line.split(":")[0] for line in lines] == ["seed 0", "seed 1", "seed 2"]
    assert all(line.endswith(f"success tick {s}") for line, s in zip(lines, steps))
    for b, line in enumerate(lines):
        assert all(f"{k} {v[b]:.4f}" in line for k, v in arrays.items())
        if cubes is not None:
            assert f"cube at [{cubes[b, 0]:.4f}, {cubes[b, 1]:.4f}, {cubes[b, 2]:.4f}]" in line


@pytest.mark.parametrize("family", ["point", "panda", "albert"])
def test_summarize_matches_the_jax_package(family):
    from m3p2i_aip_tpu.analysis import summarize as jax_summarize

    rows = _rows(family, 5)
    ours, ref = summarize(rows, family), jax_summarize(rows, family)
    assert ours.keys() == ref.keys()
    for k in ref:
        np.testing.assert_allclose(ours[k], ref[k], rtol=1e-6, atol=1e-7)
    assert all(ours[k] == (float(np.mean(v)), float(np.std(v))) for k, v in per_seed(rows, family).items())
