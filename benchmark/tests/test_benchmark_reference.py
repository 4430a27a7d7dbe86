"""The plain reference against the program's plain path at a tiny size on
the CPU, the harness's imports, and the check's control and faults: each
must turn ``correct`` false."""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys

import pytest
import torch

from benchmark import check
from benchmark.reference import tick as ref_tick
from benchmark.tests import tiny
from benchmark.yardstick import roofline

CELLS = ["point-pushpull-chunked", "panda-pick-chunked", "point-pushpull-pertick", "point-pushpull-batch20"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make(tmp_path_factory.mktemp("tiny"))


@pytest.mark.parametrize("cell", CELLS)
def test_reference_equals_the_program_on_the_cpu(cell, root, monkeypatch):
    line = tiny.run(root, monkeypatch, "--workload", cell, "--seed", "2147483801", "--seconds", "1")
    # ticks 0 and 2, one checkpoint each (a batch: of two different seeds)
    assert line["correct"] and line["failed"] == 0 and line["ticks_checked"] == 2
    assert line["checked"]["view_gap"]["value"] == 0.0  # the same plain code on the same device
    assert list(line)[-1] == "checked"
    assert set(line["metrics"]) >= {"setup_s"} and len(line["metrics"]) == 2


def _parents_bounds(scene, seeds_per_tick: int) -> dict:
    """``check._bounds`` as it was before a configuration named its
    reference: the rollout and weights bounds of the last tick's calls."""
    from benchmark.reference.plain.ops import panda_rollout, rollout as point_rollout
    from benchmark.reference.plain.ops.weights import beta_rounds

    spec = scene.rollout_spec
    out = {"rollout": [], "weights": []}
    for kind, args, live in scene.calls:
        if kind == "rollout":
            sim_state_k, acts, task = args
            K = acts.shape[-3]
            if scene.is_panda:
                inputs = (*panda_rollout.rollout_inputs(sim_state_k, task), acts)
                ops = roofline.panda_rollout_ops(spec, K)
            else:
                inputs = (*point_rollout.rollout_inputs(sim_state_k, task), acts)
                ops = roofline.point_rollout_ops(spec, K, int(torch.stack(live).sum()) if live else 0)
            out["rollout"].append(seeds_per_tick * roofline.rollout_bound_ms(spec, inputs, K, ops))
        else:
            cost, gamma, half_K, eta_u, eta_l = args
            rounds = beta_rounds(cost, gamma, half_K, eta_u, eta_l)[0]
            out["weights"].append(seeds_per_tick * roofline.weights_bound_ms(cost, gamma, half_K, rounds))
    return out


class _ParentScene(ref_tick.Scene):
    """The tick as it was: the real-env step not recorded as a call."""

    def _step(self, state, action, ext):
        return self.env.step(state, action, ext)


def _window_checkpoints(root, monkeypatch, cell, seed):
    from benchmark import spec as spec_mod

    monkeypatch.setattr(spec_mod, "ROOT", root)
    spec = spec_mod.load()
    w = spec_mod.cell(spec, cell)
    cfg_file, traffic = spec_mod.config_file(spec, w), spec_mod.traffic(w)
    loop = spec_mod.loop(traffic["loop"])(cfg_file, traffic, seed, "cpu")
    loop.setup()
    loop.window(0.1)
    return cfg_file, check.sample(loop.checkpoints, 2, seed), loop.seeds_per_tick


@pytest.mark.parametrize("cell", ["point-pushpull-chunked", "panda-pick-chunked", "point-pushpull-batch20"])
def test_the_named_reference_gives_the_parents_views_and_bounds(cell, root, monkeypatch):
    """Through the configuration's named reference: the view rows, and the
    rollout and weights bounds, of the parent's fixed reference and its
    ``check._bounds``, bit for bit; the step's bounds besides, one a point
    tick."""
    cfg_file, cks, per = _window_checkpoints(root, monkeypatch, cell, 2147483655)
    assert cfg_file["reference"] == "tick" and len(cks) >= 2
    views, bounds = check.reference_views(cfg_file, cks, "cpu", count_live=True, seeds_per_tick=per)
    parent = _ParentScene(cfg_file, "cpu", count_live=True)
    want = {"rollout": [], "weights": []}
    for ck, view in zip(cks, views):
        assert parent.tick(ck).cpu().numpy().tobytes() == view.tobytes()
        for k, v in _parents_bounds(parent, per).items():
            want[k] += v
    assert want["rollout"] and want["weights"]
    assert bounds["rollout"] == want["rollout"] and bounds["weights"] == want["weights"]
    panda = cell.startswith("panda")
    assert len(bounds["step"]) == (0 if panda else len(cks)) and all(b > 0 for b in bounds["step"])
    plain, _ = check.reference_views(cfg_file, cks, "cpu")
    assert all(a.tobytes() == b.tobytes() for a, b in zip(plain, views))


@pytest.mark.parametrize("named", [None, "nowhere"])
def test_a_configuration_without_its_reference_fails_before_its_window(named, tmp_path, monkeypatch):
    from benchmark.loops import Loop

    root = tiny.make(tmp_path / "copy")
    f = root / "benchmark" / "configs" / "point-pushpull.json"
    c = json.loads(f.read_text())
    if named is None:
        del c["reference"]
    else:
        c["reference"] = named
    f.write_text(json.dumps(c))
    for phase in ("setup", "window"):
        monkeypatch.setattr(Loop, phase, lambda *a, **k: pytest.fail("the run went past set-up's check"))
    with pytest.raises(SystemExit, match="reference"):
        tiny.run(root, monkeypatch, "--workload", "point-pushpull-chunked", "--seed", "3", "--seconds", "0.1")


def test_the_harness_and_reference_load_no_jax():
    code = ("import sys; sys.path.insert(0, '.'); import benchmark.run, benchmark.check, benchmark.loops, "
            "benchmark.loops.chunked, benchmark.loops.pertick, benchmark.loops.batch, "
            "benchmark.control, benchmark.trace, benchmark.reference.tick as t; "
            "import benchmark.reference.plain.envs; "
            "print([m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'm3p2i_aip_tpu', 'm3p2i_aip_tpu_torch')])")
    out = subprocess.run([sys.executable, "-c", code], cwd=tiny.REPO, capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_a_run_refuses_to_print_with_jax_loaded(monkeypatch):
    from benchmark import run as run_mod

    monkeypatch.setitem(sys.modules, "jax", sys)
    assert run_mod.forbidden_modules() == ["jax"]
    monkeypatch.setitem(sys.modules, "m3p2i_aip_tpu_torch_x", sys)
    assert run_mod.forbidden_modules() == ["jax"]


def test_no_result_without_a_card(monkeypatch):
    from benchmark import run as run_mod

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit):
        run_mod.run(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"])


def _gaps_with(root, monkeypatch, cell, patch):
    patch(monkeypatch)
    return tiny.run(root, monkeypatch, "--workload", cell, "--seed", "12345", "--seconds", "1")


def _step_unchanged(monkeypatch):
    from m3p2i_aip_tpu_torch.models import panda_env, point_env

    monkeypatch.setattr(point_env, "step", lambda params, state, u, ext: state)
    monkeypatch.setattr(panda_env, "step", lambda params, state, u, ext: state)


def _half_the_samples(monkeypatch):
    from m3p2i_aip_tpu_torch.planners.motion_planner.mppi import MPPI

    mean = MPPI._weighted_mean

    def half(w, actions):
        k = w.shape[-1] // 2
        w = w[..., :k] / torch.sum(w[..., :k], dim=-1, keepdim=True)
        return mean(w, actions[..., :k, :, :])

    monkeypatch.setattr(MPPI, "_weighted_mean", staticmethod(half))


def _answer_altered(monkeypatch):
    from m3p2i_aip_tpu_torch import envs

    make = envs.make_env

    def altered(cfg, device="cuda"):
        env = make(cfg, device)
        view_vec = env.view_vec
        return dataclasses.replace(env, view_vec=lambda s: view_vec(s) + 1e-2)  # 10x the widest limit

    monkeypatch.setattr(envs, "make_env", altered)
    from m3p2i_aip_tpu_torch.tamp import reactive_tamp

    monkeypatch.setattr(reactive_tamp, "make_env", altered)


def _half_the_batch(monkeypatch):
    from m3p2i_aip_tpu_torch.tamp.reactive_tamp import ReactiveTAMP

    impl = ReactiveTAMP._run_chunk_impl

    def half(self, mppi_state, real_state, task, i0, length, gate=True, done0=None):
        ms, rs, views, n, done = impl(self, mppi_state, real_state, task, i0, length, gate, done0)
        if views.dim() == 3:  # a batch: the later half of its seeds never stepped
            views = views.clone()
            views[views.shape[0] // 2:] = 0.0
        return ms, rs, views, n, done

    monkeypatch.setattr(ReactiveTAMP, "_run_chunk_impl", half)


FAULTS = [(c, f) for c in CELLS for f in ("step_unchanged", "half_the_samples", "answer_altered")] + [
    ("point-pushpull-batch20", "half_the_batch")]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_a_broken_timed_path_is_not_correct(cell, fault, root, monkeypatch):
    line = _gaps_with(root, monkeypatch, cell, globals()[f"_{fault}"])
    assert not line["correct"], line["checked"]
    assert line["checked"]["view_gap"]["value"] > line["checked"]["view_gap"]["limit"]


@pytest.mark.parametrize("cell", ["point-pushpull-chunked", "panda-pick-chunked"])
def test_the_bf16_control_is_not_correct(cell, root, monkeypatch):
    """The reference in bfloat16 in the program's place, at the cell's
    limit: the check must fail it."""
    from benchmark import spec as spec_mod

    monkeypatch.setattr(spec_mod, "ROOT", root)
    spec = spec_mod.load()
    w = spec_mod.cell(spec, cell)
    cfg_file, traffic = spec_mod.config_file(spec, w), spec_mod.traffic(w)
    limit = json.loads((tiny.REPO / "benchmark" / "limits" / f"{cell}.json").read_text())["view_gap"]
    loop = spec_mod.loop(traffic["loop"])(cfg_file, traffic, 99, "cpu")
    loop.setup()
    loop.window(0.1)
    cks = check.sample(loop.checkpoints, 1, 99)
    ref, _ = check.reference_views(cfg_file, cks, "cpu")
    low, _ = check.reference_views(cfg_file, cks, "cpu", precision="bf16")
    assert max(check.view_gap(lw, r) for lw, r in zip(low, ref)) > limit


@pytest.mark.parametrize("device", ["cuda", "cpu"])
def test_no_result_from_the_benchmark_files_alone(tmp_path, device):
    """A directory with only ``BENCHMARK.json`` and ``benchmark/``: no
    program, no scene files, so no result (and without a card, none
    either)."""
    import shutil

    shutil.copy(tiny.REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(tiny.REPO / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", CELLS[0], "--seed", "1", "--seconds", "1",
                          "--device", device], cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and not out.stdout.strip()
