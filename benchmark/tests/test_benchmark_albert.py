"""The albert's plain reference (``reference/albert.py``) on the CPU at a
small size: the program's compiled tick against ``Scene.tick``, the frozen
rollout against the program's plain version, the tiny cell end to end with
its planted faults, K4's bounds, and the reference's imports."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from benchmark import check
from benchmark.reference import albert as ref_albert
from benchmark.tests import tiny
from benchmark.tests.test_benchmark_reference import _answer_altered, _half_the_samples
from benchmark.yardstick import albert as yard_albert

CELL = "albert-pushreach-chunked"
CFG = json.loads((tiny.REPO / "benchmark" / "configs" / "albert-pushreach.json").read_text())
LIMIT = json.loads((tiny.REPO / "benchmark" / "limits" / f"{CELL}.json").read_text())["view_gap"]


def _small(cfg_file: dict, K: int = 16, T: int = 4) -> dict:
    c = json.loads(json.dumps(cfg_file))
    c["overrides"] += [f"mppi.num_samples={K}", f"mppi.horizon={T}"]
    c["numbers"].update({"mppi.num_samples": K, "mppi.horizon": T})
    c["settle_steps"] = 3
    return c


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make(tmp_path_factory.mktemp("tiny"))


def test_the_compiled_tick_equals_the_reference_at_ticks_0_and_50():
    """One seeded 100-tick episode of the program's chunked loop (chunks of
    50, the tick over static buffers on the CPU), its view rows at ticks 0
    and 50 against the reference's from the same checkpoints.  Both run
    the same plain float32 code on one device, so the rows agree to the
    last bit; the cell's limit (set on the card, where K4 and the
    compiled tick's kernels order their sums otherwise) holds a fortiori."""
    from benchmark.loops.chunked import Chunked

    traffic = {"loop": "chunked", "chunk": 50, "episode_ticks": 100, "warm_seconds": 0, "check_ticks": [0, 50],
               "trace_ticks": 2, "checks_per_tick": 1}
    cfg_file = _small(CFG)
    loop = Chunked(cfg_file, traffic, 2147483801, "cpu")
    loop._build()
    loop.window(0.01)
    cks = loop.checkpoints
    assert [c["i"] for c in cks] == [0, 50] and cks[1]["task"]["task_id"].item() == 9  # push_reach
    views, _ = check.reference_views(cfg_file, cks, "cpu")
    gaps = [check.view_gap(c["view"], v) for c, v in zip(cks, views)]
    assert gaps == [0.0, 0.0] and max(gaps) <= LIMIT


@pytest.mark.parametrize("case", ["ee_reach", "ee_reach_rotated_base", "push_reach_contact", "reposition_keep_out",
                                  "navigation"])
def test_the_frozen_rollout_equals_the_programs_plain_version(case):
    """K4's frozen plain version against the program's
    ``albert_rollout_plain`` on ``PARITY_CASES``, bit for bit (K=16, T=12)."""
    from m3p2i_aip_tpu_torch.config.config_store import load_config
    from m3p2i_aip_tpu_torch.envs import make_env
    from m3p2i_aip_tpu_torch.ops import albert_rollout as port_rollout
    from m3p2i_aip_tpu_torch.planners.motion_planner.cost_functions import AlbertObjective as PortObjective
    from m3p2i_aip_tpu_torch.planners.motion_planner.mppi import make_task_params

    from benchmark.reference.plain.ops import albert_rollout as frozen
    from benchmark.reference.plain.planners.motion_planner.albert_objective import AlbertObjective
    from benchmark.reference.plain.planners.motion_planner.mppi import make_task_params as frozen_task_params

    name, start, task, goal = next(c for c in port_rollout.PARITY_CASES if c[0] == case)
    K, T = 16, 12
    env = make_env(load_config(CFG["port_config"], CFG["overrides"]), "cpu")
    state = port_rollout.parity_state(env.params, start)
    acts = torch.randn(K, T, 13, generator=torch.Generator().manual_seed(7))
    acts = acts * torch.tensor([0.1] * 2 + [2.0] * 7 + [0.5] * 2 + [12.0] * 2)  # the configuration's limits
    states_k = port_rollout.unpack_state(port_rollout.pack_state(state), K)
    port = port_rollout.make_albert_rollout(env.params, PortObjective(env.params), K, T)
    want = port(states_k, acts, make_task_params(task, list(goal), "none", device="cpu"))

    scene = ref_albert.make_scene(ref_albert.ref_tick.config_of(CFG), "cpu")
    mine = frozen.make_albert_rollout(scene.params, AlbertObjective(scene.params), K, T)
    assert torch.equal(mine.spec.params_buf, port.spec.params_buf)
    got = mine(frozen.unpack_state(frozen.pack_state(state), K), acts,
               frozen_task_params(task, list(goal), "none", device="cpu"))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), name


def test_the_tiny_cell_is_correct(root, monkeypatch):
    line = tiny.run(root, monkeypatch, "--workload", CELL, "--seed", "2147483801", "--seconds", "1")
    assert line["correct"] and line["failed"] == 0 and line["ticks_checked"] == 2
    assert line["checked"]["view_gap"]["value"] == 0.0  # the same plain code on the same device
    assert set(line["metrics"]) == {"setup_s", "tick_rate"}


def _step_unchanged(monkeypatch):
    from m3p2i_aip_tpu_torch.models import albert

    monkeypatch.setattr(albert, "step", lambda params, state, u: state)


@pytest.mark.parametrize("fault", [_answer_altered, _half_the_samples, _step_unchanged],
                         ids=["answer_altered", "half_the_samples", "step_unchanged"])
def test_a_planted_fault_is_not_correct(fault, root, monkeypatch):
    fault(monkeypatch)
    line = tiny.run(root, monkeypatch, "--workload", CELL, "--seed", "12345", "--seconds", "1")
    assert not line["correct"], line["checked"]
    assert line["checked"]["view_gap"]["value"] > line["checked"]["view_gap"]["limit"]


def test_k4_bounds_one_a_rollout_of_the_ladder():
    """A tick's four rollouts (the first and three refine rungs), each
    bound by the port's count: bytes-bound at the cell's K=128 x T=12."""
    scene = ref_albert.Scene(CFG, "cpu", count_live=True)
    ck = {"i": 0, "start": True, "seed_val": 5, "view": None,
          "task": {"task_id": torch.tensor(9, dtype=torch.int32), "goal": torch.tensor([3.0, 0.0, 0.6, 0, 0, 0, 0]),
                   "gripper": torch.tensor(0, dtype=torch.int32), "zup_gate": torch.tensor(0.0)}}
    scene.tick(ck)
    out = ref_albert.bounds(scene, 1)
    assert set(out) == {"rollout"} and len(out["rollout"]) == 1 + scene.cfg.mppi.refine_iters
    spec = scene.rollout_spec
    n_bytes = 4 * (16 + 5 + 30 + 128 * 12 * 13) + 128 * 12 * 3 * 4
    ops = yard_albert.albert_rollout_ops(spec, 128)
    assert ops == 128 * 12 * (2 * (87 + 26 + 2 * (2 + 55 + 90)) + 2 + 330 + 60)
    assert out["rollout"] == [pytest.approx(max(n_bytes / 3.35e12, ops / 67e12) * 1e3, rel=1e-12)] * 4
    assert ref_albert.bounds(scene, 20)["rollout"][0] == pytest.approx(20 * out["rollout"][0])


def test_the_bf16_and_tf32_controls_at_the_cells_limit(root, monkeypatch):
    """The reference in bfloat16 in the program's place fails the cell's
    limit; TF32 changes nothing on the CPU (it acts on the card's matrix
    products only)."""
    from benchmark import spec as spec_mod

    monkeypatch.setattr(spec_mod, "ROOT", root)
    spec = spec_mod.load()
    w = spec_mod.cell(spec, CELL)
    cfg_file, traffic = spec_mod.config_file(spec, w), spec_mod.traffic(w)
    loop = spec_mod.loop(traffic["loop"])(cfg_file, traffic, 99, "cpu")
    loop.setup()
    loop.window(0.1)
    cks = check.sample(loop.checkpoints, 1, 99)
    ref, _ = check.reference_views(cfg_file, cks, "cpu")
    low, _ = check.reference_views(cfg_file, cks, "cpu", precision="bf16")
    tf32, _ = check.reference_views(cfg_file, cks, "cpu", precision="tf32")
    assert max(check.view_gap(lw, r) for lw, r in zip(low, ref)) > LIMIT
    assert all(a.tobytes() == b.tobytes() for a, b in zip(tf32, ref))


def test_the_albert_reference_loads_neither_jax_nor_the_program():
    code = ("import sys; sys.path.insert(0, '.'); import benchmark.reference.albert, benchmark.yardstick.albert; "
            "print([m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'm3p2i_aip_tpu', 'm3p2i_aip_tpu_torch')])")
    out = subprocess.run([sys.executable, "-c", code], cwd=tiny.REPO, capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"
