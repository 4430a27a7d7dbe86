"""The port's benchmark and evaluation programs against the JAX package's,
on the CPU at a tiny size (K=16, T=4, chunks of 2, a few ticks).

Each twin (``m3p2i_aip_tpu_torch/scripts/bench*.py``,
``analyze_utilization``, ``recompute_results``) runs with ``device=cpu``
from a temporary working directory and prints one JSON line with the JAX
script's keys (read from its source) and its metric name for the same
config, plus the device record; every file it writes by default lies under
``results_h100/``.  Each twin composes the JAX script's config, field by
field, and so does each row of the quality campaign.  Without a card and
without ``device=cpu`` every program exits non-zero.  The recompute twin
prints the JAX script's statistics for every committed log (``plot/``,
``results_h100/``), and ``analysis/roofline.py`` reproduces the bounds
recorded in PERF.md.
"""
import ast
import dataclasses
import importlib.util
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import chip_smoke
from m3p2i_aip_tpu.config.config_store import load_config as jax_load_config
from m3p2i_aip_tpu.config.config_store import load_config_from_argv as jax_load_config_from_argv
from m3p2i_aip_tpu_torch.analysis import roofline
from m3p2i_aip_tpu_torch.config.config_store import load_config
from m3p2i_aip_tpu_torch.ops import albert_rollout as ar
from m3p2i_aip_tpu_torch.ops import panda_rollout as pr
from m3p2i_aip_tpu_torch.planners.motion_planner.mppi import make_task_params
from m3p2i_aip_tpu_torch.scripts import (
    analyze_utilization,
    bench,
    bench_albert,
    bench_batch_eval,
    bench_family,
    bench_northstar,
    bench_panda,
    bench_sharded,
    recompute_results,
    run_experiments,
    run_quality_campaign,
)
from m3p2i_aip_tpu_torch.tamp.reactive_tamp import ReactiveTAMP
from m3p2i_aip_tpu_torch.utils.tree import tree_map

REPO = pathlib.Path(__file__).resolve().parents[1]
TINY = ["mppi.num_samples=16", "mppi.horizon=4"]
MAIN_PATH = ["task=push_pull", "multi_modal=True", "goal=[-3.75,-3.75]"]
HEIJN = ["-cn", "config_heijn", *MAIN_PATH]
# the JAX keys a twin names otherwise: use_pallas is the CUDA kernel here
RENAMED = {"use_pallas": "kernel"}


def _jax_keys(script: str, var) -> set:
    """The keys of the JSON object the JAX script prints: the dict literal
    assigned to ``var`` in its ``main`` and every ``var["key"] = ...`` there
    (``var`` None: the dict literal passed to ``json.dumps``)."""
    tree = ast.parse((REPO / script).read_text())
    main = next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef) and n.name == "main")
    keys = set()
    for node in ast.walk(main):
        if var is None and isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "dumps":
            if isinstance(node.args[0], ast.Dict):
                keys |= {k.value for k in node.args[0].keys}
        if not isinstance(node, ast.Assign):
            continue
        for t in node.targets:
            if isinstance(t, ast.Name) and t.id == var and isinstance(node.value, ast.Dict):
                keys |= {k.value for k in node.value.keys}
            if isinstance(t, ast.Subscript) and getattr(t.value, "id", None) == var and isinstance(t.slice, ast.Constant):
                keys.add(t.slice.value)
    return {RENAMED.get(k, k) for k in keys}


# twin: (its argv at the tiny size, the JAX script, the printed dict's name
# there, the metric name the JAX script gives the same config, the files the
# twin writes by default)
TWINS = {
    "bench": (bench, [*TINY], "bench.py", "line", "m3p2i_replan_rate_point_K16_T4_multimodal",
              ["bench/BENCH.json"]),
    "bench_panda": (bench_panda, [*TINY], "scripts/bench_panda.py", "rec",
                    "m3p2i_replan_rate_panda_K16_T4_multimodal", ["bench/PANDA_BENCH.json"]),
    "bench_albert": (bench_albert, [*TINY], "scripts/bench_albert.py", "rec",
                     "m3p2i_replan_rate_albert_K16_T4_push_reach", ["bench/ALBERT_BENCH.json"]),
    "bench_family": (bench_family, [*HEIJN, *TINY], "scripts/bench_family.py", "rec",
                     "m3p2i_replan_rate_heijn_K16_T4_push_pull", ["bench/FAMILY_BENCH_heijn.json"]),
    "bench_batch_eval": (bench_batch_eval, ["n_runs=2", "n_steps=4", *TINY], "scripts/bench_batch_eval.py", "rec",
                         "batch_eval_speedup_point", ["bench/BATCH_EVAL_BENCH.json"]),
    "bench_northstar": (bench_northstar, ["16", "4", "2"], "scripts/bench_northstar.py", None,
                        "m3p2i_replan_rate_point_K16_T4_multimodal", ["bench/NORTHSTAR_BENCH.json"]),
    "bench_sharded": (bench_sharded, ["--virtual", "--sweep", "16", "--ticks", "1"], "scripts/bench_sharded.py", "out",
                      None, ["bench/PARALLEL_BENCH.json"]),
    "analyze_utilization": (analyze_utilization, [], "scripts/analyze_utilization.py", "out", None,
                            ["UTILIZATION.json"]),
}


def _device_arg(name: str) -> list:
    return ["--device", "cpu"] if name == "bench_sharded" else ["device=cpu"]


def _last_json(out: str) -> dict:
    return json.loads([line for line in out.splitlines() if line.startswith("{")][-1])


@pytest.fixture
def tiny_protocol(monkeypatch, tmp_path):
    """Chunks of 2 ticks, 4 timed ticks, the utilization's one K=16 x T=4
    workload in chunks of 2, run from an empty working directory."""
    monkeypatch.setenv("M3P2I_BENCH_CHUNK", "2")
    monkeypatch.setenv("M3P2I_BENCH_TICKS", "4")  # the panda, albert and family scripts' knob
    monkeypatch.setattr(bench, "TICKS", 4)
    monkeypatch.setattr(bench_northstar, "TICKS", 4)
    monkeypatch.setattr(analyze_utilization, "SHAPES", ((16, 4),))
    monkeypatch.setattr(analyze_utilization, "CHUNK_TICKS", 2)
    monkeypatch.chdir(tmp_path)
    return tmp_path


@pytest.mark.parametrize("name", list(TWINS))
def test_twin_prints_the_jax_line_and_writes_under_results(name, tiny_protocol, capsys):
    module, argv, script, var, metric, written = TWINS[name]
    if name == "bench":  # the port's own panda and albert artifacts, embedded with their age
        for family in ("PANDA", "ALBERT"):
            path = tiny_protocol / "results_h100" / "bench" / f"{family}_BENCH.json"
            path.parent.mkdir(parents=True, exist_ok=True)
            path.write_text(json.dumps({"value": 12.5, "vs_baseline": 0.59}) + "\n")
    module.main([*argv, *_device_arg(name)])
    line = _last_json(capsys.readouterr().out)
    assert _jax_keys(script, var) <= set(line), _jax_keys(script, var) - set(line)
    assert line["device"] == {"platform": "cpu", "kind": "cpu", "count": 1, "power_limit": None}
    if metric is not None:
        assert line["metric"] == metric
    if "kernel" in line:
        assert line["kernel"] is False  # no CUDA kernel runs on the CPU
    files = sorted(p.relative_to(tiny_protocol).as_posix() for p in tiny_protocol.rglob("*") if p.is_file())
    assert all(f.startswith("results_h100/") for f in files), files
    assert {f"results_h100/{w}" for w in written} <= set(files), files
    if name == "bench":
        assert line["panda_hz"] == 12.5 and line["albert_hz"] == 12.5 and line["panda_age_h"] >= 0
    if name == "analyze_utilization":
        (row,) = line["rows"]
        assert row["rollout_flops"] > 0 and "kernel_ms" not in row  # no kernel time off the card


@pytest.mark.parametrize("eager", [False, True], ids=["compiled", "eager"])
def test_sharded_twin_says_which_command_it_times(eager, tiny_protocol, capsys):
    """``bench_sharded`` times ``MPPI.command``'s compiled program (on the
    CPU its static-buffer body) or, with ``--eager``, the eager call; every
    line says which, and the 8-shard first command equals the unsharded
    one either way."""
    bench_sharded.main(["--virtual", "--sweep", "16,32", "--ticks", "1", "--device", "cpu", "--out", "-",
                        *(["--eager"] if eager else [])])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    want = "eager" if eager else "static"
    assert [line["tick"] for line in lines] == [want] * 3
    assert all(row["action_maxdiff"] == 0.0 for row in lines[-1]["sweep"])
    assert not (tiny_protocol / "results_h100").exists()


def test_bench_embeds_no_tpu_artifact(tiny_protocol, capsys):
    """Without the port's own artifacts the headline line embeds nothing,
    whatever JSONs lie at the working directory's root."""
    (tiny_protocol / "PANDA_BENCH.json").write_text(json.dumps({"value": 2888.0}))
    bench.main([*TINY, "device=cpu", "out=-"])
    line = _last_json(capsys.readouterr().out)
    assert not any(k.startswith(("panda_", "albert_")) for k in line)
    assert not (tiny_protocol / "results_h100").exists()


# twin: (its composed config, the JAX script's loader and arguments)
CONFIGS = {
    "bench": (lambda: bench.config(), ("config_point", MAIN_PATH)),  # bench.py:33-36
    "bench_panda": (lambda: bench_panda.config(), ("config_panda", ["multi_modal=True"])),  # :33, :52
    "bench_albert": (lambda: bench_albert.config(), ("config_albert", ["task=push_reach", "goal=[3.0,0.0,0.6]"])),
    "bench_family": (lambda: bench_family.config(HEIJN), HEIJN),
    "bench_batch_eval point": (lambda: bench_batch_eval.config("point"), ("config_point", ["task=push", "goal=[-1,-1]"])),
    "bench_batch_eval panda": (lambda: bench_batch_eval.config("panda"), ("config_panda", [])),
    "bench_northstar": (lambda: bench_northstar.config(), ("config_point", [*MAIN_PATH, "mppi.num_samples=500",
                                                                             "mppi.horizon=30"])),
    "bench_sharded": (lambda: bench_sharded.config(16384), ("config_point", [
        *MAIN_PATH, "mppi.num_samples=16384", "mppi.horizon=12", "mppi.u_per_command=12"])),
    "analyze_utilization reference": (lambda: analyze_utilization.config(200, 15), ("config_point", [
        *MAIN_PATH, "mppi.num_samples=200", "mppi.horizon=15", "mppi.u_per_command=15"])),
    "analyze_utilization north-star": (lambda: analyze_utilization.config(500, 30), ("config_point", [
        *MAIN_PATH, "mppi.num_samples=500", "mppi.horizon=30", "mppi.u_per_command=30"])),
}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_twin_composes_the_jax_config(name):
    make, ref = CONFIGS[name]
    jax_cfg = jax_load_config(*ref) if isinstance(ref, tuple) else jax_load_config_from_argv(ref)
    assert dataclasses.asdict(make()) == dataclasses.asdict(jax_cfg)


_RUN_OPTS = ("n_runs", "out", "chunked", "reactive_perturb", "seed_offset", "parallel_seeds", "device")


@pytest.mark.parametrize("row", list(run_quality_campaign.ROWS))
def test_campaign_row_composes_the_jax_config_and_writes_under_results(row):
    """Each row's config as the JAX runner composes its arguments, and its
    log under results_h100/<family>/."""
    cmd = run_quality_campaign.command(row)
    opts, cfg = run_experiments._parse(cmd)
    jax_argv = [a for a in cmd if a.split("=", 1)[0] not in _RUN_OPTS]
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jax_load_config_from_argv(jax_argv))
    family = {"panda_env": "panda", "albert_env": "albert"}.get(cfg.env_type, "point")
    assert opts["out"] == f"results_h100/{family}/{row}.npy" and opts["n_runs"] == 20


def test_campaign_runs_one_row_under_results(monkeypatch, tmp_path, capsys):
    monkeypatch.chdir(tmp_path)
    run_quality_campaign.main(["--only", "case2_push", "device=cpu", "n_runs=2", "n_steps=2",
                               "mppi.num_samples=8", "mppi.horizon=4"])
    files = [p.relative_to(tmp_path).as_posix() for p in tmp_path.rglob("*") if p.is_file()]
    assert files == ["results_h100/point/case2_push.npy"]
    assert np.load(tmp_path / files[0]).shape == (2, 19)
    assert "=== case2_push:" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        run_quality_campaign.main(["--only", "no_such_row"])


def test_run_experiments_default_log_is_under_results(monkeypatch, tmp_path):
    """Without out= the log goes to results_h100/<family>/<task>[_mm].npy,
    never to plot/, where the JAX package's logs are."""
    monkeypatch.chdir(tmp_path)
    run_experiments.main(["task=push", "goal=[-1,-1]", "n_runs=1", "n_steps=2", "chunked=2", "mppi.num_samples=8",
                          "mppi.horizon=4", "device=cpu"])
    files = [p.relative_to(tmp_path).as_posix() for p in tmp_path.rglob("*") if p.is_file()]
    assert files == ["results_h100/point/push.npy"]


NO_CARD = {
    "bench": lambda: bench.main([*TINY]),
    "bench_panda": lambda: bench_panda.main([*TINY]),
    "bench_albert": lambda: bench_albert.main([*TINY]),
    "bench_family": lambda: bench_family.main([*HEIJN, *TINY]),
    "bench_batch_eval": lambda: bench_batch_eval.main(["n_runs=1"]),
    "bench_northstar": lambda: bench_northstar.main(["16", "4", "2"]),
    "bench_sharded": lambda: bench_sharded.main(["--virtual", "--sweep", "16"]),
    "analyze_utilization": lambda: analyze_utilization.main([]),
    "run_quality_campaign": lambda: run_quality_campaign.main(["--only", "case2_push", "n_runs=1"]),
}


@pytest.mark.parametrize("name", list(NO_CARD))
def test_without_a_card_and_device_cpu_the_twin_exits_non_zero(name, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit) as exc:
        NO_CARD[name]()
    assert exc.value.code not in (0, None)
    assert not any(tmp_path.iterdir())


def _jax_recompute():
    spec = importlib.util.spec_from_file_location("jax_recompute_results", REPO / "scripts" / "recompute_results.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# the JAX package's logs, the port's and the JAX package's CPU runs of the
# rows it disagrees with (results_h100/jax_cpu/)
LOGS = sorted(p.relative_to(REPO).as_posix() for d in ("plot", "results_h100") for p in (REPO / d).rglob("*.npy"))


@pytest.mark.parametrize("log", LOGS)
def test_recompute_prints_the_jax_statistics(log, capsys, monkeypatch):
    monkeypatch.chdir(REPO)
    _jax_recompute().recompute(log)
    want = capsys.readouterr().out
    stats = recompute_results.recompute(log)
    got = capsys.readouterr().out.splitlines()
    assert "\n".join(got[:-1]) + "\n" == want
    line = json.loads(got[-1])
    assert line["path"] == log and line["stats"] == {k: [m, s] for k, (m, s) in stats.items()}


@pytest.mark.parametrize("marks, fails", [(3, False), (2, True)], ids=["every-chunk", "a-mark-lost"])
def test_rate_record_refuses_a_run_with_a_chunk_untimed(marks, fails):
    """Four ticks in chunks of 2 make two periods; a clock short of a mark
    (a hook that no longer fires) raises instead of reporting fewer chunks."""
    from m3p2i_aip_tpu_torch.analysis import bench_record as br

    clock = br.ChunkClock(torch.device("cpu"))
    for _ in range(marks):
        clock.mark()
    if fails:
        with pytest.raises(RuntimeError):
            br.rate_record(4, 1.0, 2, clock)
    else:
        assert br.rate_record(4, 1.0, 2, clock)["chunks"] == 2


@pytest.mark.parametrize("kept", [(4, 4), (1, 4), (4, 1), (0, 0)], ids=["pads-whole", "head-lost", "tail-lost",
                                                                         "pads-lost"])
def test_profile_summary_leaves_the_pads_out(kept):
    """Two ticks of a K1 and a K2 event each between two pads of 4 empty
    kernels, of which the trace kept ``kept`` (the head pad's last events,
    the tail pad's first): the run's figures, launches and span are the same
    whatever the pads kept, and the pads are counted apart, with their gaps
    to the run."""
    from types import SimpleNamespace

    from m3p2i_aip_tpu_torch.analysis import bench_record as br

    def event(name, start_us, end_us):
        span = SimpleNamespace(start=start_us, end=end_us, elapsed_us=lambda: end_us - start_us)
        return SimpleNamespace(name=name, time_range=span)

    spin = f"at::cuda::{br.PAD_SYMBOL}(long)"
    run = [event(f"void {sym}<3>(Params)", t, t + 100) for t0 in (1000, 2000)
           for sym, t in (("point_rollout_kernel", t0), ("multimodal_weights_kernel", t0 + 500))]
    head = [event(spin, 900 - 10 * i, 905 - 10 * i) for i in range(kept[0])]
    tail = [event(spin, 2700 + 10 * i, 2705 + 10 * i) for i in range(kept[1])]
    got = br.summarize(head + run + tail, 2, 0.004, {"K1": "point_rollout"}, pad=4)
    assert got["traced_launches"]["point_rollout_kernel"] == 2
    assert got["traced_launches"]["multimodal_weights_kernel"] == 2
    assert got["kernels_per_tick"] == 2 and got["device_ms_per_tick"] == 0.2 and got["kernel_ms_per_tick"]["K1"] == 0.1
    assert got["kernel_starts_ms"]["point_rollout_kernel"] == [0.0, 1.0] and got["device_span_ms"] == 1.6
    assert got["pad"] == 4 and got["pad_traced"] == list(kept)
    assert got["pad_gaps_ms"] == [0.095 if kept[0] else None, 0.1 if kept[1] else None]
    assert br.summarize(head + tail, 2, 0.004, {}, pad=4) is None


def test_recompute_refuses_an_unknown_schema(tmp_path):
    np.save(tmp_path / "x.npy", np.zeros((2, 7)))
    with pytest.raises(SystemExit):
        recompute_results.recompute(str(tmp_path / "x.npy"))


def _panda_inputs(K: int, T: int):
    tamp = ReactiveTAMP(load_config("config_panda", ["multi_modal=True"]), device="cpu")
    name, start, task_name, grip, zup = pr.PARITY_CASES[0]
    goal = pr.PARITY_GOAL if task_name == "pick" else [0.0] * 7
    sk = tree_map(lambda x: x.expand((K,) + x.shape), pr.parity_state(tamp.env.init_state(), start))
    return tamp.motion_planner.rollout.spec, pr.rollout_inputs(sk, make_task_params(task_name, goal, "none", zup,
                                                                                  device="cpu"))


def _albert_inputs(K: int, T: int):
    tamp = ReactiveTAMP(load_config("config_albert"), device="cpu")
    name, start, task_name, goal = ar.PARITY_CASES[0]
    sk = tree_map(lambda x: x.expand((K,) + x.shape), ar.parity_state(tamp.env.params, start))
    return tamp.motion_planner.rollout.spec, ar.rollout_inputs(sk, make_task_params(task_name, goal, device="cpu"))


def _bound(kernel: str) -> dict:
    """The smoke's bound of ``kernel`` at its recorded shapes: K2 (K2b at
    B=20) on uniform(0, 50) costs at K=200 x T=15, K3 (K3b) at K=200 x T=12,
    K4 (K4b) at K=128 x T=12."""
    B = 20 if kernel.endswith("b") else None
    if kernel.startswith("K2"):
        mp = ReactiveTAMP(load_config("config_point", MAIN_PATH), device="cpu").motion_planner
        shape = (mp.K, mp.T) if B is None else (B, mp.K, mp.T)
        cost = torch.as_tensor(np.random.default_rng(0).uniform(0, 50, size=shape).astype(np.float32))
        return roofline.weights_bound((cost, mp.gamma_seq, mp.half_K, mp.eta_u, mp.eta_l))
    K, T, nu, inputs_of, ops = ((200, 12, 9, _panda_inputs, roofline.panda_rollout_ops) if kernel.startswith("K3")
                                else (128, 12, 13, _albert_inputs, roofline.albert_rollout_ops))
    spec, row = inputs_of(K, T)
    if B is None:
        return roofline.rollout_bound(spec, row + (torch.zeros(K, T, nu),), K, ops(spec, K))
    inputs = chip_smoke._stack_rows([row] * B, torch.zeros(B, K, T, nu))
    return roofline.rollout_bound(spec, inputs, B * K, ops(spec, B * K))


# PERF.md section 6's bound column, ms (the smoke's chip runs of PRs 1-12)
RECORDED_BOUNDS = {"K2": (0.0000043, "bytes"), "K3": (0.0001674, "operations"), "K4": (0.0000294, "bytes"),
                   "K2b": (0.0000860, "bytes"), "K3b": (0.0033471, "operations"), "K4b": (0.0005877, "bytes")}


@pytest.mark.parametrize("kernel", list(RECORDED_BOUNDS))
def test_roofline_reproduces_the_recorded_bounds(kernel):
    got = _bound(kernel)
    assert (round(got["bound_ms"], 7), got["bound_by"]) == RECORDED_BOUNDS[kernel]


def test_chip_smoke_imports_with_jax_blocked():
    """``chip_smoke.py`` and the twins it calls import nothing of JAX or of
    the JAX package."""
    probe = (
        "import sys; sys.modules['jax'] = None; import chip_smoke; "
        "from m3p2i_aip_tpu_torch.scripts import analyze_utilization, bench, bench_albert, bench_family, "
        "bench_northstar, bench_panda, bench_sharded; "
        "assert not [m for m in sys.modules if m.split('.')[0] == 'm3p2i_aip_tpu']"
    )
    proc = subprocess.run([sys.executable, "-c", probe], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
