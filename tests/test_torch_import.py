"""The PyTorch port imports with jax unavailable.

``m3p2i_aip_tpu_torch`` must run on a host that has only torch: every one of
its modules imports in a fresh interpreter where ``import jax`` fails, and
none of them pulls in a module of the JAX package.
"""
import os
import subprocess
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, pkgutil, sys
sys.modules["jax"] = None      # any `import jax` now raises ImportError
sys.modules["flax"] = None
import m3p2i_aip_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
for name in (
    "models.albert", "ops.albert_rollout", "models.panda_env", "ops.panda_rollout", "ops.rollout",
    "tamp.batch_loop", "analysis.run_logger", "analysis.stats", "scripts.run_experiments",
    "utils.rpc", "utils.data_transfer", "utils.teleop", "utils.render", "utils.checkpoint", "utils.profiling",
    "scripts.run_tamp", "scripts.reactive_tamp", "scripts.sim",
    "utils.urdf", "assets.urdf_gen", "analysis.dashboard", "ops.norm", "scripts.trace_tick_paths",
    "scripts.plot_point", "scripts.plot_panda", "examples.example_key", "examples.example_aip_panda",
    "examples.example_aip_parallel", "parallel.mesh",
    "analysis.bench_record", "analysis.roofline", "scripts.bench", "scripts.bench_panda", "scripts.bench_albert",
    "scripts.bench_family", "scripts.bench_batch_eval", "scripts.bench_northstar", "scripts.bench_sharded",
    "scripts.analyze_utilization", "scripts.recompute_results", "scripts.run_quality_campaign",
    "tamp.graph_tick", "scripts.graph_ab",
):
    assert pkg.__name__ + "." + name in names, name
leaked = sorted(m for m in sys.modules if m == "m3p2i_aip_tpu" or m.startswith("m3p2i_aip_tpu."))
assert not leaked, leaked
print(len(names))
"""


def _probe() -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=_REPO, capture_output=True, text=True, timeout=120
    )


def test_port_imports_with_jax_blocked():
    proc = _probe()
    assert proc.returncode == 0, proc.stderr


def test_port_covers_the_mirrored_layout():
    """Every subpackage of the JAX layout that the port mirrors is present."""
    proc = _probe()
    assert proc.returncode == 0, proc.stderr
    for sub in (
        "config", "sim", "models", "ops", "planners/motion_planner", "planners/task_planner", "tamp", "utils",
        "analysis", "scripts", "assets", "examples", "parallel",
    ):
        assert os.path.isfile(os.path.join(_REPO, "m3p2i_aip_tpu_torch", sub, "__init__.py")), sub
    assert int(proc.stdout.strip()) >= 25
