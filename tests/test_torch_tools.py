"""The rest of M10 in the port against the JAX package, on the CPU: the URDF
emitters (``assets/urdf_gen.py``), the live dashboard, ``stats.box_plot``,
``path_utils.get_plot_path``, ``skill_utils.apply_fk`` / ``apply_ik``, the
three examples (``python -m m3p2i_aip_tpu_torch.examples.<name>``) and the
two plot scripts (``python -m m3p2i_aip_tpu_torch.scripts.plot_point`` /
``plot_panda``).

Nothing here writes under ``m3p2i_aip_tpu/`` or ``plot/``: ``ensure_assets``
and the plots write under ``tmp_path``.  Bars: the emitters, the host-only
examples and the statistics exactly; ``apply_fk`` within 1e-6 (float32
divisions in another association order); the scripted teleop's printed
positions (2 decimals) exactly.
"""
import importlib.util
import json
import pathlib
import sys
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from m3p2i_aip_tpu.analysis import stats as jstats
from m3p2i_aip_tpu.assets import urdf_gen as jgen
from m3p2i_aip_tpu.utils import path_utils as jpath
from m3p2i_aip_tpu.utils import skill_utils as jskill
from m3p2i_aip_tpu_torch.analysis import stats
from m3p2i_aip_tpu_torch.analysis.dashboard import Dashboard, start_dash_server
from m3p2i_aip_tpu_torch.assets import urdf_gen
from m3p2i_aip_tpu_torch.examples import example_aip_panda, example_aip_parallel, example_key
from m3p2i_aip_tpu_torch.scripts import plot_panda, plot_point
from m3p2i_aip_tpu_torch.utils import path_utils, skill_utils

REPO = pathlib.Path(__file__).resolve().parents[1]
EMITTERS = ("emit_franka_urdf", "emit_point_urdf", "emit_heijn_urdf", "emit_boxer_urdf", "emit_husky_urdf",
            "emit_albert_urdf")


def _jax_example(name: str):
    """The repository's ``examples/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(f"jax_{name}", REPO / "examples" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("name", EMITTERS)
def test_urdf_emitters_equal_jax_package(name):
    """Each emitter's text is the JAX emitter's, byte for byte."""
    assert getattr(urdf_gen, name)() == getattr(jgen, name)()


def test_ensure_assets_writes_only_under_its_root(tmp_path):
    """The six URDFs under the given root, equal to the vendored files; a
    second call rewrites nothing."""
    root = urdf_gen.ensure_assets(tmp_path / "urdf")
    written = sorted(p.relative_to(root).as_posix() for p in root.rglob("*.urdf"))
    assert written == sorted(urdf_gen._EMITTERS)
    mtimes = {p: p.stat().st_mtime_ns for p in root.rglob("*.urdf")}
    for rel in written:
        assert (root / rel).read_text() == (path_utils.get_assets_path() / "urdf" / rel).read_text()
    urdf_gen.ensure_assets(root)
    assert {p: p.stat().st_mtime_ns for p in root.rglob("*.urdf")} == mtimes
    with pytest.raises(TypeError):
        urdf_gen.ensure_assets()  # no default: the JAX package's tree is never the target


def test_dashboard_serves_metrics(tmp_path):
    """tests/test_aux.py:15-29 on the port, and the battery CSV of the
    reference's dash server."""
    dash = Dashboard(port=0).start()
    port = dash._server.server_address[1]
    dash.publish(planner_hz=123.4, task="push")
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics") as r:
        data = json.loads(r.read())
    assert data["planner_hz"] == 123.4 and data["battery"] == 100.0
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/") as r:
        page = r.read().decode()
    assert "Battery Level" in page and "push" in page
    dash.stop()
    csv = tmp_path / "data_battery.csv"
    dash = start_dash_server(port=0, battery_csv=str(csv))
    csv.write_text("42.5\n")
    with urllib.request.urlopen(f"http://127.0.0.1:{dash._server.server_address[1]}/metrics") as r:
        assert json.loads(r.read())["battery"] == 42.5
    dash.stop()


def test_box_plot_writes_a_png_or_returns_none(tmp_path, monkeypatch):
    """A PNG where matplotlib is installed, as the JAX package's; None where
    it is not."""
    groups = {"a": np.array([1.0, 2.0, 3.0]), "b": np.array([2.0, 2.5])}
    pytest.importorskip("matplotlib")
    got = stats.box_plot(groups, str(tmp_path / "port.png"))
    ref = jstats.box_plot(groups, str(tmp_path / "jax.png"))
    assert got == str(tmp_path / "port.png") and ref == str(tmp_path / "jax.png")
    assert (tmp_path / "port.png").read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    assert stats.box_plot(groups, str(tmp_path / "none.png")) is None
    assert not (tmp_path / "none.png").exists()


def test_get_plot_path_equals_jax_package():
    assert path_utils.get_plot_path() == jpath.get_plot_path() == REPO / "plot"


@pytest.mark.parametrize("robot, nu", [("boxer", 2), ("albert", 13), ("point", 2)])
def test_apply_fk_and_ik_match_jax_package(robot, nu):
    """The (v, omega) -> wheel-speed map on a batch of actions; the input is
    left as it was."""
    u = np.random.default_rng(nu).uniform(-1, 1, size=(5, nu)).astype(np.float32)
    ut = torch.as_tensor(u)
    for port_fn, jax_fn in ((skill_utils.apply_fk, jskill.apply_fk), (skill_utils.apply_ik, jskill.apply_ik)):
        got = port_fn(robot, ut)
        np.testing.assert_allclose(got.numpy(), np.asarray(jax_fn(robot, jnp.asarray(u))), atol=1e-6, rtol=0)
    assert np.array_equal(ut.numpy(), u)


def test_example_aip_panda_prints_the_jax_script_actions(capsys):
    _jax_example("example_aip_panda").main()
    ref = capsys.readouterr().out
    actions = example_aip_panda.main(["device=cpu"])
    assert capsys.readouterr().out == ref
    assert actions[:5] == ["reach"] * 5 and actions[-1] == "reach" and "idle_success" in actions


def test_example_aip_parallel_prints_the_jax_script_plans(capsys):
    _jax_example("example_aip_parallel").main()
    ref = capsys.readouterr().out
    rounds = example_aip_parallel.main(["device=cpu"])
    assert capsys.readouterr().out == ref
    assert len(rounds) == 4 and all(plans for _, plans in rounds)


def test_example_key_scripted_drive_matches_jax_script(capsys, monkeypatch):
    """The scripted teleop (95 steps, WASD velocities): the printed robot
    positions of every 15th step equal the JAX script's, and the ASCII view
    is printed with them."""
    monkeypatch.setattr(sys, "argv", ["example_key.py"])
    _jax_example("example_key").main()
    ref = [l for l in capsys.readouterr().out.splitlines() if l.startswith("step")]
    state = example_key.main(["device=cpu"])
    out = capsys.readouterr().out
    assert [l for l in out.splitlines() if l.startswith("step")] == ref
    assert len(ref) == len(example_key.SCRIPT[::15]) and out.count("\n") > 10 * len(ref)
    assert torch.isfinite(state.q).all()
    # off a terminal the live drive says so and returns
    assert example_key.main(["--interactive", "device=cpu"]) is None
    assert "not a terminal" in capsys.readouterr().out


@pytest.mark.parametrize(
    "script, env, logs", [(plot_point, "point", "point"), (plot_panda, "panda", "panda")], ids=["point", "panda"]
)
def test_plot_scripts_read_the_committed_logs(script, env, logs, tmp_path):
    """Each committed log's statistics equal the JAX package's
    ``summarize``; the box plots go to ``out=`` and nothing is written
    under ``plot/``."""
    before = sorted(p.name for p in (REPO / "plot" / logs).iterdir())
    results = script.main([f"out={tmp_path}"])
    assert sorted(p.name for p in (REPO / "plot" / logs).iterdir()) == before
    assert results and set(results) == {p[:-4] for p in before if p.endswith(".npy")}
    for name, got in results.items():
        ref = jstats.summarize(np.load(REPO / "plot" / logs / f"{name}.npy"), env)
        assert set(got) == set(ref)
        for k in ref:
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-6, atol=1e-7, err_msg=f"{name} {k}")
    pngs = sorted(p.name for p in tmp_path.iterdir())
    assert pngs == (["pos_error_box.png", "task_time_box.png"] if env == "point" else ["pos_error_box.png"])
