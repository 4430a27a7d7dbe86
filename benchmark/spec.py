"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration, whose ``file``
lies under ``benchmark/configs``, and a traffic mix, read from
``benchmark/traffic/<traffic>.json``, whose ``loop`` is the class ``LOOP``
of ``benchmark/loops/<loop>.py``.  A metric's reader is
``benchmark/metrics/<name>.py`` with a function ``read(ctx)`` that returns
the metric's value or None (nothing to read).  A configuration file names
its plain reference, ``benchmark/reference/<reference>.py``, whose
``Scene`` recomputes a checked tick and whose ``bounds`` gives the
yardstick's bounds of that tick's kernel calls by kind.  The limits of a
cell's correctness numbers are ``benchmark/limits/<cell>.json``.  Adding a
configuration (of a new robot family too), a mix, a metric or a cell is
adding files and entries.
"""
from __future__ import annotations

import importlib.util
import json
import pathlib
from typing import Callable, List, Optional

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _root(root: Optional[pathlib.Path]) -> pathlib.Path:
    """``root``, or the checkout this module lies in (read at call time, so
    a test can point the harness at a copy)."""
    return ROOT if root is None else root


def load(root: Optional[pathlib.Path] = None) -> dict:
    with open(_root(root) / "BENCHMARK.json") as f:
        return json.load(f)


def _json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell(spec: dict, name: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload named {name!r} in BENCHMARK.json")


def config_file(spec: dict, cell_: dict, root: Optional[pathlib.Path] = None) -> dict:
    for c in spec["configs"]:
        if c["name"] == cell_["config"]:
            return _json(_root(root) / c["file"])
    raise KeyError(f"no configuration named {cell_['config']!r} in BENCHMARK.json")


def traffic(cell_: dict, root: Optional[pathlib.Path] = None) -> dict:
    return _json(_root(root) / "benchmark" / "traffic" / f"{cell_['traffic']}.json")


def limits(cell_: dict, root: Optional[pathlib.Path] = None) -> dict:
    return _json(_root(root) / "benchmark" / "limits" / f"{cell_['name']}.json")


def end_to_end(spec: dict, cell_: dict) -> List[dict]:
    """The end-to-end metrics this cell reports: those without
    ``workloads``, and those that list it."""
    return [m for m in spec["end_to_end"] if "workloads" not in m or cell_["name"] in m["workloads"]]


def per_layer(spec: dict, cell_: dict) -> List[dict]:
    """The per-layer metrics this cell reports: those that list it, and
    those without ``workloads`` whose end-to-end metric it reports."""
    mine = {m["name"] for m in end_to_end(spec, cell_)}
    return [m for m in spec["per_layer"]
            if (cell_["name"] in m["workloads"] if "workloads" in m else m["moves"] in mine)]


def _module(folder: str, name: str, root: Optional[pathlib.Path]):
    path = _root(root) / "benchmark" / folder / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(f"benchmark_{folder}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def reader(name: str, root: Optional[pathlib.Path] = None) -> Callable:
    """``read`` of ``benchmark/metrics/<name>.py``."""
    return _module("metrics", name, root).read


def reference(name: Optional[str], root: Optional[pathlib.Path] = None):
    """``benchmark/reference/<name>.py``: the plain reference a configuration
    file names (``Scene(cfg_file, device, precision, count_live)`` and
    ``bounds(scene, seeds_per_tick)``).  Raises LookupError with a plain
    message for a configuration that names none or a file that is not
    there."""
    if not name:
        raise LookupError("the configuration file names no reference (its key \"reference\")")
    path = _root(root) / "benchmark" / "reference" / f"{name}.py"
    if not path.is_file():
        raise LookupError(f"the configuration's reference {name!r} has no file {path}")
    return _module("reference", name, root)


def loop(name: str, root: Optional[pathlib.Path] = None) -> type:
    """``LOOP`` of ``benchmark/loops/<name>.py``: the loop a mix names."""
    return _module("loops", name, root).LOOP
