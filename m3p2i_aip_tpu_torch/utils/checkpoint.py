"""Checkpoint / resume of a control loop: planner, real env and host planner.

Port of ``m3p2i_aip_tpu/utils/checkpoint.py`` with the same name-keyed
``.npz``: ``mppi/<field>`` for the planner state, ``sim/<field>`` for the
real env state and ``host_json`` for the symbolic planner's task, goal and
latches.  A checkpoint of the JAX package loads here: a key the port has no
field for (``mppi/rng``) is ignored, and a field the saved state lacks (a
``None`` leaf of the JAX package, such as ``fric_scale_k``) keeps its fresh
value.

The port adds keys of its own, so a resumed run equals an uninterrupted one
bit for bit: ``torch/generator``, the state of the planner's exploration
``torch.Generator``, and ``torch/host_json``, every attribute of the host
task planner (its stall detectors, pocket-endgame latches and active-
inference beliefs) and the gripper command.

With compiled ticks (``tamp/graph_tick.py``) the loop's ``state`` and
``tamp.mppi_state`` are the host's copies of the graphs' carry, copied out
after every chunk or tick: a checkpoint reads them, and a loaded state is
copied into the graphs' buffers at the next tick, so a resumed compiled run
replays bit for bit as an uninterrupted one.  The generator's state is set
in place, so a generator registered with a captured graph stays registered.
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch


def _field_arrays(tree) -> dict:
    return {f.name: getattr(tree, f.name).detach().cpu().numpy() for f in dataclasses.fields(tree)}


def _saved(data, key: str):
    """The saved array under ``key``, or None where there is none: an object
    array (a ``None`` leaf of the saving package) needs pickle and is not
    loaded."""
    if key not in data.files:
        return None
    try:
        return data[key]
    except ValueError:
        return None


def _restore_fields(tree, data, prefix: str, device):
    updates = {}
    for f in dataclasses.fields(tree):
        arr, fresh = _saved(data, prefix + f.name), getattr(tree, f.name)
        if arr is None:
            continue
        if arr.shape != tuple(fresh.shape):
            raise ValueError(f"checkpoint {prefix}{f.name}: shape {arr.shape}, the loop's {tuple(fresh.shape)}")
        updates[f.name] = torch.as_tensor(arr, dtype=fresh.dtype, device=device)
    return dataclasses.replace(tree, **updates)


def _encode(x):
    """A host object as JSON-able data, exactly: arrays keep their dtype and
    shape, floats their bits (JSON writes a float's shortest exact form)."""
    if isinstance(x, (np.ndarray, np.generic)):
        return {"__array__": np.asarray(x).tolist(), "dtype": str(x.dtype), "scalar": isinstance(x, np.generic)}
    if x is None or isinstance(x, (bool, int, float, str)):
        return x
    if isinstance(x, list):
        return [_encode(v) for v in x]
    if hasattr(x, "__dict__"):
        return {"__object__": {k: _encode(v) for k, v in vars(x).items()}}
    raise TypeError(f"cannot checkpoint a {type(x).__name__}")


def _decode(blob, into=None):
    """Data from :func:`_encode`; an object is restored into ``into``, the
    fresh loop's object of the same place, attribute by attribute."""
    if isinstance(blob, list):
        into = into if isinstance(into, list) and len(into) == len(blob) else [None] * len(blob)
        return [_decode(v, old) for v, old in zip(blob, into)]
    if not isinstance(blob, dict):
        return blob
    if "__array__" in blob:
        arr = np.asarray(blob["__array__"], dtype=blob["dtype"])
        return arr[()] if blob["scalar"] else arr
    if into is None:
        raise ValueError("checkpoint: an object of the saved planner has no counterpart in this loop")
    for k, v in blob["__object__"].items():
        setattr(into, k, _decode(v, getattr(into, k, None)))
    return into


def save_checkpoint(path: str, tamp, sim_state) -> str:
    """Save a ReactiveTAMP's planner and host state and a real env state to
    ``path`` (``.npz`` is appended when missing); returns the file's path."""
    blobs = {f"mppi/{k}": v for k, v in _field_arrays(tamp.mppi_state).items()}
    blobs.update({f"sim/{k}": v for k, v in _field_arrays(sim_state).items()})
    tp = tamp.task_planner
    host = {
        "task": tp.task,
        "curr_goal": np.asarray(tp.curr_goal).tolist(),
        "pick_always": bool(getattr(tp, "pick_always", False)),
        "place_always": bool(getattr(tp, "place_always", False)),
        "suction_active": int(tamp.suction_active),
    }
    own = {"task_planner": _encode(tp), "gripper_command": tamp.motion_planner.gripper_command}
    blobs["host_json"] = np.frombuffer(json.dumps(host).encode(), dtype=np.uint8)
    blobs["torch/host_json"] = np.frombuffer(json.dumps(own).encode(), dtype=np.uint8)
    blobs["torch/generator"] = tamp.motion_planner.generator.get_state().numpy()
    if not str(path).endswith(".npz"):
        path = f"{path}.npz"
    np.savez(path, **blobs)
    return path


def load_checkpoint(path: str, tamp, sim_state, device="cuda"):
    """Restore a checkpoint of :func:`save_checkpoint` (or of the JAX
    package's) onto ``device``, which must be the loop's.  The tamp's
    planner state, host planner and generator are restored in place; returns
    the restored real env state."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("load_checkpoint: CUDA is not available; pass device='cpu' to load onto the CPU")
    if device.type != tamp.device.type:
        raise ValueError(f"load_checkpoint: device {device} but the loop runs on {tamp.device}")
    data = np.load(path)
    tamp.mppi_state = _restore_fields(tamp.mppi_state, data, "mppi/", device)
    new_sim = _restore_fields(sim_state, data, "sim/", device)
    host = json.loads(bytes(data["host_json"]).decode())
    tp = tamp.task_planner
    tp.task = host["task"]
    tp.curr_goal = np.asarray(host["curr_goal"], dtype=np.float32)
    if hasattr(tp, "pick_always"):
        tp.pick_always, tp.place_always = host["pick_always"], host["place_always"]
    tamp.suction_active = host["suction_active"]
    if "torch/host_json" in data.files:
        own = json.loads(bytes(data["torch/host_json"]).decode())
        _decode(own["task_planner"], tp)
        tamp.motion_planner.gripper_command = own["gripper_command"]
    if "torch/generator" in data.files:
        tamp.motion_planner.generator.set_state(torch.from_numpy(data["torch/generator"]))
    return new_sim
