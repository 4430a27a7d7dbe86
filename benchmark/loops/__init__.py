"""The benchmark's one traffic generator: a mix (``benchmark/traffic/<name>.json``)
names its ``loop``, and ``benchmark/loops/<loop>.py`` drives the program's
loop of that name over a measured window (found by name: ``spec.loop``).

Every loop runs closed-loop episodes of ``episode_ticks`` ticks, each
restarted from the settled configured scene with a planner seed drawn from
the run's seed, as the repository's evaluation varies only the planner
seed.  Both success gates are off, so every tick is a full replan and
real-env step.  ``chunk`` ticks go to the device per round trip where the
loop chunks.

While the window runs, a loop keeps checkpoints at the chunk starts the
mix's ``check_ticks`` name: the program's state there (references to the
carry the loop already holds, less the planner's Halton deltas and
friction scales, which the reference works out again from the seed; the
generator's state from the host), the task the host planner handed the
tick, and, once fetched, the view row the program wrote for that tick.  A
seed batch keeps its carry and task once a chunk, and each seed's rows are
taken from them after the window.  So the window does little work and
holds little device memory for its checkpoints beyond what the reference
reads.  The check (``benchmark/check.py``) samples them after the window.

A loop file defines ``LOOP``, a subclass of :class:`Loop` that implements
``_build``, ``_episode`` and ``_trace_run``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

# program modules are imported inside the loops, so that a checkout
# without the program fails at run time with a plain import error


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def task_fields(task) -> dict:
    """A TaskParams' fields, cloned (the program keeps its own)."""
    return {f.name: getattr(task, f.name).clone() for f in dataclasses.fields(task)}


def cloned(state):
    """A fresh copy of a dataclass of tensors (an episode's start)."""
    return dataclasses.replace(state, **{f.name: getattr(state, f.name).clone() for f in dataclasses.fields(state)})


def port_config(cfg_file: dict):
    """The program's configuration, composed by the program's own grammar,
    held to the numbers the configuration file states."""
    from m3p2i_aip_tpu_torch.config.config_store import load_config

    cfg = load_config(cfg_file["port_config"], list(cfg_file["overrides"]))
    for key, want in cfg_file["numbers"].items():
        got = cfg
        for part in key.split("."):
            got = getattr(got, part)
        if (np.asarray(got, dtype=object) != np.asarray(want, dtype=object)).any() if isinstance(want, list) \
                else got != want:
            raise ValueError(f"configuration {cfg_file['port_config']}: {key} is {got!r}, the file states {want!r}")
    return cfg


class Loop:
    """What every loop shares: the episode draws, the set-up, the window,
    the checkpoints."""

    def __init__(self, cfg_file: dict, traffic: dict, seed: int, device) -> None:
        self.cfg_file, self.traffic = cfg_file, traffic
        self.device = torch.device(device)
        self.rng = np.random.default_rng(seed)
        self.E = int(traffic["episode_ticks"])
        self.C = int(traffic.get("chunk", 1))
        self.check_ticks = set(int(t) for t in traffic["check_ticks"])
        if self.E % self.C or any(t % self.C or t >= self.E for t in self.check_ticks):
            raise ValueError("episode_ticks and every check tick must be whole chunks inside an episode")
        self.recording = False
        self.episode = 0  # episodes begun, set-up's included
        self.checkpoints: List[dict] = []
        self._pending: List[dict] = []  # checkpoints whose view row is still on the device
        self.tick_s: List[float] = []  # host seconds of each tick (pertick)
        self.chunk_s: List[float] = []  # device seconds of each chunk (chunked, batch)
        self.replay_s: Optional[float] = None  # device seconds in the window's graph replays (a timed window)
        self.ticks = 0  # ticks (a batch: batched ticks) completed in the window
        self.seeds_per_tick = 1

    # ---------------------------------------------------------- the draws
    def _draw(self, n: Optional[int] = None):
        """The planner seed of one episode, or ``n`` of them."""
        seeds = [int(s) for s in self.rng.integers(0, 2**31 - 1, size=1 if n is None else n)]
        return seeds[0] if n is None else seeds

    # ---------------------------------------------------------- the phases
    def setup(self) -> None:
        """Build the program, settle the scene and run one episode, which
        captures every program the window replays."""
        self._build()
        self._episode()
        sync(self.device)

    def warm(self) -> None:
        """Episodes for the mix's ``warm_seconds``, after set-up and not
        counted in it: a freshly captured tick runs up to ~12% slower on the
        card for its first seconds to tens of seconds, then settles
        (``PERF.md``, a fault of the program that the benchmark works
        around)."""
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < float(self.traffic.get("warm_seconds", 0)):
            self._episode()
        sync(self.device)

    def window(self, seconds: float, time_replays: bool = False) -> float:
        """Episodes until ``seconds`` have passed; returns the window's
        length to the last episode's end (the device's work included).
        ``time_replays`` records CUDA events around every graph replay, and
        ``replay_s`` is then their summed device seconds."""
        self.ticks, self.tick_s, self.chunk_s, self.checkpoints = 0, [], [], []
        self.recording = True
        with self._replays_timed(time_replays) as pairs:
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < seconds:
                self._episode(deadline=t0 + seconds)
            sync(self.device)
            elapsed = time.perf_counter() - t0
        self.recording = False
        self.replay_s = sum(a.elapsed_time(b) for a, b in pairs) / 1e3 if pairs else None
        return elapsed

    @contextlib.contextmanager
    def _replays_timed(self, on: bool):
        """Every ``TickProgram.step`` between two CUDA events while open."""
        pairs: list = []
        if not on or self.device.type != "cuda":
            yield pairs
            return
        from m3p2i_aip_tpu_torch.tamp.graph_tick import TickProgram

        step = TickProgram.step

        def timed(prog):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            step(prog)
            b.record()
            pairs.append((a, b))

        TickProgram.step = timed
        try:
            yield pairs
        finally:
            TickProgram.step = step

    def trace_run(self, n: int) -> None:
        """``n`` ticks in the window's form, for the profiler."""
        self._trace_run(n)
        sync(self.device)

    def graph_nodes(self) -> Optional[int]:
        """Nodes of the compiled tick this loop replays (None when it is not
        a CUDA graph)."""
        progs = [p for p in self.tamp.ticks.stats() if p["key"][0] in ("open", "gated", "panda")]
        return sum(p["nodes"] for p in progs) if progs else None

    def close(self) -> None:
        """Drop the program (its graphs and buffers); the checkpoints keep
        the little state they hold."""
        for name in ("loop", "batch", "tamp"):
            if hasattr(self, name):
                delattr(self, name)

    # ---------------------------------------------------------- checkpoints
    def _checkpoint(self, i: int, seed_val: int, task=None, **carry) -> dict:
        """A checkpoint at tick ``i`` of the current episode: the task the
        host planner handed the tick (the point family) and, inside an
        episode, the program's carry there (the planner state without its
        deltas and friction scales)."""
        ck = {"i": i, "start": i == 0, "episode": self.episode, "seed_val": seed_val, "view": None}
        if task is not None:
            ck["task"] = task_fields(task)
        if i:
            ck.update(carry)
            ck["mppi_state"] = dataclasses.replace(ck["mppi_state"], halton_delta=None, fric_scale_k=None)
        return ck

    def _fetch_pending(self) -> None:
        """The view rows of this episode's checkpoints, fetched once its
        work has ended."""
        for ck in self._pending:
            views, row = ck.pop("_views")
            ck["view"] = np.array(views[row].cpu(), dtype=np.float32)
            self.checkpoints.append(ck)
        self._pending = []
