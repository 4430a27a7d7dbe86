"""The compiled control tick: one CUDA graph a tick, replayed through every
chunk.

The port's counterpart of the JAX package's ``jax.jit`` of the fused tick
and of the chunk programs (``m3p2i_aip_tpu/tamp/reactive_tamp.py:193-195``;
the chunk is a ``lax.scan`` of the tick, :424, :448, :571; the seed batch a
``jax.jit(jax.vmap(...))``, ``tamp/batch_loop.py:94-104``).  A tick of the
port is ~4,700 small device kernels, each one Python dispatch when run
eagerly; captured once into a CUDA graph it costs one ``cudaGraphLaunch``.
A chunk replays the tick's graph ``length`` times with no host sync in
between, not a graph of the whole chunk (a 200-tick chunk would be a graph
of ~940k nodes).

A :class:`TickProgram` is one tick over static buffers: the carry (planner
state, real-env state, latches, the device tick counter), the inputs the
JAX package traces (``TaskParams``) and the tick's outputs (the view row
and whatever else leaves the tick).  The tick body reads the carry and
writes the next carry back into the same buffers with ``copy_``, so replays
chain on the device.  The host copies a state in with :meth:`load` and a
state out with :meth:`carry_out` (clones: nothing the host keeps aliases
memory a later replay overwrites).

Modes (:func:`resolve_mode`): on ``cuda`` the tick is captured at its first
use, after one eager run of the same body (the warm-up: lazy constants,
cuBLAS handles, the kernel library's build and load and each kernel's first
launch, so none of them happens inside a capture), and replayed from then on;
on the CPU there is no graph, and the same static-buffer body runs
directly each tick; ``graphs=False`` keeps the eager tick, the reference
the graphs are held to.  A failed capture or replay raises: there is no
fallback to the eager tick.

The graphs of one ``ReactiveTAMP`` share one memory pool (:class:`TickGraphs`).
Every tensor that outlives a replay lies outside the pool (the static
buffers are allocated before capture), so the pool only holds a tick's
intermediates and any order of replays of the pool's graphs is safe.  The
planner's ``torch.Generator``s are registered with each graph, so a replay
draws the numbers the eager tick would draw next.

Launch counts: a capture launches nothing, so the kernel wrappers' counts
are restored after it, and each replay adds the launches the capture
recorded to :data:`replayed_launches` (captured launches x replays), apart
from the wrappers' counts of what they launched themselves.
"""
from __future__ import annotations

import ctypes
import dataclasses
import gc
import sys
import time
from typing import Callable, Optional

import torch

GRAPH, STATIC, EAGER = "graph", "static", "eager"

# launches made by graph replays, by kernel wrapper count ("rollout_launches",
# ...): each replay adds its capture's launches here, never to the wrappers'
# own counts, which only count what a wrapper launched itself
replayed_launches: dict = {}


def resolve_mode(graphs: Optional[bool], device: torch.device) -> str:
    """The tick mode of ``graphs`` (None: the default) on ``device``:
    ``"graph"`` (a CUDA graph, replayed), ``"static"`` (the CPU: the
    static-buffer body run directly) or ``"eager"``."""
    if graphs is not None and not graphs:
        return EAGER
    if device.type == "cuda":
        return GRAPH
    if graphs:
        raise ValueError(f"graphs=True needs a CUDA device, not {device}: on the CPU the tick runs over its static "
                         "buffers without a graph (graphs=None) or eagerly (graphs=False)")
    return STATIC


def _map(fn, tree):
    """``tree`` (tensors, dataclasses of tensors, tuples, dicts, None) with
    ``fn`` applied to every tensor."""
    if tree is None:
        return None
    if torch.is_tensor(tree):
        return fn(tree)
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{f.name: _map(fn, getattr(tree, f.name)) for f in dataclasses.fields(tree)})
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, x) for x in tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return tree  # a static Python value


def _leaves(tree) -> list:
    out = []
    _map(out.append, tree)
    return out


def copy_into(dst, src) -> None:
    """Copy every tensor of ``src`` into the same place of ``dst`` (the same
    structure; a tensor ``src`` shares with ``dst`` is left alone)."""
    d, s = _leaves(dst), _leaves(src)
    if len(d) != len(s):
        raise ValueError(f"copy_into: {len(s)} tensors into a structure of {len(d)}")
    for x, y in zip(d, s):
        if x is not y:
            x.copy_(y)


def clone(tree):
    return _map(torch.clone, tree)


def _launch_counts() -> dict:
    from m3p2i_aip_tpu_torch.analysis.bench_record import launch_counters

    return {(mod, name): getattr(mod, name) for mod, name in launch_counters().values()}


def graph_nodes(graph) -> int:
    """The node count of a captured graph kept with ``keep_graph=True``
    (``cuGraphGetNodes`` of libcuda)."""
    libcuda = ctypes.CDLL("libcuda.so.1")
    n = ctypes.c_size_t(0)
    err = libcuda.cuGraphGetNodes(ctypes.c_void_p(graph.raw_cuda_graph()), None, ctypes.byref(n))
    if err != 0:
        raise RuntimeError(f"cuGraphGetNodes failed: CUresult {err}")
    return int(n.value)


def pool_bytes(pool) -> int:
    """Bytes of device memory reserved by the graph memory pool ``pool``."""
    return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
               if tuple(s.get("segment_pool_id", ())) == tuple(pool))


class TickProgram:
    """One control tick over static buffers (see the module docstring).

    ``body(carry, inputs) -> (next_carry, outputs)`` is the tick; ``carry``
    and ``inputs`` are templates whose clones become the static buffers.
    """

    def __init__(self, owner: "TickGraphs", key: tuple, body: Callable, carry, inputs, generators=()) -> None:
        self.owner, self.key, self.body = owner, key, body
        self.carry = clone(carry)
        self.inputs = clone(inputs)
        self.outputs = None  # static, from the first tick's outputs
        self.generators = list(generators)
        self.graph = None
        self.replays = 0
        self.stats: dict = {}  # capture_s, nodes, pool_bytes, launches (per replay)
        self._deltas: dict = {}

    def load(self, carry, inputs) -> None:
        """Copy a host-side carry and inputs into the static buffers."""
        copy_into(self.carry, carry)
        copy_into(self.inputs, inputs)

    def carry_out(self):
        """Clones of the static carry, for the host to keep."""
        return clone(self.carry)

    def _run(self) -> None:
        nxt, outs = self.body(self.carry, self.inputs)
        copy_into(self.carry, nxt)
        if self.outputs is None:
            self.outputs = clone(outs)
        else:
            copy_into(self.outputs, outs)

    def step(self) -> None:
        """One tick: a replay of the graph, or (its first tick on cuda, every
        tick on the CPU) the body over the static buffers."""
        if self.graph is not None:
            self.graph.replay()
            self.replays += 1
            for (_, name), n in self._deltas.items():
                replayed_launches[name] = replayed_launches.get(name, 0) + n
            return
        self._run()
        if self.owner.mode == GRAPH:
            self._capture()

    def _capture(self) -> None:
        owner, dev = self.owner, self.owner.device
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        for gen in self.generators:
            graph.register_generator_state(gen)
        before = _launch_counts()
        # a CUDA graph that is garbage (a dropped planner's, held in a
        # reference cycle) is destroyed whenever Python's collector runs, and
        # destroying a graph during a capture invalidates the capture: collect
        # before, and keep the collector off during it
        gc.collect()
        gc.disable()
        t0 = time.perf_counter()
        try:
            with torch.cuda.device(dev), torch.cuda.graph(graph, pool=owner.pool(), stream=owner.stream()):
                self._run()
        finally:
            gc.enable()
        graph.instantiate()
        capture_s = time.perf_counter() - t0
        after = _launch_counts()
        for (mod, name), n in before.items():
            setattr(mod, name, n)  # a capture launches nothing
        self._deltas = {k: after[k] - n for k, n in before.items() if after[k] != n}
        self.graph = graph
        self.stats = {
            "key": self.key,
            "capture_s": capture_s,
            "nodes": graph_nodes(graph),
            "pool_bytes": pool_bytes(owner.pool()),
            "launches": {name: n for (_, name), n in self._deltas.items()},
        }


class TickGraphs:
    """A ``ReactiveTAMP``'s compiled ticks: its mode, one :class:`TickProgram`
    per key (family, gate on/off, seed count), one graph memory pool and one
    capture stream."""

    def __init__(self, device: torch.device, graphs: Optional[bool], eager_reason: Optional[str] = None) -> None:
        self.device = device
        self.mode = resolve_mode(graphs, device)
        self.programs: dict = {}
        self._pool = None
        self._stream = None
        self._said: set = set()
        if eager_reason is not None:
            self.eager_by_rule(eager_reason)
            self.mode = EAGER

    def eager_by_rule(self, reason: str) -> None:
        """Say once that a path runs the eager tick by rule (ROADMAP.md:
        gradient refinement, a sample-sharded planner)."""
        if self.mode != EAGER and reason not in self._said:
            self._said.add(reason)
            print(f"graph_tick: {reason}: this planner runs the eager tick (no CUDA graph)", file=sys.stderr)

    def pool(self):
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        return self._pool

    def stream(self) -> torch.cuda.Stream:
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        return self._stream

    def program(self, key: tuple, make: Callable[[], TickProgram]) -> TickProgram:
        prog = self.programs.get(key)
        if prog is None:
            prog = self.programs[key] = make()
        return prog

    def stats(self) -> list:
        """Each captured graph's capture time, nodes, pool bytes and launches
        per replay, with its replays so far."""
        return [dict(p.stats, replays=p.replays) for p in self.programs.values() if p.graph is not None]
