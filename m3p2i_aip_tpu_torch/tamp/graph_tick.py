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
use, after one eager run of the same body (the warm-up, a ``graph.first_run``
span: lazy constants, cuBLAS handles, the kernel library's build and load and
each kernel's first launch, so none of them happens inside a capture), and
replayed from then on (the capture a ``graph.capture`` span);
on the CPU there is no graph, and the same static-buffer body runs
directly each tick; ``graphs=False`` keeps the eager tick, the reference
the graphs are held to.  A failed capture or replay raises: there is no
fallback to the eager tick.

The graphs of one ``ReactiveTAMP`` share one memory pool (:class:`TickGraphs`).
Every tensor that outlives a replay lies outside the pool (the static
buffers are allocated before capture), so the pool only holds a tick's
intermediates and any order of the pool's programs is safe (a tick cut
into graphs by :func:`repeat` replays them all, in order, as one step).  The
planner's ``torch.Generator``s are registered with each graph, so a replay
draws the numbers the eager tick would draw next.

Launch counts: a capture launches nothing, so the kernel wrappers' counts
are restored after it, and each replay adds the launches the capture
recorded to :data:`replayed_launches` (captured launches x replays), apart
from the wrappers' counts of what they launched themselves.

Loops inside a tick (:func:`repeat`: the planner's gradient steps) are not
unrolled into the tick's graph: the capture ends before the loop, the loop's
body is captured once into a graph of its own over a static carry and
replayed ``n`` times, and a third graph captures the rest of the tick.  The
three are replayed in their capture order on one stream, with no host sync
between them.  The first (eager) run of a body on the card runs on the
capture stream, so the lazy state autograd and cuBLAS keep per stream and
per thread exists before the capture (PyTorch's whole-network capture).

Parts of a tick (:func:`part`: the real-env step) are counted while the
tick is captured: the nodes a part adds to the graph under capture go to
the tracer's counter ``graph.<part>_nodes``.  A replay runs no Python, and
outside a capture the marker does nothing.

The planner's own call (``MPPI.command``, the JAX package's
``jax.jit(self._command_impl)``) is a :class:`TickProgram` too, with the
planner state as its carry and the real state and ``TaskParams`` as its
inputs.  Programs without a planner (:func:`env_steps`: warm-ups and
settles, the sim client's step) take it with the env state as their carry.
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import gc
import sys
import time
from typing import Callable, Optional

import torch

from m3p2i_aip_tpu_torch.utils import profiling

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


def signature(tree) -> tuple:
    """The shape and dtype of every tensor of ``tree``: what a capture bakes
    in of its buffers."""
    return tuple((tuple(x.shape), x.dtype) for x in _leaves(tree))


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


_CAPTURE_ACTIVE = 1  # CU_STREAM_CAPTURE_STATUS_ACTIVE


def _capture_nodes(stream: torch.cuda.Stream) -> tuple:
    """(graph handle, node count) of the graph under capture on ``stream``
    (``cuStreamGetCaptureInfo_v2`` and ``cuGraphGetNodes`` of libcuda)."""
    libcuda = ctypes.CDLL("libcuda.so.1")
    status, capture_id = ctypes.c_int(0), ctypes.c_uint64(0)
    graph, deps, n_deps = ctypes.c_void_p(), ctypes.c_void_p(), ctypes.c_size_t(0)
    err = libcuda.cuStreamGetCaptureInfo_v2(ctypes.c_void_p(stream.cuda_stream), ctypes.byref(status),
                                            ctypes.byref(capture_id), ctypes.byref(graph), ctypes.byref(deps),
                                            ctypes.byref(n_deps))
    if err != 0 or status.value != _CAPTURE_ACTIVE:
        raise RuntimeError(f"cuStreamGetCaptureInfo_v2: CUresult {err}, capture status {status.value}")
    n = ctypes.c_size_t(0)
    err = libcuda.cuGraphGetNodes(graph, None, ctypes.byref(n))
    if err != 0:
        raise RuntimeError(f"cuGraphGetNodes failed: CUresult {err}")
    return graph.value, int(n.value)


def pool_bytes(pool) -> int:
    """Bytes of device memory reserved by the graph memory pool ``pool``."""
    return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
               if tuple(s.get("segment_pool_id", ())) == tuple(pool))


class _Segments:
    """A capture in progress, cut into graphs at each :func:`repeat`: the
    parts ``[graph, replays, launches counted while it was captured,
    capture seconds]`` in replay order."""

    def __init__(self, prog: "TickProgram") -> None:
        self.prog = prog
        self.parts: list = []
        self.keep: list = []  # the static carries of the repeated graphs
        self._graph = None

    def begin(self) -> None:
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        for gen in self.prog.generators:
            graph.register_generator_state(gen)
        self._counts, self._t0 = _launch_counts(), time.perf_counter()
        graph.capture_begin(pool=self.prog.owner.pool())
        self._graph = graph

    def end(self, replays: int = 1) -> None:
        graph, self._graph = self._graph, None
        graph.capture_end()
        after = _launch_counts()
        deltas = {k: after[k] - n for k, n in self._counts.items() if after[k] != n}
        self.parts.append([graph, replays, deltas, time.perf_counter() - self._t0])

    def abort(self) -> None:
        """End a capture a failure interrupted (the failure is raised on)."""
        if self._graph is not None:
            graph, self._graph = self._graph, None
            try:
                graph.capture_end()
            except RuntimeError:
                pass


_capturing: Optional[_Segments] = None  # the capture in progress, for repeat()


def repeat(n: int, step: Callable, carry, inputs):
    """``carry = step(carry, inputs)`` ``n`` times; returns the last carry.

    Run eagerly, or over static buffers, it is the Python loop.  Inside a
    capture the tick's graph ends here: ``step`` is captured once into a
    graph of its own over a static copy of ``carry`` (the copy is the last
    node of the graph before), replayed ``n`` times, and the rest of the
    tick goes into a new graph that reads the static carry.  ``inputs`` are
    read where they lie: the tick's buffers or its earlier intermediates,
    which stay referenced until the capture ends."""
    seg = _capturing
    if seg is None:
        for _ in range(n):
            carry = step(carry, inputs)
        return carry
    if n <= 0:
        return carry
    buf = clone(carry)  # captured: each replay copies the carry in
    seg.keep.append(buf)
    seg.end()
    seg.begin()
    copy_into(buf, step(buf, inputs))
    seg.end(replays=n)
    seg.begin()
    return buf


@contextlib.contextmanager
def part(name: str):
    """``with part(name):`` inside a tick body: while the tick is captured,
    the nodes the block adds to the graph under capture are recorded under
    the tracer's counter ``graph.<name>_nodes``; otherwise (a replay, the
    eager or static tick, the CPU) nothing.  The block may not hold a
    :func:`repeat`, which would end the graph it started in."""
    if _capturing is None:
        yield
        return
    stream = torch.cuda.current_stream()
    graph, n0 = _capture_nodes(stream)
    yield
    after, n1 = _capture_nodes(stream)
    if after != graph:
        raise RuntimeError(f"graph_tick.part({name!r}) holds a repeat: its nodes lie in two graphs")
    profiling.count(f"graph.{name}_nodes", n1 - n0)


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
        self.graph = None  # the captured parts ([graph, replays, launches, capture s], ...)
        self._keep: list = []  # the static carries of its repeated parts
        self.replays = 0
        self.stats: dict = {}  # capture_s, nodes, pool_bytes, launches (per replay), segments

    def load(self, carry, inputs) -> None:
        """Copy a host-side carry and inputs into the static buffers."""
        copy_into(self.carry, carry)
        copy_into(self.inputs, inputs)

    def carry_out(self):
        """Clones of the static carry, for the host to keep."""
        return clone(self.carry)

    def registered(self, generators) -> bool:
        """Whether this program was made with exactly ``generators`` (the
        same objects): a graph replays the generators it registered,
        whatever the planner holds now."""
        return len(self.generators) == len(generators) and all(a is b for a, b in zip(self.generators, generators))

    def _run(self) -> None:
        nxt, outs = self.body(self.carry, self.inputs)
        copy_into(self.carry, nxt)
        if self.outputs is None:
            self.outputs = clone(outs)
        else:
            copy_into(self.outputs, outs)

    def step(self) -> None:
        """One tick: a replay of the graph (each part in turn, a repeated
        part its ``n`` times), or (its first tick on cuda, every tick on the
        CPU) the body over the static buffers."""
        if self.graph is not None:
            for graph, n, _, _ in self.graph:
                for _ in range(n):
                    graph.replay()
            self.replays += 1
            for name, n in self.stats["launches"].items():
                replayed_launches[name] = replayed_launches.get(name, 0) + n
            return
        if self.owner.mode != GRAPH:
            self._run()
            return
        # the warm-up: the body once, eagerly, on the capture stream
        with profiling.span("graph.first_run"):
            stream, current = self.owner.stream(), torch.cuda.current_stream(self.owner.device)
            stream.wait_stream(current)
            with torch.cuda.stream(stream):
                self._run()
            current.wait_stream(stream)
        self._capture()

    def _capture(self) -> None:
        global _capturing
        owner, dev = self.owner, self.owner.device
        before = _launch_counts()
        seg = _Segments(self)
        # a CUDA graph that is garbage (a dropped planner's, held in a
        # reference cycle) is destroyed whenever Python's collector runs, and
        # destroying a graph during a capture invalidates the capture: collect
        # before, and keep the collector off during it
        gc.collect()
        gc.disable()
        with profiling.span("graph.capture"):
            try:
                with torch.cuda.device(dev):
                    torch.cuda.synchronize(dev)
                    with torch.cuda.stream(owner.stream()):
                        _capturing = seg
                        try:
                            seg.begin()
                            self._run()
                            seg.end()
                        except BaseException:
                            seg.abort()
                            raise
                        finally:
                            _capturing = None
            finally:
                gc.enable()
            for graph, *_ in seg.parts:
                graph.instantiate()
        t0, t1 = profiling.last_span("graph.capture")
        capture_s = (t1 - t0) / 1e9
        for (mod, name), n in before.items():
            setattr(mod, name, n)  # a capture launches nothing
        launches: dict = {}
        for _, n, deltas, _ in seg.parts:
            for (_, name), d in deltas.items():
                launches[name] = launches.get(name, 0) + n * d
        self.graph = seg.parts
        self._keep = seg.keep
        segments = [{"nodes": graph_nodes(g), "replays": n, "capture_s": s} for g, n, _, s in seg.parts]
        self.stats = {
            "key": self.key,
            "capture_s": capture_s,
            "nodes": sum(x["nodes"] for x in segments),
            "pool_bytes": pool_bytes(owner.pool()),
            "launches": launches,
            "segments": segments,
        }


class TickGraphs:
    """A planner's compiled programs, shared with the ``ReactiveTAMP`` that
    holds it (or, for a caller without a planner, such as the sim client,
    its own): its mode, one :class:`TickProgram` per key (the command's; the
    tick's kind, gate on/off and seed count; the env steps), one graph
    memory pool and one capture stream."""

    def __init__(self, device: torch.device, graphs: Optional[bool]) -> None:
        self.device = torch.device(device)
        self.mode = resolve_mode(graphs, self.device)
        self.programs: dict = {}
        self._pool = None
        self._stream = None
        self._said: set = set()

    def eager_by_rule(self, reason: str) -> None:
        """Say once that a path runs eagerly by rule (ROADMAP.md: a
        sample-sharded planner over distinct cards)."""
        if self.mode != EAGER and reason not in self._said:
            self._said.add(reason)
            print(f"graph_tick: {reason}: this planner runs its command and ticks eagerly (no CUDA graph)",
                  file=sys.stderr)

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


def env_steps(ticks: TickGraphs, env, state, action, ext, n: int):
    """``n`` steps of ``env`` from ``state`` under one action and one set of
    external forces (a warm-up's or a settle's): ``n`` replays of the
    compiled step (key: env type, seed count, "step"; the env state its
    carry, the action and forces its inputs) with no host sync between
    them, or ``n`` eager steps when ``ticks`` is eager.  Returns the state
    (the host's own copy)."""
    if n <= 0:
        return state
    if ticks.mode == EAGER:
        for _ in range(n):
            state = env.step(state, action, ext)
        return state
    lead = action.shape[:-1]
    key = (env.env_type, lead[0] if lead else None, "step")
    prog = ticks.program(key, lambda: TickProgram(ticks, key, lambda s, x: (env.step(s, *x), None), state,
                                                  (action, ext)))
    prog.load(state, (action, ext))
    for _ in range(n):
        prog.step()
    return prog.carry_out()
