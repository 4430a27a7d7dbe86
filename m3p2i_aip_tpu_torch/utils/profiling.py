"""The port's tracer, and device traces.

Port of ``m3p2i_aip_tpu/utils/profiling.py``.  The reference's only
instrumentation is the per-tick FPS print of ``skill_utils.time_tracking``
and the rate columns of its experiment logs.  Here:

  * :func:`span`: a named host interval at a layer boundary of the loops
    (start, end, the enclosing span, a request id: the tick index, or a
    chunk's first tick), kept in a preallocated in-memory ring;
  * :func:`device_span`: the device time of a block on the current stream,
    between two CUDA timing events from a preallocated pool, which is the
    device spans' ring;
  * :func:`count`: a named counter of the program's own (a value recorded
    at a site: its count, total and newest value);
  * :func:`snapshot`: per name, the count, total and self seconds (exact for
    the whole process) and the p50 over retained records, all of them or a
    run's stretch of them (``last``, ``skip``), and the counters;
  * :func:`trace`: a ``torch.profiler`` trace (host and, on a GPU, device
    activity) written for TensorBoard.

The spans, where they are opened and the metric that reads each
(``benchmark/metrics/<name>.py``):

=====================  ==========================================  ==================================
span                   site                                        metric
=====================  ==========================================  ==================================
``kernels.load``       ``ops/cuda_build.load_kernels``              ``kernel_load_s``
``graph.first_run``    ``TickProgram.step``'s eager warm-up         ``first_run_s`` (self seconds)
``graph.capture``      ``TickProgram._capture``                    ``capture_s``
``tamp.plan``          ``ReactiveTAMP.tamp_interface_view``;       ``plan_ms_p50.pertick``
                       the batch's host planners
``tamp.tick``          ``ReactiveTAMP.tick_fused``                 ``launch_ms_p50.pertick``
``tamp.chunk``         ``ReactiveTAMP._run_chunk_impl``,           ``enqueue_ms_p50.chunked``, ``.batch``
                       ``_run_chunk_panda_impl``
``loop.fetch``         the loops' view fetches                     ``fetch_ms_p50.pertick``
``loop.observe``       ``SimLoop.tick`` after its fetch            ``observe_ms_p50.pertick``
``loop.drain``         ``SimLoop._drain_chunk``, the batch's        ``drain_ms_p50.chunked``
                       per-seed drain
device ``tick``        the replay in ``tick_fused``                ``tick_device_ms_p50.pertick``
device ``chunk``       a chunk's replays and view-row copies       ``chunk_device_ms_p50.chunked``,
                                                                   ``.batch``
counter                ``graph_tick.part("step")`` around the      ``step_nodes.chunked``
``graph.step_nodes``   real-env step of ``ReactiveTAMP._tick`` and
                       ``_panda_tick``, while a tick is captured:
                       the nodes the step adds to its graph
=====================  ==========================================  ==================================

The loops' ``TickLog.replan_s``, ``TickProgram.stats["capture_s"]`` and
``cuda_build.build_info["seconds"]`` read their seconds from the spans
(:func:`last_span`).

Tracing has no switch.  A span costs two clock reads and one ring write.
While ``torch.profiler`` records, a span of :data:`HOST_ONLY` also enters
the profiler's host timeline (``record_function``), so a trace's idle gaps
can carry its name; the other spans enclose device work, for which the
profiler would add a ``gpu_user_annotation`` event to the device timeline,
and stay in the ring only.  A device span costs two event records; its
events are read only by :func:`snapshot`, and a pair that comes round again
is recorded over, unread.  The spans are the loops' and open on one thread.
"""
from __future__ import annotations

import contextlib
import os
import statistics
import tempfile
import time
from typing import Optional

import torch

CAPACITY = 65536  # span records the ring retains (about 80 s of per-tick traffic)
EVENT_PAIRS = 4096  # device spans retained (a 10-s window holds ~1,500 per-tick ticks)
HOST_ONLY = frozenset({"kernels.load", "loop.observe", "loop.drain"})  # spans that launch no device work
_MAX_DEPTH = 32
_NOTHING = contextlib.nullcontext()

_clock = time.perf_counter_ns
_profiling = torch._C._autograd._profiler_enabled


class _Frame:
    """An open span: one per nesting depth, reused."""

    __slots__ = ("tracer", "depth", "name", "req", "parent", "t0", "child", "rf")

    def __init__(self, tracer: "Tracer", depth: int) -> None:
        self.tracer, self.depth = tracer, depth
        self.name = self.req = self.parent = self.rf = None
        self.t0 = self.child = 0

    def __enter__(self) -> "_Frame":
        tr = self.tracer
        if self.depth:
            up = tr._frames[self.depth - 1]
            self.parent = up.name
            if self.req is None:
                self.req = up.req
        else:
            self.parent = None
        tr._depth = self.depth + 1
        self.child = 0
        if self.name in HOST_ONLY and _profiling():
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        self.t0 = _clock()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = _clock()
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
            self.rf = None
        tr, name = self.tracer, self.name
        tr._depth = self.depth
        dur = t1 - self.t0
        own = dur - self.child
        if self.depth:
            tr._frames[self.depth - 1].child += dur
        tot = tr._totals.get(name)
        if tot is None:
            tot = tr._totals[name] = [0, 0, 0]
        tot[0] += 1
        tot[1] += dur
        tot[2] += own
        tr._last[name] = (self.t0, t1)
        tr._ring[tr._n & tr._mask] = (name, self.req, self.parent, self.t0, t1, own)
        tr._n += 1
        return False


class _Pair:
    """Two timing events around a device span, and the span they time
    (name, request, sequence number) once recorded."""

    __slots__ = ("start", "end", "stream", "span")

    def __init__(self) -> None:
        self.start = torch.cuda.Event(enable_timing=True)
        self.end = torch.cuda.Event(enable_timing=True)
        self.stream = self.span = None

    def __enter__(self) -> None:
        self.start.record(self.stream)

    def __exit__(self, *exc) -> bool:
        self.end.record(self.stream)
        return False


class _Pool:
    """A device's pairs of events, taken in turn, and its current stream's
    object, made anew only when the current stream changes."""

    def __init__(self, n: int) -> None:
        self.pairs = [_Pair() for _ in range(n)]
        self.next = 0
        self._key = self._stream = None

    def current_stream(self, index: int) -> torch.cuda.Stream:
        key = torch._C._cuda_getCurrentStream(index)
        if key != self._key:
            self._key, self._stream = key, torch.cuda.Stream(stream_id=key[0], device_index=key[1],
                                                            device_type=key[2])
        return self._stream


class Tracer:
    """Spans and device spans in memory (the module's functions use one
    shared instance; a test may make its own with a small ``capacity``, a
    power of two)."""

    def __init__(self, capacity: int = CAPACITY) -> None:
        if capacity & (capacity - 1):
            raise ValueError(f"the ring's capacity must be a power of two, not {capacity}")
        self._mask = capacity - 1
        self._ring: list = [None] * capacity
        self._n = 0  # spans closed
        self._frames = [_Frame(self, d) for d in range(_MAX_DEPTH)]
        self._depth = 0
        self._totals: dict = {}  # name -> [count, total ns, self ns]
        self._last: dict = {}  # name -> (start ns, end ns) of its newest span
        self._pools: dict = {}  # device index -> _Pool
        self._dev_n = 0  # device spans opened
        self._counters: dict = {}  # name -> [count, total, newest value]

    # ------------------------------------------------------------ host spans
    def span(self, name: str, req=None) -> _Frame:
        """``with span(name, req):`` records the block as a span.  ``req``
        (None: the enclosing span's) ties the spans of one tick or chunk."""
        f = self._frames[self._depth]
        f.name, f.req = name, req
        return f

    def last_span(self, name: str) -> tuple:
        """(start ns, end ns) of the newest closed span ``name``, on
        ``time.perf_counter_ns``'s clock."""
        return self._last[name]

    # ---------------------------------------------------------- device spans
    def device_span(self, name: str, req, device: torch.device):
        """``with device_span(name, req, device):`` times the block's work on
        ``device``'s current stream between two CUDA events (a no-op off
        CUDA).  Not inside a graph capture: the sites wrap replays."""
        if device.type != "cuda":
            return _NOTHING
        index = torch.cuda.current_device() if device.index is None else device.index
        pool = self._pools.get(index)
        if pool is None:
            pool = self._pools[index] = _Pool(EVENT_PAIRS)
        pair = pool.pairs[pool.next]
        pool.next = (pool.next + 1) % len(pool.pairs)
        pair.span = (name, req, self._dev_n)
        self._dev_n += 1
        pair.stream = pool.current_stream(index)
        return pair

    # -------------------------------------------------------------- counters
    def count(self, name: str, value) -> None:
        """Record ``value`` under the counter ``name``."""
        c = self._counters.get(name)
        if c is None:
            c = self._counters[name] = [0, 0, 0]
        c[0] += 1
        c[1] += value
        c[2] = value

    # --------------------------------------------------------------- reading
    def records(self) -> list:
        """The retained span records in the order they ended: (name, req,
        parent name, start ns, end ns, self ns)."""
        if self._n <= len(self._ring):
            return self._ring[: self._n]
        at = self._n & self._mask
        return self._ring[at:] + self._ring[:at]

    def _device_records(self) -> list:
        """The retained device spans in the order they began: (name, req,
        seconds); waits for the newest to end."""
        out = []
        for pool in self._pools.values():
            for pair in pool.pairs:
                if pair.span is not None:
                    pair.end.synchronize()
                    out.append((pair.span, pair.start.elapsed_time(pair.end) / 1e3))
        out.sort(key=lambda r: r[0][2])
        return [(name, req, seconds) for (name, req, _), seconds in out]

    def snapshot(self, last: Optional[int] = None, skip: int = 0) -> dict:
        """``{"spans": {name: {count, total_s, self_s, p50_s}}, "device":
        {name: {p50_s}}, "counters": {name: {count, total, last}}}``: counts
        and totals over the whole process; each median over the name's
        retained records, or over its ``last`` records before its ``skip``
        newest (a run's window ahead of a stretch that followed it); a
        counter's newest value as ``last``."""
        spans = {name: {"count": n, "total_s": total / 1e9, "self_s": own / 1e9}
                 for name, (n, total, own) in self._totals.items()}
        kept: dict = {}
        for rec in self.records():
            kept.setdefault(rec[0], []).append((rec[4] - rec[3]) / 1e9)
        dev_kept: dict = {}
        for name, _, seconds in self._device_records():
            dev_kept.setdefault(name, []).append(seconds)
        device = {name: {} for name in dev_kept}
        for out, retained in ((spans, kept), (device, dev_kept)):
            for name, xs in retained.items():
                xs = xs[: max(len(xs) - skip, 0)]
                if last is not None:
                    xs = xs[len(xs) - min(last, len(xs)):]
                if xs:
                    out[name]["p50_s"] = statistics.median(xs)
        counters = {name: {"count": n, "total": total, "last": newest}
                    for name, (n, total, newest) in self._counters.items()}
        return {"spans": spans, "device": device, "counters": counters}

    def reset(self) -> None:
        """Forget every record and total (tests)."""
        self._ring[:] = [None] * len(self._ring)
        self._n = 0
        self._totals.clear()
        self._last.clear()
        self._counters.clear()
        for pool in self._pools.values():
            for pair in pool.pairs:
                pair.span = None


TRACER = Tracer()
span = TRACER.span
device_span = TRACER.device_span
last_span = TRACER.last_span
count = TRACER.count
snapshot = TRACER.snapshot
reset = TRACER.reset


@contextlib.contextmanager
def trace(logdir: Optional[str] = None):
    """``with trace(): loop.tick(i)``: a TensorBoard trace of the block's
    host and device work, written to ``logdir`` (a directory under the
    temporary directory if None); yields the directory."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    logdir = logdir or os.path.join(tempfile.gettempdir(), "m3p2i_torch_trace")
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(logdir)):
        yield logdir
