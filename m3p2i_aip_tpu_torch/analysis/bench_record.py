"""What the port's benchmark programs share (``scripts/bench*.py``,
``scripts/analyze_utilization.py``).

* :func:`require_device`: the programs run on ``cuda`` unless the caller
  passes ``device=cpu``; with no card they exit non-zero, never carrying on
  on the CPU.
* :func:`device_record`: the card's name, the device count and the power
  limit ``nvidia-smi`` reports, on every line a program prints.
* :func:`gates_off`: both success gates off, so every tick replans
  (``bench.py:38-41``).
* :func:`timed_chunks`: the JAX scripts' rate, ticks over the host seconds
  up to a ``torch.cuda.synchronize()``, with the median and quartiles of the
  per-chunk rates beside it (:class:`ChunkClock`).
* :func:`emit`: the JSON line, printed and written under
  ``results_h100/bench/``; :func:`emit_rate` builds a rate twin's line
  first.

Every program runs the compiled tick by default (one replay of a CUDA graph
a tick on the card, ``tamp/graph_tick.py``) and the eager tick with
``--eager``, for the paired comparison; its JSON line's ``tick`` says which
(``graph``, ``eager``, or ``static`` on the CPU).

Every default output of the port's programs lies under :data:`RESULTS_DIR`,
relative to the working directory: the TPU-era artifacts at the repository's
root and the logs under ``plot/`` are the JAX package's.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

RESULTS_DIR = "results_h100"
BENCH_DIR = os.path.join(RESULTS_DIR, "bench")
BASELINE_HZ = 21.2  # the original's best logged scenario mean at K=200 x T=15 (BASELINE.md:16)


def require_device(name: str, program: str) -> torch.device:
    """``torch.device(name)``; exits non-zero for a CUDA device when no card
    is visible."""
    device = torch.device(name)
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"{program}: device={name}: the programs run on cuda or cpu")
    if device.type == "cuda" and not torch.cuda.is_available():
        sys.exit(f"{program}: no CUDA device; pass device=cpu to run on the CPU")
    return device


def nvidia_smi() -> str:
    """The first card's ``name, power.limit`` as ``nvidia-smi`` prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def device_record(device: torch.device) -> dict:
    """{"platform", "kind", "count", "power_limit"} of the device a program
    ran on; ``power_limit`` is null on the CPU."""
    if device.type == "cpu":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "power_limit": None}
    card = nvidia_smi()
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": torch.cuda.device_count(),
            "power_limit": card.split(",")[-1].strip()}


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def gates_off(loop) -> None:
    """Every tick replans: the host success check and the device latch off."""
    loop.tamp.task_planner.check_task_success = lambda view: False
    loop.tamp.device_gate = False


class ChunkClock:
    """Marks between chunks.  On the card a mark is a CUDA event recorded on
    the current stream, so marking makes no host sync: the time between two
    marks is the device timeline from the end of the work enqueued before
    the first to the end of the work enqueued before the second, one chunk
    of a chain of enqueued chunks.  ``host=True`` (and on the CPU) a mark
    reads the host clock, for chunks that each end in a synchronize."""

    def __init__(self, device: torch.device, host: bool = False) -> None:
        self.events = device.type == "cuda" and not host
        self.kind = "cuda_events" if self.events else "host"
        self._marks: list = []

    def mark(self) -> None:
        if self.events:
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            self._marks.append(event)
        else:
            self._marks.append(time.perf_counter())

    def periods_s(self) -> list:
        """Seconds between consecutive marks (after the work has ended)."""
        pairs = zip(self._marks, self._marks[1:])
        if self.events:
            self._marks[-1].synchronize()
            return [a.elapsed_time(b) / 1e3 for a, b in pairs]
        return [b - a for a, b in pairs]


def rate_record(ticks: int, seconds: float, chunk: int, clock: ChunkClock) -> dict:
    """The rate over the whole run beside the per-chunk rates' median and
    quartiles, in Hz.  Raises unless ``clock`` marked every one of the
    run's chunks (a mark lost to a hook that no longer fires)."""
    rec = {"value": ticks / seconds, "unit": "Hz", "seconds": seconds, "chunk_clock": clock.kind}
    periods = clock.periods_s()
    if len(periods) != -(-ticks // chunk):
        raise RuntimeError(f"{len(periods)} chunks timed of the {-(-ticks // chunk)} that {ticks} ticks in chunks "
                           f"of {chunk} make")
    q1, med, q3 = np.percentile([chunk / p for p in periods], [25, 50, 75]).tolist()
    rec.update(chunk_hz_median=med, chunk_hz_q1=q1, chunk_hz_q3=q3, chunks=len(periods))
    return rec


def timed_chunks(loop, ticks: int, chunk: int, pipelined: bool) -> dict:
    """``ticks`` replan+step ticks of ``loop.run_chunked`` in chunks of
    ``chunk``: serially, each chunk timed on the host clock to its sync, or
    pipelined (one chunk in flight, as ``run_chunked(pipelined=True)``
    runs them), each chunk timed by a CUDA event recorded as it is enqueued.
    Returns :func:`rate_record`'s fields."""
    device = loop.env.device
    synchronize(device)
    if pipelined:
        clock, enqueue = ChunkClock(device), loop._enqueue_chunk

        def marked(*args):
            clock.mark()
            return enqueue(*args)

        loop._enqueue_chunk = marked
        try:
            t0 = time.perf_counter()
            loop.run_chunked(ticks, chunk=chunk, pipelined=True)
            clock.mark()
            synchronize(device)
            seconds = time.perf_counter() - t0
        finally:
            loop._enqueue_chunk = enqueue
        return rate_record(ticks, seconds, chunk, clock)
    clock, done = ChunkClock(device, host=True), 0
    t0 = time.perf_counter()
    while done < ticks:
        clock.mark()
        loop.run_chunked(chunk, chunk=chunk)
        synchronize(device)
        done += chunk
    clock.mark()
    return rate_record(done, time.perf_counter() - t0, chunk, clock)


def settled_rate(loop, chunk: int, ticks: int, pipelined: bool) -> dict:
    """The JAX benches' protocol on a warmed-up loop: both gates off, two
    chunks to settle, then :func:`timed_chunks`."""
    gates_off(loop)
    for _ in range(2):  # settle (the JAX scripts' compile + settle chunks)
        loop.run_chunked(chunk, chunk=chunk)
    return timed_chunks(loop, ticks, chunk, pipelined)


def launch_counters() -> dict:
    """{kernel: (module, attribute)} of every kernel wrapper's launch count."""
    from m3p2i_aip_tpu_torch.ops import albert_rollout as ar
    from m3p2i_aip_tpu_torch.ops import panda_rollout as pr
    from m3p2i_aip_tpu_torch.ops import panda_step as pps
    from m3p2i_aip_tpu_torch.ops import point_step as ps
    from m3p2i_aip_tpu_torch.ops import rollout as ro
    from m3p2i_aip_tpu_torch.ops import weights

    return {
        "K1": (ro, "rollout_launches"), "K1b": (ro, "rollout_batched_launches"),
        "K2": (weights, "weights_launches"), "K2b": (weights, "weights_batched_launches"),
        "K3": (pr, "panda_rollout_launches"), "K3b": (pr, "panda_rollout_batched_launches"),
        "K4": (ar, "albert_rollout_launches"), "K4b": (ar, "albert_rollout_batched_launches"),
        "K5": (ps, "step_launches"), "K5b": (ps, "step_batched_launches"),
        "K6": (pps, "panda_step_launches"), "K6b": (pps, "panda_step_batched_launches"),
    }


# the symbol of each wrapper's kernel in a profiler trace (a batched call
# launches its single call's kernel)
KERNEL_SYMBOLS = {
    "K1": "point_rollout_kernel", "K1b": "point_rollout_kernel",
    "K2": "multimodal_weights_kernel", "K2b": "multimodal_weights_kernel",
    "K3": "panda_rollout_kernel", "K3b": "panda_rollout_kernel",
    "K4": "albert_rollout_kernel", "K4b": "albert_rollout_kernel",
    "K5": "point_env_step_kernel", "K5b": "point_env_step_kernel",
    "K6": "panda_env_step_kernel", "K6b": "panda_env_step_kernel",
}


# :func:`profile`'s pads: empty kernels before and after the profiled run.
# On the card a trace loses its first device events, more of them the more
# profiles the process has taken (30 to 43 over ten, enough to drop an eager
# north-star chunk's first K1 and K2), and at times up to a few hundred of
# its last
PAD = 4096
PAD_SYMBOL = "spin_kernel"  # the kernel of torch.cuda._sleep


def launch_counts() -> dict:
    """Every kernel's launches, by kernel: (its wrapper's own count, the
    launches CUDA graph replays made, ``graph_tick.replayed_launches``)."""
    from m3p2i_aip_tpu_torch.tamp import graph_tick

    return {k: (getattr(mod, name), graph_tick.replayed_launches.get(name, 0))
            for k, (mod, name) in launch_counters().items()}


def kernel_fields(before: dict) -> dict:
    """{"kernel", "launches", "graph_launches"} since ``before`` (a
    :func:`launch_counts`): ``kernel`` is true when a CUDA rollout kernel ran
    the planner's rollouts, ``launches`` the kernels their wrappers launched
    and ``graph_launches`` those graph replays launched (captured launches x
    replays), by kernel."""
    now = launch_counts()
    launches, graph = ({k: n[i] - before[k][i] for k, n in now.items() if n[i] != before[k][i]} for i in (0, 1))
    return {"kernel": any(k[:2] in ("K1", "K3", "K4") for k in (*launches, *graph)), "launches": launches,
            "graph_launches": graph}


def traced_launches(prof: dict, before: dict) -> dict:
    """The kernels whose events in a :func:`profile` differ from the
    launches counted since ``before`` (a :func:`launch_counts` taken just
    before the profiled run: its wrappers' launches plus its graph replays'):
    {symbol: (events traced, launches counted)}, empty when every kernel's
    events equal its launches."""
    now = launch_counts()
    counted = dict.fromkeys(prof["traced_launches"], 0)
    for k, sym in KERNEL_SYMBOLS.items():
        counted[sym] += sum(now[k]) - sum(before[k])
    return {sym: (n, counted[sym]) for sym, n in prof["traced_launches"].items() if n != counted[sym]}


def env_int(name: str, default: int) -> int:
    """An integer knob of the JAX scripts' environment (``M3P2I_BENCH_*``)."""
    return int(os.environ.get(name, default))


def emit_rate(metric: str, rate: dict, cfg, device: torch.device, chunk: int, ticks: int, before: dict,
              default_name: str, out=None, **extra) -> dict:
    """A rate twin's line: ``metric`` and its :func:`rate_record` fields,
    ``extra`` (``vs_baseline``, ...), the device record, the config's K and
    T, the protocol's chunk and timed ticks, and :func:`kernel_fields` since
    ``before``; emitted as :func:`emit` does and returned."""
    dev = device_record(device)
    rec = {
        "metric": metric,
        **rate,
        **extra,
        "platform": dev["platform"],
        "device": dev,
        "K": int(cfg.mppi.num_samples),
        "T": int(cfg.mppi.horizon),
        "chunk": chunk,
        "ticks": ticks,
        **kernel_fields(before),
    }
    emit(rec, default_name, out)
    return rec


def emit(rec: dict, default_name: str, out=None) -> str:
    """Print ``rec`` as one JSON line and write it to ``out``, by default
    ``results_h100/bench/<default_name>``; ``out="-"`` writes nothing.
    Returns the path written, or None."""
    line = json.dumps(rec)
    print(line, flush=True)
    if out == "-":
        return None
    path = out or os.path.join(BENCH_DIR, default_name)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write(line + "\n")
    return path


def event_ms(fn, calls: int = 50, warmup: int = 5) -> float:
    """Median time of one call on the card, by CUDA events around each call
    (a call shorter than the host's time to issue it reads the host's)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(calls):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in pairs]))


def replayed_ms(fn, launches: int = 20, reps: int = 5) -> float:
    """Device time of one call, without the host's time to issue it: ``fn``
    captured ``launches`` times into a CUDA graph and the graph replayed
    between CUDA events, so the calls run back to back however long the
    wrapper takes on the host (single calls between events take that time
    in wherever the kernel is shorter); the median over ``reps`` replays,
    per call."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture, as torch.cuda.graphs asks
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return float(np.median(times))


def host_ms(fn, calls: int = 10, device: torch.device = torch.device("cuda")) -> float:
    """Median host time of one call that ends in a synchronize."""
    fn()
    synchronize(device)
    times = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn()
        synchronize(device)
        times.append(time.perf_counter() - t0)
    return float(np.median(times)) * 1e3


def _pad(n: int) -> None:
    """``n`` empty kernels, waited for."""
    for _ in range(n):
        torch.cuda._sleep(0)
    torch.cuda.synchronize()


def profile(run, n: int, kernels: dict, pad: int = PAD):
    """``torch.profiler`` over ``run()``, a chunk of ``n`` ticks on the card:
    {"kernels_per_tick", "device_ms_per_tick", "wall_ms_per_tick",
    "idle_pct", "kernel_ms_per_tick"} with the time a tick of each kernel in
    ``kernels`` ({label: a substring of its name}),
    "traced_launches", the events of each of the port's kernels
    (:data:`KERNEL_SYMBOLS`), and, to place a lost event, "kernel_starts_ms",
    those events' start times, and "device_span_ms", the last device
    event's end, both from the first device event; None when the profiler
    saw no device kernel (device time not measured).

    The profiler loses events at the ends of a trace (:data:`PAD`).  So
    the run is framed inside the profile by ``pad`` empty kernels before it
    and ``pad`` after it (``torch.cuda._sleep(0)``, :data:`PAD_SYMBOL`),
    each pad waited for; a loss at an end then falls on a pad.  The pads' events are left out of
    every figure above and counted apart (:func:`summarize`)."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _pad(pad)
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        _pad(pad)
    return summarize([e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA], n, wall,
                     kernels, pad)


def summarize(events: list, n: int, wall: float, kernels: dict, pad: int):
    """:func:`profile`'s record from its device events (each with ``name``
    and ``time_range``, in us) over a run of ``n`` ticks and ``wall``
    seconds between two pads of ``pad`` launches of :data:`PAD_SYMBOL`;
    None when no event of the run was traced.  Every figure leaves the pads
    out; "pad" is a pad's launches, "pad_traced" the events kept of each
    pad (head, tail), and "pad_gaps_ms" the device time between the head
    pad's last event and the run's first, and between the run's last and
    the tail pad's first (None where a pad kept nothing): a gap of a tick's
    length places a lost tick."""
    padded = [e for e in events if PAD_SYMBOL in e.name]
    events = [e for e in events if PAD_SYMBOL not in e.name]
    if not events:
        return None
    dev_us = sum(e.time_range.elapsed_us() for e in events)
    t_first = min(e.time_range.start for e in events)
    t_last = max(e.time_range.end for e in events)
    head = [e.time_range.end for e in padded if e.time_range.start < t_first]
    tail = [e.time_range.start for e in padded if e.time_range.start >= t_first]
    symbols = sorted(set(KERNEL_SYMBOLS.values()))
    return {
        "kernels_per_tick": len(events) / n,
        "device_ms_per_tick": dev_us / n / 1e3,
        "wall_ms_per_tick": wall / n * 1e3,
        "idle_pct": 100 * (1 - dev_us / 1e6 / wall),
        "kernel_ms_per_tick": {k: sum(e.time_range.elapsed_us() for e in events if sub in e.name) / n / 1e3
                               for k, sub in kernels.items()},
        "traced_launches": {sym: sum(sym in e.name for e in events) for sym in symbols},
        "kernel_starts_ms": {sym: [round((e.time_range.start - t_first) / 1e3, 3) for e in events if sym in e.name]
                             for sym in symbols},
        "device_span_ms": round((t_last - t_first) / 1e3, 3),
        "pad": pad,
        "pad_traced": [len(head), len(tail)],
        "pad_gaps_ms": [round((t_first - max(head)) / 1e3, 3) if head else None,
                        round((min(tail) - t_last) / 1e3, 3) if tail else None],
    }
