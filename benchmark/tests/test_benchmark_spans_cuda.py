"""On the card (``M3P2I_TEST_CUDA=1``): the program's spans against the
benchmark's outside clocks in the same traced runs, and the spans kept off
the profiler's device timeline.

    M3P2I_TEST_CUDA=1 python -m pytest benchmark/tests/test_benchmark_spans_cuda.py -q -s

Each cell runs once as the benchmark runs it: ``benchmark/run.py --trace 1``
in a fresh process, with the mix's warm-up and the benchmark's window, so
the span metrics read what the benchmark's traced run reads (the window's
records alone).  The child also reports ``setup_s``, which a traced line
leaves out, and every span name it recorded.  Then a loop of each cell
profiles its traced stretch four times in this process, in turns as the
program runs and with the tracer held to its ring (no span on the
profiler's timeline, no device span: what a program without the tracer
shows the profiler).  The lines print with ``-s``.
"""
from __future__ import annotations

import contextlib
import json
import os
import pathlib
import subprocess
import sys
import time

import pytest

CELLS = ("point-pushpull-pertick", "point-pushpull-chunked")
SEED = 2147483901
ROOT = pathlib.Path(__file__).resolve().parents[2]

# one traced benchmark run, with the set-up's seconds taken as the warm-up
# begins and the names of every span the process recorded
CHILD = """
import json, sys, time
from benchmark import run as run_mod
from benchmark.loops import Loop
from m3p2i_aip_tpu_torch.utils import profiling
got, warm = {}, Loop.warm
def timed_warm(self):
    got["setup_s"] = time.perf_counter() - run_mod.T_START
    warm(self)
Loop.warm = timed_warm
got["line"] = run_mod.run(sys.argv[1:])
snap = profiling.snapshot()
got["names"] = sorted(set(snap["spans"]) | set(snap["device"]))
print("SPANS " + json.dumps(got))
"""


def _traced(cell: str, seconds: float) -> dict:
    out = subprocess.run([sys.executable, "-c", CHILD, "--workload", cell, "--seed", str(SEED), "--seconds",
                          str(seconds), "--trace", "1"], cwd=ROOT, capture_output=True, text=True, timeout=600)
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith("SPANS ")]
    assert out.returncode == 0 and lines, out.stderr[-4000:]
    return json.loads(lines[-1][len("SPANS "):])


def _stretches(cell: str) -> dict:
    """The traced stretch of a fresh loop of ``cell``, profiled four times
    from the settled scene with one planner seed, so that each runs the same
    ticks, after one unprofiled run of it, so that each starts with the same
    cached task parameters: ``{ring_only: [(device event names, wall s),
    ...]}``."""
    import torch

    from benchmark import spec as spec_mod, trace as trace_mod
    from benchmark.loops import cloned
    from m3p2i_aip_tpu_torch.utils import profiling

    spec = spec_mod.load()
    w = spec_mod.cell(spec, cell)
    traffic = spec_mod.traffic(w)
    loop = spec_mod.loop(traffic["loop"])(spec_mod.config_file(spec, w), traffic, SEED + 1, torch.device("cuda"))
    loop.setup()
    n = int(traffic["trace_ticks"])
    out: dict = {False: [], True: []}
    summarize = trace_mod.summarize
    for rep in range(-1, 4):
        ring_only = bool(rep % 2)
        with pytest.MonkeyPatch.context() as mp:
            def kept(dev, host, n_ticks, wall):
                out[ring_only].append(({d[0] for d in dev if trace_mod.PAD_SYMBOL not in d[0]}, wall))
                return summarize(dev, host, n_ticks, wall)

            mp.setattr(trace_mod, "summarize", kept)
            if ring_only:
                mp.setattr(profiling, "HOST_ONLY", frozenset())
                mp.setattr(profiling, "device_span", lambda *args: contextlib.nullcontext())
            loop.loop.reset(SEED + 2)
            loop.loop.state = cloned(loop.settled)
            if rep < 0:
                loop.trace_run(n)
            else:
                trace_mod.profile(lambda: loop.trace_run(n), n)
    loop.close()
    return out


@pytest.fixture(scope="module")
def runs():
    if os.environ.get("M3P2I_TEST_CUDA", "") != "1":
        pytest.skip("the benchmark's card tests run with M3P2I_TEST_CUDA=1")
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    from benchmark import spec as spec_mod
    from m3p2i_aip_tpu_torch.utils import profiling

    out: dict = {}
    names: set = set()  # every span and device span name the runs recorded
    seconds = float(spec_mod.load()["run_seconds"])
    for cell in CELLS:
        r = out[cell] = _traced(cell, seconds)
        names.update(r["names"])
        print(f"\n[spans {cell}] setup_s {r['setup_s']:.3f}, correct {r['line']['correct']}, "
              + ", ".join(f"{k} {v['value']:.4f}" for k, v in sorted(r["line"]["metrics"].items())))
        print(f"[spans {cell}] idle gaps {r['line']['breakdown']['idle_gaps']}")
    for cell in CELLS:
        out[cell, "stretches"] = _stretches(cell)
        snap = profiling.snapshot()
        names.update(snap["spans"], snap["device"])
        walls = {k: [round(w * 1e3, 3) for _, w in v] for k, v in out[cell, "stretches"].items()}
        print(f"\n[spans {cell}] profiled stretch ms, as the program runs {walls[False]}, ring only {walls[True]}")
    out["span names"] = names
    return out


def _value(run: dict, name: str) -> float:
    return run["line"]["metrics"][name]["value"]


@pytest.mark.cuda
def test_the_chunks_device_span_agrees_with_the_chunk_clock(runs):
    r = runs["point-pushpull-chunked"]
    assert r["line"]["correct"]
    assert _value(r, "chunk_device_ms_p50.chunked") == pytest.approx(_value(r, "chunk_ms_p50"), rel=0.02)


@pytest.mark.cuda
def test_a_ticks_parts_agree_with_its_host_clock(runs):
    r = runs["point-pushpull-pertick"]
    tick = _value(r, "tick_ms_p50.pertick")
    assert _value(r, "tick_device_ms_p50.pertick") <= tick
    parts = sum(_value(r, f"{p}_ms_p50.pertick") for p in ("plan", "launch", "fetch", "observe"))
    assert parts == pytest.approx(tick, rel=0.10)


@pytest.mark.cuda
def test_a_chunks_enqueue_runs_ahead_of_the_device(runs):
    """In the benchmark's own process, the host enqueues a point chunk in a
    small part of the chunk's device time (it does not wait in the launch)."""
    r = runs["point-pushpull-chunked"]
    assert 0 < _value(r, "enqueue_ms_p50.chunked") < 0.1 * _value(r, "chunk_ms_p50")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_set_up_spans_fit_in_the_set_up(runs, cell):
    r = runs[cell]
    parts = sum(_value(r, name) for name in ("kernel_load_s", "first_run_s", "capture_s"))
    assert 0 < parts <= r["setup_s"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_no_span_reaches_the_device_timeline(runs, cell):
    stretches, names = runs[cell, "stretches"], runs["span names"]
    assert {"tamp.plan", "tamp.tick", "tamp.chunk", "loop.fetch", "loop.observe", "loop.drain", "tick", "chunk"} <= names
    seen = [got for got, _ in stretches[False] + stretches[True]]
    union = set().union(*seen)
    print(f"\n[spans {cell}] device event names: {len(union)}; not in every stretch: "
          f"{sorted(n[:60] for n in union - set.intersection(*seen))}")
    assert not union & names
    assert all(got == seen[0] for got in seen)
    assert not {name for name, _ in runs[cell]["line"]["breakdown"]["device_ops"]} & names


@pytest.mark.cuda
def test_the_off_cost_of_a_tick_is_small(runs):
    """Four host spans and one device span a per-tick round trip, timed with
    the profiler off, against a quarter of the per-tick cell's 10% bound."""
    import torch

    from m3p2i_aip_tpu_torch.utils import profiling

    tr, n, dev = profiling.Tracer(), 20000, torch.device("cuda", torch.cuda.current_device())
    t0 = time.perf_counter()
    for i in range(n):
        with tr.span("tamp.plan", i):
            pass
    span_us = (time.perf_counter() - t0) / n * 1e6
    t0 = time.perf_counter()
    for i in range(n):
        with tr.device_span("tick", i, dev):
            pass
    device_us = (time.perf_counter() - t0) / n * 1e6
    tr.snapshot()
    tick_us = 1e3 * _value(runs["point-pushpull-pertick"], "tick_ms_p50.pertick")
    cost = 4 * span_us + device_us
    print(f"\n[spans off cost] {span_us:.3f} us a span, {device_us:.3f} us a device span, {cost:.3f} us a tick "
          f"of {tick_us:.1f} us ({100 * cost / tick_us:.3f}%)")
    assert cost < 0.025 * tick_us
