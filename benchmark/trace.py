"""The traced stretch of a ``--trace 1`` run, read from ``torch.profiler``.

A stretch of ``trace_ticks`` ticks in the window's own form runs under the
profiler after the window.  The profiler loses events at the ends of a
trace, so the stretch is framed by pads of empty kernels
(``torch.cuda._sleep(0)``), each pad waited for, as the port's
``analysis/bench_record.profile`` frames its runs; the pads are left out of
every figure.

:func:`summarize` reduces the device events to what the per-layer readers
read: the union of the kernels' intervals (busy seconds: overlapping
kernels on several streams count once), each kernel's summed and per-launch
times by name, and the longest idle gaps between kernels with the host
operation that was running when each began.
"""
from __future__ import annotations

import time
from typing import Callable, List, Optional

import torch

PAD = 4096
PAD_SYMBOL = "spin_kernel"  # the kernel of torch.cuda._sleep


def _pad(n: int) -> None:
    for _ in range(n):
        torch.cuda._sleep(0)
    torch.cuda.synchronize()


def profile(run: Callable[[], None], n_ticks: int) -> Optional[dict]:
    """:func:`summarize` of ``run()`` (``n_ticks`` ticks) under the profiler."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _pad(PAD)
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        _pad(PAD)
    events = prof.events()
    dev = [(e.name, e.time_range.start, e.time_range.end) for e in events
           if e.device_type == torch.autograd.DeviceType.CUDA]
    host = [(e.name, e.time_range.start, e.time_range.end) for e in events
            if e.device_type == torch.autograd.DeviceType.CPU]
    return summarize(dev, host, n_ticks, wall)


def _union(intervals: List[tuple]) -> List[list]:
    merged: List[list] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def summarize(dev: List[tuple], host: List[tuple], n_ticks: int, wall: float) -> Optional[dict]:
    """The stretch's record from its device events and host events, each
    (name, start us, end us); None when no device event of the stretch was
    traced (nothing to read)."""
    dev = [d for d in dev if PAD_SYMBOL not in d[0]]
    if not dev:
        return None
    merged = _union([(s, e) for _, s, e in dev])
    busy_us = sum(e - s for s, e in merged)
    by_name: dict = {}
    for name, s, e in dev:
        tot = by_name.setdefault(name, [0.0, 0, []])
        tot[0] += e - s
        tot[1] += 1
        tot[2].append(e - s)
    gaps = [(merged[k + 1][0] - merged[k][1], merged[k][1]) for k in range(len(merged) - 1)]
    gaps.sort(reverse=True)
    labelled = []
    for length, at in gaps[:10]:
        running = [h for h in host if h[1] <= at <= h[2]]
        label = max(running, key=lambda h: h[1])[0] if running else "no host op"
        labelled.append([label, length / 1e6])
    return {
        "ticks": n_ticks,
        "wall_s": wall,
        "busy_s": busy_us / 1e6,
        "kernels": {k: {"total_s": v[0] / 1e6, "launches": v[1], "median_s": sorted(v[2])[len(v[2]) // 2] / 1e6}
                    for k, v in by_name.items()},
        "idle_gaps": labelled,
    }


def breakdown(summary: dict) -> dict:
    """The line's ``breakdown``: the ten device operations that took most
    time and the ten longest idle gaps, [name, seconds] each."""
    ops = sorted(((k, v["total_s"]) for k, v in summary["kernels"].items()), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, s] for k, s in ops], "idle_gaps": summary["idle_gaps"][:10]}
