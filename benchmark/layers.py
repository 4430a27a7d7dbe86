"""Readings the per-layer metrics share: a kernel's roofline share, the
device time outside the hand-written kernels, the device's idle share.

``ctx`` is the run's record (``run.py``): the window (``window_s``,
``ticks``, ``seeds_per_tick``, ``tick_s``, ``chunk_s``, and in a traced
run ``replay_s``, the device seconds of its graph replays), the traced
stretch's summary (``trace``, ``benchmark/trace.py``), the compiled tick's
``graph_nodes``, and the yardstick's ``bounds`` of the sampled ticks'
kernel calls.  Each returns None where the run has nothing to read.
"""
from __future__ import annotations

import statistics
from typing import Optional

# the port's hand-written kernels, by their symbols in a trace (csrc/*.cu)
KERNEL_SYMBOLS = ("point_rollout_kernel", "multimodal_weights_kernel", "panda_rollout_kernel",
                  "albert_rollout_kernel", "point_env_step_kernel")


def kernel_median_s(ctx: dict, symbol: str) -> Optional[float]:
    """The median device time of one launch of ``symbol`` in the trace."""
    tr = ctx.get("trace")
    if not tr:
        return None
    times = [v["median_s"] for k, v in tr["kernels"].items() if symbol in k]
    return times[0] if len(times) == 1 else None


def roofline_pct(ctx: dict, symbol: str, bound_kind: str) -> Optional[float]:
    """The yardstick's bound (median over the sampled ticks' calls) over the
    kernel's median launch in the trace, in %."""
    bounds = ctx.get("bounds", {}).get(bound_kind) or []
    t = kernel_median_s(ctx, symbol)
    if not bounds or not t:
        return None
    return 100.0 * statistics.median(bounds) / (t * 1e3)


# device events of the trace that are copies or fills, not kernels
NOT_KERNELS = ("Memcpy", "Memset")


def plain_ops_device_ms(ctx: dict) -> Optional[float]:
    """Device ms a tick in kernels that are none of the port's hand-written
    kernels: the plain torch ops of the planner's glue and of a real-env
    step that is no kernel (the panda's), copies and fills left out."""
    tr = ctx.get("trace")
    if not tr:
        return None
    total = sum(v["total_s"] for k, v in tr["kernels"].items()
                if not any(s in k for s in KERNEL_SYMBOLS) and not k.startswith(NOT_KERNELS))
    return 1e3 * total / tr["ticks"]


def device_idle_pct(ctx: dict) -> Optional[float]:
    """1 - (the device's busy seconds in the window) / (the window's
    seconds), in %, from the traced run's own unprofiled window: the busy
    seconds are those between the CUDA events recorded around every graph
    replay there (``replay_s``).  Device work outside the replays (the
    copies of each tick's view row, an episode's reset, the fetches) counts
    as idle.  Not the profiler's busy time: the profiler lengthens each of
    a tick's thousands of kernels, and its busy time a tick read above the
    unprofiled window's wall a tick."""
    busy = ctx.get("replay_s")
    if not busy or not ctx.get("window_s"):
        return None
    return 100.0 * (1.0 - busy / ctx["window_s"])


def median_ms(values) -> Optional[float]:
    return 1e3 * statistics.median(values) if values else None
