"""Planner-rate counters and device traces.

Port of ``m3p2i_aip_tpu/utils/profiling.py``.  The reference's only
instrumentation is the per-tick FPS print of ``skill_utils.time_tracking``
and the rate columns of its experiment logs.  Here:

  * :class:`RateTracker`: rolling planner Hz and rollout env-steps per
    second, fed one ``tick()`` per control tick;
  * :func:`trace`: a ``torch.profiler`` trace (host and, on a GPU, device
    activity) written for TensorBoard.
"""
from __future__ import annotations

import collections
import contextlib
import os
import tempfile
import time
from typing import Optional

import torch


class RateTracker:
    """Rolling-window rates: planner Hz and env steps a second (K x T a replan)."""

    def __init__(self, window: int = 50, env_steps_per_replan: int = 0):
        self._times = collections.deque(maxlen=window)
        self.env_steps_per_replan = env_steps_per_replan
        self._last: Optional[float] = None

    def tick(self) -> None:
        now = time.perf_counter()
        if self._last is not None:
            self._times.append(now - self._last)
        self._last = now

    @property
    def hz(self) -> float:
        if not self._times:
            return 0.0
        return len(self._times) / sum(self._times)

    @property
    def env_steps_per_sec(self) -> float:
        """Rollout throughput: the replan rate x K samples x T horizon steps."""
        return self.hz * self.env_steps_per_replan

    def summary(self) -> dict:
        return {"planner_hz": round(self.hz, 2), "env_steps_per_sec": round(self.env_steps_per_sec, 1)}


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
