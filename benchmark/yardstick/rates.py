"""Rates, percentiles and chunk clocks, frozen for the benchmark.

:class:`ChunkClock` is a copy of the port's ``analysis/bench_record.py``
clock: on the card a mark is a CUDA event recorded on the current stream,
so marking makes no host sync, and the time between two marks is the
device timeline of one chunk of a chain of enqueued chunks.
"""
from __future__ import annotations

import statistics
import time
from typing import List, Optional

import torch


class ChunkClock:
    """Marks between chunks: CUDA events on the card, the host clock on the
    CPU (or with ``host=True``)."""

    def __init__(self, device: torch.device, host: bool = False) -> None:
        self.events = torch.device(device).type == "cuda" and not host
        self._marks: list = []

    def mark(self) -> None:
        if self.events:
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            self._marks.append(event)
        else:
            self._marks.append(time.perf_counter())

    def periods_s(self) -> List[float]:
        """Seconds between consecutive marks (after the work has ended)."""
        pairs = list(zip(self._marks, self._marks[1:]))
        if self.events:
            if self._marks:
                self._marks[-1].synchronize()
            return [a.elapsed_time(b) / 1e3 for a, b in pairs]
        return [b - a for a, b in pairs]


def rate(work: float, seconds: float) -> float:
    """Work over seconds: all the work and all the time of a window."""
    if seconds <= 0:
        raise ValueError(f"a window of {seconds} s")
    return work / seconds


def percentile(values, q: float) -> Optional[float]:
    """The ``q``-th percentile (0-100) of ``values``, linear between ranks
    (numpy's default), or None for no values."""
    xs = sorted(float(v) for v in values)
    if not xs:
        return None
    pos = (len(xs) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def spread(values) -> float:
    """The distance between the first and third quartiles over the median
    (``statistics.quantiles(values, n=4)``)."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med
