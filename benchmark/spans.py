"""What the span metrics share: the program's own tracer
(``m3p2i_aip_tpu_torch.utils.profiling``), read once the run's check has
ended.

Its ``snapshot()`` keeps, per span and device span, the count and the total
and self seconds of the whole process (the set-up metrics sum these), and
the median over records it retains.  A per-tick or per-chunk metric takes
the median over the run's window alone, as the outside clocks it is held to
do: the newest records of its name less the traced stretch's, which ran
after the window under the profiler (:func:`ticks`, :func:`chunks`).  A
program without the tracer, a span that recorded nothing (a device span on
the CPU) or a window the tracer no longer holds reads None.
"""
from __future__ import annotations

from typing import Optional


def ticks(ctx: dict) -> tuple:
    """(last, skip) of a per-tick metric: one record a tick of the window,
    ahead of the traced stretch's ticks (run on the card only)."""
    return ctx["ticks"], ctx["trace"]["ticks"] if ctx.get("trace") else 0


def chunks(ctx: dict) -> tuple:
    """(last, skip) of a per-chunk metric: one record a chunk of the window,
    ahead of the traced stretch's one chunk (run on the card only)."""
    return len(ctx["chunk_s"]), 1 if ctx.get("trace") else 0


def read(kind: str, name: str, field: str, scale: float = 1.0, window: Optional[tuple] = None) -> Optional[float]:
    """``snapshot()[kind][name][field]`` times ``scale``, or None; over the
    ``window`` (last, skip) of records where given.  ``kind`` is ``"spans"``
    or ``"device"``."""
    try:
        from m3p2i_aip_tpu_torch.utils.profiling import snapshot
    except ImportError:
        return None
    last, skip = window or (None, 0)
    if last == 0:
        return None
    value = snapshot(last=last, skip=skip).get(kind, {}).get(name, {}).get(field)
    return None if value is None else scale * value
