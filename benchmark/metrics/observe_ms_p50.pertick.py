"""observe_ms_p50.pertick: the median `loop.observe` span of the window's ticks, the fetched view unpacked, the
host success check and the log row (ms)."""
from benchmark import spans


def read(ctx):
    return spans.read("spans", "loop.observe", "p50_s", 1e3, spans.ticks(ctx))
