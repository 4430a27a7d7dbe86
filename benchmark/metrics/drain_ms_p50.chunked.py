"""drain_ms_p50.chunked: the median `loop.drain` span of the window's chunks, a fetched chunk's views unpacked,
observed, checked and logged on the host (ms a chunk)."""
from benchmark import spans


def read(ctx):
    return spans.read("spans", "loop.drain", "p50_s", 1e3, spans.chunks(ctx))
