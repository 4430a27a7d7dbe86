"""enqueue_ms_p50.chunked: the median `tamp.chunk` span of the window's chunks, the host's side of a chunk (each
replay's launch and view-row copy, the copies in and out) (ms a chunk)."""
from benchmark import spans


def read(ctx):
    return spans.read("spans", "tamp.chunk", "p50_s", 1e3, spans.chunks(ctx))
