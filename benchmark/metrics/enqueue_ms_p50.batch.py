"""enqueue_ms_p50.batch: the median `tamp.chunk` span of the window's batched chunks, the host's side of its
replays and view-row copies (ms a chunk)."""
from benchmark import spans


def read(ctx):
    return spans.read("spans", "tamp.chunk", "p50_s", 1e3, spans.chunks(ctx))
