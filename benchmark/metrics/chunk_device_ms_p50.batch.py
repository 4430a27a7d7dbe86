"""chunk_device_ms_p50.batch: the median device `chunk` span of the window's batched chunks, from before its
first replay to after its last view-row copy, between CUDA events (ms)."""
from benchmark import spans


def read(ctx):
    return spans.read("device", "chunk", "p50_s", 1e3, spans.chunks(ctx))
