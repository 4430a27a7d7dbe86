"""chunk_ms_p50: the median chunk's device timeline between CUDA events recorded
as the chunks are enqueued (ms)."""
from benchmark.layers import median_ms


def read(ctx):
    return median_ms(ctx["chunk_s"])
