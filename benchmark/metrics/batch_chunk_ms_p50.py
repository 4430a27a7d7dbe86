"""batch_chunk_ms_p50: the median batched chunk, between CUDA events recorded
as each chunk is enqueued (the fetch and the host drain included) (ms)."""
from benchmark.layers import median_ms


def read(ctx):
    return median_ms(ctx["chunk_s"])
