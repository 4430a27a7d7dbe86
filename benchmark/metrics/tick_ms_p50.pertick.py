"""tick_ms_p50.pertick: the median tick's host time, as tick_p95_ms (ms)."""
from benchmark.layers import median_ms


def read(ctx):
    return median_ms(ctx["tick_s"])
