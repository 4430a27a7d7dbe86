"""device_idle_pct.batch: 1 - (device seconds of the window's graph replays, between CUDA events)
/ (the window's seconds), in %, from the traced run's unprofiled window."""
from benchmark.layers import device_idle_pct


def read(ctx):
    return device_idle_pct(ctx)
