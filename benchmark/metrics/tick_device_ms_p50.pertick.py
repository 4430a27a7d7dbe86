"""tick_device_ms_p50.pertick: the median device `tick` span of the window's ticks, the replay of the compiled
tick between CUDA events (ms)."""
from benchmark import spans


def read(ctx):
    return spans.read("device", "tick", "p50_s", 1e3, spans.ticks(ctx))
