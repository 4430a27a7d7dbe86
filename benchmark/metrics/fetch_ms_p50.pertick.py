"""fetch_ms_p50.pertick: the median `loop.fetch` span of the window's ticks, the view row's copy to the host,
waiting for the tick's device work (ms)."""
from benchmark import spans


def read(ctx):
    return spans.read("spans", "loop.fetch", "p50_s", 1e3, spans.ticks(ctx))
