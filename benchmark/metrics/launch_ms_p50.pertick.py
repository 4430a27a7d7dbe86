"""launch_ms_p50.pertick: the median `tamp.tick` span of the window's ticks, the host's side of one compiled tick
(the copies in, the counter, the replay's launch, the carry and outputs cloned out) (ms)."""
from benchmark import spans


def read(ctx):
    return spans.read("spans", "tamp.tick", "p50_s", 1e3, spans.ticks(ctx))
