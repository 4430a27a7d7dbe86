"""tick_p95_ms: the 95th percentile of every tick's host time in the window, from the
task planner's view to the fetched next view (ms)."""
from benchmark.yardstick.rates import percentile


def read(ctx):
    p = percentile(ctx["tick_s"], 95)
    return None if p is None else 1e3 * p
