"""k4_roofline_pct: the yardstick's bound over K4's median launch in the trace, in %."""
from benchmark.layers import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "albert_rollout_kernel", "rollout")
