"""k1_roofline_pct: the yardstick's bound over K1's median launch in the trace, in %."""
from benchmark.layers import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "point_rollout_kernel", "rollout")
