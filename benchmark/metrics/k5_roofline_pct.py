"""k5_roofline_pct: the yardstick's bound over K5's median launch in the trace, in %:
the point family's real-env step, one state a launch."""
from benchmark.layers import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "point_env_step_kernel", "step")
