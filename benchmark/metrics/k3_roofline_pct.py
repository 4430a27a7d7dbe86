"""k3_roofline_pct: the yardstick's bound over K3's median launch in the trace, in %."""
from benchmark.layers import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "panda_rollout_kernel", "rollout")
