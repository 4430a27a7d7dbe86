"""k2b_roofline_pct: the yardstick's bound over K2b's median launch in the trace, in %."""
from benchmark.layers import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "multimodal_weights_kernel", "weights")
