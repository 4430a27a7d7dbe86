"""plain_ops_device_ms.chunked: device ms a tick in kernels other than the hand-written
ones: the real-env step and the planner glue as plain torch ops."""
from benchmark.layers import plain_ops_device_ms


def read(ctx):
    return plain_ops_device_ms(ctx)
