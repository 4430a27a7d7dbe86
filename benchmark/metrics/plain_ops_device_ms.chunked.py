"""plain_ops_device_ms.chunked: device ms a tick in kernels other than the hand-written
ones: the planner glue and a real-env step that is no kernel (the panda's) as plain torch ops."""
from benchmark.layers import plain_ops_device_ms


def read(ctx):
    return plain_ops_device_ms(ctx)
