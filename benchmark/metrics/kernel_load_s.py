"""kernel_load_s: seconds of the `kernels.load` span, the kernel library's build or load (s)."""
from benchmark import spans


def read(ctx):
    return spans.read("spans", "kernels.load", "total_s")
