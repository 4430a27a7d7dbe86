"""capture_s: seconds of the `graph.capture` spans, each program's CUDA graph captured and instantiated, summed
over the programs (s)."""
from benchmark import spans


def read(ctx):
    return spans.read("spans", "graph.capture", "total_s")
