"""first_run_s: self seconds of the `graph.first_run` spans, each compiled program's eager warm-up before its
capture, less the kernel library's load inside it, summed over the programs (s)."""
from benchmark import spans


def read(ctx):
    return spans.read("spans", "graph.first_run", "self_s")
