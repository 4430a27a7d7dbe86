"""step_nodes.chunked: nodes that the real-env step adds to the compiled tick the window replays (the program's
counter `graph.step_nodes`, read at the newest capture; None in a program without it)."""
from benchmark import spans


def read(ctx):
    return spans.read("counters", "graph.step_nodes", "last")
