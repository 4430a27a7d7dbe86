"""graph_nodes.chunked: nodes of the CUDA graph of the compiled tick the window replays."""


def read(ctx):
    return ctx.get("graph_nodes")
