"""tick_rate: replan+step ticks completed in the window over its seconds (ticks/s)."""


def read(ctx):
    return ctx["ticks"] / ctx["window_s"] if ctx["ticks"] else None
