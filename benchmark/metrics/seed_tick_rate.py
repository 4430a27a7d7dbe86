"""seed_tick_rate: seeds x batched ticks completed in the window over its seconds (seed-ticks/s)."""


def read(ctx):
    return ctx["ticks"] * ctx["seeds_per_tick"] / ctx["window_s"] if ctx["ticks"] else None
