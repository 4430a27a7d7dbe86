"""setup_s: process start to the first timed tick (s)."""


def read(ctx):
    return ctx["setup_s"]
