"""Seconds from the process's start to the first timed request: imports, the
kernels' build or load, weights and inputs, warm-up (and a train cell's
compared first steps)."""


def read(ctx):
    return ctx.setup_s
