"""The step's share of the card's dense bf16 peak: the FLOPs of one request
(the reference's matrix products and convolutions on the meta device,
accounting.request_flops) times the requests of the timed window, over the
window's time times the peak, in %. Read in the ``--trace 1`` run, from its
timed window (tracing off), so the profiler's cost does not lower it."""

from bench_h100 import accounting


def read(ctx):
    if ctx.trace is None:
        return None
    w = ctx.window
    flops = accounting.request_flops(ctx.config, ctx.traffic, ctx.shapes)
    return 100.0 * flops * w["requests"] / ((w["t1"] - w["t0"]) * ctx.card["bf16_flops"])
