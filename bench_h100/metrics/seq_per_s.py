"""``<cell kind>_seq_per_s``: sequences completed per second, every request
or step the timed window completed times its batch, over the window's whole
time to the synchronize that ends it (host clock). One reader for every
cell; a cell whose runs spread differently from another's gets a name of its
own in BENCHMARK.json, so that each keeps a bound of its own."""


def read(ctx):
    w = ctx.window
    return w["requests"] * ctx.traffic["batch"] / (w["t1"] - w["t0"])
