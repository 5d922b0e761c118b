"""Host milliseconds a request spends in the step's call, from the call to
its return and before any synchronize, averaged over every request of the
timed window (tracing off: the profiler's own bookkeeping about doubles the
host's time). Read in the ``--trace 1`` run, whose timed window runs as in
any other."""


def read(ctx):
    if ctx.trace is None:
        return None
    host = ctx.window["host_s"]
    return 1e3 * sum(host) / len(host)
