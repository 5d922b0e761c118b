"""Device operations (kernels, copies, fills) a request in the traced window,
counted in the profiler's trace."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.device_ops:
        return None
    return len(ctx.trace.device_ops) / ctx.trace.requests
