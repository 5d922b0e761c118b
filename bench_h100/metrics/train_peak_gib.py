"""The most device memory allocated at once during the window
(``torch.cuda.max_memory_allocated``, reset at its start), in GiB."""


def read(ctx):
    return ctx.window_peak / 2**30 if ctx.window_peak else None
