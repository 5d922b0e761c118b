"""``<counter>_mb.<kind>``: the bytes the program's step counter ``<counter>``
added a request (``cast``: the dtype conversions and scale_by multiplies;
``reflect_pad``: the padded tensors of the eager reflect pad), in MB (1e6),
the median over the device window's requests. 0 where the program counted
none; None where it records no steps."""

import statistics

from bench_h100.metrics.device_ms import window_steps


def read(ctx):
    recs = window_steps(ctx)
    if recs is None:
        return None
    counter = ctx.name.split(".")[0][:-len("_mb")]
    return statistics.median(r.counters.get(counter, 0) for r in recs) / 1e6
