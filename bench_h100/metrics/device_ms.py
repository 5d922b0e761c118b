"""``<section>_device_ms.<kind>``: a section's self time on the device clock,
in ms a request: the median, over the device window's requests, of the
elapsed time of the section's spans (the program's ``uncrtaints.<section>``
timing events), less the spans they contain, summed over the step.
``other_device_ms`` is the step span's own time less all its sections'. A
section's time runs from its first queued operation's start to its last
one's end, idle gaps inside it included. None without a trace, on the CPU
(no events), or where the program records no steps."""

import statistics


def window_steps(ctx):
    """The program's step records of the device window's requests: the first
    ``ctx.trace.requests`` records that started after the timed window (the
    request between the timed window and the device window runs with no
    profiler and makes none). None where there are fewer."""
    if ctx.trace is None:
        return None
    try:
        from uncrtaints_tpu_torch import tracing
    except ImportError:  # a program without step records
        return None
    recs = [r for r in tracing.steps() if r.t0 > ctx.window["t1"]][:ctx.trace.requests]
    return recs if recs and len(recs) == ctx.trace.requests else None


def self_ms(rec):
    """{section: self ms} of one step record ("other": the step's own)."""
    ms = [sp.device_ms() for sp in rec.spans]
    if any(m is None for m in ms):
        return None
    own = list(ms)
    for sp, m in zip(rec.spans, ms):
        if sp.parent is not None:
            own[sp.parent] -= m
    out = {}
    for i, sp in enumerate(rec.spans):
        name = "other" if i == 0 else sp.name
        out[name] = out.get(name, 0.0) + own[i]
    return out


def read(ctx):
    recs = window_steps(ctx)
    if recs is None:
        return None
    section = ctx.name.split(".")[0][:-len("_device_ms")]
    per = [self_ms(r) for r in recs]
    if any(p is None for p in per) or not any(section in p for p in per):
        return None
    return statistics.median(p.get(section, 0.0) for p in per)
