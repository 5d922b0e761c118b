"""``eval_p95_ms`` and ``p95_ms.<cell>``: the 95th percentile (nearest rank)
of the latency of every request of the timed window, from the call to the
end of the synchronize that ends it, in ms. ``p95_ms.<cell>`` is the
per-layer form, for a cell whose tail is too unsteady for an end-to-end
bound (each request paced by the host)."""

import math


def read(ctx):
    lat = sorted(ctx.window["latency_s"])
    return 1e3 * lat[math.ceil(0.95 * len(lat)) - 1]
