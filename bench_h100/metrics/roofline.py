"""``<kernel>_roofline``: a hand-written kernel family's share of its
roofline in the traced window, the sum over its calls of the least time the
card needs (accounting.bound_seconds of the family's own byte and FLOP
counts at the call's shapes) over the sum of the device time the calls
took, in %. ``kernels_roofline`` takes every family of ``kernels/``
together. None where the window called none of them. Where the trace has no
dtypes for a call, its tensors count in the configuration's dtype."""

from bench_h100 import accounting


def read(ctx):
    if ctx.trace is None:
        return None
    fam = ctx.name.split(".")[0][:-len("_roofline")]
    mods = list(ctx.kernels.values()) if fam == "kernels" else [ctx.kernels[fam]]
    bound = took = 0.0
    for call in ctx.trace.kernel_calls:
        mod = next((k for k in mods if call["op"] in k.OPS), None)
        if mod is None:
            continue
        dtypes = call["dtypes"] or [ctx.config["dtype"]] * len(call["shapes"])
        nbytes, flops = mod.cost(call["op"], call["shapes"], dtypes, call["scalars"])
        bound += accounting.bound_seconds(ctx.card, nbytes, flops)
        took += call["device_s"]
    return 100.0 * bound / took if took > 0 else None
