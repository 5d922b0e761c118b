"""K6-bwd, the backward of a norm with its activation (csrc/norm.cu): reads g
and x once, writes dx (the per-channel sums are small). Bound by bytes."""

from bench_h100.accounting import nbytes

OPS = ("uncrtaints::norm_act_bwd", "uncrtaints::norm_affine_act_bwd")
FRAGMENTS = ("norm_bwd_finalize_kernel", "norm_dx_kernel")


def cost(op, shapes, dtypes, scalars):
    g, x = shapes[0], shapes[1]
    return nbytes(g, dtypes[0]) + 2 * nbytes(x, dtypes[1]), 0
