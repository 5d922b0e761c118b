"""K1-bwd, the backward of att_group (csrc/aggregate.cu): dx = attn * g and
dattn = the sum over each head's channels of x * g. Reads x, attn and g once,
writes dx and dattn; 2 FLOPs a product for each of the two."""

import math

from bench_h100.accounting import nbytes

OPS = ("uncrtaints::att_group_aggregate_bwd",)
FRAGMENTS = ("att_group_bwd_kernel",)


def cost(op, shapes, dtypes, scalars):
    (x, attn, g), (dx, da, dg) = shapes[:3], dtypes[:3]
    moved = 2 * nbytes(x, dx) + 2 * nbytes(attn, da) + nbytes(g, dg)
    return moved, 4 * math.prod(x)
