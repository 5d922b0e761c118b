"""K1, att_group temporal aggregation (csrc/aggregate.cu), forward:
out[b,h,w,c] = sum_t attn[b,t,h,w,head(c)] * x[b,t,h,w,c]. Reads x and
attn once, writes out; 2 FLOPs a term of the sum."""

import math

from bench_h100.accounting import nbytes

OPS = ("uncrtaints::att_group_aggregate",)
FRAGMENTS = ("att_group_kernel", "att_group_bulk_kernel")


def cost(op, shapes, dtypes, scalars):
    (x, attn), (dx, da) = shapes[:2], dtypes[:2]
    out = [x[0]] + list(x[2:])
    return nbytes(x, dx) + nbytes(attn, da) + nbytes(out, dx), 2 * math.prod(x)

