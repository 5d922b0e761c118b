"""K2, the depthwise convolution's weight gradient (csrc/dwgrad.cu): the sum
over N, H, W of x * g at each tap -> [C,1,kh,kw] in fp32. Reads x and g
once; 2 FLOPs a tap of each output of g (kh, kw from the call, 3x3 where
the trace does not give them)."""

import math

from bench_h100.accounting import nbytes

OPS = ("uncrtaints::dw_kernel_grad", "uncrtaints::dw_kernel_grad_halo")
FRAGMENTS = ("dw_grad_tile_kernel", "dw_grad_direct_kernel", "dw_grad_reduce_kernel")


def cost(op, shapes, dtypes, scalars):
    x, g = shapes[0], shapes[1]
    taps = 9
    if op == "uncrtaints::dw_kernel_grad" and len(scalars) > 4:
        try:
            taps = int(scalars[3]) * int(scalars[4])
        except (TypeError, ValueError):
            pass
    return nbytes(x, dtypes[0]) + nbytes(g, dtypes[1]), 2 * taps * math.prod(g)
