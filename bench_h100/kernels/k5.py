"""K5, the depthwise stencil (csrc/dwconv.cu): the train step's 3x3 reflect
convolution and its folded adjoint (the input gradient), x [N,H,W,C] ->
[N,H,W,C]. Reads x once, writes the output; 2 FLOPs a tap (taps from the
weight [C,1,kh,kw])."""

import math

from bench_h100.accounting import nbytes

OPS = ("uncrtaints::dw_stencil", "uncrtaints::dw_stencil_halo",
       "uncrtaints::dw_stencil_halo_adjoint")
FRAGMENTS = ("dw_tile_kernel", "dw_direct_kernel", "dw_adjoint_frame_kernel",
             "dw_adjoint_halo_kernel")


def cost(op, shapes, dtypes, scalars):
    x, w = shapes[0], shapes[1]
    return 2 * nbytes(x, dtypes[0]), 2 * math.prod(w[-2:]) * math.prod(x)
