"""K4, norm + GELU + reflect-padded depthwise 3x3 conv, with the pooled sum
of the next norm's GELU for the squeeze-excitation (csrc/norm_gelu_dwconv.cu):
x [N,H,W,C] -> [N,H,W,C]. Reads x once, writes the output; 2 FLOPs a tap."""

import math

from bench_h100.accounting import nbytes

OPS = ("uncrtaints::norm_gelu_dwconv3x3", "uncrtaints::norm_gelu_dwconv3x3_halo")
FRAGMENTS = ("ngd_tile_kernel",)


def cost(op, shapes, dtypes, scalars):
    x = shapes[0]
    return 2 * nbytes(x, dtypes[0]), 18 * math.prod(x)
