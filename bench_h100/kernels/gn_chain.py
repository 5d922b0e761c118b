"""The eval group-norm MBConv's norm passes around its K3 -> K4 -> K3 chain
(csrc/norm.cu; models/blocks.py:MBConv._fused_group_body): K6's statistics
pass over the block's input (reads x; its [2,F,G] sums are not counted),
K6's apply pass of the last norm (reads x and its [F,C] coef and off,
writes x's shape) and the read-only pass that sums the squeeze-excitation's
pooled vector (reads x and the [F,G] / [C] norm vectors, writes the [F,C]
fp32 sums). Bound by bytes (their elementwise work is not counted as FLOPs,
as K6's)."""

from bench_h100.accounting import nbytes

OPS = ("uncrtaints::norm_stats", "uncrtaints::norm_apply", "uncrtaints::norm_gelu_pool")
FRAGMENTS = ("gelu_pool_part_kernel",)  # the statistics and apply passes run K6's kernels


def cost(op, shapes, dtypes, scalars):
    x = shapes[0]
    if op == "uncrtaints::norm_stats":
        return nbytes(x, dtypes[0]), 0
    small = sum(nbytes(s, d) for s, d in zip(shapes[1:], dtypes[1:]))
    if op == "uncrtaints::norm_apply":
        return 2 * nbytes(x, dtypes[0]) + small, 0
    return nbytes(x, dtypes[0]) + small + nbytes((x[0], x[-1]), "float"), 0
