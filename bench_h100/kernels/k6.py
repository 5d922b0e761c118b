"""K6, a norm (batch, group, instance; statistics or a given affine) with the
ReLU or GELU after it, forward (csrc/norm.cu): x -> y of x's shape and
dtype. Reads x once, writes y: bound by bytes (its elementwise work is not
counted as FLOPs)."""

from bench_h100.accounting import nbytes

OPS = ("uncrtaints::norm_act", "uncrtaints::norm_affine_act")
FRAGMENTS = ("norm_part_kernel", "norm_finalize_kernel", "norm_apply_kernel")


def cost(op, shapes, dtypes, scalars):
    return 2 * nbytes(shapes[0], dtypes[0]), 0
