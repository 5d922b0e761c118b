"""K3, norm + GELU (+ squeeze-excitation gate) + 1x1 conv as one GEMM with
its prologue and epilogue (csrc/norm_gelu_matmul.cu): x [N,P,C] @ w [C,C2]
-> [N,P,C2] in x's dtype. Reads x, w and the gate once, writes the output;
2 FLOPs a multiply-add of the GEMM."""

from bench_h100.accounting import nbytes

OPS = ("uncrtaints::norm_gelu_matmul",)
FRAGMENTS = ("ngm_kernel", "ngm_wg_kernel")


def cost(op, shapes, dtypes, scalars):
    x, w, se = shapes[0], shapes[5], shapes[6]
    N, P, C = x
    C2 = w[1]
    moved = nbytes(x, dtypes[0]) + nbytes(w, dtypes[5]) + nbytes((N, P, C2), dtypes[0])
    if se:
        moved += nbytes(se, dtypes[6])
    return moved, 2 * N * P * C * C2
