"""Operators of the port: the hand-written kernels (with their plain
versions) and the plain-PyTorch ops around them."""

from uncrtaints_tpu_torch.ops.aggregate import (  # noqa: F401
    att_group_aggregate, att_group_aggregate_bwd, att_group_aggregate_bwd_plain,
    att_group_aggregate_plain)
from uncrtaints_tpu_torch.ops.dwconv import dw_stencil, dw_stencil_plain  # noqa: F401
from uncrtaints_tpu_torch.ops.dwgrad import (  # noqa: F401
    dw_kernel_grad, dw_kernel_grad_plain)
from uncrtaints_tpu_torch.ops.mbconv import (  # noqa: F401
    norm_gelu_matmul, norm_gelu_matmul_plain)
from uncrtaints_tpu_torch.ops.pooling import adaptive_max_pool2d  # noqa: F401
from uncrtaints_tpu_torch.ops.resize import avg_pool2d, upsample_bilinear  # noqa: F401
from uncrtaints_tpu_torch.ops.ssim import ssim  # noqa: F401
