"""Bilinear upsampling and average pooling over the spatial axes of NHWC
tensors.

Port of uncrtaints_tpu/ops/resize.py. The JAX package writes the bilinear
resize as two matmuls with [out, in] interpolation matrices (half-pixel
centres, edges clamped), a TPU lowering choice; that is exactly
``F.interpolate(mode="bilinear", align_corners=False)``, which is used here.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _nchw(x: torch.Tensor):
    lead, (H, W, C) = x.shape[:-3], x.shape[-3:]
    return lead, x.reshape(-1, H, W, C).permute(0, 3, 1, 2)


def _nhwc(y: torch.Tensor, lead) -> torch.Tensor:
    return y.permute(0, 2, 3, 1).reshape(*lead, *y.shape[-2:], y.shape[1])


def upsample_bilinear(x: torch.Tensor, out_hw: tuple) -> torch.Tensor:
    """x [..., H, W, C] -> [..., out_h, out_w, C], align_corners=False."""
    lead, xc = _nchw(x)
    y = F.interpolate(xc, size=tuple(out_hw), mode="bilinear",
                      align_corners=False, antialias=False)
    return _nhwc(y, lead)


def avg_pool2d(x: torch.Tensor, kernel: int) -> torch.Tensor:
    """Non-overlapping average pooling (stride == kernel) of [..., H, W, C]."""
    lead, xc = _nchw(x)
    return _nhwc(F.avg_pool2d(xc, kernel), lead)
