"""Adaptive max pooling over the spatial axes of NHWC tensors.

Port of uncrtaints_tpu/ops/pooling.py:adaptive_max_pool2d, whose point was
to reproduce ``nn.AdaptiveMaxPool2d``'s windows ``[floor(i*H/o),
ceil((i+1)*H/o))``; here that is the library op itself.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def adaptive_max_pool2d(x: torch.Tensor, out_hw: tuple) -> torch.Tensor:
    """x [..., H, W, C] -> [..., oh, ow, C] (PyTorch adaptive windows)."""
    lead, (H, W, C) = x.shape[:-3], x.shape[-3:]
    xc = x.reshape(-1, H, W, C).permute(0, 3, 1, 2)  # NCHW view, NHWC memory
    y = F.adaptive_max_pool2d(xc, tuple(out_hw))
    return y.permute(0, 2, 3, 1).reshape(*lead, *y.shape[-2:], C)
