"""Adaptive max pooling over the spatial axes of NHWC tensors.

Port of uncrtaints_tpu/ops/pooling.py:adaptive_max_pool2d, whose point was
to reproduce ``nn.AdaptiveMaxPool2d``'s windows ``[floor(i*H/o),
ceil((i+1)*H/o))``; here that is the library op itself.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from uncrtaints_tpu_torch.parallel import mesh


def adaptive_max_pool2d(x: torch.Tensor, out_hw: tuple) -> torch.Tensor:
    """x [..., H, W, C] -> [..., oh, ow, C] (PyTorch adaptive windows).

    Under a spatial split x is a band of the scene and ``out_hw`` the
    scene's output: the windows then lie within a band only when the
    scene's rows are a multiple of oh and the band's a multiple of the
    window (H / oh); the band pools to its share of the rows. Anything else
    is refused."""
    lead, (H, W, C) = x.shape[:-3], x.shape[-3:]
    sp = mesh.spatial()
    if sp is not None:
        rows, oh = H * sp.n_spatial, out_hw[0]
        if rows % oh or H % (rows // oh):
            raise ValueError(f"adaptive_max_pool2d: a band of {H} of {rows} rows pooled to "
                             f"{oh} rows would split a window (the band's rows must be a "
                             f"multiple of {rows} / {oh})")
        out_hw = (H // (rows // oh), out_hw[1])
    xc = x.reshape(-1, H, W, C).permute(0, 3, 1, 2)  # NCHW view, NHWC memory
    y = F.adaptive_max_pool2d(xc, tuple(out_hw))
    return y.permute(0, 2, 3, 1).reshape(*lead, *y.shape[-2:], C)
