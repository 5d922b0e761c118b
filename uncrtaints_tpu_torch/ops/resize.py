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

from uncrtaints_tpu_torch.parallel import mesh


def _nchw(x: torch.Tensor):
    lead, (H, W, C) = x.shape[:-3], x.shape[-3:]
    return lead, x.reshape(-1, H, W, C).permute(0, 3, 1, 2)


def _nhwc(y: torch.Tensor, lead) -> torch.Tensor:
    return y.permute(0, 2, 3, 1).reshape(*lead, *y.shape[-2:], y.shape[1])


def upsample_bilinear(x: torch.Tensor, out_hw: tuple) -> torch.Tensor:
    """x [..., H, W, C] -> [..., out_h, out_w, C], align_corners=False.

    Under a spatial split x is a band of the scene and ``out_hw`` the
    band's output, an integer multiple f of its rows: the band takes one
    row from each neighbour (at the scene's edge its own edge row again,
    which is the clamp of the bilinear rule there), is upsampled by f and
    cropped to its own rows. Another ratio is refused."""
    sp = mesh.spatial()
    if sp is not None:
        h, oh = x.shape[-3], out_hw[0]
        if oh % h:
            raise ValueError(f"upsample_bilinear: a band of {h} rows to {oh} is not an "
                             f"integer factor")
        f = oh // h
        top, bot = mesh.halo_exchange(x, 1, -3, sp)
        x = torch.cat([x.narrow(-3, 0, 1) if top is None else top, x,
                       x.narrow(-3, h - 1, 1) if bot is None else bot], dim=-3)
        return _bilinear(x, ((h + 2) * f, out_hw[1])).narrow(-3, f, oh)
    return _bilinear(x, out_hw)


def _bilinear(x: torch.Tensor, out_hw: tuple) -> torch.Tensor:
    """:func:`upsample_bilinear` of a whole map (no spatial split)."""
    lead, xc = _nchw(x)
    y = F.interpolate(xc, size=tuple(out_hw), mode="bilinear",
                      align_corners=False, antialias=False)
    return _nhwc(y, lead)


def avg_pool2d(x: torch.Tensor, kernel: int) -> torch.Tensor:
    """Non-overlapping average pooling (stride == kernel) of [..., H, W, C];
    under a spatial split the band's rows must be a multiple of ``kernel``."""
    if mesh.spatial() is not None and x.shape[-3] % kernel:
        raise ValueError(f"avg_pool2d: a band of {x.shape[-3]} rows is not a multiple of the "
                         f"window {kernel}")
    lead, xc = _nchw(x)
    return _nhwc(F.avg_pool2d(xc, kernel), lead)
