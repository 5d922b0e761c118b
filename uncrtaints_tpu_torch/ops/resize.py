"""Bilinear upsampling and average pooling over the spatial axes of NHWC
tensors.

Port of uncrtaints_tpu/ops/resize.py. The JAX package writes the bilinear
resize as two matmuls with [out, in] interpolation matrices (half-pixel
centres, edges clamped), a TPU lowering choice; that is exactly
``F.interpolate(mode="bilinear", align_corners=False)``, which is used here.
Its backward is written here as those matmuls' adjoint (:class:`_Bilinear`).
"""

from __future__ import annotations

import functools

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
    if torch.is_grad_enabled() and xc.requires_grad:
        y = _Bilinear.apply(xc, tuple(out_hw))
    else:
        y = _interpolate(xc, tuple(out_hw))
    return _nhwc(y, lead)


def _interpolate(xc: torch.Tensor, out_hw: tuple) -> torch.Tensor:
    return F.interpolate(xc, size=out_hw, mode="bilinear", align_corners=False,
                         antialias=False)


@functools.lru_cache(maxsize=None)
def _interp_matrix(in_size: int, out_size: int, device: torch.device) -> torch.Tensor:
    """[out, in] fp32 linear-interpolation matrix, half-pixel centres, edges
    clamped: the JAX package's ``_interp_matrix``, made on ``device`` (no
    copy from the host, so no synchronization)."""
    pos = ((torch.arange(out_size, dtype=torch.float64, device=device) + 0.5)
           * (in_size / out_size) - 0.5)
    lo = pos.floor()
    w_hi = (pos - lo).float()[:, None]
    lo = lo.long()[:, None]
    cols = torch.arange(in_size, device=device)
    return ((1.0 - w_hi) * (cols == lo.clamp(0, in_size - 1))
            + w_hi * (cols == (lo + 1).clamp(0, in_size - 1)))


class _Bilinear(torch.autograd.Function):
    """``F.interpolate``'s bilinear forward, with the adjoint of the two
    interpolation matmuls as its backward: ``dx = Mh^T g Mw``, summed in
    fp32 and rounded once to the input's dtype. On CUDA ``F.interpolate``'s
    own backward adds into dx with atomics in no fixed order (in bf16 for a
    bf16 input), so two runs of one train step gave different gradients;
    this one gives the same bits every run."""

    @staticmethod
    def forward(ctx, xc, out_hw):
        ctx.in_hw = tuple(xc.shape[-2:])
        return _interpolate(xc, out_hw)

    @staticmethod
    def backward(ctx, g):
        (H, W), (N, C, OH, OW) = ctx.in_hw, g.shape
        mh = _interp_matrix(H, OH, g.device)
        mw = _interp_matrix(W, OW, g.device)
        gn = g.permute(0, 2, 3, 1).float().reshape(N, OH, OW * C)
        gn = (mh.t() @ gn).reshape(N * H, OW, C)            # over the output rows
        gn = (mw.t() @ gn).reshape(N, H, W, C)              # over the output columns
        return gn.to(g.dtype).permute(0, 3, 1, 2), None


def avg_pool2d(x: torch.Tensor, kernel: int) -> torch.Tensor:
    """Non-overlapping average pooling (stride == kernel) of [..., H, W, C];
    under a spatial split the band's rows must be a multiple of ``kernel``."""
    if mesh.spatial() is not None and x.shape[-3] % kernel:
        raise ValueError(f"avg_pool2d: a band of {x.shape[-3]} rows is not a multiple of the "
                         f"window {kernel}")
    lead, xc = _nchw(x)
    return _nhwc(F.avg_pool2d(xc, kernel), lead)
