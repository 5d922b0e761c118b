"""UNet3D: a 3-D convolutional U-Net over (T, H, W) with a masked temporal
mean at its end.

Port of uncrtaints_tpu/models/unet3d.py. Layout [B,T,H,W,C] throughout (a
3-D convolution permutes to an NCDHW view of the same memory). Submodules
carry the reference's names: ``en3``, ``en4``, ``dc4``, ``dc3`` are
[Conv3d, BatchNorm3d, LeakyReLU] x 2; ``center_in`` one such triple;
``center_out`` a triple then the transposed conv (index 3); ``trans3`` the
transposed conv then norm and LeakyReLU; ``final`` a Conv3d. The output
nonlinearities act on the channel axis, the JAX package's fix of the
reference, which slices the H axis (COMPONENTS.md:40).

Two max pools halve T twice, so T >= 4: at T = 2 or 3 the second pool sees
one frame and its output has none. Flax's pool returns that empty axis and
the JAX model still gives an output, made of padding alone; the reference's
``nn.MaxPool3d`` and torch's raise. This module raises a ValueError naming
the cause for T < 4 and matches the JAX package for T >= 4.

Under a spatial split (parallel/mesh.py) x holds a band of rows of each
scene, its rows a multiple of 4: the 3-D convolutions take their
neighbours' rows, the max pools stay within the band, the batch norms'
statistics sum over every rank and the pad mask is the scene's.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from uncrtaints_tpu_torch.models.layers import (
    conv_rows, conv_transpose_band, frame_pad_mask, halo_rows, run_fused)
from uncrtaints_tpu_torch.models.ltae import BatchNorm1d
from uncrtaints_tpu_torch.ops.norm import affine_act, norm_act
from uncrtaints_tpu_torch.models.unet import S2_BANDS, mean_var_heads
from uncrtaints_tpu_torch.parallel import mesh


class Conv3d(nn.Module):
    """3x3x3 convolution over [B,T,H,W,C] with the reference init
    (xavier-normal weight, N(0,1) bias): stride 1 and zero padding 1, weight
    [out, in, 3, 3, 3]; or, ``transposed``, ``nn.ConvTranspose3d(k=3, s=2,
    p=1, output_padding=1)``, which doubles T, H and W, weight [in, out, 3,
    3, 3]."""

    def __init__(self, in_channels: int, out_channels: int, transposed: bool = False):
        super().__init__()
        self.transposed = transposed
        io = (in_channels, out_channels) if transposed else (out_channels, in_channels)
        self.weight = nn.Parameter(torch.empty(*io, 3, 3, 3))
        self.bias = nn.Parameter(torch.empty(out_channels))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        nn.init.xavier_normal_(self.weight, generator=generator)
        nn.init.normal_(self.bias, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B,T,H,W,C]. Under a spatial split x is a band of the scene's
        rows: the convolution takes one row from each neighbour (zeros at
        the scene's edge, as its pad), the transposed one the next band's
        first row (its output row 2m+1 reads input rows m and m+1)."""
        w = self.weight.to(x.dtype)
        sp = mesh.spatial()
        if self.transposed:
            conv = lambda a: F.conv_transpose3d(a.permute(0, 4, 1, 2, 3), w, stride=2,
                                                padding=1, output_padding=1).permute(0, 2, 3, 4, 1)
            y = conv(x) if sp is None else conv_transpose_band(x, conv, 3, 2, 1, 1, sp, 2)
        elif sp is None:
            y = F.conv3d(x.permute(0, 4, 1, 2, 3), w, padding=1).permute(0, 2, 3, 4, 1)
        else:  # the halo rows stand for H's pad; T and W are padded as before
            xe = halo_rows(x, *conv_rows(x.shape[2], sp.n_spatial, 3, 1, 1), "zeros", sp, 2)
            y = F.conv3d(xe.permute(0, 4, 1, 2, 3), w, padding=(1, 0, 1)).permute(0, 2, 3, 4, 1)
        return y + self.bias.to(y.dtype)


class BatchNorm3d(BatchNorm1d):
    """Batch norm over (B, T, H, W) per channel of [B,T,H,W,C], as the JAX
    package runs it (flax BatchNorm: fp32 statistics, the biased variance in
    the running statistics, the affine in fp32; see ``ltae.BatchNorm1d``),
    with the activation after it (``act``, :func:`layers.run_fused`). On the
    card one K6 call each way (``ops/norm.py``, kind ``batch_f32``); on the
    CPU the eager formula of ``BatchNorm1d``."""

    fuses_act = True

    def forward(self, x: torch.Tensor, act: str = "none") -> torch.Tensor:
        if not self.training:
            return affine_act(x, torch.rsqrt(self.running_var + 1e-5), self.running_mean, act,
                              self.weight, self.bias)
        y, m, v, _ = norm_act(x, "batch_f32", self.weight, self.bias, act=act)
        with torch.no_grad():
            self.running_mean.copy_(0.9 * self.running_mean + 0.1 * m)
            self.running_var.copy_(0.9 * self.running_var + 0.1 * v)
        return y


def _conv_bn_act(c_in: int, c_out: int):
    return [Conv3d(c_in, c_out), BatchNorm3d(c_out), nn.LeakyReLU(0.01)]


def conv3d_block(c_in: int, mid: int, out: int) -> nn.Sequential:
    """[Conv3d + BatchNorm3d + LeakyReLU] x 2."""
    return nn.Sequential(*_conv_bn_act(c_in, mid), *_conv_bn_act(mid, out))


def _max_pool(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool3d(x.permute(0, 4, 1, 2, 3), 2, 2).permute(0, 2, 3, 4, 1)


class UNet3D(nn.Module):
    """x [B,T,H,W,C], T >= 4, H and W multiples of 4 -> [B,1,H,W,out_channel].
    ``forward`` takes the step's keyword arguments and uses neither."""

    def __init__(self, in_channel: int, out_channel: int = S2_BANDS, feats: int = 8,
                 pad_value: float = 0.0, out_nonlin_mean: bool = False,
                 out_nonlin_var: str = "relu"):
        super().__init__()
        f = feats
        self.pad_value = pad_value
        self.out_nonlin_mean, self.out_nonlin_var = out_nonlin_mean, out_nonlin_var
        self.en3 = conv3d_block(in_channel, f * 4, f * 4)
        self.en4 = conv3d_block(f * 4, f * 8, f * 8)
        self.center_in = nn.Sequential(*_conv_bn_act(f * 8, f * 16))
        self.center_out = nn.Sequential(*_conv_bn_act(f * 16, f * 16),
                                        Conv3d(f * 16, f * 8, transposed=True))
        self.dc4 = conv3d_block(f * 16, f * 8, f * 8)
        self.trans3 = nn.Sequential(Conv3d(f * 8, f * 4, transposed=True), BatchNorm3d(f * 4),
                                    nn.LeakyReLU(0.01))
        self.dc3 = conv3d_block(f * 8, f * 4, f * 2)
        self.final = Conv3d(f * 2, out_channel)

    def forward(self, x: torch.Tensor, batch_positions: Optional[torch.Tensor] = None,
                dropout_generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if x.shape[1] < 4:
            raise ValueError(
                f"UNet3D needs T >= 4 frames, got T={x.shape[1]}: its second temporal max "
                "pool would have no output frame (the JAX model pads that empty axis up "
                "again; torch's and the reference's max pool refuse it)")
        sp = mesh.spatial()
        if sp is not None and x.shape[2] % 4:
            raise NotImplementedError(
                f"UNet3D under a spatial split: a band of {x.shape[2]} rows; its two max "
                "pools halve the rows twice, so each band's rows must be a multiple of 4")
        pad_mask = frame_pad_mask(x, self.pad_value)  # [B, T]
        en3 = run_fused(self.en3, x)
        en4 = run_fused(self.en4, _max_pool(en3))
        c_out = run_fused(self.center_out, run_fused(self.center_in, _max_pool(en4)))
        dc4 = run_fused(self.dc4, torch.cat([c_out, en4[:, :c_out.shape[1]]], dim=-1))
        tr3 = run_fused(self.trans3, dc4)
        final = self.final(run_fused(self.dc3, torch.cat([tr3, en3[:, :tr3.shape[1]]], dim=-1)))

        # the mean over the unpadded frames
        keep = (~pad_mask[:, :final.shape[1]]).to(final.dtype)
        denom = keep.sum(dim=1).clamp(min=1.0)
        out = (final * keep[:, :, None, None, None]).sum(dim=1) / denom[:, None, None, None]
        if self.out_nonlin_mean or self.out_nonlin_var != "none":
            out = mean_var_heads(out, self.out_nonlin_mean, self.out_nonlin_var)
        return out[:, None]
