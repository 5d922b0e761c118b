"""U-Net blocks and the mono-temporal U-Net (the pretraining backbone).

Port of uncrtaints_tpu/models/unet.py (DownConvBlock, UpConvBlock,
mean_var_heads, UNet). Layout NHWC, or [B,T,H,W,C] where a block folds time
into the batch. Submodules carry the reference's names: ``down_blocks.{i}``
with ``down`` (the strided 4x4 conv), ``conv1``, ``conv2``; ``up_blocks.{i}``
with ``skip_conv`` (1x1 conv, norm, ReLU), ``up`` (transposed conv, norm,
ReLU), ``conv1``, ``conv2``.

The JAX package's upsampling is flax's ``ConvTranspose(k=4, s=2, "SAME")``
on an HWIO kernel; here it is the reference's ``ConvTranspose2d(k=4, s=2,
p=1)`` on an [in, out, kh, kw] weight, the JAX kernel flipped in space
(``models/jax_bridge.py``; the tests hold the two equal numerically).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from uncrtaints_tpu_torch.models.layers import (
    Conv2d, ConvBlock, ConvLayer, Norm2d, smart_apply, softplus_t20)

S2_BANDS = 13


class ConvTranspose2d(nn.Module):
    """``nn.ConvTranspose2d`` over NHWC maps (weight [in, out, k, k]) with
    the reference init: xavier-normal weight, N(0,1) bias."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int = 4,
                 stride: int = 2, pad: int = 1):
        super().__init__()
        self.stride, self.pad = stride, pad
        self.weight = nn.Parameter(torch.empty(in_channels, out_channels, kernel, kernel))
        self.bias = nn.Parameter(torch.empty(out_channels))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        nn.init.xavier_normal_(self.weight, generator=generator)
        nn.init.normal_(self.bias, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv_transpose2d(x.permute(0, 3, 1, 2), self.weight.to(x.dtype),
                               stride=self.stride, padding=self.pad).permute(0, 2, 3, 1)
        return y + self.bias.to(y.dtype)


def _norm_relu(conv: nn.Module, kind: str, channels: int, n_groups: int) -> nn.Sequential:
    """conv -> norm (batch | group | instance; none leaves it out) -> ReLU."""
    layers = [conv]
    if kind in ("batch", "group", "instance"):
        layers.append(Norm2d(kind, channels, n_groups))
    return nn.Sequential(*layers, nn.ReLU())


class DownConvBlock(nn.Module):
    """Strided conv (k=4, s=2, p=1) -> conv1 -> conv1 + conv2 (the residual
    pair); time folded into the batch."""

    def __init__(self, d_in: int, d_out: int, k: int = 4, s: int = 2, p: int = 1,
                 norm: str = "group", padding_mode: str = "reflect"):
        super().__init__()
        self.down = ConvLayer([d_in, d_in], norm=norm, k=k, s=s, p=p,
                              padding_mode=padding_mode)
        self.conv1 = ConvLayer([d_in, d_out], norm=norm, padding_mode=padding_mode)
        self.conv2 = ConvLayer([d_out, d_out], norm=norm, padding_mode=padding_mode,
                               last_relu=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        def body(a):
            o = self.conv1(self.down(a))
            return o + self.conv2(o)

        return smart_apply(body, x)


class UpConvBlock(nn.Module):
    """Transposed-conv upsampling (2x) of x, concatenated with the 1x1-conv
    skip branch, then conv1 -> conv1 + conv2. x, skip: [N,H,W,C]."""

    def __init__(self, d_in: int, d_out: int, d_skip: int, k: int = 4, s: int = 2,
                 norm_skip: str = "batch", norm_up: str = "batch", norm: str = "batch",
                 n_groups: int = 4, padding_mode: str = "reflect"):
        super().__init__()
        self.skip_conv = _norm_relu(Conv2d(d_skip, d_skip, kernel=1, pad=0), norm_skip,
                                    d_skip, n_groups)
        self.up = _norm_relu(ConvTranspose2d(d_in, d_out, k, s, 1), norm_up, d_out, n_groups)
        self.conv1 = ConvLayer([d_out + d_skip, d_out], norm=norm, padding_mode=padding_mode)
        self.conv2 = ConvLayer([d_out, d_out], norm=norm, padding_mode=padding_mode,
                               last_relu=False)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        o = self.conv1(torch.cat([self.up(x), self.skip_conv(skip)], dim=-1))
        return o + self.conv2(o)


def mean_var_heads(out: torch.Tensor, out_nonlin_mean: bool, out_nonlin_var: str,
                   scale_by: float = 1.0) -> torch.Tensor:
    """Split [..., 13 + k] channels into mean and variance and apply their
    nonlinearities (the variance without an eps, as the JAX package)."""
    mean, var = out[..., :S2_BANDS], out[..., S2_BANDS:]
    if out_nonlin_mean:
        mean = scale_by * torch.sigmoid(mean)
    if var.shape[-1] == 0:
        return mean
    if out_nonlin_var == "relu":
        var = F.relu(var)
    elif out_nonlin_var == "softplus":
        var = softplus_t20(var)
    elif out_nonlin_var == "elu":
        var = F.elu(var) + 1 + 1e-8
    return torch.cat([mean, var], dim=-1)


class UNet(nn.Module):
    """Mono-temporal U-Net: x [B,1,H,W,C] or [B,H,W,C] -> [B,1,H,W,out_conv[-1]].
    ``forward`` takes the step's keyword arguments and uses neither."""

    def __init__(self, input_dim: int, encoder_widths: Sequence[int] = (64, 64, 64, 128),
                 decoder_widths: Sequence[int] = (32, 32, 64, 128),
                 out_conv: Sequence[int] = (S2_BANDS,), out_nonlin_mean: bool = False,
                 out_nonlin_var: str = "relu", str_conv_k: int = 4, str_conv_s: int = 2,
                 str_conv_p: int = 1, encoder_norm: str = "group", norm_skip: str = "batch",
                 norm_up: str = "batch", decoder_norm: str = "batch", pad_value: float = 0.0,
                 padding_mode: str = "reflect"):
        super().__init__()
        if len(encoder_widths) != len(decoder_widths):
            raise ValueError("encoder_widths and decoder_widths differ in length")
        if encoder_widths[-1] != decoder_widths[-1]:
            raise ValueError("encoder_widths[-1] must equal decoder_widths[-1]")
        self.out_nonlin_mean, self.out_nonlin_var = out_nonlin_mean, out_nonlin_var
        self.in_conv, self.down_blocks, self.up_blocks, self.out_conv = _unet_stages(
            input_dim, encoder_widths, decoder_widths, out_conv, str_conv_k, str_conv_s,
            str_conv_p, encoder_norm, norm_skip, norm_up, decoder_norm, padding_mode)

    def forward(self, x: torch.Tensor, batch_positions: Optional[torch.Tensor] = None,
                dropout_generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if x.dim() == 5:
            x = x[:, 0]
        feats = [self.in_conv(x)]
        for blk in self.down_blocks:
            feats.append(blk(feats[-1]))
        out = feats[-1]
        for i, blk in enumerate(self.up_blocks):
            out = blk(out, feats[-2 - i])
        out = mean_var_heads(self.out_conv(out), self.out_nonlin_mean, self.out_nonlin_var)
        return out[:, None]


def _unet_stages(input_dim, encoder_widths, decoder_widths, out_conv, k, s, p,
                 encoder_norm, norm_skip, norm_up, decoder_norm, padding_mode):
    """(in_conv, down_blocks, up_blocks, out_conv) of the U-Net shape that
    UNet and UTAE share."""
    n = len(encoder_widths)
    in_conv = ConvBlock([input_dim, encoder_widths[0]], k=1, s=1, p=0, norm=encoder_norm,
                        padding_mode=padding_mode)
    down = nn.ModuleList(
        DownConvBlock(encoder_widths[i], encoder_widths[i + 1], k=k, s=s, p=p,
                      norm=encoder_norm, padding_mode=padding_mode) for i in range(n - 1))
    up = nn.ModuleList(
        UpConvBlock(d_in=decoder_widths[n - 1 - i], d_out=decoder_widths[n - 2 - i],
                    d_skip=encoder_widths[n - 2 - i], k=k, s=s, norm_skip=norm_skip,
                    norm_up=norm_up, norm=decoder_norm, padding_mode=padding_mode)
        for i in range(n - 1))
    head = ConvBlock([decoder_widths[0]] + list(out_conv), k=1, s=1, p=0, norm="none",
                     last_relu=False, padding_mode=padding_mode)
    return in_conv, down, up, head
