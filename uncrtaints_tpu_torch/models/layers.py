"""Shared layers: reflect-padded convolution, batch/group/instance norm,
time folding, activations and the reference weight initialisation.

Port of the math of uncrtaints_tpu/models/layers.py (Conv2d, Norm2d,
ConvLayer, ConvBlock, smart_apply, gelu, softplus_t20, the initialisers,
and the depthwise-conv VJP of _dw_conv_valid); its TPU lowering choices
(strip reflect, the other custom VJPs, UNCR_* dispatch) are not carried
over.

Layout: every module takes and returns feature maps in the JAX package's
NHWC layout ([N,H,W,C], or [B,T,H,W,C] under :func:`smart_apply`). A
convolution permutes its input to an NCHW view, which for NHWC-contiguous
memory is a ``channels_last`` tensor, so no copy is made.

Parameters carry the reference PyTorch names and layouts (conv weights
OIHW, linear weights [out, in]), so ``state_dict()`` is reference-format.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from uncrtaints_tpu_torch.ops.dwconv import Pads, dw_stencil
from uncrtaints_tpu_torch.ops.dwgrad import dw_kernel_grad

_PAD_MODES = ("reflect", "replicate", "circular")  # F.pad modes


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU, nn.GELU()'s default; bf16 input is computed in
    fp32 and rounded once."""
    return F.gelu(x)


def softplus_t20(x: torch.Tensor) -> torch.Tensor:
    """nn.Softplus(beta=1, threshold=20): identity above the threshold."""
    return F.softplus(x, beta=1.0, threshold=20.0)


def _moments_f32(x: torch.Tensor, dims, keepdim: bool = True):
    """fp32 mean and variance as E[x^2] - E[x]^2 (clamped at 0), the JAX
    package's formula."""
    m = x.mean(dim=dims, keepdim=keepdim, dtype=torch.float32)
    m2 = x.float().square().mean(dim=dims, keepdim=keepdim)
    return m, torch.clamp(m2 - m.square(), min=0.0)


class Linear(nn.Linear):
    """nn.Linear with the reference init: xavier-normal weight, N(0,1) bias."""

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        nn.init.xavier_normal_(self.weight, generator=generator)
        if self.bias is not None:
            nn.init.normal_(self.bias, generator=generator)


class Conv1d(nn.Conv1d):
    """nn.Conv1d with the reference init: N(0,1) weight and bias."""

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        nn.init.normal_(self.weight, generator=generator)
        if self.bias is not None:
            nn.init.normal_(self.bias, generator=generator)


class DepthwiseConv2d(torch.autograd.Function):
    """Depthwise stride-1 zero-padded correlation of NHWC x with w
    [C,1,kh,kw], differentiable through hand-written kernels (the math of
    the JAX package's _dw_conv_valid VJP, layers.py:349-389):

    - forward: K5 (:func:`dw_stencil`) with ``pads``;
    - gx: K5 on the output gradient with the flipped kernel and the
      complementary pads (kh-1-top, kh-1-bottom), (kw-1-left, kw-1-right):
      the FULL pads for a VALID forward;
    - gw: K2 (:func:`dw_kernel_grad`), fp32, cast to w's dtype.

    CPU tensors run the kernels' plain versions."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, w: torch.Tensor, pads: Pads):
        ctx.pads = pads
        ctx.save_for_backward(x, w)
        return dw_stencil(x, w, pads)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        x, w = ctx.saved_tensors
        (pt, pb), (pl, pr) = ctx.pads
        kh, kw = w.shape[-2:]
        g = g.contiguous()
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = dw_stencil(g, w.flip((-2, -1)).contiguous(),
                            ((kh - 1 - pt, kh - 1 - pb), (kw - 1 - pl, kw - 1 - pr)))
        if ctx.needs_input_grad[1]:
            gw = dw_kernel_grad(x, g, ctx.pads, kh, kw).to(w.dtype)
        return gx, gw, None


class Conv2d(nn.Module):
    """2-D convolution over NHWC maps with ``nn.Conv2d``'s padding modes.

    ``input_affine=(coef, offs)`` computes conv(x * coef + offs) by folding
    the per-input-channel affine into the weight and bias, which is exact
    for 1x1 convolutions and for non-zero padding modes.

    A depthwise stride-1 convolution that is differentiated (grad enabled,
    an input requires grad) runs through :class:`DepthwiseConv2d`, i.e. the
    hand-written kernels K5 and K2; otherwise (eval) it stays
    ``F.conv2d``, as the JAX eval primal keeps ``lax.conv``."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int = 3,
                 stride: int = 1, pad: int = 1, padding_mode: str = "reflect",
                 bias: bool = True, groups: int = 1):
        super().__init__()
        if padding_mode != "zeros" and padding_mode not in _PAD_MODES:
            raise ValueError(f"unknown padding_mode {padding_mode!r}")
        self.stride, self.pad, self.groups = stride, pad, groups
        self.padding_mode = padding_mode
        self.weight = nn.Parameter(
            torch.empty(out_channels, in_channels // groups, kernel, kernel))
        self.bias = nn.Parameter(torch.empty(out_channels)) if bias else None
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        nn.init.xavier_normal_(self.weight, generator=generator)
        if self.bias is not None:
            nn.init.normal_(self.bias, generator=generator)

    def forward(self, x: torch.Tensor, input_affine=None) -> torch.Tensor:
        w, b = self.weight, self.bias
        if input_affine is not None:
            coef, offs = input_affine
            if self.groups not in (1, x.shape[-1]):
                raise ValueError("input_affine folds into plain or depthwise "
                                 "convolutions only")
            if self.weight.shape[-1] != 1 and self.pad and self.padding_mode == "zeros":
                raise ValueError("input_affine is inexact at zero-padded borders")
            w32 = w.float()
            if self.groups == 1:
                w = w32 * coef[None, :, None, None]
                fold_bias = (w32 * offs[None, :, None, None]).sum(dim=(1, 2, 3))
            else:  # depthwise: channels live on the output axis
                w = w32 * coef[:, None, None, None]
                fold_bias = (w32 * offs[:, None, None, None]).sum(dim=(1, 2, 3))
            b = fold_bias if b is None else b + fold_bias
        w = w.to(x.dtype)
        pad = self.pad
        if pad and self.padding_mode != "zeros":
            # pad H and W of the NHWC tensor as the last-but-channel dims of
            # a 5-D view: one pass that keeps NHWC memory (the 2-D pad of
            # the channels_last view converts to NCHW and back, measured as
            # the step's largest copy cost on the H100)
            x = F.pad(x.unsqueeze(1), (0, 0, pad, pad, pad, pad),
                      mode=self.padding_mode).squeeze(1)
            pad = 0
        depthwise = (self.stride == 1 and self.groups > 1
                     and w.shape[0] == self.groups == x.shape[-1])
        if (depthwise and torch.is_grad_enabled()
                and (x.requires_grad or w.requires_grad)):
            y = DepthwiseConv2d.apply(x.contiguous(), w.contiguous(),
                                      ((pad, pad), (pad, pad)))
        else:
            y = F.conv2d(x.permute(0, 3, 1, 2), w, stride=self.stride,
                         padding=pad, groups=self.groups).permute(0, 2, 3, 1)
        if b is not None:  # added after the conv, in its dtype (JAX's order)
            y = y + b.to(y.dtype)
        return y


class Norm2d(nn.Module):
    """batch | group | instance | none over NHWC maps.

    Statistics accumulate in fp32; the affine is applied in the activation
    dtype. Batch norm uses eps 1e-5 and momentum 0.1 (torch convention,
    unbiased running variance); instance norm has no affine parameters."""

    def __init__(self, norm: str, channels: int, n_groups: int = 4):
        super().__init__()
        if norm not in ("batch", "group", "instance", "none"):
            raise ValueError(f"unknown norm {norm!r}")
        self.norm, self.n_groups = norm, n_groups
        if norm in ("batch", "group"):
            self.weight = nn.Parameter(torch.ones(channels))
            self.bias = nn.Parameter(torch.zeros(channels))
        if norm == "batch":
            self.register_buffer("running_mean", torch.zeros(channels))
            self.register_buffer("running_var", torch.ones(channels))

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        if self.norm == "batch":
            nn.init.normal_(self.weight, generator=generator)
            nn.init.zeros_(self.bias)
        elif self.norm == "group":
            nn.init.ones_(self.weight)
            nn.init.zeros_(self.bias)

    def fold(self):
        """Eval batch norm as the fp32 affine (coef [C], offs [C])."""
        rs = torch.rsqrt(self.running_var + 1e-5) * self.weight
        return rs, self.bias - self.running_mean * rs

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.norm == "batch":
            return self._batch_norm(x)
        if self.norm == "instance":
            m, v = _moments_f32(x, (-3, -2))
            return (x - m.to(x.dtype)) * torch.rsqrt(v + 1e-5).to(x.dtype)
        if self.norm == "group":
            N, C, g = x.shape[0], x.shape[-1], self.n_groups
            m, v = _moments_f32(x.reshape(N, -1, g, C // g), (1, 3), keepdim=False)
            mc = m.repeat_interleave(C // g, -1)
            cc = torch.rsqrt(v + 1e-5).repeat_interleave(C // g, -1) * self.weight.float()
            off = self.bias.float() - mc * cc
            shape = (N,) + (1,) * (x.dim() - 2) + (C,)
            return x * cc.to(x.dtype).view(shape) + off.to(x.dtype).view(shape)
        return x

    def _batch_norm(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            m, v = _moments_f32(x, tuple(range(x.dim() - 1)), keepdim=False)
            n = x.numel() // x.shape[-1]
            with torch.no_grad():
                self.running_mean.copy_(0.9 * self.running_mean + 0.1 * m)
                self.running_var.copy_(0.9 * self.running_var
                                       + 0.1 * (v * (n / max(n - 1, 1))))
        else:
            m, v = self.running_mean, self.running_var
        r = torch.rsqrt(v + 1e-5)
        coef = (r * self.weight).to(x.dtype)
        offs = (self.bias - m * r * self.weight).to(x.dtype)
        return x * coef + offs


class ConvLayer(nn.Module):
    """Conv2d (+ norm) (+ ReLU) stack; the reference's utae ConvLayer, with
    its ``conv`` Sequential indices."""

    def __init__(self, nkernels: Sequence[int], norm: str = "batch", k: int = 3,
                 s: int = 1, p: int = 1, n_groups: int = 4,
                 last_relu: bool = True, padding_mode: str = "reflect"):
        super().__init__()
        layers = []
        for i in range(len(nkernels) - 1):
            layers.append(Conv2d(nkernels[i], nkernels[i + 1], kernel=k,
                                 stride=s, pad=p, padding_mode=padding_mode))
            if norm != "none":
                layers.append(Norm2d(norm, nkernels[i + 1], n_groups))
            if last_relu or i < len(nkernels) - 2:
                layers.append(nn.ReLU())
        self.conv = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


def smart_apply(fn: Callable, x: torch.Tensor,
                pad_value: Optional[float] = None) -> torch.Tensor:
    """Apply an [N,H,W,C] function over [B,T,H,W,C] by folding time into
    the batch; frames that were all ``pad_value`` are re-filled with it."""
    if x.dim() == 4:
        return fn(x)
    b, t = x.shape[:2]
    pad_mask = None
    if pad_value is not None:
        pad_mask = (x == pad_value).all(dim=(2, 3, 4))
    y = fn(x.reshape(b * t, *x.shape[2:]))
    y = y.reshape(b, t, *y.shape[1:])
    if pad_mask is not None:
        y = torch.where(pad_mask[:, :, None, None, None], pad_value, y)
    return y


class ConvBlock(nn.Module):
    """Temporally shared ConvLayer (the reference's utae ConvBlock)."""

    def __init__(self, nkernels: Sequence[int], pad_value: Optional[float] = None,
                 norm: str = "batch", last_relu: bool = True, k: int = 3,
                 s: int = 1, p: int = 1, padding_mode: str = "reflect"):
        super().__init__()
        self.pad_value = pad_value
        self.conv = ConvLayer(nkernels, norm=norm, k=k, s=s, p=p,
                              last_relu=last_relu, padding_mode=padding_mode)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return smart_apply(self.conv, x, self.pad_value)


def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Draw every parameter from ``generator`` with the reference init
    (weight_init.py): conv and linear weights xavier-normal, their biases
    N(0,1), batch-norm weights N(0,1) and biases 0, group norms 1 and 0,
    Conv1d weights N(0,1). Every parameterised module of the port has a
    ``reset_parameters(generator)``; the order of ``model.modules()`` fixes
    the draws, so one seed gives one model."""
    for m in model.modules():
        reset = getattr(m, "reset_parameters", None)
        if reset is not None:
            reset(generator)
    return model
