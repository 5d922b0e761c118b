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

Under a spatial split (a 2-D mesh with ``n_spatial > 1``, parallel/mesh.py)
a map is one band of rows of the scene: a convolution that reads across rows
takes its neighbours' rows (``halo_exchange``) and pads only at the scene's
edge, and the group and instance norms sum their statistics over the
spatial group. The batch norms' statistics already sum over every rank.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from uncrtaints_tpu_torch.ops.dwconv import dw_stencil
from uncrtaints_tpu_torch.parallel import mesh

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


def _moments_band_f32(x: torch.Tensor, dims, keepdim: bool, sp):
    """:func:`_moments_f32` of the scene when x is one band of it: the fp32
    sums and sums of squares over ``dims`` summed over the spatial group by
    a differentiable all-reduce (the gradient reaches every band's rows),
    divided by the scene's count."""
    xf = x.float()
    tot = mesh.spatial_sum(torch.stack([xf.sum(dim=dims, keepdim=keepdim),
                                        xf.square().sum(dim=dims, keepdim=keepdim)]), sp)
    n = sp.n_spatial
    for d in dims:
        n *= x.shape[d]
    m = tot[0] / n
    return m, torch.clamp(tot[1] / n - m.square(), min=0.0)


def batch_moments_f32(x: torch.Tensor, dims):
    """Train-mode batch-norm statistics: per-channel fp32 mean and biased
    variance (E[x^2] - E[x]^2, clamped at 0) over ``dims``, and the number
    of rows behind them. When a process group is initialised they are the
    global batch's, as under the JAX package's pjit: the per-rank sums, sums
    of squares and counts are summed over the ranks by a differentiable
    all-reduce (parallel/mesh.py), so every rank normalises alike, its
    running statistics stay equal to the others', and the gradient reaches
    every rank's rows."""
    if not mesh.active():
        m, v = _moments_f32(x, dims, keepdim=False)
        return m, v, x.numel() // x.shape[-1]
    xf, C = x.float(), x.shape[-1]
    local = torch.cat([xf.sum(dim=dims), xf.square().sum(dim=dims),
                       xf.new_full((1,), x.numel() // C)])
    tot = mesh.all_reduce_sum_grad(local)
    n = tot[-1]
    m = tot[:C] / n
    return m, torch.clamp(tot[C:2 * C] / n - m.square(), min=0.0), n


def unbiased_factor(n):
    """n / (n - 1) for the running variance (1 for a single row); n is the
    row count :func:`batch_moments_f32` returns, an int or a tensor."""
    if isinstance(n, torch.Tensor):
        return n / torch.clamp(n - 1, min=1)
    return n / max(n - 1, 1)


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


class Conv2d(nn.Module):
    """2-D convolution over NHWC maps with ``nn.Conv2d``'s padding modes,
    stride and dilation.

    ``input_affine=(coef, offs)`` computes conv(x * coef + offs) by folding
    the per-input-channel affine into the weight and bias, which is exact
    for 1x1 convolutions and for non-zero padding modes.

    A depthwise stride-1 convolution that is differentiated (grad enabled,
    an input requires grad) runs through :func:`dw_stencil`, i.e. the
    hand-written kernels K5 and K2 (its backward: the input gradient by K5,
    the weight gradient by K2, as the JAX package's VJPs of _dw_conv_valid
    and _dw_reflect3x3); a 3x3 one with a reflect pad of one goes through
    them unpadded (``mode="reflect"``), so neither pass makes or saves a
    padded tensor. Otherwise (eval) it stays ``F.conv2d``, as the JAX eval
    primal keeps ``lax.conv``."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int = 3,
                 stride: int = 1, pad: int = 1, padding_mode: str = "reflect",
                 bias: bool = True, groups: int = 1, dilation: int = 1):
        super().__init__()
        if padding_mode != "zeros" and padding_mode not in _PAD_MODES:
            raise ValueError(f"unknown padding_mode {padding_mode!r}")
        self.stride, self.pad, self.groups = stride, pad, groups
        self.dilation = dilation
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
        """x [N,H,W,C]. Under a spatial split x is a band of the scene: a
        kernel taller than one row reads the neighbours' rows (the folded
        depthwise conv through K5 / K2's halo mode) and pads only at the
        scene's edge; it must be a stride-1 'same' convolution."""
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
        depthwise = (self.stride == 1 and self.dilation == 1 and self.groups > 1
                     and w.shape[0] == self.groups == x.shape[-1])
        differentiated = (depthwise and torch.is_grad_enabled()
                          and (x.requires_grad or w.requires_grad))
        # a 3x3 reflect conv is one op there: mirrored indices in the kernels,
        # the pad's adjoint folded into gx, no padded tensor either way
        folded = (differentiated and self.padding_mode == "reflect" and pad == 1
                  and w.shape[-2:] == (3, 3) and min(x.shape[1:3]) >= 2)
        sp = mesh.spatial() if w.shape[-2] > 1 else None
        if sp is not None:
            if self.stride != 1 or 2 * pad != self.dilation * (w.shape[-2] - 1):
                raise NotImplementedError(
                    "Conv2d under a spatial split takes stride-1 'same' convolutions only "
                    f"(stride {self.stride}, pad {pad}, kernel {tuple(w.shape[-2:])})")
            if folded:
                y = dw_stencil(x.contiguous(), w.contiguous(), ((1, 1), (1, 1)), "reflect",
                               halo=mesh.halo_exchange(x, 1, 1, sp))
                return y if b is None else y + b.to(y.dtype)
            x, pad = band_pad(x, pad, self.padding_mode, sp), 0
        if pad and self.padding_mode != "zeros" and not folded:
            # pad H and W of the NHWC tensor as the last-but-channel dims of
            # a 5-D view: one pass that keeps NHWC memory (the 2-D pad of
            # the channels_last view converts to NCHW and back, measured as
            # the step's largest copy cost on the H100)
            x = F.pad(x.unsqueeze(1), (0, 0, pad, pad, pad, pad),
                      mode=self.padding_mode).squeeze(1)
            pad = 0
        if differentiated:
            y = dw_stencil(x.contiguous(), w.contiguous(), ((pad, pad), (pad, pad)),
                           "reflect" if folded else "zeros")
        else:
            y = F.conv2d(x.permute(0, 3, 1, 2), w, stride=self.stride, padding=pad,
                         dilation=self.dilation, groups=self.groups).permute(0, 2, 3, 1)
        if b is not None:  # added after the conv, in its dtype (JAX's order)
            y = y + b.to(y.dtype)
        return y


def band_pad(x: torch.Tensor, pad: int, mode: str, sp) -> torch.Tensor:
    """Pad a band [N,H,W,C] of the scene by ``pad`` rows and columns: its
    neighbours' rows (``halo_exchange``, differentiable) where it has them,
    the padding mode's rows at the scene's edge, and the mode's columns."""
    if mode == "circular":
        raise NotImplementedError("a circular pad wraps to the scene's other edge: not "
                                  "under a spatial split")
    top, bot = mesh.halo_exchange(x, pad, 1, sp)
    if top is None:
        top = (x[:, 1:pad + 1].flip(1) if mode == "reflect" else
               x[:, :1].expand(-1, pad, -1, -1) if mode == "replicate" else
               x.new_zeros((x.shape[0], pad, *x.shape[2:])))
    if bot is None:
        bot = (x[:, -pad - 1:-1].flip(1) if mode == "reflect" else
               x[:, -1:].expand(-1, pad, -1, -1) if mode == "replicate" else
               x.new_zeros((x.shape[0], pad, *x.shape[2:])))
    xe = torch.cat([top, x, bot], dim=1)
    if mode == "zeros":
        return F.pad(xe, (0, 0, pad, pad))
    return F.pad(xe.unsqueeze(1), (0, 0, pad, pad, 0, 0), mode=mode).squeeze(1)


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
        sp = mesh.spatial()
        moments = (_moments_f32 if sp is None else
                   lambda t, dims, keepdim=True: _moments_band_f32(t, dims, keepdim, sp))
        if self.norm == "instance":
            m, v = moments(x, (-3, -2))
            return (x - m.to(x.dtype)) * torch.rsqrt(v + 1e-5).to(x.dtype)
        if self.norm == "group":
            N, C, g = x.shape[0], x.shape[-1], self.n_groups
            m, v = moments(x.reshape(N, -1, g, C // g), (1, 3), keepdim=False)
            mc = m.repeat_interleave(C // g, -1)
            cc = torch.rsqrt(v + 1e-5).repeat_interleave(C // g, -1) * self.weight.float()
            off = self.bias.float() - mc * cc
            shape = (N,) + (1,) * (x.dim() - 2) + (C,)
            return x * cc.to(x.dtype).view(shape) + off.to(x.dtype).view(shape)
        return x

    def _batch_norm(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            m, v, n = batch_moments_f32(x, tuple(range(x.dim() - 1)))
            with torch.no_grad():
                self.running_mean.copy_(0.9 * self.running_mean + 0.1 * m)
                self.running_var.copy_(0.9 * self.running_var
                                       + 0.1 * (v * unbiased_factor(n)))
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
        if mesh.spatial() is not None:  # all pixels of the scene, not of the band
            pad_mask = mesh.spatial_all(pad_mask)
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
