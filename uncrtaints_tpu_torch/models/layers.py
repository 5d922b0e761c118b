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
takes its neighbours' rows (``halo_exchange``; strided and transposed ones
the rows their windows reach, :func:`conv_rows`, :func:`conv_transpose_rows`)
and pads only at the scene's edge, and the group and instance norms sum
their statistics over the spatial group. The batch norms' statistics
already sum over every rank.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from uncrtaints_tpu_torch import tracing
from uncrtaints_tpu_torch.ops.dwconv import dw_stencil
from uncrtaints_tpu_torch.ops.norm import (  # noqa: F401  (batch_moments_f32: ltae.py's)
    activation, affine_act, batch_moments_f32, norm_act, unbiased_factor)
from uncrtaints_tpu_torch.ops.pad import reflect_pad
from uncrtaints_tpu_torch.parallel import mesh

_PAD_MODES = ("reflect", "replicate", "circular")  # F.pad modes
_RECOMPUTE = threading.local()  # set while a block runs again in the backward


@contextlib.contextmanager
def recomputing():
    """The context of a block's second forward in the backward (``remat``,
    ``torch.utils.checkpoint``'s recompute): the train-mode batch norms
    normalise as before but leave their running statistics alone, which the
    first forward updated (flax's ``nn.remat`` updates them once too)."""
    before = getattr(_RECOMPUTE, "on", False)
    _RECOMPUTE.on = True
    try:
        yield
    finally:
        _RECOMPUTE.on = before


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU, nn.GELU()'s default; bf16 input is computed in
    fp32 and rounded once."""
    return F.gelu(x)


def softplus_t20(x: torch.Tensor) -> torch.Tensor:
    """nn.Softplus(beta=1, threshold=20): identity above the threshold."""
    return F.softplus(x, beta=1.0, threshold=20.0)


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
    primal keeps ``lax.conv``. Every other reflect-padded convolution pads
    through :func:`reflect_pad` (on the card kernel K7, its backward K7's
    adjoint), then convolves the padded map."""

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
        scene's edge; a strided one reads the rows :func:`conv_rows` names
        and must give even output bands."""
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
        sp = mesh.spatial() if w.shape[-2] > 1 or self.stride > 1 else None
        band = None
        if sp is not None:
            if folded:
                y = dw_stencil(x.contiguous(), w.contiguous(), ((1, 1), (1, 1)), "reflect",
                               halo=mesh.halo_exchange(x, 1, 1, sp))
                return y if b is None else y + b.to(y.dtype)
            band = x.shape[1]
            top, bot = conv_rows(band, sp.n_spatial, w.shape[-2], self.stride, pad,
                                 self.dilation)
            x, pad = band_pad(x, top, bot, pad, self.padding_mode, sp), 0
        if pad and self.padding_mode != "zeros" and not folded:
            if self.padding_mode == "reflect":  # K7 on the card, its adjoint backward
                x = reflect_pad(x.contiguous(), pad)
            else:
                # pad H and W of the NHWC tensor as the last-but-channel dims
                # of a 5-D view: one pass that keeps NHWC memory (the 2-D pad
                # of the channels_last view converts to NCHW and back)
                x = F.pad(x.unsqueeze(1), (0, 0, pad, pad, pad, pad),
                          mode=self.padding_mode).squeeze(1)
            pad = 0
            if tracing.recording():
                tracing.count("reflect_pad", tracing.nbytes(x))
        if differentiated:
            y = dw_stencil(x.contiguous(), w.contiguous(), ((pad, pad), (pad, pad)),
                           "reflect" if folded else "zeros")
        else:
            y = F.conv2d(x.permute(0, 3, 1, 2), w, stride=self.stride, padding=pad,
                         dilation=self.dilation, groups=self.groups).permute(0, 2, 3, 1)
        if band is not None:  # the outputs of the band's own rows
            y = y[:, :band // self.stride]
        if b is not None:  # added after the conv, in its dtype (JAX's order)
            y = y + b.to(y.dtype)
        return y


def conv_rows(band: int, n_spatial: int, k: int, stride: int = 1, pad: int = 0,
              dilation: int = 1):
    """(top, bot): the rows above and below a band that a convolution's
    outputs on the band read (kernel ``k``, ``stride``, ``pad`` and
    ``dilation`` along H), when the scene of ``n_spatial`` bands of ``band``
    rows splits into bands of ``band / stride`` output rows: output row m
    reads input rows ``stride * m - pad`` to ``stride * m - pad + dilation *
    (k - 1)``. A split that would cut an output band is refused: a band
    whose rows are not a multiple of the stride (its first row would be
    odd), or a scene whose output is not its rows / stride."""
    rows, span = band * n_spatial, dilation * (k - 1)
    if band % stride or ((rows + 2 * pad - span - 1) // stride + 1) * stride != rows:
        raise NotImplementedError(
            f"Conv2d under a spatial split: a convolution of kernel {k}, stride {stride}, "
            f"pad {pad}, dilation {dilation} on bands of {band} of {rows} rows does not give "
            f"even output bands (the band's rows must be a multiple of the stride, the "
            f"scene's output rows its rows / stride)")
    return pad, max(span - pad - stride + 1, 0)


def conv_transpose_rows(band: int, n_spatial: int, k: int, stride: int, pad: int,
                        output_padding: int = 0):
    """(top, bot): the input rows above and below a band that a transposed
    convolution's outputs of that band read, its output band being rows
    ``stride * r`` to ``stride * (r + band)`` (output row o reads input rows
    i with ``o = stride * i - pad + j``, j a tap); refused when the scene's
    output is not ``stride`` times its rows."""
    rows = band * n_spatial
    if (rows - 1) * stride - 2 * pad + k + output_padding != stride * rows:
        raise NotImplementedError(
            f"a transposed convolution of kernel {k}, stride {stride}, pad {pad} under a "
            f"spatial split: its output is not {stride} x the scene's {rows} rows")
    return (k - 1 - pad) // stride, (pad - 1) // stride + 1


def conv_transpose_band(x: torch.Tensor, conv: Callable, k: int, stride: int, pad: int,
                        output_padding: int, sp, h_axis: int) -> torch.Tensor:
    """``conv`` (a transposed convolution of kernel ``k``, ``stride``,
    ``pad`` and ``output_padding`` along ``h_axis``) of a band of the
    scene: the band with its neighbours' rows (zero rows at the scene's
    edge, where the scene's transposed conv has no input), transposed, and
    cropped to the band's output rows."""
    band = x.shape[h_axis]
    top, bot = conv_transpose_rows(band, sp.n_spatial, k, stride, pad, output_padding)
    # the scene's output being stride x its rows, the band's output holds
    # stride x (top + band + bot) rows, its own from stride x top on
    y = conv(halo_rows(x, top, bot, "zeros", sp, h_axis))
    return y.narrow(h_axis, stride * top, stride * band)


def _edge_rows(x: torch.Tensor, n: int, mode: str, at_top: bool, h: int) -> torch.Tensor:
    """The ``n`` rows (along axis ``h``) that the padding ``mode`` puts
    beyond the scene's top or bottom edge of ``x``."""
    H = x.shape[h]
    if mode == "zeros":
        shape = list(x.shape)
        shape[h] = n
        return x.new_zeros(shape)
    if mode == "replicate":
        edge = x.narrow(h, 0 if at_top else H - 1, 1)
        return edge.expand(*[n if i == h else -1 for i in range(x.dim())])
    if H < n + 1:
        raise ValueError(f"a reflect pad of {n} rows at the scene's edge needs a band of at "
                         f"least {n + 1} rows, not {H}")
    return x.narrow(h, 1 if at_top else H - n - 1, n).flip(h)


def halo_rows(x: torch.Tensor, top: int, bot: int, mode: str, sp, h_axis: int = 1):
    """A band with ``top`` rows above and ``bot`` rows below it (along
    ``h_axis``): its neighbours' rows (``halo_exchange``, differentiable)
    where it has them, the padding ``mode``'s rows at the scene's edge. Both
    halos enter the result on every rank (empty where unused), so every
    rank runs the exchange's backward."""
    if mode == "circular":
        raise NotImplementedError("a circular pad wraps to the scene's other edge: not "
                                  "under a spatial split")
    h = h_axis % x.dim()
    k = max(top, bot)
    if not k:
        return x
    above, below = mesh.halo_exchange(x, k, h, sp, keep_edges=True)
    # at the scene's edge the exchange gives no rows: the mode's rows follow
    above = (above.narrow(h, k - top, top) if above.shape[h]
             else torch.cat([above, _edge_rows(x, top, mode, True, h)], dim=h))
    below = (below.narrow(h, 0, bot) if below.shape[h]
             else torch.cat([below, _edge_rows(x, bot, mode, False, h)], dim=h))
    return torch.cat([above, x, below], dim=h)


def band_pad(x: torch.Tensor, top: int, bot: int, cols: int, mode: str, sp) -> torch.Tensor:
    """Pad a band [N,H,W,C] of the scene by ``top`` rows above, ``bot``
    below and ``cols`` columns on each side: its neighbours' rows where it
    has them (:func:`halo_rows`), the padding mode's rows at the scene's
    edge, and the mode's columns."""
    xe = halo_rows(x, top, bot, mode, sp)
    if not cols:
        return xe
    if mode == "zeros":
        return F.pad(xe, (0, 0, cols, cols))
    return F.pad(xe.unsqueeze(1), (0, 0, cols, cols, 0, 0), mode=mode).squeeze(1)


class Norm2d(nn.Module):
    """batch | group | instance | none over NHWC maps, with the activation
    that follows it (``act``: none, gelu, relu) in the same call.

    Statistics accumulate in fp32; the affine is applied in the activation
    dtype. Batch norm uses eps 1e-5 and momentum 0.1 (torch convention,
    unbiased running variance); instance norm has no affine parameters. On
    the card every norm and its activation is one call of kernel family K6
    (ops/norm.py) each way; on the CPU the same formula runs as eager ops."""

    fuses_act = True  # takes the activation after it (run_fused)

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

    def forward(self, x: torch.Tensor, act: str = "none") -> torch.Tensor:
        if self.norm == "none":
            return activation(x, act)
        if self.norm == "batch" and not self.training:
            m, v = self.running_mean, self.running_var
            r = torch.rsqrt(v + 1e-5)
            coef = (r * self.weight).to(x.dtype)
            offs = (self.bias - m * r * self.weight).to(x.dtype)
            return affine_act(x, coef, offs, act)
        affine = (self.weight, self.bias) if self.norm != "instance" else (None, None)
        y, m, v, n = norm_act(x, self.norm, *affine, groups=self.n_groups, act=act)
        if self.norm == "batch" and not getattr(_RECOMPUTE, "on", False):
            with torch.no_grad():
                self.running_mean.copy_(0.9 * self.running_mean + 0.1 * m)
                self.running_var.copy_(0.9 * self.running_var
                                       + 0.1 * (v * unbiased_factor(n)))
        return y


def fusable_act(m: Optional[nn.Module]) -> Optional[str]:
    """The K6 activation a module computes (ReLU, exact GELU, LeakyReLU of
    slope 0.01), or None."""
    if isinstance(m, nn.ReLU):
        return "relu"
    if isinstance(m, nn.GELU) and m.approximate == "none":
        return "gelu"
    if isinstance(m, nn.LeakyReLU) and m.negative_slope == 0.01:
        return "leaky_relu"
    return None


def run_fused(seq: nn.Sequential, x: torch.Tensor) -> torch.Tensor:
    """Run a Sequential, handing an activation that follows a norm
    (``fuses_act``: Norm2d, UNet3D's batch norm) to the norm: one call on
    the card, the same function."""
    mods = list(seq)
    i = 0
    while i < len(mods):
        m = mods[i]
        act = fusable_act(mods[i + 1]) if i + 1 < len(mods) else None
        if getattr(m, "fuses_act", False) and act:
            x, i = m(x, act=act), i + 2
        else:
            x, i = m(x), i + 1
    return x


class ConvLayer(nn.Module):
    """Conv2d (+ norm) (+ ReLU) stack; the reference's utae ConvLayer, with
    its ``conv`` Sequential indices (each norm takes its ReLU along)."""

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
        return run_fused(self.conv, x)


def frame_pad_mask(x: torch.Tensor, pad_value: float) -> torch.Tensor:
    """[B,T] mask of the frames of x [B,T,H,W,C] that are all ``pad_value``;
    under a spatial split, all pixels of the scene, not of the band."""
    mask = (x == pad_value).all(dim=(2, 3, 4))
    return mask if mesh.spatial() is None else mesh.spatial_all(mask)


def smart_apply(fn: Callable, x: torch.Tensor,
                pad_value: Optional[float] = None) -> torch.Tensor:
    """Apply an [N,H,W,C] function over [B,T,H,W,C] by folding time into
    the batch; frames that were all ``pad_value`` are re-filled with it."""
    if x.dim() == 4:
        return fn(x)
    b, t = x.shape[:2]
    pad_mask = None if pad_value is None else frame_pad_mask(x, pad_value)
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
