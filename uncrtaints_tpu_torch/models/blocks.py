"""Encoder/decoder blocks: MBConv (inverted bottleneck with squeeze-and-
excitation) and the residual conv block.

Port of uncrtaints_tpu/models/blocks.py (SE, MBConv with its standard and
fused eval bodies, ResidualConvBlock). Submodules carry the reference
names: in MBConv ``conv.norm`` is the PreNorm and ``conv.fn.{0..8}`` the
pointwise conv, norm, GELU, depthwise 3x3 conv, norm, GELU, SE,
pointwise-linear conv and norm; in ResidualConvBlock ``conv1..3`` are the
three ConvLayers.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from uncrtaints_tpu_torch import tracing
from uncrtaints_tpu_torch.models.layers import (
    Conv2d, ConvLayer, Linear, Norm2d, gelu, smart_apply)
from uncrtaints_tpu_torch.ops.mbconv import norm_gelu_dwconv3x3, norm_gelu_matmul
from uncrtaints_tpu_torch.ops.norm import (
    group_affine, group_moments, norm_apply, norm_gelu_pool, norm_stats)
from uncrtaints_tpu_torch.parallel import mesh


def _max_pool_3x3_s2(a: torch.Tensor) -> torch.Tensor:
    """3x3 max pool of [N,H,W,C] at stride 2, pad 1 (MBConv ``downsample``'s
    residual). Under a spatial split ``a`` is a band of even rows: output
    row m reads rows 2m-1 to 2m+1, so the band takes the last row of the
    band above (nothing at the scene's top, as the pad)."""
    sp = mesh.spatial()
    if sp is None:
        return F.max_pool2d(a.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)
    if a.shape[1] % 2:
        raise NotImplementedError(f"MBConv downsample under a spatial split: a band of "
                                  f"{a.shape[1]} rows (odd) would start a pool window mid-band")
    top, bot = mesh.halo_exchange(a, 1, 1, sp, keep_edges=True)
    if not top.shape[1]:  # the scene's top: the pad's -inf row
        top = torch.cat([top, a.new_full((a.shape[0], 1, *a.shape[2:]), float("-inf"))], 1)
    # the unused halo enters with no rows, so every rank runs the exchange's backward
    ext = torch.cat([top, a, bot.narrow(1, 0, 0)], dim=1).permute(0, 3, 1, 2)
    return F.max_pool2d(ext, 3, 2, padding=(0, 1)).permute(0, 2, 3, 1)


class SE(nn.Module):
    """Squeeze-and-excitation: global average pool -> Linear(oup -> inp/4)
    -> GELU -> Linear(-> oup) -> sigmoid, applied as a channel gate."""

    def __init__(self, inp: int, oup: int, expansion: float = 0.25):
        super().__init__()
        hid = int(inp * expansion)
        self.fc = nn.Sequential(Linear(oup, hid, bias=False), nn.GELU(),
                                Linear(hid, oup, bias=False), nn.Sigmoid())

    def forward(self, x: torch.Tensor, mean: Optional[torch.Tensor] = None,
                scale_only: bool = False) -> torch.Tensor:
        """x [N,H,W,C]. ``mean`` [N,C] replaces the pooled vector (the fused
        body computes it in fp32); ``scale_only`` returns the [N,C] gate.
        Under a spatial split the mean is the scene's: the bands' sums are
        summed over the spatial group."""
        if mean is None:
            N, H, W, C = x.shape
            pooled = x.sum(dim=(1, 2), dtype=torch.float32)
            sp = mesh.spatial()
            if sp is not None:
                pooled, H = mesh.spatial_sum(pooled, sp), H * sp.n_spatial
            y = (pooled / (H * W)).to(x.dtype)
        else:
            y = mean
        y = gelu(F.linear(y, self.fc[0].weight.to(y.dtype)))
        y = torch.sigmoid(F.linear(y, self.fc[2].weight.to(y.dtype)))
        if scale_only:
            return y
        return x * y[:, None, None, :]


class PreNorm(nn.Module):
    """Holds the block's input norm and its body (the reference's PreNorm
    names); MBConv drives both."""

    def __init__(self, dim: int, fn: nn.Module, norm: str, n_groups: int):
        super().__init__()
        self.norm = Norm2d(norm, dim, n_groups)
        self.fn = fn


class MBConv(nn.Module):
    """PreNorm -> pw 1x1 (inp -> hidden) -> norm + GELU -> dw 3x3 reflect ->
    norm + GELU -> SE -> pw-linear (hidden -> oup) -> norm; residual add.

    ``expansion == 1`` drops the first pointwise conv and the SE: PreNorm ->
    dw 3x3 reflect -> norm + GELU -> pw-linear -> norm (``conv.fn.{0,1,3,4}``).
    ``downsample`` halves H and W (the first conv of the body at stride 2)
    and replaces the residual by ``proj``, a bias-free 1x1 conv of the 3x3
    stride-2 max pool of the input (pad 1). No configured model builds these
    two variants; they complete the reference block. Under a spatial split
    the strided convs and the pool read the rows above a band (even bands).

    ``fused_eval`` runs the eval-mode body as the kernel chain K3 -> K4 ->
    K3 (:func:`norm_gelu_matmul`, :func:`norm_gelu_dwconv3x3`) when the
    widths allow it (inp and hidden multiples of 128, as in the JAX
    package), for the standard block only (no downsample, expansion above
    1), as the JAX package: with batch norms (``_fused_body``), whose folded
    affines the kernels take, and with group norms (``_fused_group_body``;
    the JAX package has no such chain) where a group is whole 8-channel
    chunks, the kernels taking each norm's per-(frame, group) statistics
    from the kernel before. Instance norm, ``none`` and train mode keep the
    standard body."""

    def __init__(self, inp: int, oup: int, expansion: int = 4,
                 norm: str = "batch", n_groups: int = 4,
                 pad_value: Optional[float] = None, fused_eval: bool = False,
                 downsample: bool = False):
        super().__init__()
        if inp != oup and not downsample:
            raise ValueError("MBConv needs inp == oup for its residual add (or downsample)")
        self.inp, self.oup, self.norm, self.n_groups = inp, oup, norm, n_groups
        self.hidden = int(inp * expansion)
        self.expansion, self.downsample = expansion, downsample
        self.pad_value, self.fused_eval = pad_value, fused_eval
        hidden, stride = self.hidden, 2 if downsample else 1
        dw = lambda s: Conv2d(hidden, hidden, 3, s, 1, padding_mode="reflect", bias=False,
                              groups=hidden)
        if expansion == 1:
            fn = nn.Sequential(dw(stride), Norm2d(norm, hidden, n_groups), nn.GELU(),
                               Conv2d(hidden, oup, 1, 1, 0, bias=False),
                               Norm2d(norm, oup, n_groups))
        else:
            fn = nn.Sequential(
                Conv2d(inp, hidden, 1, stride, 0, bias=False),
                Norm2d(norm, hidden, n_groups),
                nn.GELU(),
                dw(1),
                Norm2d(norm, hidden, n_groups),
                nn.GELU(),
                SE(inp, hidden),
                Conv2d(hidden, oup, 1, 1, 0, bias=False),
                Norm2d(norm, oup, n_groups))
        self.conv = PreNorm(inp, fn, norm, n_groups)
        if downsample:
            self.proj = Conv2d(inp, oup, 1, 1, 0, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [N,H,W,C] or [B,T,H,W,C] (time folded into the batch)."""
        if (self.fused_eval and not self.training and not self.downsample
                and self.expansion != 1 and self.inp % 128 == 0 and self.hidden % 128 == 0):
            if self.norm == "batch":
                return smart_apply(self._fused_body, x, self.pad_value)
            # K3's pipelined kernel takes input groups of whole 8-channel chunks
            if self.norm == "group" and self.inp % (8 * self.n_groups) == 0:
                return smart_apply(self._fused_group_body, x, self.pad_value)
        return smart_apply(self._body, x, self.pad_value)

    def _body(self, a: torch.Tensor) -> torch.Tensor:
        fn = self.conv.fn
        if (self.norm == "batch" and not self.training and not self.downsample
                and self.expansion != 1):
            # eval batch norm is affine: fold the PreNorm into pw1 (exact)
            h = fn[0](a, input_affine=self.conv.norm.fold())
        else:
            h = fn[0](self.conv.norm(a))
        h = fn[1](h, act="gelu")  # norm + GELU: one K6 call on the card
        if self.expansion == 1:
            h = fn[4](fn[3](h))
        else:
            h = fn[4](fn[3](h), act="gelu")
            h = fn[8](fn[7](fn[6](h)))
        if self.downsample:
            return self.proj(_max_pool_3x3_s2(a)) + h
        return a + h

    def _fused_body(self, a: torch.Tensor) -> torch.Tensor:
        """Eval body as the kernel chain K3 -> K4 -> K3: pw1(prenorm(a))
        with the PreNorm affine as K3's prologue; gelu(bn1(.)) and the
        reflect depthwise 3x3 in one K4 launch, bn1's folded affine being
        its norm; then bn3(pw2(se * gelu(bn2(h2)))) with bn2 + GELU + the SE
        gate as K3's prologue and bn3 as its epilogue. The SE pooled vector
        is the fp32 mean of gelu(bn2(h2)): K4 sums it per channel in the
        pass that writes h2 (``pool_affine``), so h2 is not read again. The
        GEMM weights go to K3 as bf16 [C,C2]; K4 takes the depthwise weight
        as [3,3,C]. The kernels' group statistics are not asked for (batch
        norm needs none; ``_fused_group_body`` asks for them). The small
        weight transforms and folds are redone every
        forward: the eval step hands the module fresh casts of its
        parameters each time, so there is nothing stable to key a cache on.

        Under a spatial split ``a`` is a band of the scene: K4 runs in halo
        mode on h1's neighbouring rows, and its pooled sum, the band's, is
        summed over the spatial group before the SE gate and divided by the
        scene's pixels (one all-reduce a block)."""
        fn = self.conv.fn
        NF, H, W, C = a.shape
        P, hidden = H * W, self.hidden
        zero = torch.zeros((NF, 1), dtype=torch.float32, device=a.device)
        one = torch.ones((NF, 1), dtype=torch.float32, device=a.device)

        c0, o0 = self.conv.norm.fold()
        w1 = fn[0].weight[:, :, 0, 0].t().to(torch.bfloat16).contiguous()
        h1, _, _ = norm_gelu_matmul(
            a.contiguous().view(NF, P, C), zero, one, c0, o0, w1, groups_in=1,
            do_gelu=False, do_stats=False)

        c1, o1 = fn[1].fold()
        c2, o2 = fn[4].fold()
        wd = fn[3].weight[:, 0].permute(1, 2, 0)  # [C,1,3,3] -> [3,3,C]
        h1 = h1.view(NF, H, W, hidden)
        sp = mesh.spatial()
        h2, _, _, pool = norm_gelu_dwconv3x3(
            h1, zero, one, c1, o1, wd, groups_in=1, groups_out=1, do_stats=False,
            pool_affine=(c2, o2), halo=None if sp is None else mesh.halo_exchange(h1, 1, 1, sp))
        if sp is not None:
            pool = mesh.spatial_sum(pool, sp)
        s = fn[6](h2, mean=pool / (H * W * (1 if sp is None else sp.n_spatial)),
                  scale_only=True)

        w2 = fn[7].weight[:, :, 0, 0].t().to(torch.bfloat16).contiguous()
        y, _, _ = norm_gelu_matmul(
            h2.view(NF, P, hidden), zero, one, c2, o2, w2, se=s, groups_in=1,
            do_gelu=True, out_affine=fn[8].fold(), do_stats=False)
        return a + y.view(NF, H, W, self.oup)

    def _fused_group_body(self, a: torch.Tensor) -> torch.Tensor:
        """Eval body with group norms as the kernel chain of ``_fused_body``,
        each norm's per-(frame, group) mean and rsqrt(var + eps) computed
        from sums the pass before took (K6's formula, :func:`group_moments`):
        K6's statistics pass over a; pw1(gn0(a)) with gn0 as K3's prologue,
        gn1's sums in its epilogue; gelu(gn1(h1)) and the reflect depthwise
        3x3 in one K4 launch, gn2's sums in it; the SE pooled vector, the
        fp32 mean of gelu(gn2(h2)), in a read-only pass
        (:func:`norm_gelu_pool`: gn2's statistics exist only once h2 is
        written); pw2(se * gelu(gn2(h2))) with gn2 + GELU + the gate as
        K3's prologue, gn3's sums in its epilogue; gn3 applied by K6's apply
        pass; the residual add. Counted in the step's ``gn_chain`` counter
        (a's bytes).

        Under a spatial split ``a`` is a band of the scene, as in
        ``_fused_body``: K4 runs in halo mode, and each pass's sums, the
        band's, are summed over the spatial group before they are used (an
        all-reduce each: the four norms' statistics and the pooled vector)."""
        fn = self.conv.fn
        NF, H, W, C = a.shape
        P, hidden, G = H * W, self.hidden, self.n_groups
        if tracing.recording():
            tracing.count("gn_chain", tracing.nbytes(a))
        sp = mesh.spatial()
        # a band's sums -> the scene's; the scene's pixels a frame
        scene = lambda t: t if sp is None else mesh.spatial_sum(t, sp)
        Ps = P * (1 if sp is None else sp.n_spatial)
        a3 = a.contiguous().view(NF, P, C)
        gn0, gn1, gn2, gn3 = self.conv.norm, fn[1], fn[4], fn[8]

        m0, r0 = group_moments(scene(norm_stats(a3, G)), Ps * C // G)
        w1 = fn[0].weight[:, :, 0, 0].t().to(torch.bfloat16).contiguous()
        h1, s1, q1 = norm_gelu_matmul(a3, m0, r0, gn0.weight, gn0.bias, w1, groups_in=G,
                                      groups_out=G, do_gelu=False, do_stats=True)

        m1, r1 = group_moments(scene(torch.stack([s1, q1])), Ps * hidden // G)
        wd = fn[3].weight[:, 0].permute(1, 2, 0)  # [C,1,3,3] -> [3,3,C]
        h1 = h1.view(NF, H, W, hidden)
        h2, s2, q2 = norm_gelu_dwconv3x3(
            h1, m1, r1, gn1.weight, gn1.bias, wd, groups_in=G, groups_out=G, do_stats=True,
            halo=None if sp is None else mesh.halo_exchange(h1, 1, 1, sp))

        m2, r2 = group_moments(scene(torch.stack([s2, q2])), Ps * hidden // G)
        pool = scene(norm_gelu_pool(h2, m2, r2, gn2.weight, gn2.bias))
        s = fn[6](h2, mean=pool / Ps, scale_only=True)
        w2 = fn[7].weight[:, :, 0, 0].t().to(torch.bfloat16).contiguous()
        y, s3, q3 = norm_gelu_matmul(h2.view(NF, P, hidden), m2, r2, gn2.weight, gn2.bias, w2,
                                     se=s, groups_in=G, groups_out=G, do_gelu=True,
                                     do_stats=True)

        m3, r3 = group_moments(scene(torch.stack([s3, q3])), Ps * self.oup // G)
        coef, off = group_affine(m3, r3, gn3.weight, gn3.bias, y.dtype)
        return a + norm_apply(y, coef, off).view(NF, H, W, self.oup)


class ResidualConvBlock(nn.Module):
    """Three ConvLayers (3x3, norm + ReLU) with the residual add on the
    third; time folded into the batch, all-pad frames re-filled."""

    def __init__(self, width: int, norm: str = "batch", n_groups: int = 4,
                 k: int = 3, s: int = 1, p: int = 1,
                 padding_mode: str = "reflect",
                 pad_value: Optional[float] = None):
        super().__init__()
        self.pad_value = pad_value
        mk = lambda: ConvLayer([width, width], norm=norm, k=k, s=s, p=p,
                               n_groups=n_groups, last_relu=True,
                               padding_mode=padding_mode)
        self.conv1, self.conv2, self.conv3 = mk(), mk(), mk()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [N,H,W,C] or [B,T,H,W,C]."""
        body = lambda a: a + self.conv3(self.conv2(self.conv1(a)))
        return smart_apply(body, x, self.pad_value)
