"""MBConv (inverted bottleneck with squeeze-and-excitation) and its SE.

Port of uncrtaints_tpu/models/blocks.py (SE, MBConv with its standard and
fused eval bodies). Submodules carry the reference names: ``conv.norm`` is
the PreNorm, ``conv.fn.{0..8}`` the pointwise conv, norm, GELU, depthwise
3x3 conv, norm, GELU, SE, pointwise-linear conv and norm.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from uncrtaints_tpu_torch.models.layers import (
    Conv2d, Linear, Norm2d, gelu, smart_apply)
from uncrtaints_tpu_torch.ops.mbconv import norm_gelu_matmul


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
        body computes it in fp32); ``scale_only`` returns the [N,C] gate."""
        if mean is None:
            N, H, W, C = x.shape
            y = (x.sum(dim=(1, 2), dtype=torch.float32) / (H * W)).to(x.dtype)
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

    ``fused_eval`` runs the eval-mode batch-norm body with both pointwise
    convolutions through kernel K3 (:func:`norm_gelu_matmul`) when the
    widths allow it (inp and hidden multiples of 128, as in the JAX
    package). UnCRtainTS uses expansion 2 without downsampling; the other
    variants of the reference block are not ported."""

    def __init__(self, inp: int, oup: int, expansion: int = 4,
                 norm: str = "batch", n_groups: int = 4,
                 pad_value: Optional[float] = None, fused_eval: bool = False):
        super().__init__()
        if expansion == 1:
            raise NotImplementedError("MBConv with expansion 1 is not ported")
        if inp != oup:
            raise NotImplementedError("MBConv needs inp == oup (residual add)")
        self.inp, self.oup, self.norm = inp, oup, norm
        self.hidden = int(inp * expansion)
        self.pad_value, self.fused_eval = pad_value, fused_eval
        hidden = self.hidden
        fn = nn.Sequential(
            Conv2d(inp, hidden, 1, 1, 0, bias=False),
            Norm2d(norm, hidden, n_groups),
            nn.GELU(),
            Conv2d(hidden, hidden, 3, 1, 1, padding_mode="reflect", bias=False,
                   groups=hidden),
            Norm2d(norm, hidden, n_groups),
            nn.GELU(),
            SE(inp, hidden),
            Conv2d(hidden, oup, 1, 1, 0, bias=False),
            Norm2d(norm, oup, n_groups))
        self.conv = PreNorm(inp, fn, norm, n_groups)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [N,H,W,C] or [B,T,H,W,C] (time folded into the batch)."""
        if (self.fused_eval and not self.training and self.norm == "batch"
                and self.inp % 128 == 0 and self.hidden % 128 == 0):
            return smart_apply(self._fused_body, x, self.pad_value)
        return smart_apply(self._body, x, self.pad_value)

    def _body(self, a: torch.Tensor) -> torch.Tensor:
        fn = self.conv.fn
        if self.norm == "batch" and not self.training:
            # eval batch norm is affine: fold the PreNorm into pw1 (exact)
            h = fn[0](a, input_affine=self.conv.norm.fold())
        else:
            h = fn[0](self.conv.norm(a))
        h = gelu(fn[1](h))
        h = gelu(fn[4](fn[3](h)))
        h = fn[8](fn[7](fn[6](h)))
        return a + h

    def _fused_body(self, a: torch.Tensor) -> torch.Tensor:
        """Eval body with both pointwise GEMMs as K3 launches: gelu(bn1(pw1(
        prenorm(a)))) with the PreNorm affine as prologue and bn1 + GELU as
        epilogue; the depthwise conv in torch; then bn3(pw2(se * gelu(bn2(
        h2)))) with bn2 + GELU + the SE gate as prologue and bn3 as epilogue.
        The SE pooled vector is the fp32 mean of gelu(bn2(h2)). The GEMM
        weights go to the kernel as bf16."""
        fn = self.conv.fn
        NF, H, W, C = a.shape
        P, hidden = H * W, self.hidden
        zero = torch.zeros((NF, 1), dtype=torch.float32, device=a.device)
        one = torch.ones((NF, 1), dtype=torch.float32, device=a.device)

        c0, o0 = self.conv.norm.fold()
        w1 = fn[0].weight[:, :, 0, 0].t().to(torch.bfloat16).contiguous()
        h1, _, _ = norm_gelu_matmul(
            a.contiguous().view(NF, P, C), zero, one, c0, o0, w1, groups_in=1,
            do_gelu=False, out_affine=fn[1].fold(), out_gelu=True,
            do_stats=False)

        h2 = fn[3](h1.view(NF, H, W, hidden)).contiguous()
        c2, o2 = fn[4].fold()
        m2 = F.gelu(h2.float() * c2 + o2).mean(dim=(1, 2))
        s = fn[6](h2, mean=m2, scale_only=True)

        w2 = fn[7].weight[:, :, 0, 0].t().to(torch.bfloat16).contiguous()
        y, _, _ = norm_gelu_matmul(
            h2.view(NF, P, hidden), zero, one, c2, o2, w2, se=s, groups_in=1,
            do_gelu=True, out_affine=fn[8].fold(), do_stats=False)
        return a + y.view(NF, H, W, self.oup)
