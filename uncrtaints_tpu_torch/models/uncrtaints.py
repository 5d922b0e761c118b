"""UnCRtainTS: multi-temporal cloud removal with aleatoric uncertainty.

Port of uncrtaints_tpu/models/uncrtaints.py:

  1x1 in_conv -> in_block (MBConv or residual) -> adaptive max pool to
  low_res -> L-TAE attention over day offsets -> temporal aggregation at
  full resolution with the upsampled attention (``use_v``: plus the L-TAE's
  upsampled values through the ``include_v`` 1x1 conv) -> out_block ->
  1x1 out_conv (shared, or ``separate_out`` mean and variance streams) ->
  mean and variance nonlinearities.

Layout: x [B,T,H,W,C_in], dates [B,T] -> [B,1,H,W,C_out] with the mean in
channels [0:13] and the variance in [13:vars_idx]. The JAX package's
``remat`` (a memory knob of its compiler) has no counterpart.

Under a spatial split (parallel/mesh.py) x holds one band of rows of each
scene: the pad mask is the scene's, and the layers exchange rows and sum
statistics over the spatial group themselves (models/layers.py, blocks.py,
ops/pooling.py, ops/resize.py); L-TAE and the aggregation work pixel by
pixel.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from uncrtaints_tpu_torch.models.aggregator import TemporalAggregator
from uncrtaints_tpu_torch.models.blocks import MBConv, ResidualConvBlock
from uncrtaints_tpu_torch.models.layers import (
    Conv2d, ConvBlock, smart_apply, softplus_t20)
from uncrtaints_tpu_torch.models.ltae import LTAE2d, LTAE2dtiny
from uncrtaints_tpu_torch.ops.pooling import adaptive_max_pool2d
from uncrtaints_tpu_torch.ops.resize import upsample_bilinear
from uncrtaints_tpu_torch.parallel import mesh

S2_BANDS = 13


def variance_nonlinearity(mode: str, eps: float):
    """The variance head's nonlinearity; 'relu' gets working semantics, as
    in the JAX package."""
    if mode == "relu":
        return lambda v: F.relu(v) + eps
    if mode == "softplus":
        return lambda v: softplus_t20(v) + eps
    if mode == "elu":
        return lambda v: F.elu(v) + 1 + eps
    return lambda v: v


class UNCRTAINTS(nn.Module):
    def __init__(self, input_dim: int, encoder_widths: Sequence[int] = (128,),
                 decoder_widths: Sequence[int] = (128, 128, 128, 128, 128),
                 out_conv: Sequence[int] = (S2_BANDS,),
                 out_nonlin_mean: bool = False, out_nonlin_var: str = "relu",
                 agg_mode: str = "att_group", encoder_norm: str = "group",
                 decoder_norm: str = "batch", n_head: int = 16,
                 d_model: int = 256, d_k: int = 4, pad_value: float = 0.0,
                 padding_mode: str = "reflect", positional_encoding: bool = True,
                 covmode: str = "diag", scale_by: float = 1.0,
                 separate_out: bool = False, use_v: bool = False,
                 block_type: str = "mbconv", is_mono: bool = False,
                 low_res_size: int = 32, fused_eval: bool = False):
        super().__init__()
        if block_type not in ("mbconv", "residual"):
            raise NotImplementedError(block_type)
        if encoder_widths[-1] != decoder_widths[-1]:
            raise ValueError("encoder_widths[-1] must equal decoder_widths[-1]")
        self.out_nonlin_mean, self.out_nonlin_var = out_nonlin_mean, out_nonlin_var
        self.pad_value, self.covmode, self.scale_by = pad_value, covmode, scale_by
        self.is_mono, self.low_res_size = is_mono, low_res_size
        self.use_v = use_v and not is_mono
        covar_dim = {"uni": S2_BANDS, "iso": 1, "diag": S2_BANDS}.get(covmode, 0)
        self.mean_idx, self.vars_idx = S2_BANDS, S2_BANDS + covar_dim

        self.in_conv = ConvBlock([input_dim, encoder_widths[0]], k=1, s=1, p=0,
                                 norm=encoder_norm, padding_mode=padding_mode)

        def block(w, norm):
            if block_type == "mbconv":
                return MBConv(w, w, expansion=2, norm=norm, fused_eval=fused_eval)
            return ResidualConvBlock(w, norm=norm, padding_mode=padding_mode)

        self.in_block = nn.ModuleList(block(w, encoder_norm) for w in encoder_widths)
        if not is_mono:
            if use_v:
                self.temporal_encoder = LTAE2d(
                    in_channels=encoder_widths[0], d_model=d_model, n_head=n_head,
                    d_k=d_k, mlp=(d_model, encoder_widths[0]),
                    positional_encoding=positional_encoding, use_dropout=False)
                self.include_v = Conv2d(2 * encoder_widths[0], encoder_widths[0],
                                        kernel=1, pad=0)
            else:
                self.temporal_encoder = LTAE2dtiny(
                    in_channels=encoder_widths[0], d_model=d_model, n_head=n_head,
                    d_k=d_k, positional_encoding=positional_encoding)
            self.temporal_aggregator = TemporalAggregator(mode=agg_mode)
        self.out_block = nn.ModuleList(block(w, decoder_norm) for w in decoder_widths)

        def head(widths):
            return ConvBlock(widths, k=1, s=1, p=0, norm="none", last_relu=False,
                             padding_mode=padding_mode)

        self.separate_out = separate_out
        self.has_var_head = out_conv[-1] - S2_BANDS > 0  # else a mean-only head
        if separate_out:
            self.out_conv_mean_1 = head([decoder_widths[0], S2_BANDS])
            if self.has_var_head:
                self.out_conv_var_1 = head([decoder_widths[0], out_conv[-1] - S2_BANDS])
        else:
            self.out_conv = head([decoder_widths[0]] + list(out_conv))

    def forward(self, x: torch.Tensor,
                batch_positions: Optional[torch.Tensor] = None,
                dropout_generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``dropout_generator`` draws the dropout masks in training (the
        aggregator's attention dropout when the attention is upsampled, the
        full L-TAE's MLP dropout)."""
        H, W = x.shape[2:4]
        pad_mask = (x == self.pad_value).all(dim=(2, 3, 4))  # [B, T]
        if mesh.spatial() is not None:  # x is a band: all pixels of the scene
            pad_mask = mesh.spatial_all(pad_mask)
        out = self.in_conv(x)
        for blk in self.in_block:
            out = blk(out)
        if not self.is_mono:
            ar = self.low_res_size
            down = smart_apply(lambda a: adaptive_max_pool2d(a, (ar, ar)), out)
            if self.use_v:
                v, att = self.temporal_encoder(
                    down, batch_positions=batch_positions, pad_mask=pad_mask,
                    dropout_generator=dropout_generator)
            else:
                att = self.temporal_encoder(down, batch_positions=batch_positions,
                                            pad_mask=pad_mask)
            out = self.temporal_aggregator(out, pad_mask=pad_mask, attn_mask=att,
                                           generator=dropout_generator)
            if self.use_v:
                up_v = upsample_bilinear(v, (H, W))
                out = self.include_v(torch.cat([out, up_v], dim=-1))
        else:
            out = out[:, 0]
        for blk in self.out_block:
            out = blk(out)
        if not self.separate_out:
            out = self.out_conv(out)
        elif self.has_var_head:
            out = torch.cat([self.out_conv_mean_1(out), self.out_conv_var_1(out)], dim=-1)
        else:
            out = self.out_conv_mean_1(out)
        out = out[:, None]  # [B, 1, H, W, C_out]

        eps = 1e-9 if self.scale_by == 1.0 else 1e-3
        out_loc = out[..., :self.mean_idx]
        if self.out_nonlin_mean:
            out_loc = self.scale_by * torch.sigmoid(out_loc)
        if self.covmode not in ("uni", "iso", "diag"):
            return out_loc
        out_cov = variance_nonlinearity(self.out_nonlin_var, eps)(
            out[..., self.mean_idx:self.vars_idx])
        return torch.cat([out_loc, out_cov], dim=-1)
