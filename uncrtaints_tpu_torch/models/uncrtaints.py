"""UnCRtainTS: multi-temporal cloud removal with aleatoric uncertainty.

Port of uncrtaints_tpu/models/uncrtaints.py:

  1x1 in_conv -> in_block MBConvs -> adaptive max pool to low_res ->
  L-TAE tiny attention over day offsets -> att_group temporal aggregation at
  full resolution -> out_block MBConvs -> 1x1 out_conv -> mean and variance
  nonlinearities.

Layout: x [B,T,H,W,C_in], dates [B,T] -> [B,1,H,W,C_out] with the mean in
channels [0:13] and the variance in [13:vars_idx]. Ported so far: MBConv
blocks, the tiny L-TAE and the shared output head (residual blocks,
``use_v`` and ``separate_out`` are not).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from uncrtaints_tpu_torch.models.aggregator import TemporalAggregator
from uncrtaints_tpu_torch.models.blocks import MBConv
from uncrtaints_tpu_torch.models.layers import ConvBlock, smart_apply, softplus_t20
from uncrtaints_tpu_torch.models.ltae import LTAE2dtiny
from uncrtaints_tpu_torch.ops.pooling import adaptive_max_pool2d

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
        if block_type != "mbconv" or use_v or separate_out:
            raise NotImplementedError(
                "not ported yet: block_type='residual', use_v, separate_out")
        if encoder_widths[-1] != decoder_widths[-1]:
            raise ValueError("encoder_widths[-1] must equal decoder_widths[-1]")
        self.out_nonlin_mean, self.out_nonlin_var = out_nonlin_mean, out_nonlin_var
        self.pad_value, self.covmode, self.scale_by = pad_value, covmode, scale_by
        self.is_mono, self.low_res_size = is_mono, low_res_size
        covar_dim = {"uni": S2_BANDS, "iso": 1, "diag": S2_BANDS}.get(covmode, 0)
        self.mean_idx, self.vars_idx = S2_BANDS, S2_BANDS + covar_dim

        self.in_conv = ConvBlock([input_dim, encoder_widths[0]], k=1, s=1, p=0,
                                 norm=encoder_norm, padding_mode=padding_mode)
        self.in_block = nn.ModuleList(
            MBConv(w, w, expansion=2, norm=encoder_norm, fused_eval=fused_eval)
            for w in encoder_widths)
        if not is_mono:
            self.temporal_encoder = LTAE2dtiny(
                in_channels=encoder_widths[0], d_model=d_model, n_head=n_head,
                d_k=d_k, positional_encoding=positional_encoding)
            self.temporal_aggregator = TemporalAggregator(mode=agg_mode)
        self.out_block = nn.ModuleList(
            MBConv(w, w, expansion=2, norm=decoder_norm, fused_eval=fused_eval)
            for w in decoder_widths)
        self.out_conv = ConvBlock([decoder_widths[0]] + list(out_conv), k=1, s=1,
                                  p=0, norm="none", last_relu=False,
                                  padding_mode=padding_mode)

    def forward(self, x: torch.Tensor,
                batch_positions: Optional[torch.Tensor] = None,
                dropout_generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``dropout_generator`` draws the aggregator's attention dropout
        mask in training (needed when the attention is upsampled)."""
        pad_mask = (x == self.pad_value).all(dim=(2, 3, 4))  # [B, T]
        out = self.in_conv(x)
        for blk in self.in_block:
            out = blk(out)
        if not self.is_mono:
            ar = self.low_res_size
            down = smart_apply(lambda a: adaptive_max_pool2d(a, (ar, ar)), out)
            att = self.temporal_encoder(down, batch_positions=batch_positions,
                                        pad_mask=pad_mask)
            out = self.temporal_aggregator(out, pad_mask=pad_mask, attn_mask=att,
                                           generator=dropout_generator)
        else:
            out = out[:, 0]
        for blk in self.out_block:
            out = blk(out)
        out = self.out_conv(out)[:, None]  # [B, 1, H, W, C_out]

        eps = 1e-9 if self.scale_by == 1.0 else 1e-3
        out_loc = out[..., :self.mean_idx]
        if self.out_nonlin_mean:
            out_loc = self.scale_by * torch.sigmoid(out_loc)
        if self.covmode not in ("uni", "iso", "diag"):
            return out_loc
        out_cov = variance_nonlinearity(self.out_nonlin_var, eps)(
            out[..., self.mean_idx:self.vars_idx])
        return torch.cat([out_loc, out_cov], dim=-1)
