"""U-TAE: a U-Net whose bottleneck is a full L-TAE over time, its attention
shared by every skip level.

Port of uncrtaints_tpu/models/utae.py. The encoder runs on every frame
(time folded into the batch); the L-TAE (value path, MLP, output norm,
attention dropout in training) collapses the bottleneck over T; each of the
n-1 skip levels is collapsed by ``TemporalAggregator(att_group)`` with the
L-TAE's attention bilinearly upsampled to that level, i.e. kernel K1 three
times a forward at the published four-level widths, then the U-Net decoder.
The skip aggregator has no dropout (the reference's Temporal_Aggregator).

Layout: x [B,T,H,W,C_in], dates [B,T] -> [B,1,H,W,out_conv[-1]].
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from uncrtaints_tpu_torch.models.aggregator import TemporalAggregator
from uncrtaints_tpu_torch.models.ltae import LTAE2d
from uncrtaints_tpu_torch.models.unet import S2_BANDS, _unet_stages, mean_var_heads


class UTAE(nn.Module):
    def __init__(self, input_dim: int, encoder_widths: Sequence[int] = (64, 64, 64, 128),
                 decoder_widths: Sequence[int] = (32, 32, 64, 128),
                 out_conv: Sequence[int] = (S2_BANDS,), out_nonlin_mean: bool = False,
                 out_nonlin_var: str = "relu", str_conv_k: int = 4, str_conv_s: int = 2,
                 str_conv_p: int = 1, agg_mode: str = "att_group", encoder_norm: str = "group",
                 norm_skip: str = "batch", norm_up: str = "batch", decoder_norm: str = "batch",
                 n_head: int = 16, d_model: int = 256, d_k: int = 4, pad_value: float = 0.0,
                 padding_mode: str = "reflect", positional_encoding: bool = True,
                 scale_by: float = 1.0):
        super().__init__()
        if len(encoder_widths) != len(decoder_widths):
            raise ValueError("encoder_widths and decoder_widths differ in length")
        if encoder_widths[-1] != decoder_widths[-1]:
            raise ValueError("encoder_widths[-1] must equal decoder_widths[-1]")
        self.out_nonlin_mean, self.out_nonlin_var = out_nonlin_mean, out_nonlin_var
        self.pad_value, self.scale_by = pad_value, scale_by
        self.in_conv, self.down_blocks, self.up_blocks, self.out_conv = _unet_stages(
            input_dim, encoder_widths, decoder_widths, out_conv, str_conv_k, str_conv_s,
            str_conv_p, encoder_norm, norm_skip, norm_up, decoder_norm, padding_mode)
        self.temporal_encoder = LTAE2d(
            in_channels=encoder_widths[-1], d_model=d_model, n_head=n_head, d_k=d_k,
            mlp=(d_model, encoder_widths[-1]), positional_encoding=positional_encoding,
            use_dropout=True)
        self.temporal_aggregator = TemporalAggregator(mode=agg_mode, dropout_rate=0.0)

    def forward(self, x: torch.Tensor, batch_positions: Optional[torch.Tensor] = None,
                dropout_generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``dropout_generator`` draws the L-TAE's two dropouts in training."""
        pad_mask = (x == self.pad_value).all(dim=(2, 3, 4))  # [B, T]
        feats = [self.in_conv(x)]
        for blk in self.down_blocks:
            feats.append(blk(feats[-1]))
        out, att = self.temporal_encoder(feats[-1], batch_positions=batch_positions,
                                         pad_mask=pad_mask, dropout_generator=dropout_generator)
        for i, blk in enumerate(self.up_blocks):
            skip = self.temporal_aggregator(feats[-2 - i], pad_mask=pad_mask, attn_mask=att)
            out = blk(out, skip)
        out = mean_var_heads(self.out_conv(out), self.out_nonlin_mean, self.out_nonlin_var,
                             self.scale_by)
        return out[:, None]
