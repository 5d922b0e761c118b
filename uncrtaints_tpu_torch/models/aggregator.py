"""Temporal aggregators: collapse T attention-weighted frames to one map.

Port of uncrtaints_tpu/models/aggregator.py. Features x [B,T,H,W,C];
attention [B,T,H',W',n_head] at the attention resolution. ``att_group``
runs kernel K1 (:func:`att_group_aggregate`), differentiable through its
backward kernel.

Attention dropout in training draws its mask from an explicit
``torch.Generator`` that the caller passes (the train step's counterpart of
the JAX step's ``dropout_rng``), never from the global generator. The masks
differ from the JAX package's (another generator), their law does not:
each weight is kept with probability 1-p and scaled by 1/(1-p), as flax's
Dropout. The JAX config's ``prng_impl`` (threefry or rbg) has no
counterpart: the port's Config does not carry it.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from uncrtaints_tpu_torch.ops.aggregate import att_group_aggregate
from uncrtaints_tpu_torch.ops.resize import avg_pool2d, upsample_bilinear


def attention_dropout(a: torch.Tensor, rate: float,
                      generator: Optional[torch.Generator]) -> torch.Tensor:
    """Keep each element with probability 1-rate and scale it by
    1/(1-rate) (flax's Dropout), the mask drawn from ``generator``."""
    if generator is None:
        raise ValueError("attention dropout in training needs an explicit "
                         "torch.Generator (the train step's dropout generator)")
    keep = torch.rand(a.shape, generator=generator, device=a.device) < 1.0 - rate
    return torch.where(keep, a / (1.0 - rate), torch.zeros((), dtype=a.dtype,
                                                            device=a.device))


def _match_resolution(attn: torch.Tensor, hw: tuple) -> torch.Tensor:
    """Upsample (bilinear, half-pixel) or average-pool attention [B,T,h,w,k]
    to the feature resolution; both dims are compared, so a W-only mismatch
    resizes too."""
    H, W = hw
    h_att, w_att = attn.shape[2], attn.shape[3]
    if (H, W) == (h_att, w_att):
        return attn
    if H > h_att or W > w_att:
        return upsample_bilinear(attn, (H, W))
    return avg_pool2d(attn, w_att // W)


class TemporalAggregator(nn.Module):
    """mode att_group | att_mean | mean. ``dropout_rate`` is the compact
    aggregator's attention dropout, applied in training only (for att_group
    only after an upsample)."""

    def __init__(self, mode: str = "att_group", dropout_rate: float = 0.1):
        super().__init__()
        if mode not in ("att_group", "att_mean", "mean"):
            raise NotImplementedError(mode)
        self.mode, self.dropout_rate = mode, dropout_rate

    def forward(self, x: torch.Tensor, pad_mask: Optional[torch.Tensor] = None,
                attn_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x [B,T,H,W,C] -> [B,H,W,C]; ``generator`` draws the dropout mask
        in training."""
        B, T, H, W, C = x.shape
        if attn_mask is not None:
            attn_mask = attn_mask.to(x.dtype)  # aggregate in the feature dtype
        if self.mode == "att_group":
            attn = _match_resolution(attn_mask, (H, W))
            upsampled = (attn.shape[2] > attn_mask.shape[2]
                         or attn.shape[3] > attn_mask.shape[3])
            if upsampled and self.dropout_rate > 0 and self.training:
                attn = attention_dropout(attn, self.dropout_rate, generator)
            if pad_mask is not None:
                attn = attn * (~pad_mask)[:, :, None, None, None].to(attn.dtype)
            return att_group_aggregate(x.contiguous(), attn.contiguous())
        if self.mode == "att_mean":
            attn = _match_resolution(attn_mask.mean(dim=-1, keepdim=True), (H, W))
            if self.dropout_rate > 0 and self.training:
                attn = attention_dropout(attn, self.dropout_rate, generator)
            if pad_mask is not None:
                attn = attn * (~pad_mask)[:, :, None, None, None].to(attn.dtype)
            return (x * attn).sum(dim=1)
        if pad_mask is not None:
            keep = (~pad_mask).to(x.dtype)
            out = (x * keep[:, :, None, None, None]).sum(dim=1)
            return out / keep.sum(dim=1)[:, None, None, None]
        return x.mean(dim=1)
