"""L-TAE tiny: attention masks over time from learned queries.

Port of uncrtaints_tpu/models/ltae.py (positional_encoding_table,
GroupNormCT, LTAE2dtiny). Input [B,T,H,W,C] at the attention resolution;
the projections act on the channel axis. The full LTAE2d (``use_v``) is not
ported yet.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from uncrtaints_tpu_torch.models.layers import Conv1d, Linear


def positional_encoding_table(positions: torch.Tensor, d: int, T: int = 1000,
                              repeat: Optional[int] = None) -> torch.Tensor:
    """Sin/cos table over day offsets: positions [B,T_seq] -> [B,T_seq,
    d * (repeat or 1)]; denom_i = T^(2*(i//2)/d), sin on even channels, cos
    on odd ones."""
    i = np.arange(d)
    denom = torch.from_numpy(
        np.power(float(T), 2.0 * (i // 2) / d).astype(np.float32)).to(positions.device)
    table = positions[..., None] / denom
    out = torch.stack([torch.sin(table[..., 0::2]), torch.cos(table[..., 1::2])],
                      dim=-1).reshape(*table.shape[:-1], -1)
    if repeat is not None:
        out = out.repeat(*([1] * (out.dim() - 1)), repeat)
    return out


class GroupNormCT(nn.Module):
    """nn.GroupNorm(num_groups, C) over each pixel sequence's (channel group
    x time) slice, in fp32; per-channel affine. x [B,T,H,W,C]."""

    def __init__(self, num_groups: int, channels: int, eps: float = 1e-5):
        super().__init__()
        self.num_groups, self.eps = num_groups, eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, T, H, W, C = x.shape
        g = self.num_groups
        xg = x.float().reshape(B, T, H, W, g, C // g)
        mean = xg.mean(dim=(1, 5), keepdim=True)
        var = xg.var(dim=(1, 5), correction=0, keepdim=True)
        xg = (xg - mean) * torch.rsqrt(var + self.eps)
        return (xg.reshape(B, T, H, W, C) * self.weight.float()
                + self.bias.float()).to(x.dtype)


class MultiHeadAttentionSmall(nn.Module):
    """Learned input-independent queries ``Q`` [n_head, d_k] and the key
    projection ``fc1_k`` (the reference's names); LTAE2dtiny drives them."""

    def __init__(self, n_head: int, d_k: int, d_in: int):
        super().__init__()
        self.d_k = d_k
        self.Q = nn.Parameter(torch.zeros(n_head, d_k))
        self.fc1_k = Linear(d_in, n_head * d_k)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        nn.init.normal_(self.Q, std=math.sqrt(2.0 / self.d_k), generator=generator)


class LTAE2dtiny(nn.Module):
    """Attention-only L-TAE: x [B,T,H,W,C], positions [B,T], pad_mask [B,T]
    bool -> attention [B,T,H,W,n_head], fp32, softmax over T."""

    def __init__(self, in_channels: int = 128, n_head: int = 16, d_k: int = 4,
                 d_model: int = 256, T: int = 1000,
                 positional_encoding: bool = True):
        super().__init__()
        self.n_head, self.d_k, self.d_model, self.T = n_head, d_k, d_model, T
        self.positional_encoding = positional_encoding
        self.in_norm = GroupNormCT(n_head, in_channels)
        self.inconv = Conv1d(in_channels, d_model, 1)
        self.attention_heads = MultiHeadAttentionSmall(n_head, d_k, d_model)

    def forward(self, x: torch.Tensor, batch_positions: Optional[torch.Tensor] = None,
                pad_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        h, d_k = self.n_head, self.d_k
        out = F.linear(self.in_norm(x), self.inconv.weight[..., 0], self.inconv.bias)
        if self.positional_encoding and batch_positions is not None:
            pe = positional_encoding_table(batch_positions.float(),
                                           self.d_model // h, T=self.T, repeat=h)
            out = out + pe[:, :, None, None, :].to(out.dtype)
        k = self.attention_heads.fc1_k(out)
        k = k.reshape(*k.shape[:-1], h, d_k)
        q = self.attention_heads.Q
        logits = (k.float() * q.float()).sum(-1) / math.sqrt(d_k)
        if pad_mask is not None:
            logits = logits.masked_fill(pad_mask[:, :, None, None, None], -1e3)
        return torch.softmax(logits, dim=1)
