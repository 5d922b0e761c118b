"""L-TAE: temporal attention over day offsets from learned queries.

Port of uncrtaints_tpu/models/ltae.py (positional_encoding_table,
GroupNormCT, LTAE2dtiny: attention masks only; LTAE2d: attention-weighted
values, an MLP head and an output norm, for ``use_v``). Input [B,T,H,W,C]
at the attention resolution; the projections act on the channel axis.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from uncrtaints_tpu_torch.models.aggregator import attention_dropout
from uncrtaints_tpu_torch.models.layers import Conv1d, Linear, batch_moments_f32


def positional_encoding_table(positions: torch.Tensor, d: int, T: int = 1000,
                              repeat: Optional[int] = None) -> torch.Tensor:
    """Sin/cos table over day offsets: positions [B,T_seq] -> [B,T_seq,
    d * (repeat or 1)]; denom_i = T^(2*(i//2)/d), sin on even channels, cos
    on odd ones."""
    # made on the positions' device (a copy of a host array would make the
    # host wait for the device in every forward), in fp64 as numpy would
    i = torch.arange(d, device=positions.device, dtype=torch.float64)
    denom = torch.pow(float(T), 2.0 * torch.floor(i / 2) / d).float()
    table = positions[..., None] / denom
    sin, cos = torch.sin(table[..., 0::2]), torch.cos(table[..., 1::2])
    if d % 2:  # odd d: one sin more than cos; the pad slot is dropped below
        cos = F.pad(cos, (0, 1))
    out = torch.stack([sin, cos], dim=-1).reshape(*table.shape[:-1], -1)[..., :d]
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


def _attention(mod: nn.Module, x: torch.Tensor,
               batch_positions: Optional[torch.Tensor],
               pad_mask: Optional[torch.Tensor]):
    """The part the two L-TAEs share: in_norm, inconv, the positional
    encoding, keys against the learned queries, pad fill, softmax over T.
    Returns (the d_model features [B,T,H,W,d_model], attention
    [B,T,H,W,n_head] in fp32)."""
    h, d_k = mod.n_head, mod.d_k
    out = F.linear(mod.in_norm(x), mod.inconv.weight[..., 0], mod.inconv.bias)
    if mod.positional_encoding and batch_positions is not None:
        pe = positional_encoding_table(batch_positions.float(),
                                       mod.d_model // h, T=mod.T, repeat=h)
        out = out + pe[:, :, None, None, :].to(out.dtype)
    k = mod.attention_heads.fc1_k(out)
    k = k.reshape(*k.shape[:-1], h, d_k)
    q = mod.attention_heads.Q
    logits = (k.float() * q.float()).sum(-1) / math.sqrt(d_k)
    if pad_mask is not None:
        logits = logits.masked_fill(pad_mask[:, :, None, None, None], -1e3)
    return out, torch.softmax(logits, dim=1)


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
        return _attention(self, x, batch_positions, pad_mask)[1]


class BatchNorm1d(nn.Module):
    """Batch norm over the rows of [P,C], as the JAX package's L-TAE runs it
    (flax BatchNorm, momentum 0.9 = torch's 0.1, eps 1e-5): fp32 statistics
    as E[x^2] - E[x]^2, and the running variance takes the *biased* batch
    variance (torch's BatchNorm1d would store the unbiased one). No
    ``num_batches_tracked`` buffer, as the port's other batch norms."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        nn.init.normal_(self.weight, generator=generator)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            m, v, _ = batch_moments_f32(x, (0,))  # the global batch's under data parallel
            with torch.no_grad():
                self.running_mean.copy_(0.9 * self.running_mean + 0.1 * m)
                self.running_var.copy_(0.9 * self.running_var + 0.1 * v)
        else:
            m, v = self.running_mean, self.running_var
        y = (x.float() - m) * torch.rsqrt(v + 1e-5) * self.weight.float() + self.bias.float()
        return y.to(x.dtype)


class GroupNorm(nn.GroupNorm):
    """nn.GroupNorm in fp32 with the port's ``reset_parameters(generator)``."""

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        super().reset_parameters()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(x.float(), self.num_groups, self.weight.float(),
                            self.bias.float(), self.eps).to(x.dtype)


class LTAE2d(nn.Module):
    """Full L-TAE: x [B,T,H,W,C], positions [B,T], pad_mask [B,T] bool ->
    (values [B,H,W,mlp[-1]], attention [B,T,H,W,n_head] fp32).

    The values are d_model split into n_head contiguous channel groups,
    each weighted by its head's attention and summed over T; then per stage
    Linear -> BatchNorm1d over the flattened B*H*W pixels -> ReLU, dropout,
    and ``out_norm``: a GroupNorm over each pixel's channels (the flattened
    [B*H*W, C] batch, not pooled over H and W). In training the two
    dropouts draw from ``dropout_generator``."""

    def __init__(self, in_channels: int = 128, n_head: int = 16, d_k: int = 4,
                 mlp: Sequence[int] = (256, 128), dropout: float = 0.2,
                 d_model: int = 256, T: int = 1000,
                 positional_encoding: bool = True, use_dropout: bool = True):
        super().__init__()
        if mlp[0] != d_model:
            raise ValueError(f"mlp[0]={mlp[0]} must equal d_model={d_model}")
        self.n_head, self.d_k, self.d_model, self.T = n_head, d_k, d_model, T
        self.positional_encoding = positional_encoding
        self.dropout, self.use_dropout = dropout, use_dropout
        self.in_norm = GroupNormCT(n_head, in_channels)
        self.inconv = Conv1d(in_channels, d_model, 1)
        self.attention_heads = MultiHeadAttentionSmall(n_head, d_k, d_model)
        stages = []
        for i in range(len(mlp) - 1):
            stages += [Linear(mlp[i], mlp[i + 1]), BatchNorm1d(mlp[i + 1]), nn.ReLU()]
        self.mlp = nn.Sequential(*stages)
        self.out_norm = GroupNorm(n_head, mlp[-1])

    def forward(self, x: torch.Tensor, batch_positions: Optional[torch.Tensor] = None,
                pad_mask: Optional[torch.Tensor] = None,
                dropout_generator: Optional[torch.Generator] = None):
        out, attn = _attention(self, x, batch_positions, pad_mask)
        if self.use_dropout and self.training:
            attn = attention_dropout(attn, 0.1, dropout_generator)
        B, T, H, W, _ = out.shape
        h = self.n_head
        v = out.reshape(B, T, H, W, h, self.d_model // h)
        agg = (attn.to(out.dtype)[..., None] * v).sum(dim=1)
        y = self.mlp(agg.reshape(B * H * W, self.d_model))
        if self.dropout > 0 and self.training:
            y = attention_dropout(y, self.dropout, dropout_generator)
        return self.out_norm(y).reshape(B, H, W, -1), attn
