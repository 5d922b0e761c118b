"""Recurrent baselines: ConvLSTM and ConvGRU cells, the recurrent U-Net, the
segmentation-head models and the FPN + ConvLSTM model.

Port of uncrtaints_tpu/models/recurrent.py. The JAX package's ``lax.scan``
over time is a Python loop over T here; states are NHWC. Where a pad mask is
given, the last states are those of each sample's last unpadded frame (the
JAX package's per-sample gather; the reference indexes with a batch vector,
COMPONENTS.md:38).

Submodules carry the reference's names where
uncrtaints_tpu/models/torch_import.py maps them: a ConvLSTM's cell is
``cell_list.0`` with its gate conv ``conv``; RecUNet has ``in_conv``,
``down_blocks``, ``temporal_encoder``, ``out_convlstm``, ``up_blocks``,
``out_conv``; FPNConvLSTM ``inconv``, ``pyramid`` (``inconv``, ``convs.{i}``),
``mid_conv``, ``convlstm``, ``outconv``. Two exceptions: a ConvGRU's cell is
``cell_list.0`` with ``in_conv`` and ``out_conv`` (that file has no table
for it), and the bidirectional ConvLSTM's two directions are
``convlstm_forward`` and ``convlstm_backward``, not that table's ``forward``
and ``backward``: a submodule named ``forward`` hides behind the module's
``forward`` method, where ``add_module`` refuses it and
``torch.func.functional_call`` (the train and eval steps) cannot reach it.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from uncrtaints_tpu_torch.config import Config, input_dim
from uncrtaints_tpu_torch.models.aggregator import TemporalAggregator
from uncrtaints_tpu_torch.models.layers import Conv2d, ConvBlock, smart_apply
from uncrtaints_tpu_torch.models.unet import S2_BANDS, DownConvBlock, UpConvBlock


def _last_valid(seq: torch.Tensor, pad_mask: torch.Tensor) -> torch.Tensor:
    """seq [B,T,...] at each sample's last unpadded frame (frame 0 when all
    are padded)."""
    T = seq.shape[1]
    last = ((~pad_mask).sum(dim=1) - 1).clamp(0, T - 1)
    return seq[torch.arange(seq.shape[0], device=seq.device), last]


class ConvLSTMCell(nn.Module):
    """The i, f, o, g gates from one zero-padded conv over [x, h]."""

    def __init__(self, input_dim: int, hidden_dim: int, kernel: int = 3):
        super().__init__()
        self.conv = Conv2d(input_dim + hidden_dim, 4 * hidden_dim, kernel=kernel,
                           pad=kernel // 2, padding_mode="zeros")

    def forward(self, x: torch.Tensor, h: torch.Tensor, c: torch.Tensor):
        i, f, o, g = self.conv(torch.cat([x, h], dim=-1)).chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        return torch.sigmoid(o) * torch.tanh(c), c


class ConvGRUCell(nn.Module):
    """The z and r gates from one conv over [x, h], the candidate from a
    second over [x, r * h]."""

    def __init__(self, input_dim: int, hidden_dim: int, kernel: int = 3):
        super().__init__()
        conv = lambda n: Conv2d(input_dim + hidden_dim, n, kernel=kernel, pad=kernel // 2,
                                padding_mode="zeros")
        self.in_conv, self.out_conv = conv(2 * hidden_dim), conv(hidden_dim)

    def forward(self, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        z, r = torch.sigmoid(self.in_conv(torch.cat([x, h], dim=-1))).chunk(2, dim=-1)
        cand = torch.tanh(self.out_conv(torch.cat([x, r * h], dim=-1)))
        return (1 - z) * h + z * cand


class ConvLSTM(nn.Module):
    """One ConvLSTM layer over x [B,T,H,W,C] -> (outputs [B,T,H,W,hidden],
    (h, c) last states), zero initial states."""

    def __init__(self, input_dim: int, hidden_dim: int, kernel: int = 3):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.cell_list = nn.ModuleList([ConvLSTMCell(input_dim, hidden_dim, kernel)])

    def forward(self, x: torch.Tensor, pad_mask: Optional[torch.Tensor] = None):
        h = x.new_zeros(*x.shape[:1], *x.shape[2:4], self.hidden_dim)
        c, hs, cs = h, [], []
        for t in range(x.shape[1]):
            h, c = self.cell_list[0](x[:, t], h, c)
            hs.append(h)
            cs.append(c)
        hs = torch.stack(hs, dim=1)
        if pad_mask is not None:
            h, c = _last_valid(hs, pad_mask), _last_valid(torch.stack(cs, dim=1), pad_mask)
        return hs, (h, c)


class ConvGRU(nn.Module):
    """One ConvGRU layer: x [B,T,H,W,C] -> (outputs, last state)."""

    def __init__(self, input_dim: int, hidden_dim: int, kernel: int = 3):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.cell_list = nn.ModuleList([ConvGRUCell(input_dim, hidden_dim, kernel)])

    def forward(self, x: torch.Tensor, pad_mask: Optional[torch.Tensor] = None):
        h, hs = x.new_zeros(*x.shape[:1], *x.shape[2:4], self.hidden_dim), []
        for t in range(x.shape[1]):
            h = self.cell_list[0](x[:, t], h)
            hs.append(h)
        hs = torch.stack(hs, dim=1)
        if pad_mask is not None:
            h = _last_valid(hs, pad_mask)
        return hs, h


class BConvLSTM(nn.Module):
    """Bidirectional ConvLSTM: the last cell states of a forward pass and of
    a pass over the reversed sequence (padded frames zero-filled there),
    concatenated on the channels."""

    def __init__(self, input_dim: int, hidden_dim: int, kernel: int = 3):
        super().__init__()
        self.convlstm_forward = ConvLSTM(input_dim, hidden_dim, kernel)
        self.convlstm_backward = ConvLSTM(input_dim, hidden_dim, kernel)

    def forward(self, x: torch.Tensor, pad_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        _, (_, c_f) = self.convlstm_forward(x, pad_mask=pad_mask)
        x_rev = x.flip(1)
        if pad_mask is not None:
            x_rev = x_rev.masked_fill(pad_mask.flip(1)[:, :, None, None, None], 0.0)
        _, (_, c_b) = self.convlstm_backward(x_rev)
        return torch.cat([c_f, c_b], dim=-1)


class ConvLSTMSeg(nn.Module):
    """ConvLSTM, then a zero-padded 3x3 conv head on the last cell state."""

    def __init__(self, num_classes: int, input_dim: int, hidden_dim: int = 160,
                 kernel: int = 3, pad_value: float = 0.0):
        super().__init__()
        self.pad_value = pad_value
        self.convlstm_encoder = ConvLSTM(input_dim, hidden_dim, kernel)
        self.classification_layer = Conv2d(hidden_dim, num_classes, kernel=kernel, pad=1,
                                           padding_mode="zeros")

    def forward(self, x: torch.Tensor, batch_positions: Optional[torch.Tensor] = None,
                dropout_generator: Optional[torch.Generator] = None) -> torch.Tensor:
        pad_mask = (x == self.pad_value).all(dim=(2, 3, 4))
        _, (_, c) = self.convlstm_encoder(x, pad_mask=pad_mask)
        return self.classification_layer(c)[:, None]


class ConvGRUSeg(nn.Module):
    """ConvGRU, then a zero-padded 3x3 conv head on the last state."""

    def __init__(self, num_classes: int, input_dim: int, hidden_dim: int = 180,
                 kernel: int = 3, pad_value: float = 0.0):
        super().__init__()
        self.pad_value = pad_value
        self.convgru_encoder = ConvGRU(input_dim, hidden_dim, kernel)
        self.classification_layer = Conv2d(hidden_dim, num_classes, kernel=kernel, pad=1,
                                           padding_mode="zeros")

    def forward(self, x: torch.Tensor, batch_positions: Optional[torch.Tensor] = None,
                dropout_generator: Optional[torch.Generator] = None) -> torch.Tensor:
        pad_mask = (x == self.pad_value).all(dim=(2, 3, 4))
        _, h = self.convgru_encoder(x, pad_mask=pad_mask)
        return self.classification_layer(h)[:, None]


class RecUNet(nn.Module):
    """Recurrent U-Net: the U-Net encoder on every frame, a ConvLSTM (lstm),
    bidirectional ConvLSTM (blstm), masked mean (mean) or the first frame
    (mono) at the bottleneck, masked-mean skips, the U-Net decoder (its skip
    and up norms batch norms, the reference's defaults)."""

    def __init__(self, input_dim: int, encoder_widths: Sequence[int] = (64, 64, 64, 128),
                 decoder_widths: Sequence[int] = (32, 32, 64, 128),
                 out_conv: Sequence[int] = (S2_BANDS,), temporal: str = "lstm",
                 encoder_norm: str = "group", hidden_dim: int = 128, str_conv_k: int = 4,
                 str_conv_s: int = 2, str_conv_p: int = 1, padding_mode: str = "reflect",
                 pad_value: float = 0.0):
        super().__init__()
        if temporal not in ("lstm", "blstm", "mean", "mono"):
            raise NotImplementedError(temporal)
        if encoder_widths[-1] != decoder_widths[-1]:
            raise ValueError("encoder_widths[-1] must equal decoder_widths[-1]")
        n = len(encoder_widths)
        self.temporal, self.pad_value = temporal, pad_value
        self.in_conv = ConvBlock([input_dim, encoder_widths[0], encoder_widths[0]],
                                 norm=encoder_norm, padding_mode=padding_mode)
        self.down_blocks = nn.ModuleList(
            DownConvBlock(encoder_widths[i], encoder_widths[i + 1], k=str_conv_k,
                          s=str_conv_s, p=str_conv_p, norm=encoder_norm,
                          padding_mode=padding_mode) for i in range(n - 1))
        if temporal in ("lstm", "blstm"):
            rnn = ConvLSTM if temporal == "lstm" else BConvLSTM
            self.temporal_encoder = rnn(encoder_widths[-1], hidden_dim)
            c_in = hidden_dim * (2 if temporal == "blstm" else 1)
            self.out_convlstm = Conv2d(c_in, encoder_widths[-1], kernel=3, pad=1,
                                       padding_mode="zeros")
        self.temporal_aggregator = TemporalAggregator(mode="mean", dropout_rate=0.0)
        self.up_blocks = nn.ModuleList(
            UpConvBlock(d_in=decoder_widths[n - 1 - i], d_out=decoder_widths[n - 2 - i],
                        d_skip=encoder_widths[n - 2 - i], k=str_conv_k, s=str_conv_s,
                        norm=encoder_norm, norm_skip="batch", norm_up="batch",
                        padding_mode=padding_mode) for i in range(n - 1))
        self.out_conv = ConvBlock([decoder_widths[0]] + list(out_conv), k=1, s=1, p=0,
                                  padding_mode=padding_mode)

    def forward(self, x: torch.Tensor, batch_positions: Optional[torch.Tensor] = None,
                dropout_generator: Optional[torch.Generator] = None) -> torch.Tensor:
        pad_mask = (x == self.pad_value).all(dim=(2, 3, 4))
        feats = [self.in_conv(x)]
        for blk in self.down_blocks:
            feats.append(blk(feats[-1]))
        if self.temporal == "mean":
            out = self.temporal_aggregator(feats[-1], pad_mask=pad_mask)
        elif self.temporal == "lstm":
            _, (_, c) = self.temporal_encoder(feats[-1], pad_mask=pad_mask)
            out = self.out_convlstm(c)
        elif self.temporal == "blstm":
            out = self.out_convlstm(self.temporal_encoder(feats[-1], pad_mask=pad_mask))
        else:
            out = feats[-1][:, 0]
        for i, blk in enumerate(self.up_blocks):
            f = feats[-2 - i]
            skip = (f[:, 0] if self.temporal == "mono"
                    else self.temporal_aggregator(f, pad_mask=pad_mask))
            out = blk(out, skip)
        return self.out_conv(out)[:, None]


class PyramidBlock(nn.Module):
    """Atrous feature pyramid: a zero-padded 3x3 conv, then n_levels-1
    dilated 3x3 convs (dilation 2^i, reflect-padded) of its output,
    concatenated with the spatially broadcast global max of that output."""

    def __init__(self, input_dim: int, n_channels: int = 64, n_levels: int = 5):
        super().__init__()
        self.inconv = Conv2d(input_dim, n_channels, kernel=3, pad=1, padding_mode="zeros")
        self.convs = nn.ModuleList(
            Conv2d(n_channels, n_channels, kernel=3, pad=2 ** i, dilation=2 ** i,
                   padding_mode="reflect") for i in range(n_levels - 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.inconv(x)
        gmp = out.amax(dim=(1, 2))  # [N, C]
        levels = [conv(out) for conv in self.convs]
        g = gmp[:, None, None, :].expand(-1, *out.shape[1:3], -1)
        return torch.cat(levels + [g], dim=-1)


class FPNConvLSTM(nn.Module):
    """Feature pyramid (on every frame) + ConvLSTM + a 1x1 conv head."""

    def __init__(self, input_dim: int, num_classes: int, inconv: Sequence[int] = (32, 64),
                 n_levels: int = 5, n_channels: int = 64, hidden_size: int = 88,
                 mid_conv: bool = True, pad_value: float = 0.0):
        super().__init__()
        self.pad_value = pad_value
        self.inconv = ConvBlock([input_dim] + list(inconv), norm="group", pad_value=pad_value)
        self.pyramid = PyramidBlock(inconv[-1], n_channels, n_levels)
        width = n_channels * n_levels
        self.mid_conv = None
        if mid_conv:
            self.mid_conv = ConvBlock([width, width // 2], norm="group", pad_value=pad_value)
            width //= 2
        self.convlstm = ConvLSTM(width, hidden_size)
        self.outconv = Conv2d(hidden_size, num_classes, kernel=1, pad=0, padding_mode="zeros")

    def forward(self, x: torch.Tensor, batch_positions: Optional[torch.Tensor] = None,
                dropout_generator: Optional[torch.Generator] = None) -> torch.Tensor:
        pad_mask = (x == self.pad_value).all(dim=(2, 3, 4))
        out = smart_apply(self.pyramid, self.inconv(x), self.pad_value)
        if self.mid_conv is not None:
            out = self.mid_conv(out)
        _, (_, c) = self.convlstm(out, pad_mask=pad_mask)
        return self.outconv(c)[:, None]


def build_recurrent(cfg: Config) -> nn.Module:
    """The recurrent baselines by ``cfg.model``, at the JAX package's default
    widths (the config's widths do not reach them)."""
    dim, out_ch = input_dim(cfg), cfg.out_conv[-1]
    if cfg.model in ("uconvlstm", "buconvlstm"):
        return RecUNet(input_dim=dim, out_conv=tuple(cfg.out_conv),
                       temporal="lstm" if cfg.model == "uconvlstm" else "blstm",
                       pad_value=cfg.pad_value, padding_mode=cfg.padding_mode)
    if cfg.model == "convlstm":
        return ConvLSTMSeg(num_classes=out_ch, input_dim=dim, pad_value=cfg.pad_value)
    if cfg.model == "convgru":
        return ConvGRUSeg(num_classes=out_ch, input_dim=dim, pad_value=cfg.pad_value)
    if cfg.model == "fpn":
        return FPNConvLSTM(input_dim=dim, num_classes=out_ch, pad_value=cfg.pad_value)
    raise NotImplementedError(cfg.model)
