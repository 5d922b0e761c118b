"""FPN-ConvLSTM (Rustowicz et al., "Semantic Segmentation of Crop Type in
Africa: A Novel Dataset and Analysis of Deep Learning Methods", CVPR-W 2019;
``FPNConvLSTM`` of utae-paps ``src/backbones/fpn.py``, which the UnCRtainTS
repo copies as ``model/src/backbones/fpn.py``), forward pass in plain fp32
PyTorch.

    x [B,T,H,W,C_in] -> on every frame, each block's all-pad_value frames
    filled with pad_value again after it:
      inconv:   [3x3 conv (reflect pad 1) + group norm + ReLU] x 2,
                C_in -> 32 -> 64
      pyramid:  a = 3x3 conv (zero pad 1) 64 -> 64; the 3x3 convs of a at
                dilations 1, 2, 4, 8 (reflect pads of the same size),
                64 -> 64 each, and max_{H,W} a broadcast over the map,
                concatenated: 320 channels
      mid_conv: 3x3 conv (reflect pad 1) + group norm + ReLU, 320 -> 160
    -> ConvLSTM over T, zero initial h and c, hidden 88:
      [i, f, o, g] = 3x3 conv (zero pad 1) of [x_t, h_{t-1}], 248 -> 4 x 88
      c_t = sigmoid(f) c_{t-1} + sigmoid(i) tanh(g)
      h_t = sigmoid(o) tanh(c_t)
    -> c at each sample's last unpadded frame -> 1x1 conv, 88 -> 13

Every convolution has a bias; the group norms have 4 groups, eps 1e-5 and a
per-channel affine. Departures from the published model, shared by the
program: the head reconstructs the 13 S2 bands with no nonlinearity (the L2
loss) where the published one classifies; the last cell state is taken at
frame (number of unpadded frames - 1) of each sample (padding trails the
sequence; the published model indexes the stacked states with a batch
vector). The dates are not read.

Written with nothing but ``torch`` calls and no branch on the data, so that
it runs on the meta device, where the benchmark counts its FLOPs.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from bench_h100.reference import common as c


def conv(P, name: str, x, q, pad: int = 1, mode: str = "reflect", dilation: int = 1):
    """Convolution ``name`` with a reflect (``F.pad``) or zero (``padding=``)
    pad of ``pad`` and ``dilation``."""
    if pad and mode == "reflect":
        x, pad = F.pad(x, (pad, pad, pad, pad), mode="reflect"), 0
    return F.conv2d(q(x), q(P[f"{name}.weight"]), P[f"{name}.bias"], padding=pad,
                    dilation=dilation)


def conv_layer(P, p: str, a, layers: int, m: dict, train: bool, q):
    """ConvLayer ``p``: ``layers`` x [3x3 conv ``p.conv.conv.{3i}`` (reflect
    pad 1) + group norm ``p.conv.conv.{3i+1}`` + ReLU]."""
    for i in range(layers):
        a = conv(P, f"{p}.conv.conv.{3 * i}", a, q)
        a = F.relu(c.norm(P, f"{p}.conv.conv.{3 * i + 1}", a, "group", train, m["groups"]))
    return a


def shared(fn, a, pad_value: float):
    """``fn`` on every frame of a [B*T,C,H,W]; the frames of ``a`` that are
    all ``pad_value`` are ``pad_value`` again in the output."""
    empty = (a == pad_value).flatten(1).all(dim=1)[:, None, None, None]
    return torch.where(empty, pad_value, fn(a))


def pyramid(P, a, m: dict, q):
    a = conv(P, "pyramid.inconv", a, q, mode="zeros")
    levels = [conv(P, f"pyramid.convs.{i}", a, q, pad=2 ** i, dilation=2 ** i)
              for i in range(m["n_levels"] - 1)]
    g = a.amax(dim=(2, 3), keepdim=True).expand_as(a)
    return torch.cat(levels + [g], dim=1)


def forward(P, x: torch.Tensor, dates: torch.Tensor, m: dict, train: bool,
            drop: c.Dropout = c.no_dropout, q=c.exact):
    """(mean, None) [B,1,H,W,13] in scaled units for x [B,T,H,W,C_in]
    (already multiplied by scale_by)."""
    B, T, H, W = x.shape[:4]
    pad_mask = c.frame_pad_mask(x, m["pad_value"])
    pv = m["pad_value"]
    a = c.fold_frames(x)
    a = shared(lambda t: conv_layer(P, "inconv", t, len(m["inconv"]), m, train, q), a, pv)
    a = shared(lambda t: pyramid(P, t, m, q), a, pv)
    if m["mid_conv"]:
        a = shared(lambda t: conv_layer(P, "mid_conv", t, 1, m, train, q), a, pv)
    a = a.reshape(B, T, *a.shape[1:])
    hid = m["hidden_size"]
    h = cell = x.new_zeros(B, hid, H, W)
    cells = []
    for t in range(T):
        gates = conv(P, "convlstm.cell_list.0.conv", torch.cat([a[:, t], h], dim=1), q,
                     mode="zeros")
        i, f, o, g = gates.chunk(4, dim=1)
        cell = torch.sigmoid(f) * cell + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(cell)
        cells.append(cell)
    last = ((~pad_mask).sum(dim=1) - 1).clamp(0, T - 1)
    at_last = torch.arange(T, device=x.device)[None] == last[:, None]  # [B,T]
    cell = torch.where(at_last[:, :, None, None, None], torch.stack(cells, dim=1), 0.0).sum(1)
    return c.heads(m, conv(P, "outconv", cell, q, pad=0))
