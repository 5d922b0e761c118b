"""U-TAE (Garnot & Landrieu, "Panoptic Segmentation of Satellite Image Time
Series with Convolutional Temporal Attention Networks", ICCV 2021;
``src/backbones/utae.py``), forward pass in plain fp32 PyTorch.

    x [B,T,H,W,C_in] -> 1x1 conv + group norm + ReLU (every frame) ->
    down blocks (4x4 conv stride 2 + norm + ReLU; 3x3 conv + norm + ReLU;
    + 3x3 conv + norm, residual) -> L-TAE on the last level: attention
    over the day offsets (dropout), values weighted by their head's
    attention and summed over T, Linear + batch norm + ReLU, dropout, group
    norm -> up blocks: 2x transposed conv + norm + ReLU, concatenated with
    the skip (1x1 conv + norm + ReLU of the level's features aggregated
    over T by att_group with the L-TAE's attention, bilinearly upsampled),
    3x3 conv + norm + ReLU, + 3x3 conv + norm (residual) -> 1x1 conv ->
    mean nonlinearity

Every convolution has a bias and a reflect pad. Departures from the
published model, shared by the program: the head reconstructs the 13 S2
bands (mean scale_by * sigmoid, no variance; the L2 loss) where the
published one classifies; the dropout masks are drawn from the step's
generator over the program's tensor layouts (the attention's [B,T,h,w,
heads], the MLP's [B*h*w, C]) so both sides drop the same elements.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from bench_h100.reference import common as c


def conv_norm(P, p: str, a, kind: str, train: bool, q, relu: bool = True, stride: int = 1,
              pad: int = 1):
    """ConvLayer: conv (``p.conv.0``) + norm (``p.conv.1``) (+ ReLU)."""
    a = c.norm(P, f"{p}.conv.1", c.conv(P, f"{p}.conv.0", a, q, stride=stride, pad=pad),
               kind, train)
    return F.relu(a) if relu else a


def down_block(P, p: str, a, kind: str, train: bool, q):
    a = conv_norm(P, f"{p}.down", a, kind, train, q, stride=2)
    o = conv_norm(P, f"{p}.conv1", a, kind, train, q)
    return o + conv_norm(P, f"{p}.conv2", o, kind, train, q, relu=False)


def up_block(P, p: str, a, skip, m: dict, train: bool, q):
    up = F.relu(c.norm(P, f"{p}.up.1", c.conv_transpose(P, f"{p}.up.0", a, q),
                       m["norm_up"], train))
    sk = F.relu(c.norm(P, f"{p}.skip_conv.1", c.conv(P, f"{p}.skip_conv.0", skip, q),
                       m["norm_skip"], train))
    o = conv_norm(P, f"{p}.conv1", torch.cat([up, sk], dim=1), m["decoder_norm"], train, q)
    return o + conv_norm(P, f"{p}.conv2", o, m["decoder_norm"], train, q, relu=False)


def ltae(P, p: str, x, dates, pad_mask, m: dict, train: bool, drop, q):
    """x [B,T,C,h,w] -> (values [B,C_out,h,w], attention [B,T,h,w,heads])."""
    B, T, C, h, w = x.shape
    heads, d_model = m["n_head"], m["d_model"]
    out, att = c.ltae_attention(P, p, x, dates, pad_mask, m, q)
    att = c.pixels_to_port(att, B, h, w)
    if train:
        att = drop(att, tuple(att.shape), m["attn_dropout"])
    v = out.reshape(-1, T, heads, d_model // heads)
    agg = (c.port_to_pixels(att)[..., None] * v).sum(dim=1).reshape(-1, d_model)
    y = c.linear(agg, P[f"{p}.mlp.0.weight"], P[f"{p}.mlp.0.bias"], q)
    w_bn, b_bn = P[f"{p}.mlp.1.weight"], P[f"{p}.mlp.1.bias"]
    if train:
        y = F.batch_norm(y, None, None, w_bn, b_bn, training=True, eps=c.EPS)
    else:
        y = F.batch_norm(y, P[f"{p}.mlp.1.running_mean"], P[f"{p}.mlp.1.running_var"], w_bn,
                         b_bn, training=False, eps=c.EPS)
    y = F.relu(y)
    if train:
        y = drop(y, tuple(y.shape), m["mlp_dropout"])
    y = F.group_norm(y, heads, P[f"{p}.out_norm.weight"], P[f"{p}.out_norm.bias"], c.EPS)
    return y.reshape(B, h, w, -1).permute(0, 3, 1, 2), att


def forward(P, x: torch.Tensor, dates: torch.Tensor, m: dict, train: bool,
            drop: c.Dropout = c.no_dropout, q=c.exact):
    """(mean, None) [B,1,H,W,13] in scaled units for x [B,T,H,W,C_in]
    (already multiplied by scale_by) and dates [B,T]."""
    B, T = x.shape[:2]
    pad_mask = c.frame_pad_mask(x, m["pad_value"])
    enc = m["encoder_norm"]
    feats = [F.relu(c.norm(P, "in_conv.conv.conv.1",
                           c.conv(P, "in_conv.conv.conv.0", c.fold_frames(x), q), enc, train))]
    for i in range(len(m["encoder_widths"]) - 1):
        feats.append(down_block(P, f"down_blocks.{i}", feats[-1], enc, train, q))
    unfold = lambda a: a.reshape(B, T, *a.shape[1:])
    out, att = ltae(P, "temporal_encoder", unfold(feats[-1]), dates, pad_mask, m, train,
                    drop, q)
    for i in range(len(m["decoder_widths"]) - 1):
        f = unfold(feats[-2 - i])
        a = c.match_resolution(att, *f.shape[-2:])
        a = a * (~pad_mask)[:, :, None, None, None].to(a.dtype)
        out = up_block(P, f"up_blocks.{i}", out, c.att_group(f, a), m, train, q)
    return c.heads(m, c.conv(P, "out_conv.conv.conv.0", out, q))
