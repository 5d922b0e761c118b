"""UnCRtainTS (Ebel et al., "UnCRtainTS: Uncertainty Quantification for
Cloud Removal in Optical Satellite Time Series", CVPR-W 2023), forward pass
in plain fp32 PyTorch.

    x [B,T,H,W,C_in] -> 1x1 conv + group norm + ReLU -> MBConv blocks
    (encoder) -> adaptive max pool to low_res -> L-TAE attention over the
    day offsets -> attention upsampled (bilinear), dropped out in training,
    zeroed on padded frames -> att_group aggregation over T -> MBConv blocks
    (decoder) -> 1x1 conv -> mean scale_by * sigmoid, variance softplus + eps

MBConv (the reference repo's ``model/uncrtaints.py``, after CoAtNet):
PreNorm -> 1x1 conv (C -> expansion*C, no bias) -> norm + GELU -> 3x3
depthwise conv, reflect pad (no bias) -> norm + GELU -> squeeze-excitation
(global mean, Linear C*e -> C/4, GELU, Linear -> C*e, sigmoid; no biases)
-> 1x1 conv (-> C, no bias) -> norm; residual add.

Departures from the published description, all shared by the program:
the variance eps is 1e-3 when scale_by != 1 (the reference repo's rule);
the attention dropout draws its mask from the step's generator over the
program's [B,T,H,W,heads] layout, so that both sides drop the same weights.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from bench_h100.reference import common as c


def mbconv(P, p: str, a: torch.Tensor, kind: str, train: bool, q) -> torch.Tensor:
    fn = f"{p}.conv.fn"
    h = c.norm(P, f"{p}.conv.norm", a, kind, train)
    h = c.conv(P, f"{fn}.0", h, q, bias=False)
    h = F.gelu(c.norm(P, f"{fn}.1", h, kind, train))
    h = c.conv(P, f"{fn}.3", h, q, pad=1, groups=h.shape[1], bias=False)
    h = F.gelu(c.norm(P, f"{fn}.4", h, kind, train))
    s = F.gelu(c.linear(h.mean(dim=(2, 3)), P[f"{fn}.6.fc.0.weight"], None, q))
    s = torch.sigmoid(c.linear(s, P[f"{fn}.6.fc.2.weight"], None, q))
    h = c.conv(P, f"{fn}.7", h * s[:, :, None, None], q, bias=False)
    return a + c.norm(P, f"{fn}.8", h, kind, train)


def block(P, p: str, a, kind: str, train: bool, q):
    """An MBConv block; under autograd its activations are recomputed in the
    backward (the same arithmetic; it holds a large batch's fp32 reference
    in the card's memory)."""
    if torch.is_grad_enabled() and a.requires_grad and not a.is_meta:  # (meta: FLOPs once)
        return checkpoint(mbconv, P, p, a, kind, train, q, use_reentrant=False)
    return mbconv(P, p, a, kind, train, q)


def forward(P, x: torch.Tensor, dates: torch.Tensor, m: dict, train: bool,
            drop: c.Dropout = c.no_dropout, q=c.exact):
    """(mean, variance) [B,1,H,W,13] in scaled units for x [B,T,H,W,C_in]
    (already multiplied by scale_by) and dates [B,T]."""
    B, T, H, W, _ = x.shape
    pad_mask = c.frame_pad_mask(x, m["pad_value"])
    a = c.conv(P, "in_conv.conv.conv.0", c.fold_frames(x), q)
    a = F.relu(c.norm(P, "in_conv.conv.conv.1", a, m["encoder_norm"], train))
    for i in range(len(m["encoder_widths"])):
        a = block(P, f"in_block.{i}", a, m["encoder_norm"], train, q)
    C, r = a.shape[1], m["low_res_size"]
    low = F.adaptive_max_pool2d(a, (r, r)).reshape(B, T, C, r, r)
    _, att = c.ltae_attention(P, "temporal_encoder", low, dates, pad_mask, m, q)
    att = c.match_resolution(c.pixels_to_port(att, B, r, r), H, W)  # [B,T,H,W,heads]
    if train and (H, W) != (r, r):
        att = drop(att, tuple(att.shape), m["agg_dropout"])
    att = att * (~pad_mask)[:, :, None, None, None].to(att.dtype)
    a = c.att_group(a.reshape(B, T, C, H, W), att)
    for i in range(len(m["decoder_widths"])):
        a = block(P, f"out_block.{i}", a, m["decoder_norm"], train, q)
    return c.heads(m, c.conv(P, "out_conv.conv.conv.0", a, q))
