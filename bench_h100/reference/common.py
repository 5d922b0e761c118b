"""Plain PyTorch building blocks of the reference families, in fp32.

Every function takes the weights as a flat ``{name: tensor}`` dict with the
names of the port's ``state_dict`` (so the benchmark's seeded weights load
into both sides by name) and feature maps in NCHW. Nothing here imports the
program: the layers are written from the published descriptions (UnCRtainTS,
Ebel et al. 2023; U-TAE and L-TAE, Garnot & Landrieu 2020-21) with plain
``torch`` and ``torch.nn.functional`` calls.

``q`` is the precision of the matrix products: the identity for the fp32
reference, :func:`fp8_e4m3` for the control (the reference computed one
precision step below the bf16 that the configurations state).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

Weights = Dict[str, torch.Tensor]
Dropout = Callable[..., torch.Tensor]
EPS = 1e-5
S2_BANDS = 13


def exact(t: torch.Tensor) -> torch.Tensor:
    return t


def fp8_e4m3(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale a tensor (its largest
    magnitude to 448, the format's largest), back in fp32; the gradient
    passes straight through the rounding."""
    if t.is_meta:
        return t
    scale = 448.0 / t.detach().abs().amax().clamp(min=1e-30)
    r = (t.detach() * scale).to(torch.float8_e4m3fn).to(t.dtype) / scale
    return t + (r - t.detach())


def no_dropout(t: torch.Tensor, port_shape: tuple, rate: float, to_layout=None):
    return t


def seeded_dropout(gen: torch.Generator) -> Dropout:
    """Dropout whose keep mask is ``U[0,1) < 1 - rate`` drawn from ``gen`` in
    one call over ``port_shape``, the shape of the tensor the program draws
    for (its layout); the caller maps the mask to its own layout. Kept
    elements are scaled by 1 / (1 - rate)."""
    def drop(t, port_shape, rate, to_layout=None):
        if rate == 0:
            return t
        keep = torch.rand(port_shape, generator=gen, device=t.device) < 1.0 - rate
        if to_layout is not None:
            keep = to_layout(keep)
        return torch.where(keep, t / (1.0 - rate), torch.zeros((), dtype=t.dtype,
                                                                device=t.device))
    return drop


# ----------------------------------------------------------------- layers --

def conv(P: Weights, name: str, x: torch.Tensor, q, stride: int = 1, pad: int = 0,
         groups: int = 1, bias: bool = True) -> torch.Tensor:
    """Convolution with a reflect pad of ``pad`` (the configurations' padding
    mode), weight ``name.weight`` [out, in/groups, kh, kw]."""
    if pad:
        x = F.pad(x, (pad, pad, pad, pad), mode="reflect")
    b = P[f"{name}.bias"] if bias else None
    return F.conv2d(q(x), q(P[f"{name}.weight"]), b, stride=stride, groups=groups)


def conv_transpose(P: Weights, name: str, x: torch.Tensor, q) -> torch.Tensor:
    """The 2x upsampling: transposed convolution, kernel 4, stride 2, pad 1."""
    return F.conv_transpose2d(q(x), q(P[f"{name}.weight"]), P[f"{name}.bias"], stride=2,
                              padding=1)


def linear(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor], q) -> torch.Tensor:
    return F.linear(q(x), q(w), b)


def norm(P: Weights, name: str, x: torch.Tensor, kind: str, train: bool,
         groups: int = 4) -> torch.Tensor:
    """Group norm (``groups`` contiguous channel groups of each frame) or
    batch norm (batch statistics in training, running statistics else),
    eps 1e-5, per-channel affine."""
    w, b = P[f"{name}.weight"], P[f"{name}.bias"]
    if kind == "group":
        return F.group_norm(x, groups, w, b, EPS)
    if kind == "batch":
        if train:
            return F.batch_norm(x, None, None, w, b, training=True, eps=EPS)
        return F.batch_norm(x, P[f"{name}.running_mean"], P[f"{name}.running_var"], w, b,
                            training=False, eps=EPS)
    raise ValueError(f"unknown norm {kind!r}")


def frame_pad_mask(x: torch.Tensor, pad_value: float) -> torch.Tensor:
    """[B,T]: the frames of x [B,T,H,W,C] that hold nothing but ``pad_value``."""
    return (x == pad_value).all(dim=4).all(dim=3).all(dim=2)


def fold_frames(x: torch.Tensor) -> torch.Tensor:
    """[B,T,H,W,C] -> [B*T,C,H,W]."""
    B, T, H, W, C = x.shape
    return x.reshape(B * T, H, W, C).permute(0, 3, 1, 2)


def positional_encoding(dates: torch.Tensor, d: int, period: float, repeat: int):
    """The L-TAE's sinusoid table over day offsets, [B,T,d * repeat]:
    position / period^(2*(i//2)/d), sine on even channels, cosine on odd
    ones, the table tiled ``repeat`` times (once a head)."""
    i = torch.arange(d, dtype=torch.float64, device=dates.device)
    denom = torch.pow(float(period), 2.0 * torch.floor(i / 2) / d).to(torch.float32)
    table = dates.to(torch.float32)[..., None] / denom
    even = (torch.arange(d, device=dates.device) % 2 == 0)
    table = torch.where(even, torch.sin(table), torch.cos(table))
    return table.repeat(1, 1, repeat)


def ltae_attention(P: Weights, p: str, x: torch.Tensor, dates, pad_mask, m: dict, q):
    """The L-TAE's shared part on x [B,T,C,h,w]: the group norm over each
    pixel's (channel group x time) slice, the 1x1 input projection to
    d_model, the positional encoding, keys against the learned queries,
    masked and softmaxed over time. Returns (features [N,T,d_model],
    attention [N,T,heads]) with N = B*h*w pixels in (b, h, w) order."""
    B, T, C, h, w = x.shape
    heads, d_model, d_k = m["n_head"], m["d_model"], m["d_k"]
    xp = x.permute(0, 3, 4, 1, 2).reshape(B * h * w, T, C)
    xg = xp.reshape(-1, T, heads, C // heads)
    mean = xg.mean(dim=(1, 3), keepdim=True)
    var = xg.var(dim=(1, 3), correction=0, keepdim=True)
    xp = ((xg - mean) * torch.rsqrt(var + EPS)).reshape(-1, T, C)
    xp = xp * P[f"{p}.in_norm.weight"] + P[f"{p}.in_norm.bias"]
    out = linear(xp, P[f"{p}.inconv.weight"][..., 0], P[f"{p}.inconv.bias"], q)
    if m["positional_encoding"]:
        pe = positional_encoding(dates, d_model // heads, m["pe_period"], heads)  # [B,T,d]
        out = out + pe[:, None, None].expand(B, h, w, T, d_model).reshape(-1, T, d_model)
    k = linear(out, P[f"{p}.attention_heads.fc1_k.weight"],
               P[f"{p}.attention_heads.fc1_k.bias"], q).reshape(-1, T, heads, d_k)
    logits = (k * P[f"{p}.attention_heads.Q"]).sum(-1) / math.sqrt(d_k)
    pm = pad_mask[:, None, None, :].expand(B, h, w, T).reshape(-1, T)
    logits = logits.masked_fill(pm[..., None], -1e3)
    return out, torch.softmax(logits, dim=1)


def pixels_to_port(att: torch.Tensor, B: int, h: int, w: int) -> torch.Tensor:
    """[N,T,k] attention (pixels in (b, h, w) order) -> the program's
    [B,T,h,w,k] layout."""
    T, k = att.shape[1:]
    return att.reshape(B, h, w, T, k).permute(0, 3, 1, 2, 4)


def port_to_pixels(t: torch.Tensor) -> torch.Tensor:
    """The program's [B,T,h,w,k] layout -> [N,T,k]."""
    B, T, h, w, k = t.shape
    return t.permute(0, 2, 3, 1, 4).reshape(B * h * w, T, k)


def match_resolution(att: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """Attention [B,T,h,w,k] at the features' resolution: bilinear with
    half-pixel centres (edges clamped) up, a mean over windows down."""
    B, T, h, w, k = att.shape
    if (h, w) == (H, W):
        return att
    a = att.permute(0, 1, 4, 2, 3).reshape(B * T, k, h, w)
    if H > h or W > w:
        a = F.interpolate(a, size=(H, W), mode="bilinear", align_corners=False)
    else:
        a = F.avg_pool2d(a, w // W)
    return a.reshape(B, T, k, H, W).permute(0, 1, 3, 4, 2)


def att_group(x: torch.Tensor, att: torch.Tensor) -> torch.Tensor:
    """Head-grouped temporal aggregation: x [B,T,C,H,W], att [B,T,H,W,k] ->
    [B,C,H,W], channel c weighted by head c // (C/k), summed over T."""
    B, T, C, H, W = x.shape
    k = att.shape[-1]
    a = att.permute(0, 1, 4, 2, 3).repeat_interleave(C // k, dim=2)
    return (a * x).sum(dim=1)


# ----------------------------------------------------------------- losses --

def mgnll(mean: torch.Tensor, var: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Diagonal multivariate Gaussian NLL over the 13 bands of each pixel,
    averaged over pixels (the reference repo's losses.py, closed form); the
    Mahalanobis term held at 1e-9 or more."""
    k = mean.shape[-1]
    logdet = torch.log(var).sum(dim=-1)
    maha = ((mean - y).square() / var).sum(dim=-1)
    maha = torch.clamp(torch.nan_to_num(maha), min=1e-9)
    return (0.5 * k * math.log(2 * math.pi) + 0.5 * logdet + 0.5 * maha).mean()


def loss(m: dict, mean, var, y):
    if m["loss"] == "MGNLL":
        return mgnll(mean, var, y)
    if m["loss"] == "l2":
        return (mean - y).square().mean()
    raise ValueError(f"unknown loss {m['loss']!r}")


def heads(m: dict, out: torch.Tensor):
    """[N,C_out,H,W] head output -> (mean, variance or None) as
    [B,1,H,W,13] in scaled units: mean scale_by * sigmoid, variance
    softplus (threshold 20) + var_eps."""
    o = out.permute(0, 2, 3, 1)[:, None]
    mean = o[..., :S2_BANDS]
    if m["mean_nonlinearity"]:
        mean = m["scale_by"] * torch.sigmoid(mean)
    if o.shape[-1] == S2_BANDS:
        return mean, None
    var = F.softplus(o[..., S2_BANDS:2 * S2_BANDS], beta=1.0, threshold=20.0) + m["var_eps"]
    return mean, var


# -------------------------------------------------------------- optimizer --

class Adam:
    """Adam as the configurations state it (b1, b2, eps outside the square
    root, bias corrections), one tensor at a time."""

    def __init__(self, params: Weights, lr: float, b1: float, b2: float, eps: float):
        self.lr, self.b1, self.b2, self.eps, self.t = lr, b1, b2, eps, 0
        self.mu = {n: torch.zeros_like(p) for n, p in params.items()}
        self.nu = {n: torch.zeros_like(p) for n, p in params.items()}

    @torch.no_grad()
    def step(self, params: Weights, grads: Weights) -> None:
        self.t += 1
        c1, c2 = 1.0 - self.b1 ** self.t, 1.0 - self.b2 ** self.t
        for n, p in params.items():
            g = grads[n]
            self.mu[n].mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            self.nu[n].mul_(self.b2).add_(g * g, alpha=1.0 - self.b2)
            p.sub_(self.lr * (self.mu[n] / c1) / ((self.nu[n] / c2).sqrt() + self.eps))
