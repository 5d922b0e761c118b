"""Head-grouped attention aggregation over time (att_group), kernel K1.

    out[b,h,w,c] = sum_t attn[b,t,h,w, c // (C/heads)] * x[b,t,h,w,c]

with fp32 products and accumulation and one cast to x's dtype. Port of
uncrtaints_tpu/ops/pallas_aggregate.py:att_group_aggregate and its custom
VJP: the backward

    dx[b,t,h,w,c]    = attn[b,t,h,w, c // (C/heads)] * g[b,h,w,c]
    dattn[b,t,h,w,k] = sum_{c in head k} x[b,t,h,w,c] * g[b,h,w,c]

is one more kernel (fp32 products and sums, dx in x's dtype, dattn in
attn's). Both CUDA kernels are in csrc/aggregate.cu; an autograd Function
joins them, so gradients reach everything upstream of the aggregator.
"""

from __future__ import annotations

import ctypes

import torch

from uncrtaints_tpu_torch import _build


def att_group_aggregate_plain(x: torch.Tensor, attn: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of the kernel (same math, same dtype)."""
    C, heads = x.shape[-1], attn.shape[-1]
    return (attn.repeat_interleave(C // heads, -1).float() * x.float()).sum(1).to(x.dtype)


def _check(x: torch.Tensor, attn: torch.Tensor) -> None:
    if x.dim() != 5 or attn.dim() != 5 or attn.shape[:4] != x.shape[:4]:
        raise ValueError(f"att_group_aggregate: x [B,T,H,W,C] and attn "
                         f"[B,T,H,W,heads] expected, got {tuple(x.shape)} and "
                         f"{tuple(attn.shape)}")
    if x.dtype not in _build.DTYPE_CODES or attn.dtype != x.dtype:
        raise TypeError(f"att_group_aggregate: x and attn must share a dtype "
                        f"in {list(_build.DTYPE_CODES)}, got {x.dtype}, {attn.dtype}")
    if x.device != attn.device:
        raise ValueError(f"att_group_aggregate: x on {x.device}, attn on "
                         f"{attn.device}")
    if not (x.is_contiguous() and attn.is_contiguous()):
        raise ValueError("att_group_aggregate: x and attn must be contiguous")
    if x.shape[-1] % attn.shape[-1]:
        raise ValueError(f"att_group_aggregate: C={x.shape[-1]} is not a "
                         f"multiple of heads={attn.shape[-1]}")


def att_group_aggregate_bwd_plain(x: torch.Tensor, attn: torch.Tensor,
                                  g: torch.Tensor):
    """The plain PyTorch version of the backward kernel: (dx, dattn)."""
    B, T, H, W, C = x.shape
    heads = attn.shape[-1]
    g32 = g.float()[:, None]
    dx = attn.repeat_interleave(C // heads, -1).float() * g32
    da = (x.float() * g32).view(B, T, H, W, heads, C // heads).sum(-1)
    return dx.to(x.dtype), da.to(attn.dtype)


def _forward(x: torch.Tensor, attn: torch.Tensor) -> torch.Tensor:
    if x.device.type == "cpu":
        return att_group_aggregate_plain(x, attn)
    if x.device.type != "cuda":
        raise ValueError(f"att_group_aggregate: unsupported device {x.device}")
    B, T, H, W, C = x.shape
    out = torch.empty((B, H, W, C), dtype=x.dtype, device=x.device)
    if out.numel() == 0 or T == 0:
        return out.zero_()
    fn = _build.kernel("uncr_att_group_aggregate", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p])
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), attn.data_ptr(), out.data_ptr(), B, T, H * W, C,
                 attn.shape[-1], _build.DTYPE_CODES[x.dtype],
                 torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "uncr_att_group_aggregate")
    att_group_aggregate.launches += 1
    return out


def att_group_aggregate_bwd(x: torch.Tensor, attn: torch.Tensor,
                            g: torch.Tensor):
    """The backward of :func:`att_group_aggregate` for the output gradient g
    [B,H,W,C] (x's dtype, contiguous) -> (dx [B,T,H,W,C] in x's dtype,
    dattn [B,T,H,W,heads] in attn's dtype).

    A CUDA tensor launches the CUDA kernel (an error raises); a CPU tensor
    runs :func:`att_group_aggregate_bwd_plain`.
    ``att_group_aggregate_bwd.launches`` counts the kernel launches."""
    _check(x, attn)
    B, T, H, W, C = x.shape
    if g.shape != (B, H, W, C) or g.dtype != x.dtype or g.device != x.device:
        raise ValueError(f"att_group_aggregate_bwd: g must be {(B, H, W, C)} "
                         f"{x.dtype} on {x.device}, got {tuple(g.shape)} "
                         f"{g.dtype} on {g.device}")
    if not g.is_contiguous():
        raise ValueError("att_group_aggregate_bwd: g must be contiguous")
    if x.device.type == "cpu":
        return att_group_aggregate_bwd_plain(x, attn, g)
    if x.device.type != "cuda":
        raise ValueError(f"att_group_aggregate_bwd: unsupported device {x.device}")
    dx = torch.empty_like(x)
    da = torch.empty_like(attn)
    if dx.numel() == 0:
        return dx, da.zero_()
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn = _build.kernel("uncr_att_group_aggregate_bwd", [
        vp, vp, vp, vp, vp, ci, ci, ctypes.c_longlong, ci, ci, ci, vp])
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), attn.data_ptr(), g.data_ptr(), dx.data_ptr(),
                 da.data_ptr(), B, T, H * W, C, attn.shape[-1],
                 _build.DTYPE_CODES[x.dtype],
                 torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "uncr_att_group_aggregate_bwd")
    att_group_aggregate_bwd.launches += 1
    return dx, da


class _AttGroupAggregate(torch.autograd.Function):
    """K1 forward, K1 backward (the plain versions for CPU tensors)."""

    @staticmethod
    def forward(ctx, x, attn):
        ctx.save_for_backward(x, attn)
        return _forward(x, attn)

    @staticmethod
    def backward(ctx, g):
        x, attn = ctx.saved_tensors
        return att_group_aggregate_bwd(x, attn, g.contiguous())


def att_group_aggregate(x: torch.Tensor, attn: torch.Tensor) -> torch.Tensor:
    """x [B,T,H,W,C], attn [B,T,H,W,heads] (contiguous, one dtype: fp32 or
    bf16, C % heads == 0) -> [B,H,W,C] in x's dtype.

    A CUDA tensor launches the CUDA kernel (an error raises); a CPU tensor
    runs :func:`att_group_aggregate_plain`. With grad enabled and an input
    that requires it, the result is differentiable through
    :func:`att_group_aggregate_bwd`. ``att_group_aggregate.launches`` counts
    the forward kernel's launches."""
    _check(x, attn)
    if torch.is_grad_enabled() and (x.requires_grad or attn.requires_grad):
        return _AttGroupAggregate.apply(x, attn)
    return _forward(x, attn)


att_group_aggregate.launches = 0
att_group_aggregate_bwd.launches = 0
