"""Head-grouped attention aggregation over time (att_group), kernel K1.

    out[b,h,w,c] = sum_t attn[b,t,h,w, c // (C/heads)] * x[b,t,h,w,c]

with fp32 products and accumulation and one cast to x's dtype. Port of the
forward of uncrtaints_tpu/ops/pallas_aggregate.py:att_group_aggregate; the
CUDA kernel is csrc/aggregate.cu.
"""

from __future__ import annotations

import ctypes

import torch

from uncrtaints_tpu_torch import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def att_group_aggregate_plain(x: torch.Tensor, attn: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of the kernel (same math, same dtype)."""
    C, heads = x.shape[-1], attn.shape[-1]
    return (attn.repeat_interleave(C // heads, -1).float() * x.float()).sum(1).to(x.dtype)


def _check(x: torch.Tensor, attn: torch.Tensor) -> None:
    if x.dim() != 5 or attn.dim() != 5 or attn.shape[:4] != x.shape[:4]:
        raise ValueError(f"att_group_aggregate: x [B,T,H,W,C] and attn "
                         f"[B,T,H,W,heads] expected, got {tuple(x.shape)} and "
                         f"{tuple(attn.shape)}")
    if x.dtype not in _DTYPE_CODES or attn.dtype != x.dtype:
        raise TypeError(f"att_group_aggregate: x and attn must share a dtype "
                        f"in {list(_DTYPE_CODES)}, got {x.dtype}, {attn.dtype}")
    if x.device != attn.device:
        raise ValueError(f"att_group_aggregate: x on {x.device}, attn on "
                         f"{attn.device}")
    if not (x.is_contiguous() and attn.is_contiguous()):
        raise ValueError("att_group_aggregate: x and attn must be contiguous")
    if x.shape[-1] % attn.shape[-1]:
        raise ValueError(f"att_group_aggregate: C={x.shape[-1]} is not a "
                         f"multiple of heads={attn.shape[-1]}")


def att_group_aggregate(x: torch.Tensor, attn: torch.Tensor) -> torch.Tensor:
    """x [B,T,H,W,C], attn [B,T,H,W,heads] (contiguous, one dtype: fp32 or
    bf16, C % heads == 0) -> [B,H,W,C] in x's dtype.

    A CUDA tensor launches the CUDA kernel (an error raises); a CPU tensor
    runs :func:`att_group_aggregate_plain`. ``att_group_aggregate.launches``
    counts the kernel launches."""
    _check(x, attn)
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
                 attn.shape[-1], _DTYPE_CODES[x.dtype],
                 torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "uncr_att_group_aggregate")
    att_group_aggregate.launches += 1
    return out


att_group_aggregate.launches = 0
