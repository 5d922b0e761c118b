"""Depthwise-convolution weight gradient for all taps, kernel K2.

    gw[c, 0, dy, dx] = sum_{n,h,w} xpad[n, h+dy, w+dx, c] * g[n, h, w, c]

in fp32, for x [N,H,W,C] the input of a stride-1 depthwise correlation with
zero pads ``((top, bottom), (left, right))`` and g [N,Ho,Wo,C] its output
gradient. Port of uncrtaints_tpu/ops/pallas_dwgrad.py:dw_kernel_grad (which
returns [kh,kw,1,C]); here the result has the port's weight layout
[C,1,kh,kw]. The CUDA kernel is csrc/dwgrad.cu: per-block partial sums and a
second pass over them, no atomics, so the result is deterministic.
"""

from __future__ import annotations

import ctypes

import torch

from uncrtaints_tpu_torch import _build
from uncrtaints_tpu_torch.ops.dwconv import (
    KERNEL_SIZES, Pads, check_pads, out_hw, zero_pad)


def dw_kernel_grad_plain(x: torch.Tensor, g: torch.Tensor, pads: Pads,
                         kh: int, kw: int) -> torch.Tensor:
    """The plain PyTorch version of the kernel: one fp32 multiply-reduce
    per tap (the tap loop of the JAX package's dw-conv VJP)."""
    N, H, W, C = x.shape
    Ho, Wo = out_hw(H, W, kh, kw, pads)
    xp = zero_pad(x, pads)
    g32 = g.float()
    taps = [(xp[:, dy:dy + Ho, dx:dx + Wo].float() * g32).sum(dim=(0, 1, 2))
            for dy in range(kh) for dx in range(kw)]
    return torch.stack(taps, dim=-1).reshape(C, 1, kh, kw)


def dw_kernel_grad(x: torch.Tensor, g: torch.Tensor, pads: Pads, kh: int,
                   kw: int) -> torch.Tensor:
    """x [N,H,W,C], g [N,Ho,Wo,C] (contiguous, one dtype: fp32 or bf16) ->
    gw [C,1,kh,kw] fp32.

    A CUDA tensor launches the CUDA kernel, which takes the kernel sizes in
    ``KERNEL_SIZES`` (anything else raises); a CPU tensor runs
    :func:`dw_kernel_grad_plain`. ``dw_kernel_grad.launches`` counts the
    kernel launches (one per call: the two passes are one launch of the C
    entry point)."""
    if x.dim() != 4:
        raise ValueError(f"dw_kernel_grad: x [N,H,W,C] expected, got {tuple(x.shape)}")
    N, H, W, C = x.shape
    check_pads("dw_kernel_grad", x, kh, kw, pads)
    Ho, Wo = out_hw(H, W, kh, kw, pads)
    if g.shape != (N, Ho, Wo, C):
        raise ValueError(f"dw_kernel_grad: g must be {(N, Ho, Wo, C)}, got "
                         f"{tuple(g.shape)}")
    if x.dtype not in _build.DTYPE_CODES or g.dtype != x.dtype:
        raise TypeError(f"dw_kernel_grad: x and g must share a dtype in "
                        f"{list(_build.DTYPE_CODES)}, got {x.dtype}, {g.dtype}")
    if x.device != g.device:
        raise ValueError(f"dw_kernel_grad: x on {x.device}, g on {g.device}")
    if not (x.is_contiguous() and g.is_contiguous()):
        raise ValueError("dw_kernel_grad: x and g must be contiguous")
    if x.device.type == "cpu":
        return dw_kernel_grad_plain(x, g, pads, kh, kw)
    if x.device.type != "cuda":
        raise ValueError(f"dw_kernel_grad: unsupported device {x.device}")
    if (kh, kw) not in KERNEL_SIZES:
        raise ValueError(f"dw_kernel_grad kernel takes kernel sizes "
                         f"{KERNEL_SIZES}, got {(kh, kw)}")
    gw = torch.empty((C, 1, kh, kw), dtype=torch.float32, device=x.device)
    if g.numel() == 0:
        return gw.zero_()
    ci = ctypes.c_int
    nb = _build.kernel("uncr_dw_kernel_grad_blocks", [ci, ci, ci])(N, Ho, Wo)
    part = torch.empty((nb, kh * kw, C), dtype=torch.float32, device=x.device)
    (pt, pb), (pl, pr) = pads
    fn = _build.kernel("uncr_dw_kernel_grad", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ci, ci, ci, ci, ci, ci, ci, ci, ci, ci, ci, ctypes.c_void_p])
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), g.data_ptr(), part.data_ptr(), gw.data_ptr(),
                 N, H, W, C, kh, kw, pt, pb, pl, pr, _build.DTYPE_CODES[x.dtype],
                 torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "uncr_dw_kernel_grad")
    dw_kernel_grad.launches += 1
    return gw


dw_kernel_grad.launches = 0
