"""Depthwise-convolution weight gradient for all taps, kernel K2.

    gw[c, 0, dy, dx] = sum_{n,h,w} xpad[n, h+dy, w+dx, c] * g[n, h, w, c]

in fp32, for x [N,H,W,C] the input of a stride-1 depthwise correlation with
zero pads ``((top, bottom), (left, right))`` and g [N,Ho,Wo,C] its output
gradient. With ``mode="reflect"`` xpad is the reflect pad of one pixel of the
unpadded x (3x3 kernels, H, W >= 2), read through mirrored indices: no
padded copy is made. Port of uncrtaints_tpu/ops/pallas_dwgrad.py:dw_kernel_grad (which
returns [kh,kw,1,C]); here the result has the port's weight layout
[C,1,kh,kw]. The CUDA kernel is csrc/dwgrad.cu: per-block partial sums and a
second pass over them, no atomics, so the result is deterministic.

In halo mode (``halo=(top, bot)``, reflect only) x is one band of rows of a
scene split over the ranks of a 2-D mesh: rows -1 and H are the neighbours'
edge rows [N,1,W,C] where given, and the result is this band's partial sum
(the train step's gradient all-reduce adds the bands').
"""

from __future__ import annotations

import ctypes
import math
from typing import List, Optional

import torch
from torch.utils.flop_counter import register_flop_formula

from uncrtaints_tpu_torch import _build
from uncrtaints_tpu_torch.ops.dwconv import (
    _MODE_NAMES, KERNEL_SIZES, MODES, Pads, check_halo, check_mode, check_pads, halo_rows,
    mirror_cols, out_hw, pads_of, reflect_pad, zero_pad)


def dw_kernel_grad_plain(x: torch.Tensor, g: torch.Tensor, pads: Pads,
                         kh: int, kw: int, mode: str = "zeros") -> torch.Tensor:
    """The plain PyTorch version of the kernel: pad (zeros by ``pads``, or a
    reflect pad of one), then one fp32 multiply-reduce per tap (the tap loop
    of the JAX package's dw-conv VJP)."""
    xp = reflect_pad(x) if mode == "reflect" else zero_pad(x, pads)
    return _taps(xp, g, kh, kw)


def _taps(xp: torch.Tensor, g: torch.Tensor, kh: int, kw: int) -> torch.Tensor:
    """One fp32 multiply-reduce of g with each shifted window of padded xp."""
    N, Ho, Wo, C = g.shape
    g32 = g.float()
    taps = [(xp[:, dy:dy + Ho, dx:dx + Wo].float() * g32).sum(dim=(0, 1, 2))
            for dy in range(kh) for dx in range(kw)]
    return torch.stack(taps, dim=-1).reshape(C, 1, kh, kw)


def dw_kernel_grad_halo_plain(x: torch.Tensor, g: torch.Tensor, top: Optional[torch.Tensor],
                              bot: Optional[torch.Tensor]) -> torch.Tensor:
    """The plain PyTorch version of the halo mode: the band with its halo
    rows (mirrored at the scene's edge), the columns mirrored, then the nine
    taps."""
    return _taps(mirror_cols(halo_rows(x, top, bot)), g, 3, 3)


def _launch(x: torch.Tensor, g: torch.Tensor, pads: Pads, kh: int, kw: int,
            mode: str) -> torch.Tensor:
    """One launch of the CUDA kernel (its two passes); counted in
    ``dw_kernel_grad.launches``."""
    N, H, W, C = x.shape
    if (kh, kw) not in KERNEL_SIZES:
        raise ValueError(f"dw_kernel_grad kernel takes kernel sizes "
                         f"{KERNEL_SIZES}, got {(kh, kw)}")
    Ho, Wo = out_hw(H, W, kh, kw, pads)
    gw = torch.empty((C, 1, kh, kw), dtype=torch.float32, device=x.device)
    if g.numel() == 0:
        return gw.zero_()
    ci = ctypes.c_int
    code = _build.DTYPE_CODES[x.dtype]
    aligned = int(x.data_ptr() % 16 == 0 and g.data_ptr() % 16 == 0)
    with torch.cuda.device(x.device):  # the grid follows this card's SM count
        nb = _build.kernel("uncr_dw_kernel_grad_blocks", [ci] * 8)(
            N, Ho, Wo, C, kh, kw, code, aligned)
    part = torch.empty((nb, kh * kw, C), dtype=torch.float32, device=x.device)
    (pt, pb), (pl, pr) = pads
    fn = _build.kernel("uncr_dw_kernel_grad", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ci, ci, ci, ci, ci, ci, ci, ci, ci, ci, ci, ci, ctypes.c_void_p])
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), g.data_ptr(), part.data_ptr(), gw.data_ptr(),
                 N, H, W, C, kh, kw, pt, pb, pl, pr, MODES[mode], code,
                 torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "uncr_dw_kernel_grad")
    dw_kernel_grad.launches += 1
    return gw


def _launch_halo(x: torch.Tensor, g: torch.Tensor, top, bot) -> torch.Tensor:
    """One launch of the CUDA kernel's halo mode; counted in
    ``dw_kernel_grad.launches`` and ``dw_kernel_grad.halo_launches``."""
    N, H, W, C = x.shape
    gw = torch.empty((C, 1, 3, 3), dtype=torch.float32, device=x.device)
    if g.numel() == 0:
        return gw.zero_()
    ci, vp = ctypes.c_int, ctypes.c_void_p
    code = _build.DTYPE_CODES[x.dtype]
    aligned = int(all(t.data_ptr() % 16 == 0 for t in (x, g, top, bot) if t is not None))
    with torch.cuda.device(x.device):
        nb = _build.kernel("uncr_dw_kernel_grad_blocks", [ci] * 8)(
            N, H, W, C, 3, 3, code, aligned)
    part = torch.empty((nb, 9, C), dtype=torch.float32, device=x.device)
    ptr = lambda t: t.data_ptr() if t is not None else None
    fn = _build.kernel("uncr_dw_kernel_grad_halo", [vp] * 6 + [ci] * 5 + [vp])
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), g.data_ptr(), ptr(top), ptr(bot), part.data_ptr(),
                 gw.data_ptr(), N, H, W, C, code,
                 torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "uncr_dw_kernel_grad_halo")
    dw_kernel_grad.launches += 1
    dw_kernel_grad.halo_launches += 1
    return gw


# K2 as an operator of the dispatcher (``torch.ops.uncrtaints.dw_kernel_grad``;
# K5's backward calls it): the CUDA kernel for a CUDA tensor, the plain
# version for a CPU tensor, the output shape for a FakeTensor. ``mode`` is a
# code of MODES.

@torch.library.custom_op("uncrtaints::dw_kernel_grad", mutates_args=(), device_types="cuda")
def _k2(x: torch.Tensor, g: torch.Tensor, pads: List[int], kh: int, kw: int,
        mode: int) -> torch.Tensor:
    return _launch(x, g, pads_of(pads), kh, kw, _MODE_NAMES[mode])


@_k2.register_kernel("cpu")
def _k2_cpu(x, g, pads, kh, kw, mode):
    return dw_kernel_grad_plain(x, g, pads_of(pads), kh, kw, _MODE_NAMES[mode])


@_k2.register_fake
def _k2_fake(x, g, pads, kh, kw, mode):
    return x.new_empty((x.shape[-1], 1, kh, kw), dtype=torch.float32)


@register_flop_formula(torch.ops.uncrtaints.dw_kernel_grad)
def _k2_flops(x_shape, g_shape, pads, kh, kw, *args, out_shape=None, **kwargs) -> int:
    """Two FLOPs a multiply-add, kh*kw of them an element of g (torch's
    count of a depthwise convolution's weight gradient)."""
    return 2 * math.prod(g_shape) * kh * kw


# K2's halo mode (``torch.ops.uncrtaints.dw_kernel_grad_halo``; the backward
# of ``dw_stencil_halo`` calls it)

@torch.library.custom_op("uncrtaints::dw_kernel_grad_halo", mutates_args=(),
                         device_types="cuda")
def _k2h(x: torch.Tensor, g: torch.Tensor, top: Optional[torch.Tensor],
         bot: Optional[torch.Tensor]) -> torch.Tensor:
    return _launch_halo(x, g, top, bot)


@_k2h.register_kernel("cpu")
def _k2h_cpu(x, g, top, bot):
    return dw_kernel_grad_halo_plain(x, g, top, bot)


@_k2h.register_fake
def _k2h_fake(x, g, top, bot):
    return x.new_empty((x.shape[-1], 1, 3, 3), dtype=torch.float32)


@register_flop_formula(torch.ops.uncrtaints.dw_kernel_grad_halo)
def _k2h_flops(x_shape, g_shape, *args, out_shape=None, **kwargs) -> int:
    return 2 * math.prod(g_shape) * 9


def dw_kernel_grad(x: torch.Tensor, g: torch.Tensor, pads: Pads, kh: int,
                   kw: int, mode: str = "zeros", halo=None) -> torch.Tensor:
    """x [N,H,W,C], g [N,Ho,Wo,C] (contiguous, one dtype: fp32 or bf16) ->
    gw [C,1,kh,kw] fp32. ``mode="reflect"`` takes the unpadded x, a 3x3
    kernel and ``pads`` of one.

    A CUDA tensor launches the CUDA kernel, which takes the kernel sizes in
    ``KERNEL_SIZES`` (anything else raises); a CPU tensor runs
    :func:`dw_kernel_grad_plain`; both through the operator
    ``torch.ops.uncrtaints.dw_kernel_grad``. ``dw_kernel_grad.launches``
    counts the kernel launches (one per call: the two passes are one launch
    of the C entry point).

    ``halo=(top, bot)`` (reflect only): x is one band of a taller scene and
    ``top`` / ``bot`` [N,1,W,C] its neighbours' edge rows, None at the
    scene's edge; the result is the band's partial sum
    (``dw_kernel_grad.halo_launches`` counts these launches too)."""
    if x.dim() != 4:
        raise ValueError(f"dw_kernel_grad: x [N,H,W,C] expected, got {tuple(x.shape)}")
    N, H, W, C = x.shape
    check_pads("dw_kernel_grad", x, kh, kw, pads)
    check_mode("dw_kernel_grad", x, kh, kw, pads, mode)
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
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"dw_kernel_grad: unsupported device {x.device}")
    if halo is not None:
        if mode != "reflect":
            raise ValueError("dw_kernel_grad: the halo mode is a reflect mode")
        check_halo("dw_kernel_grad", x, halo)
        return torch.ops.uncrtaints.dw_kernel_grad_halo(x, g, *halo)
    return torch.ops.uncrtaints.dw_kernel_grad(x, g, [*pads[0], *pads[1]], kh, kw,
                                               MODES[mode])


dw_kernel_grad.launches = 0
dw_kernel_grad.halo_launches = 0
