"""Depthwise stride-1 correlation with zero padding, kernel K5.

    out[n,ho,wo,c] = sum_{dy,dx} xpad[n, ho+dy, wo+dx, c] * w[c, 0, dy, dx]

over NHWC maps, xpad being x zero-padded by ``pads = ((top, bottom), (left,
right))``. The taps are summed in fp32 in the order of the JAX package's
shift-add form (uncrtaints_tpu/models/layers.py:_dw_shift_add: dy-major,
dx-minor) and rounded once to x's dtype. Port of
uncrtaints_tpu/ops/pallas_dwconv.py:dw_stencil; the CUDA kernel is
csrc/dwconv.cu. The train step runs it for the differentiated depthwise
forward and its input gradient (models/layers.py:DepthwiseConv2d).

The weight has the port's depthwise layout [C,1,kh,kw] (OIHW); a caller
flips or reshapes it.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from uncrtaints_tpu_torch import _build

# the kernel sizes the CUDA kernels are compiled for
KERNEL_SIZES = ((3, 3), (1, 3), (3, 1))

Pads = Tuple[Tuple[int, int], Tuple[int, int]]


def out_hw(H: int, W: int, kh: int, kw: int, pads: Pads) -> Tuple[int, int]:
    """Output height and width of a stride-1 correlation."""
    (pt, pb), (pl, pr) = pads
    return H + pt + pb - kh + 1, W + pl + pr - kw + 1


def zero_pad(x: torch.Tensor, pads: Pads) -> torch.Tensor:
    """Zero-pad H and W of an NHWC tensor."""
    (pt, pb), (pl, pr) = pads
    return F.pad(x, (0, 0, pl, pr, pt, pb))


def dw_stencil_plain(x: torch.Tensor, w: torch.Tensor, pads: Pads) -> torch.Tensor:
    """The plain PyTorch version of the kernel: pad, then kh*kw shifted
    fp32 multiply-adds (the shift-add form)."""
    N, H, W, C = x.shape
    kh, kw = w.shape[-2:]
    Ho, Wo = out_hw(H, W, kh, kw, pads)
    xp = zero_pad(x, pads)
    w32 = w.float().reshape(C, kh, kw)
    acc = torch.zeros((N, Ho, Wo, C), dtype=torch.float32, device=x.device)
    for dy in range(kh):
        for dx in range(kw):
            acc = acc + xp[:, dy:dy + Ho, dx:dx + Wo].float() * w32[:, dy, dx]
    return acc.to(x.dtype)


def check_pads(name: str, x: torch.Tensor, kh: int, kw: int, pads: Pads) -> None:
    """Raise unless pads are non-negative and leave an output of size >= 1."""
    if any(p < 0 for pair in pads for p in pair):
        raise ValueError(f"{name}: negative pads {pads}")
    Ho, Wo = out_hw(x.shape[1], x.shape[2], kh, kw, pads)
    if Ho < 1 or Wo < 1:
        raise ValueError(f"{name}: a {kh}x{kw} kernel with pads {pads} leaves "
                         f"no output of x {tuple(x.shape)}")


def dw_stencil(x: torch.Tensor, w: torch.Tensor, pads: Pads) -> torch.Tensor:
    """x [N,H,W,C], w [C,1,kh,kw] (contiguous, one dtype: fp32 or bf16) ->
    [N,Ho,Wo,C] in x's dtype.

    A CUDA tensor launches the CUDA kernel, which takes the kernel sizes in
    ``KERNEL_SIZES`` (anything else raises); a CPU tensor runs
    :func:`dw_stencil_plain`. ``dw_stencil.launches`` counts the kernel
    launches."""
    if x.dim() != 4 or w.dim() != 4 or w.shape[:2] != (x.shape[-1], 1):
        raise ValueError(f"dw_stencil: x [N,H,W,C] and w [C,1,kh,kw] expected, "
                         f"got {tuple(x.shape)} and {tuple(w.shape)}")
    if x.dtype not in _build.DTYPE_CODES or w.dtype != x.dtype:
        raise TypeError(f"dw_stencil: x and w must share a dtype in "
                        f"{list(_build.DTYPE_CODES)}, got {x.dtype}, {w.dtype}")
    if x.device != w.device:
        raise ValueError(f"dw_stencil: x on {x.device}, w on {w.device}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("dw_stencil: x and w must be contiguous")
    N, H, W, C = x.shape
    kh, kw = w.shape[-2:]
    check_pads("dw_stencil", x, kh, kw, pads)
    if x.device.type == "cpu":
        return dw_stencil_plain(x, w, pads)
    if x.device.type != "cuda":
        raise ValueError(f"dw_stencil: unsupported device {x.device}")
    if (kh, kw) not in KERNEL_SIZES:
        raise ValueError(f"dw_stencil kernel takes kernel sizes {KERNEL_SIZES}, "
                         f"got {(kh, kw)}")
    Ho, Wo = out_hw(H, W, kh, kw, pads)
    out = torch.empty((N, Ho, Wo, C), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    (pt, pb), (pl, pr) = pads
    ci = ctypes.c_int
    fn = _build.kernel("uncr_dw_stencil", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ci, ci, ci, ci, ci,
        ci, ci, ci, ci, ci, ci, ctypes.c_void_p])
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), N, H, W, C, kh, kw,
                 pt, pb, pl, pr, _build.DTYPE_CODES[x.dtype],
                 torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "uncr_dw_stencil")
    dw_stencil.launches += 1
    return out


dw_stencil.launches = 0
