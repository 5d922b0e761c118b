"""Fused MBConv pointwise stage, kernel K3 (norm -> GELU -> SE -> GEMM ->
affine -> GELU, plus optional per-group output statistics).

Port of uncrtaints_tpu/ops/pallas_mbconv.py:norm_gelu_matmul (kernel A);
the CUDA kernel is csrc/norm_gelu_matmul.cu. The eval-mode MBConv runs both
of its pointwise convolutions through it (models/blocks.py).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from uncrtaints_tpu_torch import _build

BLOCK_M = 128  # rows per CUDA block; a block must not straddle two frames


def norm_gelu_matmul_plain(x, mean, coef, scale, bias, w, se=None,
                           groups_in: int = 4, groups_out: int = 4,
                           do_gelu: bool = True, out_affine=None,
                           out_gelu: bool = False, do_stats: bool = True):
    """The plain PyTorch version of the kernel.

    The prologue runs in fp32; its result is rounded to bf16 and multiplied
    as ``h.bfloat16().float() @ w.float()``: exact bf16 products with fp32
    accumulation, as the kernel's tensor cores compute them. (A bf16
    ``torch.matmul`` would round the product before the epilogue.)"""
    N, P, C = x.shape
    C2 = w.shape[1]
    m = mean.float().repeat_interleave(C // groups_in, -1)[:, None, :]
    cf = coef.float().repeat_interleave(C // groups_in, -1)[:, None, :]
    h = (x.float() - m) * cf * scale.float() + bias.float()
    if do_gelu:
        h = F.gelu(h)
    if se is not None:
        h = h * se.float()[:, None, :]
    o = h.bfloat16().float() @ w.float()
    if out_affine is not None:
        o = o * out_affine[0].float() + out_affine[1].float()
    if out_gelu:
        o = F.gelu(o)
    out = o.to(x.dtype)
    if not do_stats:
        zeros = torch.zeros((N, groups_out), dtype=torch.float32, device=x.device)
        return out, zeros, zeros.clone()
    og = out.float().view(N, P, groups_out, C2 // groups_out)
    return out, og.sum(dim=(1, 3)), og.square().sum(dim=(1, 3))


def _f32(t: torch.Tensor, shape, name: str) -> torch.Tensor:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"norm_gelu_matmul: {name} must be {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    return t.to(torch.float32).contiguous()


def norm_gelu_matmul(x: torch.Tensor, mean: torch.Tensor, coef: torch.Tensor,
                     scale: torch.Tensor, bias: torch.Tensor, w: torch.Tensor,
                     se: Optional[torch.Tensor] = None, groups_in: int = 4,
                     groups_out: int = 4, do_gelu: bool = True,
                     out_affine: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                     out_gelu: bool = False, do_stats: bool = True):
    """x [N,P,C] (bf16 or fp32, contiguous); mean/coef [N,groups_in];
    scale/bias [C]; w [C,C2] bf16; se [N,C] or None; ``out_affine=(oscale,
    obias)`` [C2] each, applied to the fp32 GEMM output before ``out_gelu``
    and the cast. The small vectors are taken as fp32.

    Returns (out [N,P,C2] in x's dtype, sum [N,groups_out], sumsq
    [N,groups_out]): the per-(frame, group) sum and sum of squares of the
    output after rounding, or zeros when ``do_stats`` is False.

    A CUDA tensor launches the CUDA kernel, which needs P % 128 == 0,
    C % 32 == 0 and C2 % 16 == 0 (anything else raises); a CPU tensor runs
    :func:`norm_gelu_matmul_plain`. ``norm_gelu_matmul.launches`` counts
    the kernel launches. The kernel has no backward (the JAX kernel has no
    VJP either; it serves the eval step only), so on the card it raises
    when grad is enabled and an input requires grad, rather than return a
    result detached from the graph."""
    if x.dim() != 3 or w.dim() != 2 or w.shape[0] != x.shape[2]:
        raise ValueError(f"norm_gelu_matmul: x [N,P,C] and w [C,C2] expected, "
                         f"got {tuple(x.shape)} and {tuple(w.shape)}")
    N, P, C = x.shape
    C2 = w.shape[1]
    if x.dtype not in _build.DTYPE_CODES or w.dtype != torch.bfloat16:
        raise TypeError(f"norm_gelu_matmul: x must be fp32 or bf16 and w bf16, "
                        f"got {x.dtype}, {w.dtype}")
    if C % groups_in or C2 % groups_out:
        raise ValueError(f"norm_gelu_matmul: C={C} / groups_in={groups_in} or "
                         f"C2={C2} / groups_out={groups_out} is not whole")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("norm_gelu_matmul: x and w must be contiguous")
    if x.device.type == "cpu":
        return norm_gelu_matmul_plain(
            x, mean, coef, scale, bias, w, se=se, groups_in=groups_in,
            groups_out=groups_out, do_gelu=do_gelu, out_affine=out_affine,
            out_gelu=out_gelu, do_stats=do_stats)
    if x.device.type != "cuda":
        raise ValueError(f"norm_gelu_matmul: unsupported device {x.device}")
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, mean, coef, scale, bias, w, se,
                      *(out_affine if out_affine is not None else ()))):
        raise RuntimeError(
            "norm_gelu_matmul: the CUDA kernel has no backward; call it under "
            "torch.no_grad() or torch.inference_mode() (the fused MBConv body "
            "is for eval), or with inputs that do not require grad")
    if P % BLOCK_M or C % 32 or C2 % 16:
        raise ValueError(f"norm_gelu_matmul kernel needs P % {BLOCK_M} == 0, "
                         f"C % 32 == 0 and C2 % 16 == 0; got P={P}, C={C}, "
                         f"C2={C2}")

    mean = _f32(mean, (N, groups_in), "mean")
    coef = _f32(coef, (N, groups_in), "coef")
    scale = _f32(scale, (C,), "scale")
    bias = _f32(bias, (C,), "bias")
    se = _f32(se, (N, C), "se") if se is not None else None
    if out_affine is not None:
        oscale = _f32(out_affine[0], (C2,), "oscale")
        obias = _f32(out_affine[1], (C2,), "obias")
    else:
        oscale = obias = None
    small = [mean, coef, scale, bias, se, oscale, obias]
    if any(t is not None and t.device != x.device for t in small + [w]):
        raise ValueError("norm_gelu_matmul: all tensors must be on x's device")
    if any(t.data_ptr() % 16 for t in (x, w)):
        raise ValueError("norm_gelu_matmul: x and w must be 16-byte aligned")

    dev = x.device
    out = torch.empty((N, P, C2), dtype=x.dtype, device=dev)
    s1 = torch.zeros((N, groups_out), dtype=torch.float32, device=dev)
    s2 = torch.zeros((N, groups_out), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out, s1, s2
    psum = psq = None
    if do_stats:
        psum = torch.empty((N * P // BLOCK_M, C2), dtype=torch.float32, device=dev)
        psq = torch.empty_like(psum)
    ptr = lambda t: t.data_ptr() if t is not None else None
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn = _build.kernel("uncr_norm_gelu_matmul", [
        vp, ci, vp, vp, ci, vp, vp, vp, vp, vp, vp, ci, ci, vp, ci,
        ctypes.c_longlong, ci, ci, vp, vp, vp, vp, ci, vp])
    with torch.cuda.device(dev):
        err = fn(x.data_ptr(), _build.DTYPE_CODES[x.dtype], mean.data_ptr(),
                 coef.data_ptr(), groups_in, scale.data_ptr(), bias.data_ptr(),
                 w.data_ptr(), ptr(se), ptr(oscale), ptr(obias), int(do_gelu),
                 int(out_gelu), out.data_ptr(), N, P, C, C2, ptr(psum),
                 ptr(psq), s1.data_ptr(), s2.data_ptr(), groups_out,
                 torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "uncr_norm_gelu_matmul")
    norm_gelu_matmul.launches += 1
    return out, s1, s2


norm_gelu_matmul.launches = 0
