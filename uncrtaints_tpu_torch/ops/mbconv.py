"""The fused MBConv eval stages: kernel K3 (norm -> GELU -> SE -> GEMM ->
affine -> GELU) and kernel K4 (norm -> GELU -> reflect depthwise 3x3), each
with per-group statistics of its output.

Port of uncrtaints_tpu/ops/pallas_mbconv.py: norm_gelu_matmul (kernel A,
CUDA kernel csrc/norm_gelu_matmul.cu) and norm_gelu_dwconv3x3 (kernel B,
CUDA kernel csrc/norm_gelu_dwconv.cu). The eval-mode MBConv runs its two
pointwise convolutions through K3 and its depthwise convolution through K4
(models/blocks.py).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.flop_counter import register_flop_formula

from uncrtaints_tpu_torch import _build
from uncrtaints_tpu_torch.ops.dwconv import check_halo, halo_rows, mirror_cols

BLOCK_M = 128  # P must be a multiple: a CUDA block's rows must not straddle two frames


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
        raise ValueError(f"{name} must be {tuple(shape)}, got {tuple(t.shape)}")
    return t.to(torch.float32).contiguous()


def _refuse_grad(name: str, tensors) -> None:
    """The eval kernels have no backward (the JAX kernels have no VJP
    either): raise rather than return a result detached from the graph."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward; call it under "
            "torch.no_grad() or torch.inference_mode() (the fused MBConv body "
            "is for eval), or with inputs that do not require grad")


@functools.lru_cache(maxsize=None)
def _tile_rows(dtype_code: int, C: int, C2: int, groups_in: int) -> int:
    """Rows of x behind one partial row of K3's statistics: 64 where the
    wgmma kernel runs, else 128. Asked of the library once per shape."""
    ci = ctypes.c_int
    return _build.kernel("uncr_ngm_tile_rows", [ci, ci, ci, ci])(dtype_code, C, C2, groups_in)


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

    A CUDA tensor launches a CUDA kernel, which needs P % 128 == 0,
    C % 32 == 0 and C2 % 16 == 0 (anything else raises); a CPU tensor runs
    :func:`norm_gelu_matmul_plain`. bf16 x with C and C2 of 128 or 256 (not
    both 256) and input groups of whole 8-channel chunks runs the pipelined
    wgmma kernel, everything else the tiled WMMA kernel.
    ``norm_gelu_matmul.launches`` counts the launches of either,
    ``norm_gelu_matmul.wgmma_launches`` those of the first. The kernel has
    no backward (the JAX kernel has no
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
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"norm_gelu_matmul: unsupported device {x.device}")
    if x.device.type == "cuda":
        _refuse_grad("norm_gelu_matmul", (x, mean, coef, scale, bias, w, se,
                                          *(out_affine if out_affine is not None else ())))
    oscale, obias = out_affine if out_affine is not None else (None, None)
    return torch.ops.uncrtaints.norm_gelu_matmul(
        x, mean, coef, scale, bias, w, se, oscale, obias, groups_in, groups_out,
        do_gelu, out_gelu, do_stats)


def _k3_launch(x, mean, coef, scale, bias, w, se, oscale, obias, groups_in,
               groups_out, do_gelu, out_gelu, do_stats):
    """The CUDA kernel's launch (the operator's CUDA implementation)."""
    N, P, C = x.shape
    C2 = w.shape[1]
    if P % BLOCK_M or C % 32 or C2 % 16:
        raise ValueError(f"norm_gelu_matmul kernel needs P % {BLOCK_M} == 0, "
                         f"C % 32 == 0 and C2 % 16 == 0; got P={P}, C={C}, "
                         f"C2={C2}")

    mean = _f32(mean, (N, groups_in), "norm_gelu_matmul: mean")
    coef = _f32(coef, (N, groups_in), "norm_gelu_matmul: coef")
    scale = _f32(scale, (C,), "norm_gelu_matmul: scale")
    bias = _f32(bias, (C,), "norm_gelu_matmul: bias")
    se = _f32(se, (N, C), "norm_gelu_matmul: se") if se is not None else None
    if oscale is not None:
        oscale = _f32(oscale, (C2,), "norm_gelu_matmul: oscale")
        obias = _f32(obias, (C2,), "norm_gelu_matmul: obias")
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
    vp, ci = ctypes.c_void_p, ctypes.c_int
    # rows of x behind one partial row: 64 under the wgmma kernel, else 128
    # (N more rows serve the statistics' second pass)
    tile_rows = _tile_rows(_build.DTYPE_CODES[x.dtype], C, C2, groups_in)
    psum = psq = None
    if do_stats:
        psum = torch.empty((N * P // tile_rows + N, C2), dtype=torch.float32, device=dev)
        psq = torch.empty_like(psum)
    ptr = lambda t: t.data_ptr() if t is not None else None
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
    norm_gelu_matmul.wgmma_launches += tile_rows != BLOCK_M
    return out, s1, s2


# K3 as an operator of the dispatcher (``torch.ops.uncrtaints.norm_gelu_matmul``):
# the CUDA kernel for a CUDA tensor, the plain version for a CPU tensor, the
# output shapes for a FakeTensor. Eval only: no backward, as the JAX kernel.

@torch.library.custom_op("uncrtaints::norm_gelu_matmul", mutates_args=(),
                         device_types="cuda")
def _k3(x: torch.Tensor, mean: torch.Tensor, coef: torch.Tensor, scale: torch.Tensor,
        bias: torch.Tensor, w: torch.Tensor, se: Optional[torch.Tensor],
        oscale: Optional[torch.Tensor], obias: Optional[torch.Tensor], groups_in: int,
        groups_out: int, do_gelu: bool, out_gelu: bool,
        do_stats: bool) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return _k3_launch(x, mean, coef, scale, bias, w, se, oscale, obias, groups_in,
                      groups_out, do_gelu, out_gelu, do_stats)


@_k3.register_kernel("cpu")
def _k3_cpu(x, mean, coef, scale, bias, w, se, oscale, obias, groups_in, groups_out,
            do_gelu, out_gelu, do_stats):
    return norm_gelu_matmul_plain(
        x, mean, coef, scale, bias, w, se=se, groups_in=groups_in,
        groups_out=groups_out, do_gelu=do_gelu,
        out_affine=None if oscale is None else (oscale, obias),
        out_gelu=out_gelu, do_stats=do_stats)


@_k3.register_fake
def _k3_fake(x, mean, coef, scale, bias, w, se, oscale, obias, groups_in, groups_out,
             do_gelu, out_gelu, do_stats):
    N, P, _ = x.shape
    stats = lambda: x.new_empty((N, groups_out), dtype=torch.float32)
    return x.new_empty((N, P, w.shape[1])), stats(), stats()


norm_gelu_matmul.launches = 0
norm_gelu_matmul.wgmma_launches = 0


# ------------------------------------------------------------------- K4 --

@register_flop_formula(torch.ops.uncrtaints.norm_gelu_matmul)
def _k3_flops(x_shape, mean_shape, coef_shape, scale_shape, bias_shape, w_shape,
              *args, out_shape=None, **kwargs) -> int:
    """The GEMM's, two FLOPs a multiply-add (torch's count of a 1x1
    convolution; the norm, GELU and SE prologue are elementwise, uncounted
    as torch's elementwise ops are)."""
    N, P, C = x_shape
    return 2 * N * P * C * w_shape[1]


def norm_gelu_dwconv3x3_plain(x, mean, coef, scale, bias, w,
                              groups_in: int = 4, groups_out: int = 4,
                              do_stats: bool = True, pool_affine=None, halo=None):
    """The plain PyTorch version of kernel K4: the prologue and the exact
    GELU in fp32, a reflect pad of one pixel, then the nine fp32 shifted
    multiply-adds in the JAX kernel's order (dx-major, dy-minor; product
    and sum rounded separately), one cast, and the sums of the cast output
    (zeros when ``do_stats`` is False). With ``pool_affine=(scale, bias)``
    a fourth value: the per-(frame, channel) sum over the pixels of
    ``gelu(q * scale + bias)``, q the cast output taken back to fp32.

    ``halo=(top, bot)``: x is a band of a taller scene and its raw halo rows
    [N,1,W,C] (None at the scene's edge: mirrored) are normalised and
    activated with it; the statistics and the pooled sum are the band's."""
    N, H, W, C = x.shape
    m = mean.float().repeat_interleave(C // groups_in, -1)[:, None, None, :]
    cf = coef.float().repeat_interleave(C // groups_in, -1)[:, None, None, :]
    xe = x if halo is None else halo_rows(x, *halo)
    h = F.gelu((xe.float() - m) * cf * scale.float() + bias.float())
    if halo is None:
        # pad H and W of the NHWC map as the inner dims of a 5-D view
        hp = F.pad(h.unsqueeze(1), (0, 0, 1, 1, 1, 1), mode="reflect").squeeze(1)
    else:
        hp = mirror_cols(h)
    w9 = w.float().reshape(9, C)
    acc = torch.zeros((N, H, W, C), dtype=torch.float32, device=x.device)
    for dx in range(3):
        for dy in range(3):
            acc = acc + hp[:, dy:dy + H, dx:dx + W] * w9[dy * 3 + dx]
    out = acc.to(x.dtype)
    if do_stats:
        og = out.float().view(N, H * W, groups_out, C // groups_out)
        s1, s2 = og.sum(dim=(1, 3)), og.square().sum(dim=(1, 3))
    else:
        s1 = torch.zeros((N, groups_out), dtype=torch.float32, device=x.device)
        s2 = s1.clone()
    if pool_affine is None:
        return out, s1, s2
    pool = F.gelu(out.float() * pool_affine[0].float()
                  + pool_affine[1].float()).sum(dim=(1, 2))
    return out, s1, s2, pool


def norm_gelu_dwconv3x3(x: torch.Tensor, mean: torch.Tensor, coef: torch.Tensor,
                        scale: torch.Tensor, bias: torch.Tensor, w: torch.Tensor,
                        groups_in: int = 4, groups_out: int = 4,
                        do_stats: bool = True,
                        pool_affine: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                        halo=None):
    """dw3x3(gelu(norm(x))) with reflect borders, fused.

    x [N,H,W,C] (bf16 or fp32, NHWC contiguous, H and W >= 2); mean/coef
    [N,groups_in]; scale/bias [C]; w [3,3,C] (tap dy, dx). The small
    tensors are taken as fp32. Returns (out [N,H,W,C] in x's dtype, sum
    [N,groups_out], sumsq [N,groups_out]): the per-(frame, group) sum and
    sum of squares of the output after rounding, or zeros when ``do_stats``
    is False (the kernel then skips them).

    ``pool_affine=(pscale, pbias)``, each [C], adds a fourth return value
    ``pool`` [N,C] fp32: the sum over the frame's pixels of
    ``gelu(q * pscale + pbias)``, q the output after rounding to x's dtype.
    Divided by H*W it is the squeeze-and-excitation mean of the fused MBConv
    body, taken in the same pass over the output.

    A CUDA tensor launches the CUDA kernel, which moves 16-byte channel
    vectors and so needs C % 8 == 0 in bf16 and C % 4 == 0 in fp32
    (anything else raises); a CPU tensor runs
    :func:`norm_gelu_dwconv3x3_plain`. ``norm_gelu_dwconv3x3.launches``
    counts the kernel launches. Like K3 the kernel has no backward and
    raises on the card when grad is enabled and an input requires grad.

    ``halo=(top, bot)``: the halo mode. x is one band of rows of a scene
    split over the ranks of a 2-D mesh and ``top`` / ``bot`` [N,1,W,C] are
    the raw input rows just above and below it (None at the scene's edge,
    which mirrors), normalised and activated like the band's own; the
    statistics and the pooled sum cover the band's own rows (operator
    ``uncrtaints::norm_gelu_dwconv3x3_halo``; its launches are counted in
    ``launches`` and ``halo_launches``)."""
    name = "norm_gelu_dwconv3x3"
    if x.dim() != 4 or tuple(w.shape) != (3, 3, x.shape[-1]):
        raise ValueError(f"{name}: x [N,H,W,C] and w [3,3,C] expected, got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    N, H, W, C = x.shape
    if x.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"{name}: x must be fp32 or bf16, got {x.dtype}")
    if H < 2 or W < 2:
        raise ValueError(f"{name}: the reflect border needs H, W >= 2, got {H}x{W}")
    if C % groups_in or C % groups_out:
        raise ValueError(f"{name}: C={C} is not a multiple of groups_in="
                         f"{groups_in} and groups_out={groups_out}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: x must be contiguous")
    if pool_affine is not None:
        if len(pool_affine) != 2:
            raise ValueError(f"{name}: pool_affine must be (scale, bias)")
        pool_affine = tuple(_f32(t, (C,), f"{name}: pool_affine[{i}]")
                            for i, t in enumerate(pool_affine))
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.device.type == "cuda":
        _refuse_grad(name, (x, mean, coef, scale, bias, w,
                            *(pool_affine if pool_affine is not None else ())))
    pscale, pbias = pool_affine if pool_affine is not None else (None, None)
    if halo is not None:
        check_halo(name, x, halo)
        *result, pool = torch.ops.uncrtaints.norm_gelu_dwconv3x3_halo(
            x, *halo, mean, coef, scale, bias, w, pscale, pbias, groups_in, groups_out,
            do_stats)
        return tuple(result) if pool_affine is None else (*result, pool)
    *result, pool = torch.ops.uncrtaints.norm_gelu_dwconv3x3(
        x, mean, coef, scale, bias, w, pscale, pbias, groups_in, groups_out, do_stats)
    return tuple(result) if pool_affine is None else (*result, pool)


def _k4_launch(x, mean, coef, scale, bias, w, pscale, pbias, groups_in, groups_out,
               do_stats, halo=None):
    """The CUDA kernel's launch (the operator's CUDA implementation); the
    fourth value is [0] without ``pscale``."""
    name = "norm_gelu_dwconv3x3"
    N, H, W, C = x.shape
    vec = 16 // x.element_size()
    if C % vec:
        raise ValueError(f"{name} kernel needs C % {vec} == 0 for {x.dtype} "
                         f"(16-byte channel vectors), got C={C}")

    mean = _f32(mean, (N, groups_in), f"{name}: mean")
    coef = _f32(coef, (N, groups_in), f"{name}: coef")
    scale = _f32(scale, (C,), f"{name}: scale")
    bias = _f32(bias, (C,), f"{name}: bias")
    w9 = w.to(torch.float32).reshape(9, C).contiguous()
    pooled = pscale is not None
    small = (mean, coef, scale, bias, w9, *((pscale, pbias) if pooled else ()))
    if any(t.device != x.device for t in small):
        raise ValueError(f"{name}: all tensors must be on x's device")
    if any(t.data_ptr() % 16 for t in (x, *(halo or ())) if t is not None):
        raise ValueError(f"{name}: x and its halo rows must be 16-byte aligned")

    dev = x.device
    out = torch.empty_like(x)
    s1 = torch.zeros((N, groups_out), dtype=torch.float32, device=dev)
    s2 = torch.zeros((N, groups_out), dtype=torch.float32, device=dev)
    pool = torch.zeros((N, C) if pooled else (0,), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out, s1, s2, pool
    vp, ci = ctypes.c_void_p, ctypes.c_int
    # one partial row per item of the kernel's grid walk (and N more for
    # the statistics' second pass)
    rows = N * _build.kernel("uncr_ngd_blocks", [ci, ci])(H, W)
    psum = psq = ppool = None
    if do_stats:
        psum = torch.empty((rows + N, C), dtype=torch.float32, device=dev)
        psq = torch.empty_like(psum)
    if pooled:
        ppool = torch.empty((rows, C), dtype=torch.float32, device=dev)
    ptr = lambda t: t.data_ptr() if t is not None else None
    args = (_build.DTYPE_CODES[x.dtype], mean.data_ptr(),
            coef.data_ptr(), groups_in, scale.data_ptr(), bias.data_ptr(),
            w9.data_ptr(), out.data_ptr(), N, H, W, C, ptr(psum),
            ptr(psq), s1.data_ptr(), s2.data_ptr(), groups_out,
            ptr(pscale), ptr(pbias), ptr(ppool), ptr(pool if pooled else None),
            torch.cuda.current_stream(dev).cuda_stream)
    types = [ci, vp, vp, ci, vp, vp, vp, vp, ci, ci, ci, ci, vp, vp, vp, vp, ci,
             vp, vp, vp, vp, vp]
    entry = "uncr_norm_gelu_dwconv3x3" if halo is None else "uncr_norm_gelu_dwconv3x3_halo"
    with torch.cuda.device(dev):
        if halo is None:
            err = _build.kernel(entry, [vp] + types)(x.data_ptr(), *args)
        else:
            err = _build.kernel(entry, [vp] * 3 + types)(
                x.data_ptr(), *(ptr(t) for t in halo), *args)
    _build.check(err, entry)
    norm_gelu_dwconv3x3.launches += 1
    if halo is not None:
        norm_gelu_dwconv3x3.halo_launches += 1
    return out, s1, s2, pool


# K4 as an operator of the dispatcher (``torch.ops.uncrtaints.norm_gelu_dwconv3x3``):
# the CUDA kernel for a CUDA tensor, the plain version for a CPU tensor, the
# output shapes for a FakeTensor; the pooled sum is [0] without ``pscale``
# (an operator's outputs are fixed). Eval only, as K3.

@torch.library.custom_op("uncrtaints::norm_gelu_dwconv3x3", mutates_args=(),
                         device_types="cuda")
def _k4(x: torch.Tensor, mean: torch.Tensor, coef: torch.Tensor, scale: torch.Tensor,
        bias: torch.Tensor, w: torch.Tensor, pscale: Optional[torch.Tensor],
        pbias: Optional[torch.Tensor], groups_in: int, groups_out: int,
        do_stats: bool) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    return _k4_launch(x, mean, coef, scale, bias, w, pscale, pbias, groups_in,
                      groups_out, do_stats)


@_k4.register_kernel("cpu")
def _k4_cpu(x, mean, coef, scale, bias, w, pscale, pbias, groups_in, groups_out,
            do_stats):
    pooled = pscale is not None
    res = norm_gelu_dwconv3x3_plain(
        x, mean, coef, scale, bias, w, groups_in=groups_in, groups_out=groups_out,
        do_stats=do_stats, pool_affine=(pscale, pbias) if pooled else None)
    return res if pooled else (*res, x.new_zeros((0,), dtype=torch.float32))


@_k4.register_fake
def _k4_fake(x, mean, coef, scale, bias, w, pscale, pbias, groups_in, groups_out,
             do_stats):
    N, C = x.shape[0], x.shape[-1]
    f32 = lambda *shape: x.new_empty(shape, dtype=torch.float32)
    pool = f32(N, C) if pscale is not None else f32(0)
    return x.new_empty(x.shape), f32(N, groups_out), f32(N, groups_out), pool


@register_flop_formula(torch.ops.uncrtaints.norm_gelu_dwconv3x3)
def _k4_flops(x_shape, *args, out_shape=None, **kwargs) -> int:
    """The nine taps' multiply-adds, two FLOPs each (torch's count of a
    depthwise 3x3 convolution)."""
    return 2 * 9 * math.prod(x_shape)


# K4's halo mode (``torch.ops.uncrtaints.norm_gelu_dwconv3x3_halo``): the
# raw halo rows ``top`` / ``bot`` [N,1,W,C] (None at the scene's edge) after
# x, otherwise the operator above

@torch.library.custom_op("uncrtaints::norm_gelu_dwconv3x3_halo", mutates_args=(),
                         device_types="cuda")
def _k4h(x: torch.Tensor, top: Optional[torch.Tensor], bot: Optional[torch.Tensor],
         mean: torch.Tensor, coef: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
         w: torch.Tensor, pscale: Optional[torch.Tensor], pbias: Optional[torch.Tensor],
         groups_in: int, groups_out: int,
         do_stats: bool) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    return _k4_launch(x, mean, coef, scale, bias, w, pscale, pbias, groups_in,
                      groups_out, do_stats, halo=(top, bot))


@_k4h.register_kernel("cpu")
def _k4h_cpu(x, top, bot, mean, coef, scale, bias, w, pscale, pbias, groups_in, groups_out,
             do_stats):
    pooled = pscale is not None
    res = norm_gelu_dwconv3x3_plain(
        x, mean, coef, scale, bias, w, groups_in=groups_in, groups_out=groups_out,
        do_stats=do_stats, pool_affine=(pscale, pbias) if pooled else None, halo=(top, bot))
    return res if pooled else (*res, x.new_zeros((0,), dtype=torch.float32))


@_k4h.register_fake
def _k4h_fake(x, top, bot, mean, coef, scale, bias, w, pscale, pbias, groups_in, groups_out,
              do_stats):
    return _k4_fake(x, mean, coef, scale, bias, w, pscale, pbias, groups_in, groups_out,
                    do_stats)


@register_flop_formula(torch.ops.uncrtaints.norm_gelu_dwconv3x3_halo)
def _k4h_flops(x_shape, *args, out_shape=None, **kwargs) -> int:
    return 2 * 9 * math.prod(x_shape)


norm_gelu_dwconv3x3.launches = 0
norm_gelu_dwconv3x3.halo_launches = 0
