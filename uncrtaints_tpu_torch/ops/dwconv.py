"""Depthwise stride-1 correlation, kernel K5, with three border rules.

    zeros:    out[n,ho,wo,c] = sum_{dy,dx} xpad[n, ho+dy, wo+dx, c] * w[c, 0, dy, dx]
    reflect:  out[n,h,w,c]   = sum_{dy,dx} x[n, m(h+dy-1), m(w+dx-1), c] * w[c, 0, dy, dx]

over NHWC maps, xpad being x zero-padded by ``pads = ((top, bottom), (left,
right))`` and m torch's reflect index for a pad of one (m(-1) = 1, m(L) =
L-2; 3x3 kernels, H, W >= 2). The taps are summed in fp32 and rounded once to
x's dtype; the plain versions sum in the order of the JAX package's shift-add
form (uncrtaints_tpu/models/layers.py:_dw_shift_add: dy-major, dx-minor).
The third rule is the adjoint of the reflect correlation
(:func:`dw_stencil_reflect_adjoint`): its input gradient with the pad's fold
inside, so that no padded tensor exists on the way forward or back, as in
the JAX package's fused VJP (layers.py:_dw_reflect3x3).

In halo mode (``halo=(top, bot)``, reflect only) x is one band of rows of a
scene split over the ranks of a 2-D mesh (parallel/mesh.py): rows -1 and H
are the neighbours' edge rows ``top`` and ``bot`` [N,1,W,C], and only a None
one (the scene's edge) mirrors; columns always mirror. Its adjoint folds
only at the scene's edge and also returns the gradient of the two halo rows.
The JAX package has no counterpart inside its kernel: its partition rule
gathers the rows before the kernel (pallas_dwconv.py:171-176).

Port of uncrtaints_tpu/ops/pallas_dwconv.py:dw_stencil; the CUDA kernel is
csrc/dwconv.cu. The train step runs it for the differentiated depthwise
forward and its input gradient (models/layers.py:Conv2d).

The weight has the port's depthwise layout [C,1,kh,kw] (OIHW); a caller
flips or reshapes it.
"""

from __future__ import annotations

import ctypes
import math
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.flop_counter import register_flop_formula

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


# the border rules and their codes in csrc/common.cuh (DwMode)
MODES = {"zeros": 0, "reflect": 1}
_MODE_NAMES = {v: k for k, v in MODES.items()}
_REFLECT_ADJOINT = 2
_PADS_ONE: Pads = ((1, 1), (1, 1))


def reflect_pad(x: torch.Tensor) -> torch.Tensor:
    """Reflect-pad H and W of an NHWC tensor by one pixel (as the
    last-but-channel dims of a 5-D view, which keeps NHWC memory)."""
    return F.pad(x.unsqueeze(1), (0, 0, 1, 1, 1, 1), mode="reflect").squeeze(1)


def _shift_add_f32(xp: torch.Tensor, w: torch.Tensor, Ho: int, Wo: int) -> torch.Tensor:
    """The kh*kw shifted fp32 multiply-adds of padded xp with w [C,1,kh,kw],
    dy-major, dx-minor; fp32, not yet rounded."""
    kh, kw = w.shape[-2:]
    w32 = w.float().reshape(-1, kh, kw)
    acc = torch.zeros((xp.shape[0], Ho, Wo, xp.shape[-1]), dtype=torch.float32,
                      device=xp.device)
    for dy in range(kh):
        for dx in range(kw):
            acc = acc + xp[:, dy:dy + Ho, dx:dx + Wo].float() * w32[:, dy, dx]
    return acc


def dw_stencil_plain(x: torch.Tensor, w: torch.Tensor, pads: Pads,
                     mode: str = "zeros") -> torch.Tensor:
    """The plain PyTorch version of the kernel: pad (zeros by ``pads``, or a
    reflect pad of one), then kh*kw shifted fp32 multiply-adds (the
    shift-add form)."""
    N, H, W, C = x.shape
    kh, kw = w.shape[-2:]
    Ho, Wo = out_hw(H, W, kh, kw, pads)
    xp = reflect_pad(x) if mode == "reflect" else zero_pad(x, pads)
    return _shift_add_f32(xp, w, Ho, Wo).to(x.dtype)


def dw_stencil_reflect_adjoint_plain(g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of the folded adjoint: the FULL zero-pad
    shift-add of g with the flipped kernel gives the gradient of the padded
    input [N,H+2,W+2,C]; the pad's adjoint folds its ring onto rows and
    columns 1 and -2. All in fp32, rounded once."""
    N, H, W, C = g.shape
    full = _shift_add_f32(zero_pad(g, ((2, 2), (2, 2))), w.flip((-2, -1)), H + 2, W + 2)
    full[:, 2] += full[:, 0]        # padded row 0 mirrors x row 1
    full[:, -3] += full[:, -1]      # padded row H+1 mirrors x row H-2
    full = full[:, 1:-1]
    full[:, :, 2] += full[:, :, 0]
    full[:, :, -3] += full[:, :, -1]
    return full[:, :, 1:-1].to(g.dtype).contiguous()


def halo_rows(x: torch.Tensor, top: Optional[torch.Tensor],
              bot: Optional[torch.Tensor]) -> torch.Tensor:
    """A band [N,H,W,C] with the row above and the row below: the
    neighbours' rows ``top`` / ``bot`` [N,1,W,C], or at the scene's edge
    (None) the mirrored rows 1 and H-2 -> [N,H+2,W,C]."""
    t = top if top is not None else x[:, 1:2]
    b = bot if bot is not None else x[:, -2:-1]
    return torch.cat([t, x, b], dim=1)


def mirror_cols(x: torch.Tensor) -> torch.Tensor:
    """Reflect-pad the columns of an NHWC map by one pixel."""
    return torch.cat([x[:, :, 1:2], x, x[:, :, -2:-1]], dim=2)


def dw_stencil_halo_plain(x: torch.Tensor, w: torch.Tensor, top: Optional[torch.Tensor],
                          bot: Optional[torch.Tensor]) -> torch.Tensor:
    """The plain PyTorch version of the halo mode: the band with its halo
    rows (mirrored at the scene's edge), the columns mirrored, then the nine
    shifted fp32 multiply-adds (VALID in H)."""
    N, H, W, C = x.shape
    return _shift_add_f32(mirror_cols(halo_rows(x, top, bot)), w, H, W).to(x.dtype)


def dw_stencil_halo_adjoint_plain(g: torch.Tensor, w: torch.Tensor, has_top: bool,
                                  has_bot: bool):
    """The plain PyTorch version of the halo mode's adjoint: the FULL
    zero-pad shift-add of g with the flipped kernel is the gradient of the
    band with its halo rows, padded by a column each side; the column pad
    folds as always, the row pad only at the scene's edge (no neighbour),
    and rows 0 and H+1 are the halo rows' gradients. -> (gx [N,H,W,C], gtop
    [N,1,W,C] or [0], gbot likewise), in g's dtype."""
    N, H, W, C = g.shape
    full = _shift_add_f32(zero_pad(g, ((2, 2), (2, 2))), w.flip((-2, -1)), H + 2, W + 2)
    if not has_top:
        full[:, 2] += full[:, 0]
    if not has_bot:
        full[:, -3] += full[:, -1]
    full[:, :, 2] += full[:, :, 0]
    full[:, :, -3] += full[:, :, -1]
    full = full[:, :, 1:-1].to(g.dtype)
    empty = g.new_empty(0)
    return (full[:, 1:-1].contiguous(), full[:, :1].contiguous() if has_top else empty,
            full[:, -1:].contiguous() if has_bot else empty.clone())


def check_halo(name: str, x: torch.Tensor, halo) -> None:
    """Raise unless ``halo`` is (top, bot), each None or [N,1,W,C] in x's
    dtype, on its device and contiguous, and the band has the two rows the
    kernels need."""
    if len(halo) != 2:
        raise ValueError(f"{name}: halo must be (top, bot)")
    N, H, W, C = x.shape
    if H < 2 or W < 2:
        raise ValueError(f"{name}: a band needs H, W >= 2, got {H}x{W}")
    for side, t in zip(("top", "bot"), halo):
        if t is None:
            continue
        if tuple(t.shape) != (N, 1, W, C) or t.dtype != x.dtype or t.device != x.device:
            raise ValueError(f"{name}: halo {side} must be [N,1,W,C] = {(N, 1, W, C)} "
                             f"{x.dtype} on {x.device}, got {tuple(t.shape)} {t.dtype} "
                             f"on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: halo {side} must be contiguous")


def check_pads(name: str, x: torch.Tensor, kh: int, kw: int, pads: Pads) -> None:
    """Raise unless pads are non-negative and leave an output of size >= 1."""
    if any(p < 0 for pair in pads for p in pair):
        raise ValueError(f"{name}: negative pads {pads}")
    Ho, Wo = out_hw(x.shape[1], x.shape[2], kh, kw, pads)
    if Ho < 1 or Wo < 1:
        raise ValueError(f"{name}: a {kh}x{kw} kernel with pads {pads} leaves "
                         f"no output of x {tuple(x.shape)}")


def check_mode(name: str, x: torch.Tensor, kh: int, kw: int, pads: Pads,
               mode: str) -> None:
    """Raise unless ``mode`` is a border rule and, for reflect, the kernel is
    3x3 with pads of one on a map of at least 2x2."""
    if mode not in MODES:
        raise ValueError(f"{name}: mode must be one of {list(MODES)}, got {mode!r}")
    if mode != "reflect":
        return
    if (kh, kw) != (3, 3) or tuple(map(tuple, pads)) != _PADS_ONE:
        raise ValueError(f"{name}: reflect mode takes a 3x3 kernel with pads "
                         f"{_PADS_ONE}, got {kh}x{kw} with pads {pads}")
    if x.shape[1] < 2 or x.shape[2] < 2:
        raise ValueError(f"{name}: the reflect border needs H, W >= 2, got "
                         f"{x.shape[1]}x{x.shape[2]}")


def _check_operands(name: str, x: torch.Tensor, w: torch.Tensor) -> None:
    if x.dim() != 4 or w.dim() != 4 or w.shape[:2] != (x.shape[-1], 1):
        raise ValueError(f"{name}: x [N,H,W,C] and w [C,1,kh,kw] expected, "
                         f"got {tuple(x.shape)} and {tuple(w.shape)}")
    if x.dtype not in _build.DTYPE_CODES or w.dtype != x.dtype:
        raise TypeError(f"{name}: x and w must share a dtype in "
                        f"{list(_build.DTYPE_CODES)}, got {x.dtype}, {w.dtype}")
    if x.device != w.device:
        raise ValueError(f"{name}: x on {x.device}, w on {w.device}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError(f"{name}: x and w must be contiguous")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {x.device}")


def _launch(x: torch.Tensor, w: torch.Tensor, pads: Pads, mode_code: int) -> torch.Tensor:
    """One launch of the CUDA kernel; counted in ``dw_stencil.launches``."""
    N, H, W, C = x.shape
    kh, kw = w.shape[-2:]
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
        ci, ci, ci, ci, ci, ci, ci, ctypes.c_void_p])
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), N, H, W, C, kh, kw,
                 pt, pb, pl, pr, mode_code, _build.DTYPE_CODES[x.dtype],
                 torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "uncr_dw_stencil")
    dw_stencil.launches += 1
    return out


def _launch_halo(x: torch.Tensor, w: torch.Tensor, top, bot, mode_code: int,
                 has_top: bool = False, has_bot: bool = False):
    """One launch of the CUDA kernel's halo mode (uncr_dw_stencil_halo);
    counted in ``dw_stencil.launches`` and ``dw_stencil.halo_launches``.
    Reflect: -> out. Adjoint (x the output gradient): -> (gx, gtop, gbot),
    a halo gradient [N,1,W,C] where the band has that neighbour, else [0]."""
    N, H, W, C = x.shape
    out = torch.empty_like(x)
    adj = mode_code == _REFLECT_ADJOINT
    edge = lambda has: (x.new_empty((N, 1, W, C)) if has else x.new_empty(0)) if adj else None
    gtop, gbot = edge(has_top), edge(has_bot)
    if out.numel():
        ptr = lambda t: t.data_ptr() if t is not None and t.numel() else None
        ci, vp = ctypes.c_int, ctypes.c_void_p
        fn = _build.kernel("uncr_dw_stencil_halo", [vp] * 7 + [ci] * 6 + [vp])
        with torch.cuda.device(x.device):
            err = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), ptr(top), ptr(bot),
                     ptr(gtop), ptr(gbot), N, H, W, C, mode_code, _build.DTYPE_CODES[x.dtype],
                     torch.cuda.current_stream(x.device).cuda_stream)
        _build.check(err, "uncr_dw_stencil_halo")
        dw_stencil.launches += 1
        dw_stencil.halo_launches += 1
    return (out, gtop, gbot) if adj else out


def pads_of(flat) -> Pads:
    """[top, bottom, left, right] (an operator's int list) -> Pads."""
    pt, pb, pl, pr = flat
    return (pt, pb), (pl, pr)


# K5 as an operator of the dispatcher (``torch.ops.uncrtaints.dw_stencil``):
# the CUDA kernel for a CUDA tensor, the plain versions for a CPU tensor, the
# output shape for a FakeTensor, and its backward through the operator itself
# (the input gradient) and K2 (``torch.ops.uncrtaints.dw_kernel_grad``, the
# weight gradient). ``mode`` is a code of MODES, or _REFLECT_ADJOINT.

@torch.library.custom_op("uncrtaints::dw_stencil", mutates_args=(), device_types="cuda")
def _k5(x: torch.Tensor, w: torch.Tensor, pads: List[int], mode: int) -> torch.Tensor:
    return _launch(x, w, pads_of(pads), mode)


@_k5.register_kernel("cpu")
def _k5_cpu(x, w, pads, mode):
    if mode == _REFLECT_ADJOINT:
        return dw_stencil_reflect_adjoint_plain(x, w)
    return dw_stencil_plain(x, w, pads_of(pads), _MODE_NAMES[mode])


@_k5.register_fake
def _k5_fake(x, w, pads, mode):
    N, H, W, C = x.shape
    Ho, Wo = out_hw(H, W, *w.shape[-2:], pads_of(pads))
    return x.new_empty((N, Ho, Wo, C))


def _k5_setup(ctx, inputs, output):
    x, w, pads, mode = inputs
    ctx.save_for_backward(x, w)
    ctx.pads, ctx.mode = pads, _MODE_NAMES.get(mode, "reflect adjoint")


def _k5_backward(ctx, g):
    """The input gradient by K5 (``zeros``: the flipped kernel with the
    complementary pads, the FULL pads of a VALID forward, as the JAX
    package's _dw_conv_valid VJP; ``reflect``: the folded adjoint), the
    weight gradient by K2 (fp32, cast to w's dtype)."""
    x, w = ctx.saved_tensors
    if ctx.mode not in MODES:
        raise RuntimeError("dw_stencil: the reflect adjoint has no backward")
    pt, pb, pl, pr = ctx.pads
    kh, kw = w.shape[-2:]
    g = g.contiguous()
    gx = gw = None
    if ctx.needs_input_grad[0]:
        if ctx.mode == "reflect":
            gx = torch.ops.uncrtaints.dw_stencil(g, w, [1, 1, 1, 1], _REFLECT_ADJOINT)
        else:
            gx = torch.ops.uncrtaints.dw_stencil(
                g, w.flip((-2, -1)).contiguous(),
                [kh - 1 - pt, kh - 1 - pb, kw - 1 - pl, kw - 1 - pr], 0)
    if ctx.needs_input_grad[1]:
        gw = torch.ops.uncrtaints.dw_kernel_grad(
            x, g, list(ctx.pads), kh, kw, MODES[ctx.mode]).to(w.dtype)
    return gx, gw, None, None


_k5.register_autograd(_k5_backward, setup_context=_k5_setup)


@register_flop_formula(torch.ops.uncrtaints.dw_stencil)
def _k5_flops(x_shape, w_shape, *args, out_shape=None, **kwargs) -> int:
    """Two FLOPs a multiply-add, kh*kw of them an output (torch's count of
    a depthwise convolution)."""
    return 2 * math.prod(out_shape) * w_shape[-2] * w_shape[-1]


# K5's halo mode as two operators: the forward (``dw_stencil_halo``,
# differentiable in x, w and the halo rows: its input gradient by the halo
# adjoint, its weight gradient by K2's halo mode) and the adjoint
# (``dw_stencil_halo_adjoint``), which returns the band's gradient and the
# halo rows' ([0] where there is no neighbour: an operator's outputs are
# fixed).

@torch.library.custom_op("uncrtaints::dw_stencil_halo", mutates_args=(), device_types="cuda")
def _k5h(x: torch.Tensor, w: torch.Tensor, top: Optional[torch.Tensor],
         bot: Optional[torch.Tensor]) -> torch.Tensor:
    return _launch_halo(x, w, top, bot, MODES["reflect"])


@_k5h.register_kernel("cpu")
def _k5h_cpu(x, w, top, bot):
    return dw_stencil_halo_plain(x, w, top, bot)


@_k5h.register_fake
def _k5h_fake(x, w, top, bot):
    return x.new_empty(x.shape)


@torch.library.custom_op("uncrtaints::dw_stencil_halo_adjoint", mutates_args=(),
                         device_types="cuda")
def _k5ha(g: torch.Tensor, w: torch.Tensor, has_top: bool,
          has_bot: bool) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return _launch_halo(g, w, None, None, _REFLECT_ADJOINT, has_top, has_bot)


@_k5ha.register_kernel("cpu")
def _k5ha_cpu(g, w, has_top, has_bot):
    return dw_stencil_halo_adjoint_plain(g, w, has_top, has_bot)


@_k5ha.register_fake
def _k5ha_fake(g, w, has_top, has_bot):
    N, H, W, C = g.shape
    edge = lambda has: g.new_empty((N, 1, W, C)) if has else g.new_empty(0)
    return g.new_empty(g.shape), edge(has_top), edge(has_bot)


def _k5h_setup(ctx, inputs, output):
    x, w, top, bot = inputs
    ctx.save_for_backward(x, w, top, bot)


def _k5h_backward(ctx, g):
    x, w, top, bot = ctx.saved_tensors
    g = g.contiguous()
    gx = gw = gtop = gbot = None
    if ctx.needs_input_grad[0] or ctx.needs_input_grad[2] or ctx.needs_input_grad[3]:
        gx, gtop, gbot = torch.ops.uncrtaints.dw_stencil_halo_adjoint(
            g, w, top is not None, bot is not None)
    if ctx.needs_input_grad[1]:
        gw = torch.ops.uncrtaints.dw_kernel_grad_halo(x, g, top, bot).to(w.dtype)
    return (gx, gw, gtop if top is not None else None, gbot if bot is not None else None)


_k5h.register_autograd(_k5h_backward, setup_context=_k5h_setup)


@register_flop_formula(torch.ops.uncrtaints.dw_stencil_halo)
def _k5h_flops(x_shape, *args, out_shape=None, **kwargs) -> int:
    return 2 * 9 * math.prod(x_shape)


@register_flop_formula(torch.ops.uncrtaints.dw_stencil_halo_adjoint)
def _k5ha_flops(g_shape, *args, out_shape=None, **kwargs) -> int:
    return 2 * 9 * math.prod(g_shape)


def dw_stencil(x: torch.Tensor, w: torch.Tensor, pads: Pads,
               mode: str = "zeros", halo=None) -> torch.Tensor:
    """x [N,H,W,C], w [C,1,kh,kw] (contiguous, one dtype: fp32 or bf16) ->
    [N,Ho,Wo,C] in x's dtype. ``mode="reflect"`` takes the unpadded x, a 3x3
    kernel and ``pads`` of one, and mirrors the border instead of padding.

    A CUDA tensor launches the CUDA kernel, which takes the kernel sizes in
    ``KERNEL_SIZES`` (anything else raises); a CPU tensor runs
    :func:`dw_stencil_plain`; both through the operator
    ``torch.ops.uncrtaints.dw_stencil``, which is differentiable in x and w
    (the input gradient by this kernel, the weight gradient by K2,
    :func:`dw_kernel_grad`; the JAX package's VJPs of _dw_conv_valid and
    _dw_reflect3x3). ``dw_stencil.launches`` counts the kernel launches,
    those of :func:`dw_stencil_reflect_adjoint` included (one kernel, K5).

    ``halo=(top, bot)`` (reflect only) runs the halo mode on a band of a
    taller scene: ``top`` / ``bot`` [N,1,W,C] the rows just above and below
    it, None at the scene's edge (operator ``uncrtaints::dw_stencil_halo``,
    differentiable in x, w and both halo rows). ``dw_stencil.halo_launches``
    counts its launches (also counted in ``launches``)."""
    _check_operands("dw_stencil", x, w)
    kh, kw = w.shape[-2:]
    check_pads("dw_stencil", x, kh, kw, pads)
    check_mode("dw_stencil", x, kh, kw, pads, mode)
    if halo is not None:
        if mode != "reflect":
            raise ValueError("dw_stencil: the halo mode is a reflect mode")
        check_halo("dw_stencil", x, halo)
        return torch.ops.uncrtaints.dw_stencil_halo(x, w, *halo)
    return torch.ops.uncrtaints.dw_stencil(x, w, [*pads[0], *pads[1]], MODES[mode])


dw_stencil.launches = 0
dw_stencil.halo_launches = 0


def dw_stencil_reflect_adjoint(g: torch.Tensor, w: torch.Tensor, halo=None):
    """The input gradient of ``dw_stencil(x, w, pads of one, "reflect")``:
    g [N,H,W,C] the output gradient, w [C,1,3,3] the primal kernel (not
    flipped) -> gx [N,H,W,C] in g's dtype,

        gx[n,r,s,c] = sum g[n,h,w,c] * w[c,0,dy,dx]

    over all (h, dy) with m(h+dy-1) = r and all (w, dx) with m(w+dx-1) = s:
    nine terms inside, up to sixteen next to a corner. No [N,H+2,W+2,C]
    tensor is made. A CUDA tensor launches the CUDA kernel (counted in
    ``dw_stencil.launches``); a CPU tensor runs
    :func:`dw_stencil_reflect_adjoint_plain`.

    ``halo=(has_top, has_bot)``: the adjoint of the halo mode, for a band
    with a neighbour above / below where True -> (gx, gtop, gbot), a halo
    row's gradient [N,1,W,C] where the band has that neighbour, else None."""
    name = "dw_stencil_reflect_adjoint"
    _check_operands(name, g, w)
    check_mode(name, g, *w.shape[-2:], _PADS_ONE, "reflect")
    if halo is not None:
        has_top, has_bot = map(bool, halo)
        check_halo(name, g, (None, None))
        gx, gtop, gbot = torch.ops.uncrtaints.dw_stencil_halo_adjoint(g, w, has_top, has_bot)
        return gx, gtop if has_top else None, gbot if has_bot else None
    return torch.ops.uncrtaints.dw_stencil(g, w, [1, 1, 1, 1], _REFLECT_ADJOINT)


# K5's backward calls K2: register its operator with this one's
from uncrtaints_tpu_torch.ops import dwgrad as _dwgrad  # noqa: E402,F401
