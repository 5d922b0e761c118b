"""Reflect pad of an NHWC map and its adjoint, kernel K7.

    forward   y[n,r,s,c] = x[n, m(r-p), m(s-p), c]     x [N,H,W,C] -> [N,H+2p,W+2p,C]
    adjoint   gx[n,i,j,c] = sum of g[n,r,s,c] over m(r-p) = i, m(s-p) = j

with m torch's reflect index (-i below 0, 2L-2-i from L: the edge is not
repeated) and 1 <= p < min(H, W). Per axis an input position i has the
padded position i+p and up to two mirrored ones (p-i where 1 <= i <= p,
2L-2-i+p where L-1-p <= i <= L-2); the adjoint sums each padded row's
column terms first (i+p, then the low, then the high mirror), then the rows
in the same order, in fp32, and rounds once.

The convolutions that take a padded tensor (models/layers.py:Conv2d: the
reflect convs that K5 and K2 do not fold) pad through this module: on a CUDA
tensor the kernels of csrc/pad.cu, in place of ATen's reflection_pad3d and
its backward; on a CPU tensor the plain versions (:func:`reflect_pad_plain`,
``F.pad`` of the 5-D view, and :func:`reflect_pad_adjoint_plain`, the gather
written out in fp32). The JAX package has no kernel here: its ``jnp.pad`` is
fused by XLA.

Both directions are dispatcher operators, ``uncrtaints::reflect_pad`` (its
backward the adjoint, which saves no tensor, as ATen's pad saves none) and
``uncrtaints::reflect_pad_adjoint``.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from uncrtaints_tpu_torch import _build


def reflect_pad_plain(x: torch.Tensor, pad: int) -> torch.Tensor:
    """The plain version of the forward: ``F.pad`` of H and W as the
    last-but-channel dims of a 5-D view (one pass that keeps NHWC memory)."""
    return F.pad(x.unsqueeze(1), (0, 0, pad, pad, pad, pad), mode="reflect").squeeze(1)


def _fold(t: torch.Tensor, dim: int, pad: int) -> torch.Tensor:
    """The adjoint of the reflect pad along ``dim`` of t: the interior,
    plus the low mirror onto 1..p, plus the high mirror onto L-1-p..L-2."""
    L = t.shape[dim] - 2 * pad
    out = t.narrow(dim, pad, L).clone()
    out.narrow(dim, 1, pad).add_(t.narrow(dim, 0, pad).flip(dim))
    out.narrow(dim, L - 1 - pad, pad).add_(t.narrow(dim, L + pad, pad).flip(dim))
    return out


def reflect_pad_adjoint_plain(g: torch.Tensor, pad: int) -> torch.Tensor:
    """The plain version of the adjoint: g [N,H+2p,W+2p,C] -> [N,H,W,C], the
    columns folded, then the rows, in fp32 (or g's wider dtype), rounded
    once to g's dtype."""
    acc = g.to(torch.promote_types(g.dtype, torch.float32))
    return _fold(_fold(acc, 2, pad), 1, pad).to(g.dtype)


@functools.lru_cache(maxsize=None)
def _fn(name: str):
    """The C entry point ``name`` of csrc/pad.cu, its argument types declared
    once: (in, out, N, H, W, C, pad, dtype, stream), H and W unpadded."""
    ci, vp = ctypes.c_int, ctypes.c_void_p
    return _build.kernel(name, [vp, vp, ci, ci, ci, ci, ci, ci, vp])


def _padded(shape, pad: int):
    N, H, W, C = shape
    return N, H + 2 * pad, W + 2 * pad, C


def _unpadded(shape, pad: int):
    N, H2, W2, C = shape
    return N, H2 - 2 * pad, W2 - 2 * pad, C


def _launch(name: str, src: torch.Tensor, pad: int, out_shape, nhwc) -> torch.Tensor:
    """One launch of ``name`` from contiguous src into a new tensor of
    ``out_shape``; ``nhwc`` the unpadded map's shape."""
    out = torch.empty(out_shape, dtype=src.dtype, device=src.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(src.device):
        err = _fn(name)(src.data_ptr(), out.data_ptr(), *nhwc, pad,
                        _build.DTYPE_CODES[src.dtype],
                        torch.cuda.current_stream(src.device).cuda_stream)
    _build.check(err, name)
    return out


@torch.library.custom_op("uncrtaints::reflect_pad", mutates_args=(), device_types="cuda")
def _k7(x: torch.Tensor, pad: int) -> torch.Tensor:
    y = _launch("uncr_reflect_pad_nhwc", x, pad, _padded(x.shape, pad), x.shape)
    reflect_pad.launches += 1
    return y


@_k7.register_kernel("cpu")
def _k7_cpu(x, pad):
    return reflect_pad_plain(x, pad)


@_k7.register_fake
def _k7_fake(x, pad):
    return x.new_empty(_padded(x.shape, pad))


@torch.library.custom_op("uncrtaints::reflect_pad_adjoint", mutates_args=(),
                         device_types="cuda")
def _k7a(g: torch.Tensor, pad: int) -> torch.Tensor:
    shape = _unpadded(g.shape, pad)
    gx = _launch("uncr_reflect_pad_adjoint_nhwc", g, pad, shape, shape)
    reflect_pad_adjoint.launches += 1
    return gx


@_k7a.register_kernel("cpu")
def _k7a_cpu(g, pad):
    return reflect_pad_adjoint_plain(g, pad)


@_k7a.register_fake
def _k7a_fake(g, pad):
    return g.new_empty(_unpadded(g.shape, pad))


def _k7_setup(ctx, inputs, output):
    ctx.pad = inputs[1]  # no tensor saved


def _k7_backward(ctx, g):
    return torch.ops.uncrtaints.reflect_pad_adjoint(g.contiguous(), ctx.pad), None


_k7.register_autograd(_k7_backward, setup_context=_k7_setup)


def _check(name: str, t: torch.Tensor, pad: int, padded: bool) -> None:
    if t.dim() != 4:
        raise ValueError(f"{name}: an NHWC map [N,H,W,C] expected, got {tuple(t.shape)}")
    if t.device.type == "cuda" and t.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"{name}: the kernel takes {list(_build.DTYPE_CODES)}, got {t.dtype}")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: the map must be contiguous")
    H, W = t.shape[1:3]
    if padded:
        H, W = H - 2 * pad, W - 2 * pad
    if not 1 <= pad < min(H, W):
        raise ValueError(f"{name}: a reflect pad of {pad} needs 1 <= pad < min(H, W) = "
                         f"{min(H, W)}")


def reflect_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    """x [N,H,W,C] (contiguous) -> [N,H+2p,W+2p,C], reflect-padded by ``pad``
    on H and W (torch's rule: ``F.pad(..., mode="reflect")``), 1 <= pad <
    min(H, W). A CUDA tensor (fp32 or bf16) launches the kernel, counted in
    ``reflect_pad.launches``; a CPU tensor runs :func:`reflect_pad_plain`.
    Differentiable: the input gradient is :func:`reflect_pad_adjoint`."""
    _check("reflect_pad", x, pad, padded=False)
    return torch.ops.uncrtaints.reflect_pad(x, pad)


def reflect_pad_adjoint(g: torch.Tensor, pad: int) -> torch.Tensor:
    """The adjoint of :func:`reflect_pad` (its input gradient): g
    [N,H+2p,W+2p,C] (contiguous) -> [N,H,W,C]. A CUDA tensor launches the
    kernel, counted in ``reflect_pad_adjoint.launches`` (also when autograd
    calls it); a CPU tensor runs :func:`reflect_pad_adjoint_plain`."""
    _check("reflect_pad_adjoint", g, pad, padded=True)
    return torch.ops.uncrtaints.reflect_pad_adjoint(g, pad)


reflect_pad.launches = 0
reflect_pad_adjoint.launches = 0
