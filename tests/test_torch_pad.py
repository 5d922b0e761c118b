"""K7, the reflect pad of an NHWC map and its adjoint (ops/pad.py), on the
CPU: the plain versions against the JAX package's ``jnp.pad`` and its VJP
and against autograd of ``F.pad``, the operators' registrations, and the
reflect-padded ``Conv2d`` that now pads through them.

Inputs of the exact comparisons are small integers, so every sum of the
adjoint is exact whatever its order: the plain gather, autograd's scatter
and XLA's transpose then agree to the bit.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from uncrtaints_tpu_torch.models import layers as tl
from uncrtaints_tpu_torch.ops import pad as tp

# (N, H, W): odd H != W; H of 3 with p = 2 gives row 1 three sources (the
# padded row itself, both mirrors); a square map
SHAPES = [(2, 5, 7), (1, 3, 6), (2, 6, 6)]
CHANNELS = [3, 15, 64, 256]


def _ints(rng, *shape):
    return rng.integers(-8, 9, size=shape).astype(np.float32)


def _jnp_pad(x, p):
    return jnp.pad(x, ((0, 0), (p, p), (p, p), (0, 0)), mode="reflect")


@pytest.mark.parametrize("p", [1, 2])
@pytest.mark.parametrize("C", CHANNELS)
@pytest.mark.parametrize("shape", SHAPES)
def test_forward_matches_jnp_pad(rng, shape, C, p):
    """The plain forward (and the operator's CPU route) is jnp.pad's reflect
    pad to the bit, fp32."""
    x = rng.standard_normal((*shape, C)).astype(np.float32)
    want = np.asarray(_jnp_pad(x, p))
    xt = torch.from_numpy(x)
    assert np.array_equal(tp.reflect_pad_plain(xt, p).numpy(), want)
    assert np.array_equal(tp.reflect_pad(xt, p).numpy(), want)


@pytest.mark.parametrize("p", [1, 2])
@pytest.mark.parametrize("C", CHANNELS)
@pytest.mark.parametrize("shape", SHAPES)
def test_adjoint_matches_autograd_and_jax_vjp(rng, shape, C, p):
    """The plain adjoint against torch's autograd of F.pad and jax.vjp of
    jnp.pad: to the bit on integer cotangents, and the operator's backward
    is the plain adjoint."""
    N, H, W = shape
    x = rng.standard_normal((N, H, W, C)).astype(np.float32)
    g = _ints(rng, N, H + 2 * p, W + 2 * p, C)
    gt = torch.from_numpy(g)
    got = tp.reflect_pad_adjoint_plain(gt, p)

    leaf = torch.from_numpy(x).requires_grad_()
    (ref,) = torch.autograd.grad(F.pad(leaf.unsqueeze(1), (0, 0, p, p, p, p),
                                       mode="reflect").squeeze(1), leaf, gt)
    _, vjp = jax.vjp(lambda a: _jnp_pad(a, p), jnp.asarray(x))
    (jref,) = vjp(jnp.asarray(g))
    assert torch.equal(got, ref)
    assert np.array_equal(got.numpy(), np.asarray(jref))

    leaf2 = torch.from_numpy(x).requires_grad_()
    (op,) = torch.autograd.grad(tp.reflect_pad(leaf2, p), leaf2, gt)
    assert torch.equal(op, got)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-6), (torch.bfloat16, 2 ** -7)])
def test_adjoint_rounds_once(rng, dtype, tol):
    """On random cotangents the plain adjoint sums in fp32 and rounds once:
    within one rounding of the float64 sum (relative to the largest)."""
    g = torch.from_numpy(rng.standard_normal((2, 9, 11, 8))).to(dtype)
    got = tp.reflect_pad_adjoint_plain(g, 2)
    exact = tp.reflect_pad_adjoint_plain(g.double(), 2)
    assert got.dtype == dtype
    assert float((got.double() - exact).abs().max()) <= tol * float(exact.abs().max())


def test_autograd_saves_no_tensor(rng):
    """Like ATen's pad, the operator's autograd keeps only the pad: the
    train step's peak cannot grow by a saved map."""
    packed = []
    x = torch.from_numpy(rng.standard_normal((1, 4, 5, 8)).astype(np.float32)).requires_grad_()
    with torch.autograd.graph.saved_tensors_hooks(lambda t: packed.append(t) or t, lambda t: t):
        y = tp.reflect_pad(x, 1)
    assert not packed
    y.sum().backward()
    assert x.grad.shape == x.shape


@pytest.mark.parametrize("op,args,grad", [
    ("reflect_pad", ((2, 5, 7, 3), 1), False), ("reflect_pad", ((1, 3, 6, 4), 2), False),
    ("reflect_pad", ((2, 5, 7, 3), 1), True), ("reflect_pad", ((1, 3, 6, 4), 2), True),
    ("reflect_pad_adjoint", ((2, 7, 9, 3), 1), False),
    ("reflect_pad_adjoint", ((1, 7, 10, 4), 2), False),
])
def test_opcheck(rng, op, args, grad):
    """torch.library.opcheck of both operators (schema, fake shapes, AOT
    dispatch; the pad's registered autograd with gradients)."""
    shape, p = args
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).requires_grad_(grad)
    torch.library.opcheck(getattr(torch.ops.uncrtaints, op).default, (x, p))


@pytest.mark.parametrize("bad", ["not contiguous", "p = H", "p = W", "p = 0", "3-D"])
def test_wrappers_refuse(bad):
    x = torch.zeros(2, 4, 6, 8)
    p = 1
    if bad == "not contiguous":
        x = x.permute(0, 2, 1, 3)
    elif bad == "p = H":
        p = 4
    elif bad == "p = W":
        x, p = torch.zeros(2, 8, 3, 8), 3
    elif bad == "p = 0":
        p = 0
    else:
        x = x[0]
    with pytest.raises(ValueError):
        tp.reflect_pad(x, p)
    g = torch.zeros(2, 6, 8, 8) if bad != "3-D" else torch.zeros(6, 8, 8)
    if bad == "not contiguous":
        g = g.permute(0, 2, 1, 3)
    elif bad == "p = H":
        g, p = torch.zeros(2, 10, 14, 8), 4  # unpadded 2 x 6
    elif bad == "p = W":
        g, p = torch.zeros(2, 14, 9, 8), 3  # unpadded 8 x 3
    with pytest.raises(ValueError):
        tp.reflect_pad_adjoint(g, p)


# (in, out, kernel, stride, pad, dilation, groups): a dense 3x3, U-TAE's
# downsampling conv (k=4, s=2, p=1), FPN's dilated 3x3 (pad 2), and the eval
# encoder's depthwise 3x3 (undifferentiated: padded, then F.conv2d)
CONVS = [(15, 16, 3, 1, 1, 1, 1), (16, 16, 4, 2, 1, 1, 1), (8, 8, 3, 1, 2, 2, 1),
         (16, 16, 3, 1, 1, 1, 16)]


def _fpad_conv(conv, x, mode):
    p = conv.pad
    xp = F.pad(x.unsqueeze(1), (0, 0, p, p, p, p), mode=mode).squeeze(1)
    y = F.conv2d(xp.permute(0, 3, 1, 2), conv.weight, conv.bias, stride=conv.stride,
                 dilation=conv.dilation, groups=conv.groups)
    return y.permute(0, 2, 3, 1)


@pytest.mark.parametrize("case", CONVS)
def test_reflect_conv2d_pads_through_k7(rng, monkeypatch, case):
    """A reflect Conv2d that K5 does not fold pads through the operator (one
    call) and gives what F.pad + F.conv2d gave, output and gradients."""
    cin, cout, k, s, p, d, groups = case
    torch.manual_seed(0)
    conv = tl.Conv2d(cin, cout, kernel=k, stride=s, pad=p, groups=groups, dilation=d)
    x = torch.from_numpy(rng.standard_normal((2, 9, 10, cin)).astype(np.float32))
    calls = []
    real = tl.reflect_pad
    monkeypatch.setattr(tl, "reflect_pad", lambda t, q: calls.append(q) or real(t, q))
    depthwise = groups > 1
    with torch.set_grad_enabled(not depthwise):
        xa = x.clone().requires_grad_(not depthwise)
        y = conv(xa)
    assert calls == [p]
    xb = x.clone().requires_grad_(not depthwise)
    ref = _fpad_conv(conv, xb, "reflect")
    assert (y - ref).abs().max() <= 1e-5 * ref.abs().max()
    if depthwise:
        return
    cot = torch.from_numpy(rng.standard_normal(y.shape).astype(np.float32))
    got = torch.autograd.grad(y, [xa, conv.weight, conv.bias], cot)
    want = torch.autograd.grad(ref, [xb, conv.weight, conv.bias], cot)
    for a, b in zip(got, want):
        assert (a - b).abs().max() <= 1e-5 * b.abs().max()


@pytest.mark.parametrize("mode", ["replicate", "circular"])
def test_other_pad_modes_keep_fpad(rng, monkeypatch, mode):
    """replicate and circular still pad with F.pad: K7 is never called."""
    conv = tl.Conv2d(4, 6, kernel=3, pad=1, padding_mode=mode)
    x = torch.from_numpy(rng.standard_normal((2, 7, 8, 4)).astype(np.float32))

    def refuse(*args):
        raise AssertionError("K7 called for a non-reflect pad")

    monkeypatch.setattr(tl, "reflect_pad", refuse)
    y = conv(x)
    assert (y - _fpad_conv(conv, x, mode)).abs().max() <= 1e-5
