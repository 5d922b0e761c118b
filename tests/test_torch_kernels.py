"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips where no CUDA device is
present. The file imports neither JAX nor the conftest (which does), so on
a GPU machine without JAX it runs as

    python -m pytest tests/test_torch_kernels.py --noconftest -m cuda
"""

import copy

import numpy as np
import pytest
import torch

from uncrtaints_tpu_torch import ops as tops


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels build and run only there)")
    return torch.device("cuda")


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _t(a, dev, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dev, dtype)


# K1's cases: the paper's width, a ragged one with 5 channels a head (the
# generic kernels), U-TAE's 4 channels a head; then T of 1, 5 and 8; 16 and
# 32 channels a head; an H*W (667) that is not a multiple of the forward's
# tile of 512 vectors; U-TAE's 64^2 level; and, as a seventh field, x as a
# contiguous view one element off the 16 bytes of a fresh allocation
K1_SHAPES = [(2, 3, 16, 16, 128, 16), (1, 2, 7, 9, 20, 4), (2, 3, 32, 32, 64, 16),
             (1, 1, 16, 16, 128, 16), (1, 5, 8, 8, 128, 16), (1, 8, 8, 8, 64, 16),
             (2, 3, 8, 8, 128, 8), (2, 3, 8, 8, 128, 4), (1, 3, 23, 29, 128, 16),
             (4, 3, 64, 64, 64, 16), (2, 3, 16, 16, 128, 16, 1)]


def _k1_inputs(rng, dev, dtype, shape):
    """x [B,T,H,W,C] (at an element offset where the shape names one), attn
    [B,T,H,W,heads] and an output gradient [B,H,W,C]."""
    B, T, H, W, C, heads, *offset = shape
    x = _t(rng.standard_normal((B, T, H, W, C)), dev, dtype)
    if offset:
        buf = torch.empty(x.numel() + offset[0], dtype=dtype, device=dev)
        x = buf[offset[0]:].view(x.shape).copy_(x)
        assert x.is_contiguous() and x.data_ptr() % 16
    a = _t(rng.random((B, T, H, W, heads)), dev, dtype)
    return x, a, _t(rng.standard_normal((B, H, W, C)), dev, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", K1_SHAPES)
def test_att_group_kernel_matches_plain(cuda, rng, dtype, shape):
    x, a, _ = _k1_inputs(rng, cuda, dtype, shape)
    n = tops.att_group_aggregate.launches
    got = tops.att_group_aggregate(x, a)
    torch.cuda.synchronize()
    assert tops.att_group_aggregate.launches == n + 1
    ref = tops.att_group_aggregate_plain(x, a)
    # fp32: the same products summed in the same order; bf16: the final
    # rounding may differ by one ulp at the top of the range
    tol = 1e-6 if dtype == torch.float32 else 2 ** -7
    assert (got.float() - ref.float()).abs().max() <= tol * max(1.0, ref.float().abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("xdtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(2, 256, 128, 256, 4), (3, 128, 96, 80, 4)])
def test_norm_gelu_matmul_kernel_matches_plain(cuda, rng, shape, xdtype):
    N, P, C, C2, G = shape
    x = _t(rng.standard_normal((N, P, C)), cuda, xdtype)
    w = _t(rng.standard_normal((C, C2)) * 0.05, cuda, torch.bfloat16)
    f = lambda *s: _t(rng.standard_normal(s), cuda)
    args = (x, f(N, G), f(N, G).abs() + 0.5, f(C), f(C), w)
    kw = dict(se=f(N, C).sigmoid(), groups_in=G, groups_out=G, do_gelu=True,
              out_affine=(f(C2), f(C2)), out_gelu=True, do_stats=True)
    n = tops.norm_gelu_matmul.launches
    got = tops.norm_gelu_matmul(*args, **kw)
    torch.cuda.synchronize()
    assert tops.norm_gelu_matmul.launches == n + 1
    ref = tops.norm_gelu_matmul_plain(*args, **kw)
    assert got[0].dtype == xdtype
    # one bf16 ulp at the top of the range (fp32 output: the same bf16 GEMM
    # operands, sums in another order)
    tol = 2 ** -7 if xdtype == torch.bfloat16 else 1e-4
    assert (got[0].float() - ref[0].float()).abs().max() <= tol * ref[0].float().abs().max()
    torch.testing.assert_close(got[2], ref[2], rtol=1e-4, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("stats", [False, True])
@pytest.mark.parametrize("se,out_gelu", [(False, False), (True, False), (False, True)])
@pytest.mark.parametrize("C,C2,G", [(128, 256, 1), (256, 128, 1), (128, 128, 4), (256, 128, 8)])
def test_norm_gelu_matmul_wgmma_kernel_matches_plain(cuda, rng, C, C2, G, se, out_gelu, stats):
    """The decoder widths in bf16 run the pipelined wgmma kernel (its own
    counter says so); tolerance as for the tiled kernel: one bf16 ulp of the
    largest output, statistics 1e-4 relative. 3 frames of 384 rows: a
    warpgroup's 64-row tiles cross frames, the last block has one tile."""
    N, P = 3, 384
    x = _t(rng.standard_normal((N, P, C)), cuda, torch.bfloat16)
    w = _t(rng.standard_normal((C, C2)) * 0.05, cuda, torch.bfloat16)
    f = lambda *s: _t(rng.standard_normal(s), cuda)
    args = (x, f(N, G), f(N, G).abs() + 0.5, f(C), f(C), w)
    kw = dict(se=f(N, C).sigmoid() if se else None, groups_in=G, groups_out=G, do_gelu=se,
              out_affine=(f(C2), f(C2)) if se or out_gelu else None, out_gelu=out_gelu,
              do_stats=stats)
    n, nw = tops.norm_gelu_matmul.launches, tops.norm_gelu_matmul.wgmma_launches
    got = tops.norm_gelu_matmul(*args, **kw)
    torch.cuda.synchronize()
    assert tops.norm_gelu_matmul.launches == n + 1
    assert tops.norm_gelu_matmul.wgmma_launches == nw + 1
    ref = tops.norm_gelu_matmul_plain(*args, **kw)
    assert got[0].dtype == torch.bfloat16 and got[0].shape == (N, P, C2)
    assert (got[0].float() - ref[0].float()).abs().max() <= 2 ** -7 * ref[0].float().abs().max()
    if stats:
        abs_sum = ref[0].float().abs().view(N, P, G, C2 // G).sum(dim=(1, 3))
        assert ((got[1] - ref[1]).abs() <= 1e-4 * abs_sum).all()
        torch.testing.assert_close(got[2], ref[2], rtol=1e-4, atol=1e-3)
        again = tops.norm_gelu_matmul(*args, **kw)
        assert all(torch.equal(a, b) for a, b in zip(got, again))  # no atomics
    else:
        assert not got[1].any() and not got[2].any()


@pytest.mark.cuda
@pytest.mark.parametrize("shape,xdtype", [((3, 128, 96, 80, 4), torch.bfloat16),
                                          ((2, 256, 128, 256, 4), torch.float32),
                                          ((2, 128, 256, 256, 4), torch.bfloat16),
                                          ((2, 128, 128, 128, 32), torch.bfloat16)])
def test_norm_gelu_matmul_other_shapes_keep_the_tiled_kernel(cuda, rng, shape, xdtype):
    """Widths outside {128, 256}, fp32 x, 256 -> 256 (weight and ring do not
    fit in shared memory) and input groups narrower than 8 channels run the
    tiled WMMA kernel: the wgmma counter stays."""
    N, P, C, C2, G = shape
    x = _t(rng.standard_normal((N, P, C)), cuda, xdtype)
    w = _t(rng.standard_normal((C, C2)) * 0.05, cuda, torch.bfloat16)
    f = lambda *s: _t(rng.standard_normal(s), cuda)
    args = (x, f(N, G), f(N, G).abs() + 0.5, f(C), f(C), w)
    n, nw = tops.norm_gelu_matmul.launches, tops.norm_gelu_matmul.wgmma_launches
    got = tops.norm_gelu_matmul(*args, groups_in=G, groups_out=4)
    torch.cuda.synchronize()
    assert tops.norm_gelu_matmul.launches == n + 1
    assert tops.norm_gelu_matmul.wgmma_launches == nw
    ref = tops.norm_gelu_matmul_plain(*args, groups_in=G, groups_out=4)
    tol = 2 ** -7 if xdtype == torch.bfloat16 else 1e-4
    assert (got[0].float() - ref[0].float()).abs().max() <= tol * ref[0].float().abs().max()
    torch.testing.assert_close(got[2], ref[2], rtol=1e-4, atol=1e-3)


@pytest.mark.cuda
def test_norm_gelu_matmul_kernel_rejects_ragged_rows(cuda):
    x = torch.zeros(2, 100, 32, device=cuda, dtype=torch.bfloat16)
    w = torch.zeros(32, 16, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="P % 128"):
        tops.norm_gelu_matmul(x, torch.zeros(2, 4, device=cuda), torch.ones(2, 4, device=cuda),
                              torch.ones(32, device=cuda), torch.zeros(32, device=cuda), w)


def _ulp_bf16(ref: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at each element of ref (fp32 tensor of bf16 values)."""
    e = torch.floor(torch.log2(ref.abs().clamp_min(torch.finfo(torch.float32).tiny)))
    return torch.exp2(e - 7)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", K1_SHAPES)
def test_att_group_autograd_on_card(cuda, rng, dtype, shape):
    """att_group_aggregate on the card is differentiable: x.grad and a.grad
    exist and match the plain version's autograd gradients, taken in fp32
    from the same values (bf16: the kernels sum in fp32 and round once, the
    plain version's bf16 autograd would round every product)."""
    x, a, cot = _k1_inputs(rng, cuda, dtype, shape)
    x, a = x.requires_grad_(), a.requires_grad_()
    n_f, n_b = tops.att_group_aggregate.launches, tops.att_group_aggregate_bwd.launches
    (tops.att_group_aggregate(x, a) * cot).float().sum().backward()
    torch.cuda.synchronize()
    assert tops.att_group_aggregate.launches == n_f + 1
    assert tops.att_group_aggregate_bwd.launches == n_b + 1
    assert x.grad is not None and a.grad is not None
    xp = x.detach().float().requires_grad_()
    ap = a.detach().float().requires_grad_()
    (tops.att_group_aggregate_plain(xp, ap) * cot.float()).sum().backward()
    if dtype == torch.float32:
        assert torch.equal(x.grad, xp.grad)  # the same product
        # a head's sum of C/heads products in another order
        assert (a.grad - ap.grad).abs().max() <= 1e-6 * ap.grad.abs().max()
    else:  # one rounding of the fp32 value: within one bf16 ulp
        assert ((x.grad.float() - xp.grad).abs() <= _ulp_bf16(xp.grad)).all()
        assert ((a.grad.float() - ap.grad).abs() <= _ulp_bf16(ap.grad)).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", K1_SHAPES)
def test_att_group_bwd_kernel_matches_plain(cuda, rng, dtype, shape):
    x, a, g = _k1_inputs(rng, cuda, dtype, shape)
    n = tops.att_group_aggregate_bwd.launches
    dx, da = tops.att_group_aggregate_bwd(x, a, g)
    torch.cuda.synchronize()
    assert tops.att_group_aggregate_bwd.launches == n + 1
    rdx, rda = tops.att_group_aggregate_bwd_plain(x, a, g)
    assert torch.equal(dx, rdx)
    tol = 1e-6 * rda.float().abs().max() if dtype == torch.float32 else _ulp_bf16(rda.float())
    assert ((da.float() - rda.float()).abs() <= tol).all()


def _stencil_close(got, ref, dtype):
    """K5 against its plain version: the same fp32 taps summed in another
    order with one fused multiply-add each, then one rounding. The fp32
    sums differ by at most 1e-6 of the largest output (far more than an
    output's own ulp where its taps cancel); bf16 adds one ulp of each output
    for the rounding."""
    assert got.dtype == dtype and got.shape == ref.shape
    got, ref = got.float(), ref.float()
    tol = 1e-6 * ref.abs().max()
    if dtype == torch.bfloat16:
        tol = tol + _ulp_bf16(ref)
    assert ((got - ref).abs() <= tol).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C", [256, 20])
@pytest.mark.parametrize("k,pads", [((3, 3), ((0, 0), (0, 0))), ((3, 3), ((1, 1), (1, 1))),
                                    ((3, 3), ((2, 2), (2, 2))), ((1, 3), ((0, 0), (0, 0))),
                                    ((3, 1), ((1, 1), (0, 0)))])
def test_dw_stencil_kernel_matches_plain(cuda, rng, dtype, C, k, pads):
    kh, kw = k
    x = _t(rng.standard_normal((2, 37, 70, C)), cuda, dtype)
    w = _t(rng.standard_normal((C, 1, kh, kw)), cuda, dtype)
    n = tops.dw_stencil.launches
    got = tops.dw_stencil(x, w, pads)
    torch.cuda.synchronize()
    assert tops.dw_stencil.launches == n + 1
    ref = tops.dw_stencil_plain(x, w, pads)
    if (kh, kw) == (3, 3) and C % (8 if dtype == torch.bfloat16 else 4) == 0:
        # 16-byte channel vectors: the tiled kernel (fmaf, dx-major)
        _stencil_close(got, ref, dtype)
    else:  # the direct kernel keeps the plain version's roundings exactly
        assert torch.equal(got, ref)


ONE = ((1, 1), (1, 1))
# aligned and ragged channel counts (the tiled and the direct kernel), odd
# sizes, ragged column strips and row bands, and the border-only sizes where
# every pixel folds: H or W of 2 and 3
REFLECT_SHAPES = [(2, 37, 70, 256), (2, 37, 70, 20), (3, 16, 33, 72), (1, 2, 2, 8),
                  (2, 3, 3, 16), (2, 2, 9, 12), (1, 5, 2, 64), (2, 3, 40, 6)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", REFLECT_SHAPES)
def test_dw_stencil_reflect_kernel_matches_plain(cuda, rng, dtype, shape):
    N, H, W, C = shape
    x = _t(rng.standard_normal(shape), cuda, dtype)
    w = _t(rng.standard_normal((C, 1, 3, 3)), cuda, dtype)
    n = tops.dw_stencil.launches
    got = tops.dw_stencil(x, w, ONE, "reflect")
    torch.cuda.synchronize()
    assert tops.dw_stencil.launches == n + 1
    _stencil_close(got, tops.dw_stencil_plain(x, w, ONE, "reflect"), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", REFLECT_SHAPES)
def test_dw_stencil_reflect_adjoint_kernel_matches_plain(cuda, rng, dtype, shape):
    N, H, W, C = shape
    g = _t(rng.standard_normal(shape), cuda, dtype)
    w = _t(rng.standard_normal((C, 1, 3, 3)), cuda, dtype)
    n = tops.dw_stencil.launches
    got = tops.dw_stencil_reflect_adjoint(g, w)
    torch.cuda.synchronize()
    assert tops.dw_stencil.launches == n + 1  # the adjoint counts as K5
    _stencil_close(got, tops.dw_stencil_reflect_adjoint_plain(g, w), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", REFLECT_SHAPES)
def test_dw_kernel_grad_reflect_kernel_matches_plain(cuda, rng, dtype, shape):
    N, H, W, C = shape
    x = _t(rng.standard_normal(shape), cuda, dtype)
    g = _t(rng.standard_normal(shape), cuda, dtype)
    n = tops.dw_kernel_grad.launches
    got = tops.dw_kernel_grad(x, g, ONE, 3, 3, "reflect")
    torch.cuda.synchronize()
    assert tops.dw_kernel_grad.launches == n + 1
    ref = tops.dw_kernel_grad_plain(x, g, ONE, 3, 3, "reflect")
    scale = tops.dw_kernel_grad_plain(x.abs(), g.abs(), ONE, 3, 3, "reflect")
    # fp32 sums of N*H*W products in another order: relative to sum |x*g|
    assert ((got - ref).abs() / scale).max() <= 1e-5
    assert torch.equal(got, tops.dw_kernel_grad(x, g, ONE, 3, 3, "reflect"))  # deterministic


@pytest.mark.cuda
def test_dw_reflect_kernels_reject_bad_input(cuda):
    """On the card too: reflect mode takes 3x3 on a map of at least 2x2."""
    w = torch.zeros(8, 1, 3, 3, device=cuda)
    bad = torch.zeros(1, 1, 6, 8, device=cuda)
    with pytest.raises(ValueError, match="H, W >= 2"):
        tops.dw_stencil(bad, w, ONE, "reflect")
    with pytest.raises(ValueError, match="H, W >= 2"):
        tops.dw_stencil_reflect_adjoint(bad, w)
    with pytest.raises(ValueError, match="3x3"):
        tops.dw_kernel_grad(torch.zeros(1, 6, 6, 8, device=cuda),
                            torch.zeros(1, 6, 6, 8, device=cuda), ((1, 1), (0, 0)), 3, 1,
                            "reflect")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C", [256, 20])
@pytest.mark.parametrize("k,pads", [((3, 3), ((0, 0), (0, 0))), ((3, 3), ((1, 1), (1, 1))),
                                    ((1, 3), ((0, 0), (0, 0))), ((3, 1), ((0, 0), (0, 0)))])
def test_dw_kernel_grad_kernel_matches_plain(cuda, rng, dtype, C, k, pads):
    kh, kw = k
    (pt, pb), (pl, pr) = pads
    N, H, W = 3, 37, 70
    Ho, Wo = H + pt + pb - kh + 1, W + pl + pr - kw + 1
    x = _t(rng.standard_normal((N, H, W, C)), cuda, dtype)
    g = _t(rng.standard_normal((N, Ho, Wo, C)), cuda, dtype)
    n = tops.dw_kernel_grad.launches
    got = tops.dw_kernel_grad(x, g, pads, kh, kw)
    torch.cuda.synchronize()
    assert tops.dw_kernel_grad.launches == n + 1
    ref = tops.dw_kernel_grad_plain(x, g, pads, kh, kw)
    scale = tops.dw_kernel_grad_plain(x.abs(), g.abs(), pads, kh, kw)
    # fp32 sums of N*Ho*Wo products in another order: relative to sum |x*g|
    assert ((got - ref).abs() / scale).max() <= 1e-5
    assert torch.equal(got, tops.dw_kernel_grad(x, g, pads, kh, kw))  # deterministic


@pytest.mark.cuda
@pytest.mark.parametrize("mode,hw", [("zeros", (18, 20)), ("reflect", (18, 20)),
                                     ("reflect", (3, 5)), ("reflect", (2, 2))])
def test_depthwise_function_on_card_matches_cpu(cuda, rng, mode, hw):
    """The K5 operator with its backward (K5 forward, K5 input gradient or
    folded adjoint, K2 weight gradient) on the card against the same
    operator on the CPU (the kernels' plain versions), fp32."""
    pads = ONE if mode == "reflect" else ((0, 0), (0, 0))
    H, W = hw
    x = rng.standard_normal((2, H, W, 64)).astype(np.float32)
    w = rng.standard_normal((64, 1, 3, 3)).astype(np.float32)
    cot = rng.standard_normal((2, H + 2 * pads[0][0] - 2, W + 2 * pads[0][0] - 2, 64)).astype(
        np.float32)
    out = {}
    for dev in (torch.device("cpu"), cuda):
        tx, tw = _t(x, dev).requires_grad_(), _t(w, dev).requires_grad_()
        n5, n2 = tops.dw_stencil.launches, tops.dw_kernel_grad.launches
        y = tops.dw_stencil(tx, tw, pads, mode)
        (y * _t(cot, dev)).sum().backward()
        launched = (tops.dw_stencil.launches - n5, tops.dw_kernel_grad.launches - n2)
        assert launched == ((2, 1) if dev.type == "cuda" else (0, 0))
        out[dev.type] = [t.detach().cpu() for t in (y, tx.grad, tw.grad)]
    for got, ref in zip(out["cuda"], out["cpu"]):
        assert (got - ref).abs().max() <= 1e-5 * ref.abs().max()


@pytest.mark.cuda
def test_reflect_conv2d_on_card_does_not_pad(cuda, rng):
    """The differentiated reflect depthwise Conv2d on the card: one K5
    forward, one K5 adjoint and one K2, the gradients of the explicit pad +
    F.conv2d route, and no pad node in its graph."""
    import torch.nn.functional as F
    from uncrtaints_tpu_torch.models.layers import Conv2d
    torch.backends.cudnn.allow_tf32 = False
    tm = Conv2d(32, 32, kernel=3, pad=1, groups=32, bias=True).to(cuda)
    x = _t(rng.standard_normal((2, 9, 11, 32)), cuda).requires_grad_()
    cot = _t(rng.standard_normal((2, 9, 11, 32)), cuda)
    n5, n2 = tops.dw_stencil.launches, tops.dw_kernel_grad.launches
    y = tm(x)
    (y * cot).sum().backward()
    assert (tops.dw_stencil.launches - n5, tops.dw_kernel_grad.launches - n2) == (2, 1)
    x2 = x.detach().clone().requires_grad_()
    w2 = tm.weight.detach().clone().requires_grad_()
    xp = F.pad(x2.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect")
    y2 = F.conv2d(xp, w2, tm.bias.detach(), groups=32).permute(0, 2, 3, 1)
    (y2 * cot).sum().backward()
    for got, ref in ((y, y2), (x.grad, x2.grad), (tm.weight.grad, w2.grad)):
        assert (got - ref).abs().max() <= 1e-5 * ref.abs().max()


@pytest.mark.cuda
def test_norm_gelu_matmul_kernel_refuses_grad(cuda):
    """K3 has no backward: with grad enabled and an input that requires
    grad it raises instead of returning a detached result."""
    x = torch.randn(2, 128, 32, device=cuda, dtype=torch.bfloat16, requires_grad=True)
    w = torch.randn(32, 16, device=cuda).bfloat16()
    args = (x, torch.zeros(2, 4, device=cuda), torch.ones(2, 4, device=cuda),
            torch.ones(32, device=cuda), torch.zeros(32, device=cuda), w)
    with pytest.raises(RuntimeError, match="no backward"):
        tops.norm_gelu_matmul(*args)
    with torch.no_grad():
        out, _, _ = tops.norm_gelu_matmul(*args)
    assert out.shape == (2, 128, 16) and out.grad_fn is None


def _k4_args(rng, dev, N, H, W, C, G, dtype):
    x = _t(rng.standard_normal((N, H, W, C)), dev, dtype)
    if G == 1:  # the batch-norm form: a plain per-channel affine
        mean, coef = torch.zeros(N, 1, device=dev), torch.ones(N, 1, device=dev)
    else:
        xg = x.float().view(N, H * W, G, C // G)
        mean = xg.mean(dim=(1, 3))
        coef = torch.rsqrt(xg.var(dim=(1, 3), correction=0) + 1e-5)
    f = lambda *s: _t(rng.standard_normal(s), dev)
    return x, mean, coef, f(C), f(C), f(3, 3, C) * 0.3


@pytest.mark.cuda
@pytest.mark.parametrize("stats,pool", [(True, False), (False, True), (True, True),
                                        (False, False)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [
    (2, 32, 64, 256, 1),   # the decoder's width, the batch-norm form
    (2, 32, 64, 256, 4),   # group statistics in and out
    (3, 37, 70, 24, 3),    # ragged: an odd height, a column strip of 6, a part channel tile
    (1, 2, 2, 8, 1),       # the smallest map: every tap reflects
    (2, 5, 130, 16, 2),    # five column strips, the last of 2
])
def test_norm_gelu_dwconv_kernel_matches_plain(cuda, rng, shape, dtype, stats, pool):
    N, H, W, C, G = shape
    args = _k4_args(rng, cuda, N, H, W, C, G, dtype)
    f = lambda *s: _t(rng.standard_normal(s), cuda)
    kw = dict(groups_in=G, groups_out=G, do_stats=stats,
              pool_affine=(f(C), f(C)) if pool else None)
    n = tops.norm_gelu_dwconv3x3.launches
    got = tops.norm_gelu_dwconv3x3(*args, **kw)
    torch.cuda.synchronize()
    assert tops.norm_gelu_dwconv3x3.launches == n + 1
    ref = tops.norm_gelu_dwconv3x3_plain(*args, **kw)
    assert len(got) == len(ref) == (4 if pool else 3)
    assert got[0].dtype == dtype and got[0].shape == (N, H, W, C)
    # one fused multiply-add per tap against the plain version's product
    # and sum rounded apart, then the cast: one bf16 ulp of the largest
    # output, or 1e-5 of it in fp32
    top = ref[0].float().abs().max()
    tol = (2 ** -7 if dtype == torch.bfloat16 else 1e-5) * top
    assert (got[0].float() - ref[0].float()).abs().max() <= tol
    if stats:
        # fp32 sums in another order: 1e-5 of the sum of magnitudes
        abs_sum = ref[0].float().abs().view(N, H * W, G, C // G).sum(dim=(1, 3))
        assert ((got[1] - ref[1]).abs() <= 1e-5 * abs_sum).all()
        assert ((got[2] - ref[2]).abs() <= 1e-5 * ref[2]).all()
    else:
        assert not got[1].any() and not got[2].any()
    if pool:
        # the pooled sum of the kernel's own rounded output: 1e-5 of sum|gelu|
        act = torch.nn.functional.gelu(got[0].float() * kw["pool_affine"][0]
                                       + kw["pool_affine"][1])
        assert got[3].dtype == torch.float32 and got[3].shape == (N, C)
        assert ((got[3] - act.sum(dim=(1, 2))).abs() <= 1e-5 * act.abs().sum(dim=(1, 2))).all()
    again = tops.norm_gelu_dwconv3x3(*args, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, again))  # no atomics


@pytest.mark.cuda
def test_norm_gelu_dwconv_kernel_rejects_unaligned_channels(cuda, rng):
    """16-byte channel vectors: C % 8 in bf16, C % 4 in fp32; never a
    fallback."""
    for C, dtype in ((12, torch.bfloat16), (6, torch.float32)):
        args = _k4_args(rng, cuda, 1, 4, 4, C, 1, dtype)
        with pytest.raises(ValueError, match="16-byte"):
            tops.norm_gelu_dwconv3x3(*args, groups_in=1, groups_out=1)
    args = _k4_args(rng, cuda, 1, 4, 4, 12, 1, torch.float32)
    out, _, _ = tops.norm_gelu_dwconv3x3(*args, groups_in=1, groups_out=1)
    assert out.shape == (1, 4, 4, 12)


@pytest.mark.cuda
def test_norm_gelu_dwconv_kernel_refuses_grad(cuda, rng):
    """K4 has no backward: with grad enabled and an input that requires
    grad it raises instead of returning a detached result."""
    args = list(_k4_args(rng, cuda, 1, 4, 4, 16, 1, torch.bfloat16))
    args[0].requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        tops.norm_gelu_dwconv3x3(*args, groups_in=1, groups_out=1)
    with torch.no_grad():
        out, _, _ = tops.norm_gelu_dwconv3x3(*args, groups_in=1, groups_out=1)
    assert out.shape == (1, 4, 4, 16) and out.grad_fn is None


@pytest.mark.cuda
@pytest.mark.parametrize("norm", ["batch", "group"])
def test_fused_mbconv_chain_on_card(cuda, rng, norm):
    """The eval MBConv on the card runs K3, K4, K3 and stays within the
    fused-vs-standard gate of its own standard body. With group norms (the
    group chain) also one statistics pass, one pooled-sum pass and one
    apply, no K7 and no K6 norm of its own; two calls bit-equal."""
    from uncrtaints_tpu_torch.models.blocks import MBConv
    from uncrtaints_tpu_torch.models.layers import Norm2d, init_weights
    from uncrtaints_tpu_torch.ops import norm as tn
    tm = MBConv(128, 128, expansion=2, norm=norm).eval()
    init_weights(tm, torch.Generator().manual_seed(0))
    for b in tm.buffers():
        b.copy_(_t(np.abs(rng.standard_normal(b.shape) * 0.3) + 0.5, "cpu"))
    with torch.no_grad():
        for m in tm.modules():
            if isinstance(m, Norm2d) and m.norm == "group":
                m.weight.copy_(_t(1.0 + 0.3 * rng.standard_normal(m.weight.shape), "cpu"))
                m.bias.copy_(_t(0.3 * rng.standard_normal(m.bias.shape), "cpu"))
    tm = tm.to(cuda)
    for p in tm.parameters():
        p.data = p.data.bfloat16()
    x = _t(rng.standard_normal((2, 3, 16, 16, 128)), cuda, torch.bfloat16)
    passes = (tn.norm_stats, tn.norm_gelu_pool, tn.norm_apply, tn.norm_act, tops.reflect_pad)
    with torch.inference_mode():
        y0 = tm(x).float()
        tm.fused_eval = True
        n3, n4 = tops.norm_gelu_matmul.launches, tops.norm_gelu_dwconv3x3.launches
        nw = tops.norm_gelu_matmul.wgmma_launches
        before = [f.launches for f in passes]
        y1 = tm(x).float()
        after = [f.launches for f in passes]
        again = tm(x).float()
    assert tops.norm_gelu_matmul.launches == n3 + 4
    assert tops.norm_gelu_matmul.wgmma_launches == nw + 4  # both GEMMs pipelined
    assert tops.norm_gelu_dwconv3x3.launches == n4 + 2
    chain = 1 if norm == "group" else 0
    assert [b - a for a, b in zip(before, after)] == [chain, chain, chain, 0, 0]
    assert torch.equal(y1, again)
    d = (y0 - y1).abs()
    assert d.max() <= 0.02 * y0.abs().max()
    assert d.square().mean().sqrt() <= 5e-3 * y0.abs().max()


# the pooled-sum pass: the path's C of 256 (16-byte vectors, groups of 64
# channels), fp32, groups that split a vector (C=24 in 4 groups of 6) and the
# scalar path (C=20); (N, H, W, C, G, dtype)
POOL_CASES = [(6, 64, 64, 256, 4, torch.bfloat16), (3, 16, 16, 128, 4, torch.float32),
              (2, 5, 7, 24, 4, torch.bfloat16), (2, 9, 11, 20, 2, torch.bfloat16)]


@pytest.mark.cuda
@pytest.mark.parametrize("N,H,W,C,G,dtype", POOL_CASES)
def test_norm_gelu_pool_kernel_matches_twin(cuda, N, H, W, C, G, dtype):
    """The group chain's pooled-sum pass against its twin on the same
    inputs: within 1e-5 of the sum of |terms| (the same fp32 terms summed in
    another order); two calls bit-equal (no atomics); one launch a call."""
    from uncrtaints_tpu_torch.ops import norm as tn
    g = torch.Generator(device=cuda).manual_seed(0)
    rand = lambda *s: torch.randn(*s, generator=g, device=cuda)
    x = (rand(N, H, W, C) * 1.5 + 0.5).to(dtype)
    mean, rstd = rand(N, G) * 0.3 + 0.5, rand(N, G).abs() + 0.5
    scale, bias = rand(C) * 0.3 + 1.0, rand(C) * 0.3
    n0 = tn.norm_gelu_pool.launches
    got = tn.norm_gelu_pool(x, mean, rstd, scale, bias)
    again = tn.norm_gelu_pool(x, mean, rstd, scale, bias)
    assert tn.norm_gelu_pool.launches == n0 + 2
    assert got.shape == (N, C) and got.dtype == torch.float32 and torch.equal(got, again)
    x3 = x.view(N, H * W, C)
    ref = tn.gelu_pool_twin(x3, mean, rstd, scale, bias)
    m = mean.repeat_interleave(C // G, -1)[:, None, :]
    r = rstd.repeat_interleave(C // G, -1)[:, None, :]
    terms = torch.nn.functional.gelu((x3.float() - m) * r * scale + bias).abs().sum(dim=1)
    assert float(((got - ref).abs() / terms.clamp_min(1e-30)).max()) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_group_chain_passes_on_card(cuda, rng, dtype):
    """The group chain's statistics pass (K6's, within 1e-5 of the sum of
    |terms| of its twin) and its apply (bit-equal to the twin on the same
    coef and off) at [6,64,64,128], each one launch."""
    from uncrtaints_tpu_torch.ops import norm as tn
    x = _t(rng.standard_normal((6, 64, 64, 128)) * 1.5 + 0.5, cuda, dtype)
    w = _t(1.0 + 0.3 * rng.standard_normal(128), cuda, dtype)
    b = _t(0.3 * rng.standard_normal(128), cuda, dtype)
    n0, a0 = tn.norm_stats.launches, tn.norm_apply.launches
    sums = tn.norm_stats(x, 4)
    ref = tn.stats_twin(x.view(6, -1, 128), 4)
    scale = torch.stack([x.float().abs().view(6, -1, 4, 32).sum(dim=(1, 3)),
                         x.float().square().view(6, -1, 4, 32).sum(dim=(1, 3))])
    assert float(((sums - ref).abs() / scale).max()) <= 1e-5
    coef, off = tn.group_affine(*tn.group_moments(sums, 64 * 64 * 32), w, b, dtype)
    y = tn.norm_apply(x, coef, off)
    assert torch.equal(y, tn.apply_twin(x.view(6, -1, 128), coef, off, 0, 0).view(x.shape))
    assert (tn.norm_stats.launches, tn.norm_apply.launches) == (n0 + 1, a0 + 1)


# ------------------------------------------------------------ halo modes --
# a map split into bands of rows, each with its neighbours' edge rows: every
# band against the plain halo version, and the bands stitched against the
# whole-tensor kernel (the tiled kernels at C % 8 == 0, the direct ones at 20)

HALO_SHAPES = [(2, 8, 37, 16), (3, 12, 9, 20), (2, 8, 34, 64)]


def _bands(x, n):
    rows = x.shape[1] // n
    return [x[:, i * rows:(i + 1) * rows].contiguous() for i in range(n)]


def _halos(bands):
    n = len(bands)
    return [(bands[i - 1][:, -1:].contiguous() if i > 0 else None,
             bands[i + 1][:, :1].contiguous() if i < n - 1 else None) for i in range(n)]


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 4])  # 4 bands of 8 rows: bands of exactly 2 rows
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", HALO_SHAPES)
def test_dw_halo_kernels_match_plain_and_stitch(cuda, rng, shape, dtype, n):
    from uncrtaints_tpu_torch.ops import dwconv, dwgrad
    N, H, W, C = shape
    ONE = ((1, 1), (1, 1))
    x = _t(rng.standard_normal(shape), cuda, dtype)
    g = _t(rng.standard_normal(shape), cuda, dtype)
    w = _t(rng.standard_normal((C, 1, 3, 3)) * 0.3, cuda, dtype)
    tol = 1e-6 if dtype == torch.float32 else 2 ** -7
    xb, gb = _bands(x, n), _bands(g, n)
    hb = _halos(xb)
    k = tops.dw_stencil.halo_launches
    fwd = [dwconv.dw_stencil(b, w, ONE, "reflect", halo=h) for b, h in zip(xb, hb)]
    adj = [dwconv.dw_stencil_reflect_adjoint(b, w, halo=(i > 0, i < n - 1))
           for i, b in enumerate(gb)]
    gws = [dwgrad.dw_kernel_grad(b, gg, ONE, 3, 3, "reflect", halo=h)
           for b, gg, h in zip(xb, gb, hb)]
    torch.cuda.synchronize()
    assert tops.dw_stencil.halo_launches == k + 2 * n
    scale = dwgrad.dw_kernel_grad_plain(x.abs(), g.abs(), ONE, 3, 3, "reflect")
    for i in range(n):
        ref = dwconv.dw_stencil_halo_plain(xb[i], w, *hb[i])
        assert (fwd[i].float() - ref.float()).abs().max() <= tol * ref.float().abs().max()
        for got, want in zip(adj[i], dwconv.dw_stencil_halo_adjoint_plain(
                gb[i], w, i > 0, i < n - 1)):
            if got is not None:
                assert (got.float() - want.float()).abs().max() <= tol * want.float().abs().max()
        want = dwgrad.dw_kernel_grad_halo_plain(xb[i], gb[i], *hb[i])
        assert ((gws[i] - want).abs() / scale).max() <= 1e-4
    whole = dwconv.dw_stencil(x, w, ONE, "reflect")
    assert torch.equal(torch.cat(fwd, 1), whole)
    rows = H // n
    gx = torch.cat([a[0] for a in adj], 1).float()
    for i, (_, gt, gbot) in enumerate(adj):
        if gt is not None:
            gx[:, i * rows - 1] += gt[:, 0].float()
        if gbot is not None:
            gx[:, (i + 1) * rows] += gbot[:, 0].float()
    wgx = dwconv.dw_stencil_reflect_adjoint(g, w).float()
    assert (gx - wgx).abs().max() <= 2 * tol * wgx.abs().max()
    wgw = dwgrad.dw_kernel_grad(x, g, ONE, 3, 3, "reflect")
    assert ((sum(gws) - wgw).abs() / scale).max() <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 8, 37, 16), (2, 8, 34, 64)])
def test_norm_gelu_dwconv_halo_kernel_matches_plain_and_stitches(cuda, rng, shape, dtype, n):
    N, H, W, C = shape
    f = lambda *s: _t(rng.standard_normal(s), cuda)
    x = _t(rng.standard_normal(shape), cuda, dtype)
    args = (f(N, 4), f(N, 4).abs() + 0.5, f(C), f(C), f(3, 3, C) * 0.3)
    kw = dict(groups_in=4, groups_out=4, pool_affine=(f(C), f(C)))
    tol = 1e-5 if dtype == torch.float32 else 2 ** -7
    xb = _bands(x, n)
    k = tops.norm_gelu_dwconv3x3.halo_launches
    parts = [tops.norm_gelu_dwconv3x3(b, *args, halo=h, **kw) for b, h in zip(xb, _halos(xb))]
    torch.cuda.synchronize()
    assert tops.norm_gelu_dwconv3x3.halo_launches == k + n
    for b, h, p in zip(xb, _halos(xb), parts):
        ref = tops.norm_gelu_dwconv3x3_plain(b, *args, halo=h, **kw)
        assert (p[0].float() - ref[0].float()).abs().max() <= tol * ref[0].float().abs().max()
    whole = tops.norm_gelu_dwconv3x3(x, *args, **kw)
    assert torch.equal(torch.cat([p[0] for p in parts], 1), whole[0])
    for j in (1, 2, 3):
        tot = sum(p[j] for p in parts)
        assert ((tot - whole[j]).abs() / whole[j].abs().clamp(min=1.0)).max() <= 1e-5


# K6 (ops/norm.py, csrc/norm.cu): the norms with their activation. Cases:
# (norm, shape [N,H,W,C], groups, activation, dtype): 16-byte vectors (bf16
# C % 8, fp32 C % 4) and the scalar path (C = 20 in bf16, 10 in fp32), two
# channel slabs (4096 bf16 channels), instance norm's (x - m) * r form, and
# UNet3D's batch norm ([B,T,H,W,C], the affine in fp32) with its LeakyReLU
K6_CASES = [("group", (2, 16, 16, 128), 4, "gelu", torch.bfloat16),
            ("group", (3, 8, 8, 64), 4, "relu", torch.float32),
            ("group", (2, 9, 7, 20), 4, "gelu", torch.bfloat16),
            ("batch", (3, 16, 16, 256), 4, "gelu", torch.bfloat16),
            ("batch", (2, 9, 7, 20), 4, "relu", torch.bfloat16),
            ("batch", (2, 9, 7, 10), 2, "none", torch.float32),
            ("batch", (1, 4, 4, 4096), 4, "none", torch.bfloat16),
            ("instance", (2, 8, 8, 24), 4, "relu", torch.bfloat16),
            ("instance", (2, 8, 8, 12), 4, "none", torch.float32),
            ("batch_f32", (2, 4, 16, 16, 32), 4, "leaky_relu", torch.bfloat16),
            ("batch_f32", (1, 4, 9, 7, 20), 4, "leaky_relu", torch.float32)]


def _k6_inputs(rng, dev, kind, shape, dtype):
    """x, g and the weight and bias: bf16 beside a bf16 x (as the train step
    hands them), fp32 beside an fp32 x."""
    C = shape[-1]
    x = _t(rng.standard_normal(shape) * 2 + 1, dev, dtype)
    g = _t(rng.standard_normal(shape), dev, dtype)
    wb = (None, None) if kind == "instance" else (
        _t(rng.standard_normal(C) + 1, dev, dtype), _t(rng.standard_normal(C), dev, dtype))
    return x, g, wb


@pytest.mark.cuda
@pytest.mark.parametrize("kind,shape,groups,act,dtype", K6_CASES)
def test_norm_act_kernels_match_twins(cuda, rng, kind, shape, groups, act, dtype):
    """Forward: the statistics within 1e-5 of the twins' (another order of
    fp32 sums), the apply bit-equal to the twin's on the kernel's coef / off;
    backward on the same inputs: dx within 1e-2 (bf16) / 1e-5 (fp32) of the
    largest element, dweight and dbias within 1e-2 (bf16: one rounding
    each side) / 1e-4 (fp32); two runs bit-equal."""
    from uncrtaints_tpu_torch.ops import norm as tn
    x, g, (w, b) = _k6_inputs(rng, cuda, kind, shape, dtype)
    K, A = tn.KINDS[kind], tn.ACTS[act]
    U = torch.ops.uncrtaints
    n0, b0 = tn.norm_act.launches, tn.norm_act_bwd.launches
    y, mvn, coef, off = U.norm_act(x, w, b, K, groups, A, 0)
    dx, dw, db = U.norm_act_bwd(g, x, w, b, mvn, coef, off, K, groups, A, 0)
    torch.cuda.synchronize()
    assert (tn.norm_act.launches, tn.norm_act_bwd.launches) == (n0 + 1, b0 + 1)
    ry, rmvn, _, _ = tn.norm_act_twin(x, w, b, K, groups, A)
    scale = float(x.float().abs().max())
    stat = (mvn - rmvn).abs()[:-1] / (scale * scale)
    assert float(stat.max()) <= 1e-5 and float(mvn[-1]) == float(rmvn[-1])
    Fr, C = coef.shape
    form = tn.FORMS[K]
    assert torch.equal(y, tn.apply_twin(x.view(Fr, -1, C), coef, off, form, A, w, b).view(x.shape))
    tol = 2 ** -6 if dtype == torch.bfloat16 else 1e-5
    assert float((y.float() - ry.float()).abs().max()) <= tol * float(ry.float().abs().max())
    rdx, rdw, rdb = tn.norm_act_bwd_twin(g, x, w, b, mvn, coef, off, K, groups, A)
    dtol = 1e-2 if dtype == torch.bfloat16 else 1e-5
    assert float((dx.float() - rdx.float()).abs().max()) <= dtol * float(rdx.float().abs().max())
    for got, ref in ((dw, rdw), (db, rdb)):  # empty for instance norm
        assert got.shape == ref.shape
        if ref.numel():
            ptol = 1e-2 if dtype == torch.bfloat16 else 1e-4
            assert float((got.float() - ref.float()).abs().max()) <= ptol * max(
                float(ref.float().abs().max()), 1.0)
    again = U.norm_act(x, w, b, K, groups, A, 0)
    back = U.norm_act_bwd(g, x, w, b, mvn, coef, off, K, groups, A, 0)
    assert all(torch.equal(p, q) for p, q in zip((y, mvn, coef, off, dx, dw, db),
                                                 (*again, *back)))


# The one-pass K6 (ops/norm.py:onchip_plan admits these forwards, and the
# backwards of few waves): the paper encoder's group norms at B=16 (48
# frames, GELU and ReLU), U-TAE's 64-channel level and its 32^2 levels (64
# and 128 channels, backward too), the FPN's 32 and 160 channels, an
# instance norm and an fp32 frame (backward too). (norm, [N,H,W,C], groups,
# activation, dtype)
K6_ONCHIP_CASES = [("group", (48, 256, 256, 256), 4, "gelu", torch.bfloat16),
                   ("group", (48, 256, 256, 128), 4, "relu", torch.bfloat16),
                   ("group", (64, 256, 256, 64), 4, "relu", torch.bfloat16),
                   ("group", (192, 32, 32, 64), 4, "relu", torch.bfloat16),
                   ("group", (192, 32, 32, 128), 4, "relu", torch.bfloat16),
                   ("group", (48, 256, 256, 32), 4, "relu", torch.bfloat16),
                   ("group", (48, 256, 256, 160), 4, "relu", torch.bfloat16),
                   ("instance", (16, 128, 128, 64), 4, "gelu", torch.bfloat16),
                   ("group", (12, 128, 128, 64), 4, "gelu", torch.float32)]


def _k6_card_inputs(dev, kind, shape, dtype):
    """As :func:`_k6_inputs`, drawn on the card (the paths' maps are large)."""
    g = torch.Generator(device=dev).manual_seed(0)
    rand = lambda *s: torch.randn(*s, generator=g, device=dev)
    C = shape[-1]
    x = (rand(*shape) * 2 + 1).to(dtype)
    gy = rand(*shape).to(dtype)
    wb = (None, None) if kind == "instance" else ((rand(C) + 1).to(dtype), rand(C).to(dtype))
    return x, gy, wb


@pytest.mark.cuda
@pytest.mark.parametrize("kind,shape,groups,act,dtype", K6_ONCHIP_CASES)
def test_norm_onchip_matches_twins(cuda, kind, shape, groups, act, dtype):
    """The one-pass kernels (one forward call, and one backward call where
    ``onchip_plan`` admits it: counted in ``.onchip``) against the twins as
    the two-pass kernels are held:
    the statistics within 1e-5, the apply bit-equal to the twin's on the
    kernel's coef / off, y within 2^-6 (bf16) of the largest, dx within
    1e-2 (bf16) / 1e-5 (fp32) of the largest, dweight and dbias within
    1e-2 / 1e-4; the statistics within 1e-5 of the two-pass kernels'; two
    runs bit-equal."""
    from uncrtaints_tpu_torch.ops import norm as tn
    x, g, (w, b) = _k6_card_inputs(cuda, kind, shape, dtype)
    K, A = tn.KINDS[kind], tn.ACTS[act]
    U = torch.ops.uncrtaints
    n0, b0 = tn.norm_act.onchip, tn.norm_act_bwd.onchip
    y, mvn, coef, off = U.norm_act(x, w, b, K, groups, A, 0)
    dx, dw, db = U.norm_act_bwd(g, x, w, b, mvn, coef, off, K, groups, A, 0)
    torch.cuda.synchronize()
    Fr, C = coef.shape
    G = C if kind == "instance" else groups
    bwd_plan = tn.onchip_plan(kind, Fr, x.numel() // (Fr * C), C, G, x.element_size(),
                              tn.REDUCE_NONE, *tn._device_limits(cuda.index or 0), backward=True)
    assert (tn.norm_act.onchip, tn.norm_act_bwd.onchip) == (n0 + 1, b0 + (bwd_plan is not None))
    scale = float(x.float().abs().max()) ** 2
    ry, rmvn, _, _ = tn.norm_act_twin(x, w, b, K, groups, A)
    assert float((mvn - rmvn).abs()[:-1].max()) <= 1e-5 * scale
    assert float(mvn[-1]) == float(rmvn[-1])
    x3, g3 = x.view(Fr, -1, C), g.view(Fr, -1, C)
    form = tn.FORMS[K]
    assert torch.equal(y, tn.apply_twin(x3, coef, off, form, A).view(x.shape))
    tol = 2 ** -6 if dtype == torch.bfloat16 else 1e-5
    assert float((y.float() - ry.float()).abs().max()) <= tol * float(ry.float().abs().max())
    del ry
    two = tn.forward_two_pass(x3, w, b, K, G, A, form, x3.shape[1] * (C // G))
    assert float((mvn - two[3]).abs()[:-1].max()) <= 1e-5 * scale
    del two
    rdx, rdw, rdb = tn.norm_act_bwd_twin(g, x, w, b, mvn, coef, off, K, groups, A)
    dtol = 1e-2 if dtype == torch.bfloat16 else 1e-5
    assert float((dx.float() - rdx.float()).abs().max()) <= dtol * float(rdx.float().abs().max())
    del rdx
    for got, ref in ((dw, rdw), (db, rdb)):  # empty for instance norm
        assert got.shape == ref.shape
        if ref.numel():
            ptol = 1e-2 if dtype == torch.bfloat16 else 1e-4
            assert float((got.float() - ref.float()).abs().max()) <= ptol * max(
                float(ref.float().abs().max()), 1.0)
    again = U.norm_act(x, w, b, K, groups, A, 0)
    back = U.norm_act_bwd(g, x, w, b, mvn, coef, off, K, groups, A, 0)
    assert all(torch.equal(p, q) for p, q in zip((y, mvn, coef, off, dx, dw, db),
                                                 (*again, *back)))


@pytest.mark.cuda
@pytest.mark.parametrize("C,act", [(256, "gelu"), (128, "relu")])
def test_norm_onchip_backward_kernel_at_the_paper_widths(cuda, C, act):
    """The one-pass backward kernel called directly at the paper step's
    frames (48 x 256^2), where the rule takes two passes (one slab a wave),
    under the plan the card's budget gives: dx, dweight and dbias against the
    twin as the routed calls are held, two runs bit-equal."""
    from uncrtaints_tpu_torch.ops import norm as tn
    x, g, (w, b) = _k6_card_inputs(cuda, "group", (48, 256, 256, C), torch.bfloat16)
    K, A = tn.KINDS["group"], tn.ACTS[act]
    x3, g3 = x.view(48, -1, C), g.view(48, -1, C)
    y, coef, off, mvn = tn.forward_two_pass(x3, w, b, K, 4, A, 0, x3.shape[1] * (C // 4))
    sms, smem = tn._device_limits(cuda.index or 0)
    plan = tn.OnchipPlan(64, 1, sms, -(-x3.shape[1] // sms))  # one 64-channel group a slab
    cap = (smem - tn._onchip_smem_bytes(0, 64, 2, True)) // tn._onchip_row_bytes(64, 2, True)
    assert plan.rpb <= cap
    dx, dw, db = tn.backward_one_pass(g3, x3, w, mvn, coef, off, K, 4, A, plan)
    rdx, rdw, rdb = tn.norm_act_bwd_twin(g, x, w, b, mvn, coef, off, K, 4, A)
    assert float((dx.float() - rdx.float().view(dx.shape)).abs().max()) <= 1e-2 * float(
        rdx.float().abs().max())
    for got, ref in ((dw, rdw), (db, rdb)):
        assert float((got.float() - ref.float()).abs().max()) <= 1e-2 * max(
            float(ref.float().abs().max()), 1.0)
    again = tn.backward_one_pass(g3, x3, w, mvn, coef, off, K, 4, A, plan)
    assert all(torch.equal(p, q) for p, q in zip((dx, dw, db), again))


@pytest.mark.cuda
@pytest.mark.parametrize("kind,shape,dtype", [("group", (4, 64, 64, 128), torch.bfloat16),
                                              ("instance", (3, 32, 32, 64), torch.float32)])
def test_norm_onchip_opcheck(cuda, kind, shape, dtype):
    """``torch.library.opcheck`` of ``norm_act`` on the card where it takes
    one pass: schema, fake shapes, the registered backward (one pass too),
    AOT dispatch."""
    from uncrtaints_tpu_torch.ops import norm as tn
    x, _, (w, b) = _k6_card_inputs(cuda, kind, shape, dtype)
    leaves = [t if t is None else t.requires_grad_() for t in (x, w, b)]
    n0, b0 = tn.norm_act.onchip, tn.norm_act_bwd.onchip
    torch.library.opcheck(torch.ops.uncrtaints.norm_act.default,
                          (*leaves, tn.KINDS[kind], 4, tn.ACTS["gelu"], 0))
    assert tn.norm_act.onchip > n0 and tn.norm_act_bwd.onchip > b0


@pytest.mark.cuda
def test_norm_onchip_routes_by_shape(cuda):
    """A group-norm frame one row over the one-pass budget, and a batch
    norm, take the two-pass kernels (``.onchip`` unchanged); a frame at the
    budget takes one pass; the two agree."""
    from uncrtaints_tpu_torch.ops import norm as tn
    sms, smem = tn._device_limits(cuda.index or 0)
    C, size = 64, 2  # bf16 rows of 128 bytes, one group: the whole row a slab
    cap = (smem - tn._onchip_smem_bytes(0, C, size, False)) // tn._onchip_row_bytes(C, size, False)
    rows = cap * sms
    plan = lambda P: tn.onchip_plan("group", 2, P, C, 1, size, tn.REDUCE_NONE, sms, smem)
    assert plan(rows) is not None and plan(rows + 1) is None
    U, K, A = torch.ops.uncrtaints, tn.KINDS["group"], tn.ACTS["relu"]
    outs = []
    for P in (rows, rows + 1):
        x, _, (w, b) = _k6_card_inputs(cuda, "group", (2, P, 1, C), torch.bfloat16)
        n0, l0 = tn.norm_act.onchip, tn.norm_act.launches
        y, mvn, coef, off = U.norm_act(x, w, b, K, 1, A, 0)
        torch.cuda.synchronize()
        assert tn.norm_act.launches == l0 + 1
        assert tn.norm_act.onchip == n0 + (P == rows)
        ry, rmvn, _, _ = tn.norm_act_twin(x, w, b, K, 1, A)
        assert float((y.float() - ry.float()).abs().max()) <= 2 ** -6 * float(
            ry.float().abs().max())
        outs.append(mvn)
    x, g, (w, b) = _k6_card_inputs(cuda, "batch", (4, 64, 64, 128), torch.bfloat16)
    n0, b0 = tn.norm_act.onchip, tn.norm_act_bwd.onchip
    y, mvn, coef, off = U.norm_act(x, w, b, tn.KINDS["batch"], 4, A, 0)
    U.norm_act_bwd(g, x, w, b, mvn, coef, off, tn.KINDS["batch"], 4, A, 0)
    torch.cuda.synchronize()
    assert (tn.norm_act.onchip, tn.norm_act_bwd.onchip) == (n0, b0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", ["none", "gelu", "relu"])
def test_affine_act_kernel_matches_twin(cuda, rng, act, dtype):
    """The eval batch norm's apply: bit-equal to the eager x * coef + off
    and the activation; its backward's dcoef / doff sums within 1e-4."""
    from uncrtaints_tpu_torch.ops import norm as tn
    x, g, _ = _k6_inputs(rng, cuda, "batch", (2, 16, 16, 64), dtype)
    coef, off = _t(rng.standard_normal(64), cuda, dtype), _t(rng.standard_normal(64), cuda, dtype)
    y = tn.affine_act(x, coef, off, act)
    assert torch.equal(y, tn.affine_act_plain(x, coef, off, act))
    dx, dc, do, _, _ = torch.ops.uncrtaints.norm_affine_act_bwd(g, x, coef, off, None, None,
                                                                tn.ACTS[act])
    rdx, rdc, rdo, _, _ = tn.affine_act_bwd_twin(g, x, coef, off, None, None, tn.ACTS[act])
    dtol = 1e-2 if dtype == torch.bfloat16 else 1e-5
    assert float((dx.float() - rdx.float()).abs().max()) <= dtol * float(rdx.float().abs().max())
    for got, ref in ((dc, rdc), (do, rdo)):
        assert float((got.float() - ref.float()).abs().max()) <= 1e-2 * float(
            ref.float().abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_affine_f32_kernel_matches_twin(cuda, rng, dtype):
    """UNet3D's eval batch norm (((x - m) * r) * w + b in fp32, then the
    LeakyReLU): bit-equal to the eager formula; its backward within 1e-2."""
    from uncrtaints_tpu_torch.ops import norm as tn
    x, g, (w, b) = _k6_inputs(rng, cuda, "batch_f32", (2, 4, 8, 8, 32), dtype)
    r, m = _t(rng.random(32) + 0.5, cuda), _t(rng.standard_normal(32), cuda)
    y = tn.affine_act(x, r, m, "leaky_relu", w, b)
    assert torch.equal(y, tn.affine_act_plain(x, r, m, "leaky_relu", w, b))
    act = tn.ACTS["leaky_relu"]
    got = torch.ops.uncrtaints.norm_affine_act_bwd(g, x, r, m, w, b, act)
    ref = tn.affine_act_bwd_twin(g, x, r, m, w, b, act)
    for a, e in zip(got, ref):
        assert float((a.float() - e.float()).abs().max()) <= 1e-2 * max(
            float(e.float().abs().max()), 1.0)


@pytest.mark.cuda
@pytest.mark.parametrize("norm", ["batch", "group", "instance", "batch3d"])
def test_norm2d_on_card_matches_cpu(cuda, rng, norm):
    """Norm2d with its ReLU (UNet3D's BatchNorm3d with its LeakyReLU), fp32,
    train mode: the card (K6) against the CPU (the eager formula): output,
    gradients and running statistics within 1e-4 of the largest."""
    from uncrtaints_tpu_torch.models import layers as tl
    from uncrtaints_tpu_torch.models.unet3d import BatchNorm3d
    shape = (2, 4, 9, 10, 16) if norm == "batch3d" else (3, 9, 10, 16)
    x = _t(rng.standard_normal(shape) * 2 + 1, "cpu")
    g = _t(rng.standard_normal(shape), "cpu")
    base = (BatchNorm3d(16) if norm == "batch3d" else tl.Norm2d(norm, 16)).train()
    act = "leaky_relu" if norm == "batch3d" else "relu"
    if norm != "instance":
        base.weight.data = _t(rng.standard_normal(16) * 0.5 + 1, "cpu")
        base.bias.data = _t(rng.standard_normal(16), "cpu")
    outs = []
    for dev in ("cpu", cuda):
        m = copy.deepcopy(base).to(dev)
        xd = x.to(dev).requires_grad_()
        y = m(xd, act=act)
        grads = torch.autograd.grad(y, [xd, *m.parameters()], g.to(dev))
        outs.append([t.detach().cpu() for t in (y, *grads, *m.buffers())])
    for a, r in zip(outs[1], outs[0]):
        assert float((a - r).abs().max()) <= 1e-4 * max(float(r.abs().max()), 1.0)


# K7's cases: (N, H, W, C, p, offset). C of 256 and 64 (16-byte vectors, the
# paths' widths), 12 (8 bytes in bf16), 15 and 3 (2 bytes in bf16, 4 in
# fp32); p of 1, 2 and 3; odd H != W; H of 3 with p = 2 (a row with both
# mirrors); as a sixth field x a contiguous view one element off 16 bytes
K7_CASES = [(2, 37, 70, 256, 1, 0), (3, 16, 33, 64, 2, 0), (2, 5, 7, 12, 3, 0),
            (2, 33, 20, 15, 1, 0), (2, 9, 11, 3, 2, 0), (1, 3, 6, 64, 2, 0),
            (2, 17, 19, 64, 1, 1)]


def _k7_input(rng, dev, dtype, case):
    N, H, W, C, p, offset = case
    x = _t(rng.standard_normal((N, H, W, C)), dev, dtype)
    if offset:
        buf = torch.empty(x.numel() + offset, dtype=dtype, device=dev)
        x = buf[offset:].view(x.shape).copy_(x)
        assert x.is_contiguous() and x.data_ptr() % 16
    return x, p


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", K7_CASES)
def test_reflect_pad_kernel_matches_fpad(cuda, rng, dtype, case):
    """K7's forward is F.pad's reflect pad to the bit; one launch."""
    from uncrtaints_tpu_torch.ops import pad as tp
    x, p = _k7_input(rng, cuda, dtype, case)
    n = tp.reflect_pad.launches
    y = tp.reflect_pad(x, p)
    torch.cuda.synchronize()
    assert tp.reflect_pad.launches == n + 1
    assert torch.equal(y, tp.reflect_pad_plain(x, p))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", K7_CASES)
def test_reflect_pad_adjoint_kernel_matches_plain(cuda, rng, dtype, case):
    """K7's adjoint is its plain version (the same fp32 sums in the same
    order, rounded once) to the bit, in both dtypes, and gives the same bits
    twice; within rounding of autograd's backward of F.pad."""
    from uncrtaints_tpu_torch.ops import pad as tp
    x, p = _k7_input(rng, cuda, dtype, case)
    N, H, W, C = x.shape
    g = _t(rng.standard_normal((N, H + 2 * p, W + 2 * p, C)), cuda, dtype)
    n = tp.reflect_pad_adjoint.launches
    gx = tp.reflect_pad_adjoint(g, p)
    again = tp.reflect_pad_adjoint(g, p)
    torch.cuda.synchronize()
    assert tp.reflect_pad_adjoint.launches == n + 2
    assert torch.equal(gx, tp.reflect_pad_adjoint_plain(g, p))
    assert torch.equal(gx, again)
    leaf = x.detach().clone().requires_grad_()
    (ref,) = torch.autograd.grad(tp.reflect_pad_plain(leaf, p), leaf, g)
    tol = (1e-6 if dtype == torch.float32 else 2 ** -6) * float(gx.float().abs().max())
    assert float((gx.float() - ref.float()).abs().max()) <= tol


@pytest.mark.cuda
def test_reflect_pad_autograd_on_card(cuda, rng):
    """The operator's backward on the card is the adjoint kernel."""
    from uncrtaints_tpu_torch.ops import pad as tp
    x = _t(rng.standard_normal((2, 8, 9, 64)), cuda, torch.bfloat16).requires_grad_()
    g = _t(rng.standard_normal((2, 10, 11, 64)), cuda, torch.bfloat16)
    n = tp.reflect_pad_adjoint.launches
    (gx,) = torch.autograd.grad(tp.reflect_pad(x, 1), x, g)
    assert tp.reflect_pad_adjoint.launches == n + 1
    assert torch.equal(gx, tp.reflect_pad_adjoint_plain(g, 1))


@pytest.mark.cuda
def test_reflect_pad_kernel_refuses_bad_input(cuda):
    """A non-contiguous map, p >= H or p >= W, and an fp16 map raise."""
    from uncrtaints_tpu_torch.ops import pad as tp
    x = torch.zeros(2, 4, 6, 8, device=cuda)
    with pytest.raises(ValueError):
        tp.reflect_pad(x.permute(0, 2, 1, 3), 1)
    with pytest.raises(ValueError):
        tp.reflect_pad(x, 4)
    with pytest.raises(ValueError):
        tp.reflect_pad(torch.zeros(2, 8, 3, 8, device=cuda), 3)
    with pytest.raises(TypeError):
        tp.reflect_pad(x.half(), 1)
    with pytest.raises(ValueError):
        tp.reflect_pad_adjoint(torch.zeros(2, 10, 14, 8, device=cuda), 4)


@pytest.mark.cuda
def test_utae_train_step_pads_through_k7(cuda):
    """A U-TAE train step on the card pads its 3x3 convs through K7 and
    differentiates them through K7's adjoint; card against CPU, fp32 (the
    gradients zero in exact arithmetic, rounding noise under 1e-5 of the
    largest, left out: the L-TAE's key-side biases shift every logit of a
    pixel under its softmax)."""
    from uncrtaints_tpu_torch.config import Config, derive
    from uncrtaints_tpu_torch.models import get_generator
    from uncrtaints_tpu_torch.ops import pad as tp
    from uncrtaints_tpu_torch.train import create_train_state, make_train_step
    torch.backends.cudnn.allow_tf32 = False
    cfg = derive(Config(model="utae", use_sar=True, encoder_widths=[16, 16, 16, 32],
                        decoder_widths=[16, 16, 16, 32], n_head=4, d_model=32,
                        compute_dtype="float32"))
    rng = np.random.default_rng(0)
    batch = {"x": rng.random((2, cfg.input_t, 32, 32, 15), dtype=np.float32),
             "y": rng.random((2, 1, 32, 32, 13), dtype=np.float32),
             "dates": np.zeros((2, cfg.input_t), np.float32)}
    out = {}
    for dev in ("cpu", cuda):
        model = get_generator(cfg, device=torch.device(dev),
                              generator=torch.Generator().manual_seed(0))
        te = model.temporal_encoder
        te.use_dropout, te.dropout = False, 0.0
        b = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        n, na = tp.reflect_pad.launches, tp.reflect_pad_adjoint.launches
        _, aux = make_train_step(cfg)(create_train_state(cfg, model), b)
        torch.cuda.synchronize()
        launched = (tp.reflect_pad.launches - n, tp.reflect_pad_adjoint.launches - na)
        if dev == "cpu":
            assert launched == (0, 0)
        else:
            assert launched[0] > 0 and launched[1] > 0
        out[dev] = (float(aux["loss"]), {k: g.cpu() for k, g in aux["grads"].items()})
    (lc, gc), (lg, gg) = out["cpu"], out[cuda]
    assert abs(lg / lc - 1) <= 1e-4
    top = max(float(g.abs().max()) for g in gc.values())
    for k, ref in gc.items():
        scale = float(ref.abs().max())
        if scale > 1e-5 * top:
            assert float((gg[k] - ref).abs().max()) <= 1e-3 * scale, k
