"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips where no CUDA device is
present. The file imports neither JAX nor the conftest (which does), so on
a GPU machine without JAX it runs as

    python -m pytest tests/test_torch_kernels.py --noconftest -m cuda
"""

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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 3, 16, 16, 128, 16), (1, 2, 7, 9, 20, 4),
                                   (2, 3, 32, 32, 64, 16)])  # + U-TAE's 4 channels a head
def test_att_group_kernel_matches_plain(cuda, rng, dtype, shape):
    B, T, H, W, C, heads = shape
    x = _t(rng.standard_normal((B, T, H, W, C)), cuda, dtype)
    a = _t(rng.random((B, T, H, W, heads)), cuda, dtype)
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
@pytest.mark.parametrize("shape", [(2, 3, 16, 16, 128, 16), (1, 2, 7, 9, 20, 4),
                                   (2, 3, 32, 32, 64, 16)])  # + U-TAE's 4 channels a head
def test_att_group_autograd_on_card(cuda, rng, dtype, shape):
    """att_group_aggregate on the card is differentiable: x.grad and a.grad
    exist and match the plain version's autograd gradients, taken in fp32
    from the same values (bf16: the kernels sum in fp32 and round once, the
    plain version's bf16 autograd would round every product)."""
    B, T, H, W, C, heads = shape
    x = _t(rng.standard_normal((B, T, H, W, C)), cuda, dtype).requires_grad_()
    a = _t(rng.random((B, T, H, W, heads)), cuda, dtype).requires_grad_()
    cot = _t(rng.standard_normal((B, H, W, C)), cuda, dtype)
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
@pytest.mark.parametrize("shape", [(2, 3, 16, 16, 128, 16), (1, 2, 7, 9, 20, 4),
                                   (2, 3, 32, 32, 64, 16)])  # + U-TAE's 4 channels a head
def test_att_group_bwd_kernel_matches_plain(cuda, rng, dtype, shape):
    B, T, H, W, C, heads = shape
    x = _t(rng.standard_normal((B, T, H, W, C)), cuda, dtype)
    a = _t(rng.random((B, T, H, W, heads)), cuda, dtype)
    g = _t(rng.standard_normal((B, H, W, C)), cuda, dtype)
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
def test_fused_mbconv_chain_on_card(cuda, rng):
    """The eval MBConv on the card runs K3, K4, K3 and stays within the
    fused-vs-standard gate of its own standard body."""
    from uncrtaints_tpu_torch.models.blocks import MBConv
    from uncrtaints_tpu_torch.models.layers import init_weights
    tm = MBConv(128, 128, expansion=2, norm="batch").eval()
    init_weights(tm, torch.Generator().manual_seed(0))
    for b in tm.buffers():
        b.copy_(_t(np.abs(rng.standard_normal(b.shape) * 0.3) + 0.5, "cpu"))
    tm = tm.to(cuda)
    for p in tm.parameters():
        p.data = p.data.bfloat16()
    x = _t(rng.standard_normal((2, 3, 16, 16, 128)), cuda, torch.bfloat16)
    with torch.inference_mode():
        y0 = tm(x).float()
        tm.fused_eval = True
        n3, n4 = tops.norm_gelu_matmul.launches, tops.norm_gelu_dwconv3x3.launches
        nw = tops.norm_gelu_matmul.wgmma_launches
        y1 = tm(x).float()
    assert tops.norm_gelu_matmul.launches == n3 + 2
    assert tops.norm_gelu_matmul.wgmma_launches == nw + 2  # both GEMMs pipelined
    assert tops.norm_gelu_dwconv3x3.launches == n4 + 1
    d = (y0 - y1).abs()
    assert d.max() <= 0.02 * y0.abs().max()
    assert d.square().mean().sqrt() <= 5e-3 * y0.abs().max()


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
