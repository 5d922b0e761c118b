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
@pytest.mark.parametrize("shape", [(2, 3, 16, 16, 128, 16), (1, 2, 7, 9, 20, 4)])
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
@pytest.mark.parametrize("shape", [(2, 3, 16, 16, 128, 16), (1, 2, 7, 9, 20, 4)])
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
@pytest.mark.parametrize("shape", [(2, 3, 16, 16, 128, 16), (1, 2, 7, 9, 20, 4)])
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
    # the plain version's roundings exactly (fp32 taps in its order, no FMA)
    assert torch.equal(got, tops.dw_stencil_plain(x, w, pads))


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
def test_depthwise_function_on_card_matches_cpu(cuda, rng):
    """The depthwise Function (K5 forward, K5 input gradient, K2 weight
    gradient) on the card against the same Function on the CPU (the
    kernels' plain versions), fp32."""
    from uncrtaints_tpu_torch.models.layers import DepthwiseConv2d
    x = rng.standard_normal((2, 18, 20, 64)).astype(np.float32)
    w = rng.standard_normal((64, 1, 3, 3)).astype(np.float32)
    cot = rng.standard_normal((2, 16, 18, 64)).astype(np.float32)
    out = {}
    for dev in (torch.device("cpu"), cuda):
        tx, tw = _t(x, dev).requires_grad_(), _t(w, dev).requires_grad_()
        y = DepthwiseConv2d.apply(tx, tw, ((0, 0), (0, 0)))
        (y * _t(cot, dev)).sum().backward()
        out[dev.type] = [t.detach().cpu() for t in (y, tx.grad, tw.grad)]
    for got, ref in zip(out["cuda"], out["cpu"]):
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
