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
