"""The six hand-written kernels as dispatcher operators
(``torch.ops.uncrtaints``): ``torch.library.opcheck`` on each CPU
implementation (the plain versions), their FLOP formulas, and that the
wrappers call them.

opcheck runs its own tolerances (the schema, the FakeTensor shapes against
the CPU result, the autograd registration, and AOT dispatch with dynamic
shapes against eager). The FLOP counts are integers, held exactly.
"""

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from uncrtaints_tpu_torch import ops  # noqa: F401  (registers the operators)

OPS = ("att_group_aggregate", "att_group_aggregate_bwd", "dw_stencil", "dw_kernel_grad",
       "norm_gelu_matmul", "norm_gelu_dwconv3x3")


def _r(rng, *shape, dtype=torch.float32):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)


def _cases(rng):
    """(operator, args) at small shapes, each mode and option of the ops."""
    x, attn = _r(rng, 2, 3, 4, 5, 8), _r(rng, 2, 3, 4, 5, 2).softmax(1)
    g = _r(rng, 2, 4, 5, 8)
    xd, wd = _r(rng, 2, 6, 7, 4), _r(rng, 4, 1, 3, 3)
    N, P, C, C2 = 2, 16, 8, 12
    k3 = [_r(rng, N, P, C, dtype=torch.bfloat16), _r(rng, N, 2), _r(rng, N, 2).abs(),
          _r(rng, C), _r(rng, C), _r(rng, C, C2, dtype=torch.bfloat16)]
    x4 = _r(rng, N, 5, 6, C)
    k4 = [x4, _r(rng, N, 2), _r(rng, N, 2).abs(), _r(rng, C), _r(rng, C), _r(rng, 3, 3, C)]
    u = torch.ops.uncrtaints
    return [
        (u.att_group_aggregate.default, (x, attn)),
        (u.att_group_aggregate_bwd.default, (x, attn, g)),
        (u.dw_stencil.default, (xd, wd, [0, 0, 0, 0], 0)),
        (u.dw_stencil.default, (xd, wd, [1, 0, 2, 1], 0)),
        (u.dw_stencil.default, (xd, wd, [1, 1, 1, 1], 1)),
        (u.dw_stencil.default, (xd, wd, [1, 1, 1, 1], 2)),
        (u.dw_kernel_grad.default, (xd, _r(rng, 2, 4, 5, 4), [0, 0, 0, 0], 3, 3, 0)),
        (u.dw_kernel_grad.default, (xd, _r(rng, 2, 6, 7, 4), [1, 1, 1, 1], 3, 3, 1)),
        (u.norm_gelu_matmul.default, (*k3, None, None, None, 2, 4, True, False, True)),
        (u.norm_gelu_matmul.default, (*k3, _r(rng, N, C), _r(rng, C2), _r(rng, C2), 2, 3,
                                      True, True, False)),
        (u.norm_gelu_dwconv3x3.default, (*k4, None, None, 2, 4, True)),
        (u.norm_gelu_dwconv3x3.default, (*k4, _r(rng, C), _r(rng, C), 2, 1, False)),
    ]


@pytest.mark.parametrize("case", range(12))
def test_opcheck_cpu(rng, case):
    op, args = _cases(rng)[case]
    torch.library.opcheck(op, args)


def test_opcheck_with_gradients(rng):
    """The differentiable operators (K1 through K1-bwd, K5 through itself
    and K2) with inputs that require grad: the registered backward against
    autograd's checks."""
    x = _r(rng, 2, 3, 4, 5, 8).requires_grad_()
    attn = _r(rng, 2, 3, 4, 5, 2).softmax(1).detach().requires_grad_()
    torch.library.opcheck(torch.ops.uncrtaints.att_group_aggregate.default, (x, attn))
    xd, wd = _r(rng, 2, 6, 7, 4).requires_grad_(), _r(rng, 4, 1, 3, 3).requires_grad_()
    for pads, mode in (([1, 0, 2, 1], 0), ([1, 1, 1, 1], 1)):
        torch.library.opcheck(torch.ops.uncrtaints.dw_stencil.default, (xd, wd, pads, mode))


def test_flop_formulas(rng):
    """Two FLOPs a multiply-add, as torch counts a convolution: K1 T an
    output, K1-bwd two an element of x, K5 and K2 kh*kw an output (the same
    count as F.conv2d's depthwise convolution), K3 its GEMM, K4 nine taps an
    output."""
    cases = _cases(rng)
    want = [2 * 2 * 3 * 4 * 5 * 8, 4 * 2 * 3 * 4 * 5 * 8,
            2 * 9 * 2 * 4 * 5 * 4, 2 * 9 * 2 * 5 * 8 * 4, 2 * 9 * 2 * 6 * 7 * 4,
            2 * 9 * 2 * 6 * 7 * 4, 2 * 9 * 2 * 4 * 5 * 4, 2 * 9 * 2 * 6 * 7 * 4,
            2 * 2 * 16 * 8 * 12, 2 * 2 * 16 * 8 * 12, 2 * 9 * 2 * 5 * 6 * 8,
            2 * 9 * 2 * 5 * 6 * 8]
    for (op, args), n in zip(cases, want):
        with FlopCounterMode(display=False) as fc:
            op(*args)
        assert fc.get_total_flops() == n, (op, fc.get_total_flops(), n)
    xd, wd = cases[2][1][:2]
    with FlopCounterMode(display=False) as fc:
        torch.nn.functional.conv2d(xd.permute(0, 3, 1, 2), wd, groups=4)
    assert fc.get_total_flops() == want[2]


def test_the_wrappers_call_the_operators(rng):
    """Each wrapper dispatches its operator (so the exported graph, the
    profiler and the FLOP counter see the kernel), on the CPU its plain
    version."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Seen(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.names = set()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func.namespace == "uncrtaints":
                self.names.add(func._opname)
            return func(*args, **(kwargs or {}))

    cases = {op._opname: args for op, args in _cases(rng)}
    x, attn = cases["att_group_aggregate"]
    xd, wd = cases["dw_stencil"][:2]
    k3, k4 = cases["norm_gelu_matmul"], cases["norm_gelu_dwconv3x3"]
    with Seen() as seen:
        out = ops.att_group_aggregate(x.requires_grad_(), attn)
        out.sum().backward()
        y = ops.dw_stencil(xd.requires_grad_(), wd.requires_grad_(), ((1, 1), (1, 1)), "reflect")
        y.sum().backward()
        ops.norm_gelu_matmul(*k3[:6], groups_in=2)
        ops.norm_gelu_dwconv3x3(*k4[:6], groups_in=2)
    assert seen.names == set(OPS)
