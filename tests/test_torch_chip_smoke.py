"""``chip_smoke.py``'s helpers on the CPU: the kernel-kind tables sort a
profile's kernels, and ``kernel_wrappers()`` names the thirteen counted kernel
wrappers, whose counters a CPU call leaves at 0 (a CPU tensor runs the
plain version, not the kernel)."""

import pytest
import torch

import chip_smoke

# counter name: the wrapper that holds it, as module.function of ops/
WRAPPERS = {"K1": "aggregate.att_group_aggregate", "K1-bwd": "aggregate.att_group_aggregate_bwd",
            "K5": "dwconv.dw_stencil", "K2": "dwgrad.dw_kernel_grad",
            "K3": "mbconv.norm_gelu_matmul", "K4": "mbconv.norm_gelu_dwconv3x3",
            "K6": "norm.norm_act", "K6-bwd": "norm.norm_act_bwd",
            "K7": "pad.reflect_pad", "K7-adj": "pad.reflect_pad_adjoint",
            "GN-stats": "norm.norm_stats", "GN-pool": "norm.norm_gelu_pool",
            "GN-apply": "norm.norm_apply"}


def _cpu_args(name):
    """A small CPU call's arguments for the wrapper counted as ``name``."""
    from uncrtaints_tpu_torch.ops import norm
    gen = torch.Generator().manual_seed(0)
    r = lambda *s: torch.randn(*s, generator=gen)
    N, H, W, C, G = 2, 6, 5, 8, 4
    x, x5 = r(N, H, W, C), r(N, 3, H, W, C)
    attn = r(N, 3, H, W, 2).softmax(1)
    stats = (r(N, G), r(N, G).abs() + 0.5, r(C), r(C))  # mean, coef, scale, bias
    one = ((1, 1), (1, 1))
    if name == "K6-bwd":
        w, b = r(C), r(C)
        _, mvn, coef, off = torch.ops.uncrtaints.norm_act(x, w, b, norm.KINDS["group"], G,
                                                          norm.ACTS["gelu"], norm.REDUCE_NONE)
        return (r(N, H, W, C), x, w, b, mvn, coef, off, "group", G, "gelu")
    return {"K1": (x5, attn), "K1-bwd": (x5, attn, r(N, H, W, C)),
            "K5": (x, r(C, 1, 3, 3), one, "reflect"),
            "K2": (x, r(N, H, W, C), one, 3, 3, "reflect"),
            "K3": (x.view(N, H * W, C), *stats, r(C, 2 * C).bfloat16()),
            "K4": (x, *stats, r(3, 3, C)),
            "K6": (x, "group", r(C), r(C), G, "gelu"),
            "K7": (x, 1), "K7-adj": (r(N, H + 2, W + 2, C), 1),
            "GN-stats": (x, G), "GN-pool": (x, *stats), "GN-apply": (x, r(N, C), r(N, C))}[name]


@pytest.mark.parametrize("name", list(WRAPPERS))
def test_each_counted_wrapper_leaves_its_counter_at_0_on_the_cpu(name):
    wrappers = chip_smoke.kernel_wrappers()
    assert list(wrappers) == list(WRAPPERS)
    f = wrappers[name]
    assert f"{f.__module__.rsplit('.', 1)[1]}.{f.__name__}" == WRAPPERS[name]
    out = f(*_cpu_args(name))
    outs = out if isinstance(out, tuple) else (out,)
    assert all(bool(torch.isfinite(t).all()) for t in outs if isinstance(t, torch.Tensor))
    assert chip_smoke.launch_counts() == dict.fromkeys(WRAPPERS, 0)


def test_device_time_by_kind_sorts_kernels_by_the_first_fragment():
    from torch.autograd import DeviceType

    class Event:
        def __init__(self, key, count, us, device=DeviceType.CUDA):
            self.key, self.count, self.self_device_time_total = key, count, us
            self.device_type = device

    class Prof:
        def key_averages(self):
            return [Event("void att_group_bulk_kernel<16, true>", 1, 190.0),
                    Event("void dw_grad_tile_kernel", 6, 1000.0),
                    Event("vectorized_elementwise_kernel<gelu>", 36, 3680.0),
                    Event("vectorized_elementwise_kernel<mul>", 100, 500.0),
                    Event("aten::mul", 100, 0.0, DeviceType.CPU),
                    Event("some_kernel", 2, 20.0)]

    kinds, names, others = chip_smoke.device_time_by_kind(Prof(), chip_smoke.KERNEL_KINDS)
    assert kinds == {"K1 and K1-bwd": (0.19, 1), "K2 depthwise weight gradient": (1.0, 6),
                     "GELU": (3.68, 36), "elementwise": (0.5, 100), "other": (0.02, 2)}
    assert names["some_kernel"] == (2, 0.02) and others == [(0.02, 2, "some_kernel")]
