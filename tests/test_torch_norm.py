"""Kernel family K6 (ops/norm.py: the norms with their activation, forward
and backward) on the CPU, against the JAX package's Norm2d.

The operators' CPU implementations are the CUDA kernels' plain twins: the
same passes (sums, the per-slot math, the apply; the backward's sums, the
chain through the statistics, dx) as torch ops. The same seeded numpy
input and weights go through ``torch.ops.uncrtaints.norm_act`` /
``norm_affine_act`` and through the JAX ``Norm2d`` followed by the JAX
package's GELU or ReLU, in fp32 at widths 8-32:

- outputs within rtol 1e-5 / atol 1e-5 (the order of the fp32 sums
  differs, nothing else);
- gradients of x, weight and bias (the operators' ``register_autograd``
  backward) against ``jax.vjp`` of the same composition within 1e-4 of the
  largest element (the backward's closed form sums in another order than
  XLA's autodiff; the train-mode chain through the variance cancels);
- UNet3D's batch norm (kind ``batch_f32``, the affine in fp32) with its
  LeakyReLU against the JAX package's ``BatchNorm3d``, train and eval, and
  a UNet3D block on the operators against the eager route;
- the running statistics of a train call, and their skip under
  ``layers.recomputing()``;
- ``torch.export`` of a small group-norm MBConv in eval with its norms on
  the operators' route: the fake implementations' shapes carry it, and the
  exported program equals the module.
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uncrtaints_tpu.models import layers as jl

from uncrtaints_tpu_torch.models import blocks as tb
from uncrtaints_tpu_torch.models import layers as tl
from uncrtaints_tpu_torch.ops import norm as tn

U = torch.ops.uncrtaints
RTOL = ATOL = 1e-5  # forward, fp32: the order of the sums
GTOL = 1e-4  # gradients, of the largest element

# (norm, train, activation, channels, groups)
CASES = [("batch", True, "gelu", 16, 4), ("batch", True, "relu", 8, 4),
         ("batch", True, "none", 32, 4), ("batch", False, "gelu", 16, 4),
         ("batch", False, "relu", 32, 4), ("group", True, "gelu", 32, 4),
         ("group", True, "relu", 16, 4), ("group", True, "none", 8, 2),
         ("instance", True, "none", 8, 4), ("instance", True, "relu", 16, 4)]
IDS = [f"{n}-{'train' if t else 'eval'}-{a}-C{c}" for n, t, a, c, _ in CASES]


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _jax_act(y, act):
    if act == "gelu":
        return jl.gelu(y)
    if act == "relu":
        return jax.nn.relu(y)
    return y


def _setup(rng, norm, C, groups):
    """x [3,5,6,C] and the JAX Norm2d's variables (batch norm: non-trivial
    running statistics)."""
    x = (rng.standard_normal((3, 5, 6, C)) * 2 + 1).astype(np.float32)
    jm = jl.Norm2d(norm, n_groups=groups)
    v = jax.tree.map(np.asarray, flax.core.unfreeze(jm.init(jax.random.PRNGKey(1), x)))
    if norm in ("batch", "group"):
        v["params"]["scale"] = (rng.standard_normal(C) + 1).astype(np.float32)
        v["params"]["bias"] = rng.standard_normal(C).astype(np.float32)
    if norm == "batch":
        v["batch_stats"]["mean"] = rng.standard_normal(C).astype(np.float32)
        v["batch_stats"]["var"] = (rng.random(C) + 0.5).astype(np.float32)
    return x, jm, v


def _jax_fn(jm, v, train, act):
    """The JAX composition as a function of (x, scale, bias)."""
    def f(x, scale, bias):
        p = dict(v, params={"scale": scale, "bias": bias}) if "params" in v else v
        if train and "batch_stats" in v:
            y, _ = jm.apply(p, x, train=True, mutable=["batch_stats"])
        else:
            y = jm.apply(p, x, train=train)
        return _jax_act(y, act)
    return f


def _torch_op(x, v, norm, train, act, groups):
    """The operator's route (its CPU implementation: the kernels' twins),
    as Norm2d takes it on the card; returns y and what it differentiates."""
    if norm == "batch" and not train:
        w, b = _t(v["params"]["scale"]), _t(v["params"]["bias"])
        m, var = _t(v["batch_stats"]["mean"]), _t(v["batch_stats"]["var"])
        r = torch.rsqrt(var + 1e-5)
        coef, off = (r * w).requires_grad_(), (b - m * r * w).requires_grad_()
        return U.norm_affine_act(x, coef, off, None, None, tn.ACTS[act]), (coef, off)
    if norm == "instance":
        w = b = None
    else:
        w = _t(v["params"]["scale"]).requires_grad_()
        b = _t(v["params"]["bias"]).requires_grad_()
    y, _, _, _ = U.norm_act(x, w, b, tn.KINDS[norm], groups, tn.ACTS[act], tn.REDUCE_NONE)
    return y, (w, b)


@pytest.mark.parametrize("norm,train,act,C,groups", CASES, ids=IDS)
def test_forward_and_gradients_match_jax(rng, norm, train, act, C, groups):
    x, jm, v = _setup(rng, norm, C, groups)
    g = rng.standard_normal(x.shape).astype(np.float32)
    p = v.get("params", {})
    f = _jax_fn(jm, v, train, act)
    ref, vjp = jax.vjp(f, x, p.get("scale"), p.get("bias"))
    rx, rw, rb = vjp(jnp.asarray(g))
    xt = _t(x).requires_grad_()
    y, (a, b) = _torch_op(xt, v, norm, train, act, groups)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)
    wanted = [xt] + [t for t in (a, b) if t is not None]
    got = torch.autograd.grad(y, wanted, _t(g))
    if norm == "batch" and not train:
        # the operator's inputs are the folded coef / off: chain them to
        # scale and bias as the fold does (coef = r * w, off = b - m * r * w)
        r = 1 / np.sqrt(v["batch_stats"]["var"] + 1e-5)
        gc, go = got[1].numpy(), got[2].numpy()
        got = [got[0], _t(gc * r - go * v["batch_stats"]["mean"] * r), _t(go)]
    refs = [rx] + ([] if norm == "instance" else [rw, rb])
    for t, r_ in zip(got, refs):
        r_ = np.asarray(r_)
        np.testing.assert_allclose(t.detach().numpy(), r_, rtol=GTOL,
                                   atol=GTOL * float(np.abs(r_).max()))


@pytest.mark.parametrize("act", ["gelu", "relu"])
def test_running_statistics(rng, act):
    """A train call's running mean and unbiased variance (the module, and the
    operator's statistics put through the same update) equal the JAX
    package's; under ``recomputing()`` they stay as they were."""
    C = 16
    x, jm, v = _setup(rng, "batch", C, 4)
    _, mut = jm.apply(v, x, train=True, mutable=["batch_stats"])
    tm = tl.Norm2d("batch", C)
    tm.load_state_dict({"weight": _t(v["params"]["scale"]), "bias": _t(v["params"]["bias"]),
                        "running_mean": _t(v["batch_stats"]["mean"]),
                        "running_var": _t(v["batch_stats"]["var"])}, strict=True)
    tm.train()
    with tl.recomputing():
        tm(_t(x), act=act)
    np.testing.assert_array_equal(tm.running_mean.numpy(), v["batch_stats"]["mean"])
    np.testing.assert_array_equal(tm.running_var.numpy(), v["batch_stats"]["var"])
    tm(_t(x), act=act)
    want_m, want_v = mut["batch_stats"]["mean"], mut["batch_stats"]["var"]
    np.testing.assert_allclose(tm.running_mean.numpy(), want_m, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tm.running_var.numpy(), want_v, rtol=RTOL, atol=ATOL)
    # the operator's mean and clamped variance, as Norm2d reads them on the card
    _, mvn, _, _ = U.norm_act(_t(x), _t(v["params"]["scale"]), _t(v["params"]["bias"]),
                              tn.KINDS["batch"], 4, tn.ACTS[act], tn.REDUCE_NONE)
    n = x.size // C
    rm = 0.9 * _t(v["batch_stats"]["mean"]) + 0.1 * mvn[:C]
    rv = 0.9 * _t(v["batch_stats"]["var"]) + 0.1 * mvn[C:2 * C] * (n / (n - 1))
    np.testing.assert_allclose(rm.numpy(), want_m, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(rv.numpy(), want_v, rtol=RTOL, atol=ATOL)


def _mbconv(norm):
    torch.manual_seed(0)
    m = tb.MBConv(16, 16, expansion=2, norm=norm, n_groups=4)
    tl.init_weights(m, torch.Generator().manual_seed(3))
    return m


def test_export_group_norm_mbconv_on_the_operators(rng, monkeypatch):
    """The eval MBConv of the paper encoder (group norms) exported with its
    norms on the operators: the graph holds them (traced through their fake
    implementations) and the program's output equals the module's."""
    monkeypatch.setattr(tl, "norm_act", tn.norm_act_operator)
    m = _mbconv("group").eval()
    x = _t(rng.standard_normal((2, 8, 8, 16)))
    with torch.no_grad():
        ref = m(x)
    ep = torch.export.export(m, (x,), strict=False)
    names = [str(n.target) for n in ep.graph.nodes if n.op == "call_function"]
    assert sum("uncrtaints.norm_act" in s for s in names) == 4, names
    with torch.no_grad():
        got = ep.module()(x)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("norm", ["group", "batch"])
def test_mbconv_train_step_on_the_operators(rng, monkeypatch, norm):
    """A train-mode MBConv (the encoder's group norms, the decoder's batch
    norms) through the operators' route against the eager route: output
    within 1e-5 and every parameter's gradient within 1e-4 of its largest
    element (of the largest of all where it is zero in exact arithmetic);
    the running statistics agree."""
    x = _t(rng.standard_normal((2, 8, 8, 16)))
    g = _t(rng.standard_normal((2, 8, 8, 16)))
    outs = []
    for route in ("eager", "operators"):
        if route == "operators":
            monkeypatch.setattr(tl, "norm_act", tn.norm_act_operator)
            monkeypatch.setattr(tl, "affine_act", tn.affine_act_operator)
        m = _mbconv(norm).train()
        y = m(x)
        names, params = zip(*m.named_parameters())
        grads = torch.autograd.grad(y, params, g)
        outs.append((y.detach(), grads, [b.clone() for b in m.buffers()]))
    (y0, g0, b0), (y1, g1, b1) = outs
    np.testing.assert_allclose(y1.numpy(), y0.numpy(), rtol=RTOL, atol=ATOL)
    # the PreNorm's bias ahead of a batch norm (through the bias-free pw1)
    # has a gradient of zero in exact arithmetic: rounding noise on both routes
    noise = {"conv.norm.bias"} if norm == "batch" else set()
    top = max(float(b.abs().max()) for b in g0)
    for name, a, b in zip(names, g1, g0):
        scale = top if name in noise else float(b.abs().max())
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=GTOL, atol=GTOL * scale,
                                   err_msg=name)
    for a, b in zip(b1, b0):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=RTOL, atol=ATOL)



@pytest.mark.parametrize("case", range(7))
def test_opcheck(rng, case):
    """``torch.library.opcheck`` of the four operators on their CPU
    implementations (the twins): schema, fake shapes, the registered
    backward, AOT dispatch; bf16 maps with bf16 parameters as the train step
    hands them."""
    bf = torch.bfloat16
    x = lambda dt=torch.float32: _t(rng.standard_normal((2, 3, 4, 8))).to(dt).requires_grad_()
    v = lambda dt=torch.float32: _t(rng.standard_normal(8)).to(dt).requires_grad_()
    cases = [(U.norm_act.default, (x(), v(), v(), tn.KINDS["batch"], 4, tn.ACTS["gelu"], 0)),
             (U.norm_act.default, (x(bf), v(bf), v(bf), tn.KINDS["group"], 4, tn.ACTS["relu"],
                                   0)),
             (U.norm_act.default, (x(), None, None, tn.KINDS["instance"], 4, tn.ACTS["none"], 0)),
             (U.norm_affine_act.default, (x(), v(), v(), None, None, tn.ACTS["relu"])),
             (U.norm_affine_act.default, (x(bf), v(bf), v(bf), None, None, tn.ACTS["gelu"])),
             (U.norm_act.default, (x(bf), v(bf), v(bf), tn.KINDS["batch_f32"], 4,
                                   tn.ACTS["leaky_relu"], 0)),
             (U.norm_affine_act.default, (x(bf), v().abs().detach().requires_grad_(), v(),
                                          v(bf), v(bf), tn.ACTS["leaky_relu"]))]
    op, args = cases[case]
    torch.library.opcheck(op, args)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_unet3d_batch_norm_matches_jax(rng, train):
    """UNet3D's batch norm (kind ``batch_f32``: flax's BatchNorm, the affine
    in fp32) with its LeakyReLU on the operators' twins against the JAX
    package's ``BatchNorm3d`` + ``leaky_relu(0.01)``: output within 1e-5,
    the gradients of x, scale and bias against ``jax.vjp`` within 1e-4 of
    the largest."""
    from uncrtaints_tpu.models import unet3d as ju
    C = 16
    x = (rng.standard_normal((2, 4, 5, 6, C)) * 2 + 1).astype(np.float32)
    g = rng.standard_normal(x.shape).astype(np.float32)
    jm = ju.BatchNorm3d()
    v = jax.tree.map(np.asarray, flax.core.unfreeze(jm.init(jax.random.PRNGKey(1), x)))
    scale = (rng.standard_normal(C) + 1).astype(np.float32)
    bias = rng.standard_normal(C).astype(np.float32)
    stats = {"mean": rng.standard_normal(C).astype(np.float32),
             "var": (rng.random(C) + 0.5).astype(np.float32)}

    def f(x, scale, bias):
        p = {"params": {"BatchNorm_0": {"scale": scale, "bias": bias}},
             "batch_stats": {"BatchNorm_0": stats}}
        y = (jm.apply(p, x, train=True, mutable=["batch_stats"])[0] if train
             else jm.apply(p, x, train=False))
        return jax.nn.leaky_relu(y, 0.01)

    ref, vjp = jax.vjp(f, x, scale, bias)
    refs = vjp(jnp.asarray(g))
    xt, wt, bt = (_t(a).requires_grad_() for a in (x, scale, bias))
    if train:
        y = U.norm_act(xt, wt, bt, tn.KINDS["batch_f32"], 4, tn.ACTS["leaky_relu"],
                       tn.REDUCE_NONE)[0]
    else:
        r = torch.rsqrt(_t(stats["var"]) + 1e-5)
        y = U.norm_affine_act(xt, r, _t(stats["mean"]), wt, bt, tn.ACTS["leaky_relu"])
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)
    got = torch.autograd.grad(y, [xt, wt, bt], _t(g))
    for t, r_ in zip(got, refs):
        r_ = np.asarray(r_)
        np.testing.assert_allclose(t.numpy(), r_, rtol=GTOL, atol=GTOL * float(np.abs(r_).max()))


def test_unet3d_block_on_the_operators(rng, monkeypatch):
    """A UNet3D encoder block ([Conv3d, BatchNorm3d, LeakyReLU] x 2) in
    train mode through the operators' route against the eager route:
    output within 1e-5, every gradient within 1e-4 of its largest element
    (of the largest of all for the conv biases ahead of a batch norm, zero
    in exact arithmetic), the running statistics within 1e-5."""
    from uncrtaints_tpu_torch.models import layers as tl3
    from uncrtaints_tpu_torch.models import unet3d as tu
    x = _t(rng.standard_normal((2, 4, 6, 6, 8)))
    g = _t(rng.standard_normal((2, 4, 6, 6, 16)))
    outs = []
    for route in ("eager", "operators"):
        if route == "operators":
            monkeypatch.setattr(tu, "norm_act", tn.norm_act_operator)
            monkeypatch.setattr(tu, "affine_act", tn.affine_act_operator)
        torch.manual_seed(0)
        blk = tu.conv3d_block(8, 16, 16)
        tl3.init_weights(blk, torch.Generator().manual_seed(5))
        y = tl3.run_fused(blk.train(), x)
        names, params = zip(*blk.named_parameters())
        grads = torch.autograd.grad(y, params, g)
        outs.append((y.detach(), grads, [b.clone() for b in blk.buffers()]))
    (y0, g0, b0), (y1, g1, b1) = outs
    np.testing.assert_allclose(y1.numpy(), y0.numpy(), rtol=RTOL, atol=ATOL)
    top = max(float(b.abs().max()) for b in g0)
    for name, a, b in zip(names, g1, g0):
        scale = top if name.endswith(("0.bias", "3.bias")) else float(b.abs().max())
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=GTOL, atol=GTOL * scale,
                                   err_msg=name)
    for a, b in zip(b1, b0):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=RTOL, atol=ATOL)


# The one-pass rule (ops/norm.py:onchip_plan) as a pure function of the call
# and the card: an H100's 132 SMs and 227 KB of shared memory a block
H100 = dict(sms=132, smem=232448)
BF, F32 = 2, 4
# (kind, frames, rows, channels, groups, itemsize, backward): per-frame norms
# of the benchmark's cells and a few others that take one pass: every
# forward within the budget; backwards of a few waves
ONCHIP = {"paper enc 256 gelu": ("group", 48, 256 * 256, 256, 4, BF, False),
          "paper in_conv 128": ("group", 48, 256 * 256, 128, 4, BF, False),
          "U-TAE 64": ("group", 192, 256 * 256, 64, 4, BF, False),
          "U-TAE 64 at 64^2": ("group", 192, 64 * 64, 64, 4, BF, False),
          "U-TAE 64 at 32^2 backward": ("group", 192, 32 * 32, 64, 4, BF, True),
          "U-TAE 128 at 32^2 backward": ("group", 192, 32 * 32, 128, 4, BF, True),
          "FPN 32": ("group", 48, 256 * 256, 32, 4, BF, False),
          "FPN 160": ("group", 48, 256 * 256, 160, 4, BF, False),
          "instance": ("instance", 16, 128 * 128, 64, 4, BF, False),
          "instance backward": ("instance", 16, 128 * 128, 64, 4, BF, True),
          "fp32 frame": ("group", 12, 128 * 128, 64, 4, F32, False),
          "fp32 frame backward": ("group", 12, 128 * 128, 64, 4, F32, True),
          "one small frame": ("group", 1, 9 * 7, 64, 4, BF, False),
          "one small frame backward": ("group", 1, 9 * 7, 64, 4, BF, True)}


@pytest.mark.parametrize("case", list(ONCHIP))
def test_onchip_plan_takes_per_frame_norms(case):
    """Per-frame norms whose slab of whole groups fits the card take one
    pass, under a plan the kernels can run: whole groups of 16-byte row
    pieces a slab, at most one block an SM, every row of a slab covered,
    each block's rows (backward: g's and x's) in its shared memory."""
    kind, Fr, P, C, G, size, bwd = ONCHIP[case]
    plan = tn.onchip_plan(kind, Fr, P, C, G, size, tn.REDUCE_NONE, **H100, backward=bwd)
    assert plan is not None
    cg = 1 if kind == "instance" else C // G
    assert plan.W % cg == 0 and C % plan.W == 0 and (plan.W * size) % 16 == 0
    assert plan.W <= tn._ONCHIP_THREADS
    assert 1 <= plan.K <= Fr * (C // plan.W) and plan.K * plan.bps <= H100["sms"]
    assert plan.rpb * plan.bps >= P and plan.rpb * (plan.bps - 1) < P
    assert tn._onchip_smem_bytes(plan.rpb, plan.W, size, bwd) <= H100["smem"]


def test_onchip_plan_of_the_paper_step():
    """The paper step's group norms: slabs of one 64-channel group (256
    channels) or two 32-channel groups (128 channels), 128-byte row pieces,
    three slabs a wave over 44 blocks forward; the backward's waves would
    hold one slab each, so it takes two passes."""
    plan = lambda C, bwd: tn.onchip_plan("group", 48, 65536, C, 4, BF, tn.REDUCE_NONE, **H100,
                                         backward=bwd)
    for C in (256, 128):
        assert plan(C, False) == tn.OnchipPlan(W=64, K=3, bps=44, rpb=1490)
        assert plan(C, True) is None  # 96-192 waves of one slab: two passes


# (kind, frames, rows, channels, groups, itemsize, reduce): two passes
TWO_PASS = {"batch": ("batch", 1, 48 * 65536, 256, 256, BF, tn.REDUCE_NONE),
            "batch_f32": ("batch_f32", 1, 4 * 4 * 65536, 32, 32, BF, tn.REDUCE_NONE),
            "the affine form": ("affine", 1, 16 * 65536, 128, 128, BF, tn.REDUCE_NONE),
            "a spatial split": ("group", 48, 128 * 256, 256, 4, BF, tn.REDUCE_SPATIAL),
            "a data-parallel batch norm": ("batch", 1, 65536, 128, 128, BF, tn.REDUCE_WORLD),
            "the 1024^2 scene frame": ("group", 3, 1024 * 1024, 256, 4, BF, tn.REDUCE_NONE),
            "rows off 16 bytes": ("group", 12, 65536, 20, 4, BF, tn.REDUCE_NONE),
            "fp32 rows off 16 bytes": ("instance", 2, 64, 10, 10, F32, tn.REDUCE_NONE),
            "an unknown dtype size": ("group", 12, 65536, 64, 4, 1, tn.REDUCE_NONE)}
# (kind, frames, rows, channels, groups, itemsize): backwards within the
# budget whose many waves make one pass the slower
MANY_WAVES = {"paper enc 256": ("group", 48, 256 * 256, 256, 4, BF),
              "paper in_conv 128": ("group", 48, 256 * 256, 128, 4, BF),
              "U-TAE 64": ("group", 192, 256 * 256, 64, 4, BF),
              "U-TAE 64 at 64^2": ("group", 192, 64 * 64, 64, 4, BF),
              "FPN 32": ("group", 48, 256 * 256, 32, 4, BF)}


@pytest.mark.parametrize("case", list(TWO_PASS))
@pytest.mark.parametrize("bwd", [False, True], ids=["forward", "backward"])
def test_onchip_plan_sends_the_rest_to_two_passes(case, bwd):
    kind, Fr, P, C, G, size, reduce = TWO_PASS[case]
    assert tn.onchip_plan(kind, Fr, P, C, G, size, reduce, **H100, backward=bwd) is None


@pytest.mark.parametrize("case", list(MANY_WAVES))
def test_onchip_plan_sends_backwards_of_many_waves_to_two_passes(case):
    kind, Fr, P, C, G, size = MANY_WAVES[case]
    assert tn.onchip_plan(kind, Fr, P, C, G, size, tn.REDUCE_NONE, **H100) is not None
    assert tn.onchip_plan(kind, Fr, P, C, G, size, tn.REDUCE_NONE, **H100, backward=True) is None


def test_onchip_plan_small_waves_take_two_passes():
    """A card whose blocks hold less: forward waves of one 8.4 MB slab (a
    64-channel frame) take two passes; a single such wave takes one."""
    small = dict(H100, smem=100 * 1024)
    plan = lambda Fr: tn.onchip_plan("group", Fr, 65536, 64, 4, BF, tn.REDUCE_NONE, **small)
    assert plan(48) is None
    assert plan(1) is not None and plan(1).K == 1


def test_onchip_plan_fpn_mid_conv_backward_over_budget():
    """The FPN's 160-channel frame: its forward's slab of x fits (one pass),
    its backward's x and fp32 g' do not, in any whole groups of 128-byte row
    pieces: two passes."""
    plan = lambda bwd: tn.onchip_plan("group", 48, 65536, 160, 4, BF, tn.REDUCE_NONE, **H100,
                                      backward=bwd)
    assert plan(False) == tn.OnchipPlan(W=160, K=1, bps=132, rpb=497)
    assert plan(True) is None


@pytest.mark.parametrize("bwd", [False, True], ids=["forward", "backward"])
def test_onchip_plan_budget_edge(bwd):
    """A frame of one group one row over what the card's blocks hold goes
    to two passes; at the budget, one pass over every SM."""
    C = 64
    cap = ((H100["smem"] - tn._onchip_smem_bytes(0, C, BF, bwd))
           // tn._onchip_row_bytes(C, BF, bwd))
    plan = lambda P: tn.onchip_plan("group", 4, P, C, 1, BF, tn.REDUCE_NONE, **H100,
                                    backward=bwd)
    assert plan(cap * H100["sms"]) == tn.OnchipPlan(W=C, K=1, bps=H100["sms"], rpb=cap)
    assert plan(cap * H100["sms"] + 1) is None
    small = dict(H100, sms=66, smem=116224)  # half the SMs, half the shared memory
    assert tn.onchip_plan("group", 1, cap * H100["sms"] // 8, C, 1, BF, tn.REDUCE_NONE,
                          **small, backward=bwd) is not None
    assert tn.onchip_plan("group", 1, cap * H100["sms"], C, 1, BF, tn.REDUCE_NONE, **small,
                          backward=bwd) is None


# ------------------------------------- the group-norm MBConv's passes --

def _gn_inputs(rng, Fr=3, H=5, W=6, C=16, G=4, dtype=torch.float32):
    x = _t(rng.standard_normal((Fr, H, W, C)) * 1.5 + 0.5).to(dtype)
    w = _t(1.0 + 0.3 * rng.standard_normal(C))
    b = _t(0.3 * rng.standard_normal(C))
    return x, w, b


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_group_moments_and_affine_equal_k6s_finalize(rng, dtype):
    """norm_stats, group_moments and group_affine (the chain's pieces of a
    group norm) give K6's twins' coef and off, and with norm_apply K6's
    group norm itself, bit for bit."""
    x, w, b = _gn_inputs(rng, dtype=dtype)
    w, b = w.to(dtype), b.to(dtype)  # the parameters in the compute dtype, as the eval step
    Fr, H, W, C = x.shape
    sums = tn.norm_stats(x, 4)
    assert sums.shape == (2, Fr, 4) and sums.dtype == torch.float32
    torch.testing.assert_close(sums, tn.stats_twin(x.view(Fr, H * W, C), 4), rtol=0, atol=0)
    m, r = tn.group_moments(sums, H * W * C // 4)
    coef, off = tn.group_affine(m, r, w, b, dtype)
    cf, of, mvn = tn.finalize_twin(sums, H * W * C // 4, w, b, tn.KINDS["group"], C, dtype)
    assert torch.equal(coef, cf) and torch.equal(off, of)
    assert torch.equal(m.reshape(-1), mvn[:Fr * 4])
    assert torch.equal(r, torch.rsqrt(mvn[Fr * 4:2 * Fr * 4].view(Fr, 4) + tn.EPS))
    y = tn.norm_apply(x, coef, off)
    want, _, _, _ = tn.norm_act_twin(x, w, b, tn.KINDS["group"], 4, tn.ACTS["none"])
    assert y.dtype == dtype and torch.equal(y, want)


@pytest.mark.parametrize("G", [4, 2])
def test_gelu_pool_twin_matches_the_eager_formula(rng, G):
    """The squeeze-and-excitation's pooled sum of the group chain, fp32:
    the operator (on the CPU its twin, K3's prologue ((x - m) * r) * scale +
    bias) against the eager formula gelu(x * coef + off).sum over the pixels
    with the norm's folded per-(frame, channel) coef and off in fp32, within
    1e-5 of the largest sum's scale; and the twin of the same fp32 terms
    summed in another order."""
    x, w, b = _gn_inputs(rng, G=G)
    Fr, H, W, C = x.shape
    m, r = tn.group_moments(tn.norm_stats(x, G), H * W * C // G)
    got = tn.norm_gelu_pool(x, m, r, w, b)
    assert got.shape == (Fr, C) and got.dtype == torch.float32
    cg = C // G
    cf = r.repeat_interleave(cg, -1) * w
    of = b - m.repeat_interleave(cg, -1) * cf
    want = torch.nn.functional.gelu(x * cf[:, None, None, :] + of[:, None, None, :]).sum(
        dim=(1, 2))
    scale = float(torch.nn.functional.gelu(x * cf[:, None, None, :]
                                           + of[:, None, None, :]).abs().sum(dim=(1, 2)).max())
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5 * scale)
    twin = tn.gelu_pool_twin(x.view(Fr, H * W, C), m, r, w, b)
    assert torch.equal(got, twin)


def test_group_chain_passes_refuse_bad_input(rng):
    x, w, b = _gn_inputs(rng)
    with pytest.raises(ValueError, match="groups"):
        tn.norm_stats(x, 5)
    with pytest.raises(ValueError, match=r"\[F, \.\.\., C\]"):
        tn.norm_stats(x[0, 0], 4)
    m, r = tn.group_moments(tn.norm_stats(x, 4), 5 * 6 * 4)
    with pytest.raises(ValueError, match=r"\[3, 4\]"):
        tn.norm_gelu_pool(x, m[:2], r[:2], w, b)
    with pytest.raises(ValueError, match="coef and off"):
        tn.norm_apply(x, w.expand(3, 16), b.expand(3, 16).bfloat16())


@pytest.mark.parametrize("case", range(4))
def test_opcheck_group_chain_passes(rng, case):
    """``torch.library.opcheck`` of the group chain's three passes on their
    CPU implementations (the twins): schema, fake shapes, AOT dispatch; bf16
    and fp32 maps."""
    bf = torch.bfloat16
    x32, w, b = _gn_inputs(rng)
    x16 = x32.to(bf)
    m, r = tn.group_moments(tn.stats_twin(x32.view(3, 30, 16), 4), 30 * 4)
    coef, off = tn.group_affine(m, r, w, b, bf)
    cases = [(U.norm_stats.default, (x16, 4)),
             (U.norm_stats.default, (x32, 2)),
             (U.norm_gelu_pool.default, (x16, m, r, w, b)),
             (U.norm_apply.default, (x16, coef, off))]
    op, args = cases[case]
    torch.library.opcheck(op, args)
