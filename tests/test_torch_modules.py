"""The port's modules against the JAX package's, on the CPU: layers, the
two L-TAEs, the temporal aggregator, the MBConv block (standard and fused
bodies) and the residual conv block.

Both sides get the same weights: the JAX module is initialised, its
variables are converted with the port's layout transforms and loaded into
the port's module, and the same numpy input goes through both. fp32 cases
hold rtol 1e-5 (only the order of fp32 sums differs); the bf16 MBConv case
holds the JAX package's own fused-vs-standard tolerance.
"""

import numpy as np
import pytest
import torch

import flax
import jax
import jax.numpy as jnp

from uncrtaints_tpu.config import Config
from uncrtaints_tpu.models import layers as jl

from uncrtaints_tpu_torch.models import layers as tl
from uncrtaints_tpu_torch.models.jax_bridge import jax_to_torch_names


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _np(t):
    return t.detach().float().numpy()


def _close(got, ref, rtol=1e-5, atol=1e-5):
    np.testing.assert_allclose(_np(got), np.asarray(ref, np.float32), rtol=rtol, atol=atol)


def _hwio(k):
    return _t(np.transpose(np.asarray(k), (3, 2, 0, 1)))


# --------------------------------------------------------------- layers --

@pytest.mark.parametrize("kernel,groups,bias,affine", [
    (3, 1, True, False),    # reflect 3x3
    (3, 8, False, False),   # reflect depthwise 3x3
    (3, 8, False, True),    # depthwise with a folded input affine
    (1, 1, True, True),     # 1x1 with bias and a folded input affine
])
def test_conv2d(rng, kernel, groups, bias, affine):
    C, O = 8, 8 if groups > 1 else 6
    x = rng.standard_normal((2, 7, 9, C)).astype(np.float32)
    jm = jl.Conv2d(O, kernel=kernel, pad=kernel // 2, use_bias=bias, groups=groups)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    aff = None
    if affine:
        aff = (rng.standard_normal(C).astype(np.float32),
               rng.standard_normal(C).astype(np.float32))
    ref = jm.apply(v, jnp.asarray(x),
                   input_affine=None if aff is None else tuple(map(jnp.asarray, aff)))
    tm = tl.Conv2d(C, O, kernel=kernel, pad=kernel // 2, bias=bias, groups=groups)
    sd = {"weight": _hwio(v["params"]["kernel"])}
    if bias:
        sd["bias"] = _t(v["params"]["bias"])
    tm.load_state_dict(sd, strict=True)
    got = tm(_t(x), input_affine=None if aff is None else tuple(map(_t, aff)))
    _close(got, ref)


def _norm_state(v, norm):
    sd = {}
    if norm in ("batch", "group"):
        sd = {"weight": _t(v["params"]["scale"]), "bias": _t(v["params"]["bias"])}
    if norm == "batch":
        sd.update(running_mean=_t(v["batch_stats"]["mean"]),
                  running_var=_t(v["batch_stats"]["var"]))
    return sd


@pytest.mark.parametrize("norm,train", [("batch", False), ("batch", True),
                                        ("group", False), ("instance", False)])
def test_norm2d(rng, norm, train):
    C = 8
    x = (rng.standard_normal((3, 5, 6, C)) * 2 + 1).astype(np.float32)
    jm = jl.Norm2d(norm, n_groups=4)
    v = jm.init(jax.random.PRNGKey(1), jnp.asarray(x))
    v = jax.tree.map(np.asarray, flax.core.unfreeze(v))
    if norm == "batch":
        v["batch_stats"]["mean"] = rng.standard_normal(C).astype(np.float32)
        v["batch_stats"]["var"] = rng.random(C).astype(np.float32) + 0.5
    tm = tl.Norm2d(norm, C, n_groups=4)
    tm.load_state_dict(_norm_state(v, norm), strict=True)
    tm.train(train)
    if train:
        ref, mut = jm.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"])
    else:
        ref = jm.apply(v, jnp.asarray(x))
    _close(tm(_t(x)), ref)
    if train:
        _close(tm.running_mean, mut["batch_stats"]["mean"])
        _close(tm.running_var, mut["batch_stats"]["var"])


def test_conv_block_refills_pad_frames(rng):
    x = rng.standard_normal((2, 3, 6, 6, 15)).astype(np.float32)
    x[1, 2] = 0.0  # an all-pad frame
    jm = jl.ConvBlock([15, 16], pad_value=0.0, norm="group", k=1, s=1, p=0)
    v = jm.init(jax.random.PRNGKey(2), jnp.asarray(x))
    ref = jm.apply(v, jnp.asarray(x))
    p = v["params"]["ConvLayer_0"]
    tm = tl.ConvBlock([15, 16], pad_value=0.0, norm="group", k=1, s=1, p=0)
    tm.load_state_dict({
        "conv.conv.0.weight": _hwio(p["Conv2d_0"]["kernel"]),
        "conv.conv.0.bias": _t(p["Conv2d_0"]["bias"]),
        "conv.conv.1.weight": _t(p["Norm2d_0"]["scale"]),
        "conv.conv.1.bias": _t(p["Norm2d_0"]["bias"])}, strict=True)
    got = tm(_t(x))
    assert float(got[1, 2].detach().abs().max()) == 0.0
    _close(got, ref)


def test_activations(rng):
    x = (rng.standard_normal(4096) * 10).astype(np.float32)
    _close(tl.gelu(_t(x)), jl.gelu(jnp.asarray(x)))
    _close(tl.softplus_t20(_t(x)), jl.softplus_t20(jnp.asarray(x)))


# ----------------------------------------------------------------- ltae --

def test_positional_encoding_table(rng):
    from uncrtaints_tpu.models.ltae import positional_encoding_table as jpe
    from uncrtaints_tpu_torch.models.ltae import positional_encoding_table
    pos = rng.integers(0, 1500, (2, 4)).astype(np.float32)
    _close(positional_encoding_table(_t(pos), 16, repeat=4),
           jpe(jnp.asarray(pos), 16, repeat=4))


@pytest.mark.parametrize("d", [1, 5])
def test_positional_encoding_table_odd_width(rng, d):
    """An odd width (d_model // n_head of a U-TAE with 16 heads and d_model
    16): sin on the even channels, cos on the odd ones, as the JAX package's
    docstring and its odd-width branch intend (its jnp.stack of the unequal
    halves raises before that branch; ROADMAP section 3)."""
    from uncrtaints_tpu_torch.models.ltae import positional_encoding_table
    pos = rng.integers(0, 1500, (2, 4)).astype(np.float32)
    i = np.arange(d)
    table = pos[..., None] / np.power(1000.0, 2.0 * (i // 2) / d).astype(np.float32)
    want = np.where(i % 2 == 0, np.sin(table), np.cos(table))
    got = positional_encoding_table(_t(pos), d, repeat=3)
    assert got.shape == (2, 4, 3 * d)
    np.testing.assert_allclose(got.numpy(), np.tile(want, 3), rtol=1e-5, atol=1e-6)


def test_ltae2dtiny(rng):
    from uncrtaints_tpu.models.ltae import LTAE2dtiny as JLTAE
    from uncrtaints_tpu_torch.models.ltae import LTAE2dtiny
    x = rng.standard_normal((2, 3, 4, 5, 16)).astype(np.float32)
    pos = rng.integers(0, 1500, (2, 3)).astype(np.float32)
    pad = np.array([[False, False, False], [False, False, True]])
    jm = JLTAE(in_channels=16, n_head=4, d_k=4, d_model=32)
    v = jm.init(jax.random.PRNGKey(3), jnp.asarray(x), batch_positions=jnp.asarray(pos))
    ref = jm.apply(v, jnp.asarray(x), batch_positions=jnp.asarray(pos),
                   pad_mask=jnp.asarray(pad))
    p = v["params"]
    tm = LTAE2dtiny(in_channels=16, n_head=4, d_k=4, d_model=32)
    tm.load_state_dict({
        "in_norm.weight": _t(p["GroupNormCT_0"]["scale"]),
        "in_norm.bias": _t(p["GroupNormCT_0"]["bias"]),
        "inconv.weight": _t(np.asarray(p["inconv"]["kernel"]).T[..., None]),
        "inconv.bias": _t(p["inconv"]["bias"]),
        "attention_heads.Q": _t(p["Q"]),
        "attention_heads.fc1_k.weight": _t(np.asarray(p["fc1_k"]["kernel"]).T),
        "attention_heads.fc1_k.bias": _t(p["fc1_k"]["bias"])}, strict=True)
    got = tm(_t(x), batch_positions=_t(pos), pad_mask=torch.from_numpy(pad))
    assert got.shape == (2, 3, 4, 5, 4)
    _close(got, ref)


# ----------------------------------------------------------- aggregator --

@pytest.mark.parametrize("mode,att_hw", [
    ("att_group", (4, 4)),    # attention upsampled to the features
    ("att_group", (8, 8)),    # same resolution
    ("att_group", (16, 16)),  # attention average-pooled down
    ("att_mean", (4, 4)),
    ("mean", (4, 4)),
])
def test_temporal_aggregator(rng, mode, att_hw):
    from uncrtaints_tpu.models.aggregator import TemporalAggregator as JAgg
    from uncrtaints_tpu_torch.models.aggregator import TemporalAggregator
    x = rng.standard_normal((2, 3, 8, 8, 16)).astype(np.float32)
    a = rng.random((2, 3, *att_hw, 4)).astype(np.float32)
    a /= a.sum(axis=1, keepdims=True)
    pad = np.array([[False, False, False], [False, True, False]])
    jm = JAgg(mode=mode)
    args = dict(pad_mask=jnp.asarray(pad), attn_mask=jnp.asarray(a))
    ref = jm.apply(jm.init(jax.random.PRNGKey(0), jnp.asarray(x), **args),
                   jnp.asarray(x), **args)
    tm = TemporalAggregator(mode=mode).eval()
    got = tm(_t(x), pad_mask=torch.from_numpy(pad), attn_mask=_t(a))
    _close(got, ref)


# --------------------------------------------------------------- MBConv --

def _mbconv_state(variables, norm, C):
    """The bridge's table for an encoder block, re-rooted at the block."""
    table = jax_to_torch_names(Config(encoder_norm=norm, encoder_widths=[C]))
    flat = {}
    for coll, tag in (("params", ""), ("batch_stats", "B:")):
        for path, leaf in flax.traverse_util.flatten_dict(
                flax.core.unfreeze(variables.get(coll, {})), sep="/").items():
            flat[f"{tag}in_block0/{path}"] = leaf
    return {table[k][0][len("in_block.0."):]: _t(table[k][1](np.asarray(v)))
            for k, v in flat.items()}


def _jax_mbconv(rng, C, norm, x, fused=False):
    from uncrtaints_tpu.models.blocks import MBConv as JMB
    jm = JMB(C, C, expansion=2, norm=norm, fused_eval=fused)
    v = flax.core.unfreeze(jm.init(jax.random.PRNGKey(0), x, False))
    if "batch_stats" in v:  # non-trivial running stats, so the folds matter
        v["batch_stats"] = jax.tree.map(
            lambda a: jnp.abs(jnp.asarray(rng.standard_normal(a.shape).astype(np.float32)) * 0.3) + 0.5,
            v["batch_stats"])
    return jm, v


@pytest.mark.parametrize("norm", ["batch", "group"])
def test_mbconv_fp32(rng, norm):
    from uncrtaints_tpu_torch.models.blocks import MBConv
    C = 16
    x = rng.standard_normal((2, 3, 8, 8, C)).astype(np.float32)
    jm, v = _jax_mbconv(rng, C, norm, jnp.asarray(x))
    ref = jm.apply(v, jnp.asarray(x), False)
    tm = MBConv(C, C, expansion=2, norm=norm).eval()
    tm.load_state_dict(_mbconv_state(v, norm, C), strict=True)
    _close(tm(_t(x)), ref, atol=1e-4)


@pytest.mark.parametrize("fused", [False, True])
def test_mbconv_bf16_against_jax(rng, fused):
    """C=128, 16x16 in bf16 (tests/test_pallas_kernels.py's fused-eval
    case): the port's body against the JAX body of the same kind. Bound:
    the JAX package's fused-vs-standard tolerance, max 0.02 and RMSE 5e-3 of
    max|y| (bf16 activations; JAX's bf16 GELU uses a tanh-form erf)."""
    from uncrtaints_tpu_torch.models.blocks import MBConv
    C = 128
    xb = jnp.asarray(rng.standard_normal((2, 3, 16, 16, C)).astype(np.float32)).astype(jnp.bfloat16)
    jm, v = _jax_mbconv(rng, C, "batch", xb, fused=fused)
    vb = {"params": jax.tree.map(lambda p: p.astype(jnp.bfloat16), v["params"]),
          "batch_stats": v["batch_stats"]}
    ref = np.asarray(jm.apply(vb, xb, False), np.float32)
    tm = MBConv(C, C, expansion=2, norm="batch", fused_eval=fused).eval()
    tm.load_state_dict(_mbconv_state(vb, "batch", C), strict=True)
    for p in tm.parameters():
        p.data = p.data.bfloat16()
    got = _np(tm(_t(xb.astype(jnp.float32)).bfloat16()))
    d = np.abs(got - ref)
    assert d.max() <= 0.02 * np.abs(ref).max()
    assert np.sqrt((d ** 2).mean()) <= 5e-3 * np.abs(ref).max()


def test_mbconv_fused_matches_standard_bf16(rng):
    """The port's own fused and standard eval bodies, same weights, bf16."""
    from uncrtaints_tpu_torch.models.blocks import MBConv
    tm = MBConv(128, 128, expansion=2, norm="batch").eval()
    tl.init_weights(tm, torch.Generator().manual_seed(0))
    for b in tm.buffers():
        b.copy_(_t(np.abs(rng.standard_normal(b.shape) * 0.3) + 0.5))
    for p in tm.parameters():
        p.data = p.data.bfloat16()
    x = _t(rng.standard_normal((2, 3, 16, 16, 128))).bfloat16()
    y0 = tm(x).float()
    tm.fused_eval = True
    y1 = tm(x).float()
    d = (y0 - y1).abs()
    assert d.max() <= 0.02 * y0.abs().max()
    assert d.square().mean().sqrt() <= 5e-3 * y0.abs().max()


def test_mbconv_fused_chain_against_jax_standard(rng):
    """The port's fused body (the chain K3 -> K4 -> K3 through the kernels'
    plain versions, bf16) against the JAX package's *standard* eval body on
    the same weights: the JAX package's fused-vs-standard gate, max 0.02 and
    RMSE 5e-3 of max|y|."""
    from uncrtaints_tpu_torch.models.blocks import MBConv
    from uncrtaints_tpu_torch.ops import norm_gelu_dwconv3x3, norm_gelu_matmul
    C = 128
    xb = jnp.asarray(rng.standard_normal((2, 3, 16, 16, C)).astype(np.float32)).astype(jnp.bfloat16)
    jm, v = _jax_mbconv(rng, C, "batch", xb, fused=False)
    vb = {"params": jax.tree.map(lambda p: p.astype(jnp.bfloat16), v["params"]),
          "batch_stats": v["batch_stats"]}
    ref = np.asarray(jm.apply(vb, xb, False), np.float32)
    tm = MBConv(C, C, expansion=2, norm="batch", fused_eval=True).eval()
    tm.load_state_dict(_mbconv_state(vb, "batch", C), strict=True)
    for p in tm.parameters():
        p.data = p.data.bfloat16()
    calls = []
    hook = tm.conv.fn[3].register_forward_hook(lambda *a: calls.append("conv"))
    got = _np(tm(_t(xb.astype(jnp.float32)).bfloat16()))
    hook.remove()
    assert not calls  # the depthwise conv module is bypassed: K4 does its work
    d = np.abs(got - ref)
    assert d.max() <= 0.02 * np.abs(ref).max()
    assert np.sqrt((d ** 2).mean()) <= 5e-3 * np.abs(ref).max()
    assert norm_gelu_matmul.launches == 0 and norm_gelu_dwconv3x3.launches == 0  # CPU: plain


def _seeded_bf16_mbconv(rng, fused=True):
    from uncrtaints_tpu_torch.models.blocks import MBConv
    tm = MBConv(128, 128, expansion=2, norm="batch", fused_eval=fused).eval()
    tl.init_weights(tm, torch.Generator().manual_seed(0))
    for b in tm.buffers():
        b.copy_(_t(np.abs(rng.standard_normal(b.shape) * 0.3) + 0.5))
    for p in tm.parameters():
        p.data = p.data.bfloat16()
    return tm


def test_mbconv_fused_se_gate_matches_the_eager_expression(rng):
    """The SE gate of the fused body, whose pooled vector K4 sums in its own
    pass (``pool_affine``), against the gate from the eager expression the
    JAX body writes, ``gelu(h2.float() * c2 + o2).mean((1, 2))`` on the
    same h2: 1e-6 (the same fp32 terms summed in another order, then two
    small linears and a sigmoid)."""
    tm = _seeded_bf16_mbconv(rng)
    seen = {}
    se = tm.conv.fn[6]
    hook = se.register_forward_hook(
        lambda mod, args, kwargs, out: seen.update(h2=args[0], mean=kwargs["mean"], gate=out),
        with_kwargs=True)
    with torch.no_grad():
        tm(_t(rng.standard_normal((2, 3, 16, 16, 128))).bfloat16())
        hook.remove()
        c2, o2 = tm.conv.fn[4].fold()
        m2 = torch.nn.functional.gelu(seen["h2"].float() * c2 + o2).mean(dim=(1, 2))
        want = se(seen["h2"], mean=m2, scale_only=True)
    assert seen["mean"].dtype == torch.float32 and seen["mean"].shape == (6, 256)
    np.testing.assert_allclose(_np(seen["mean"]), _np(m2), rtol=0, atol=1e-6)
    np.testing.assert_allclose(_np(seen["gate"]), _np(want), rtol=0, atol=1e-6)


def test_mbconv_fused_body_follows_its_parameters(rng):
    """The fused body rebuilds its bf16 GEMM weights, the [3,3,C] depthwise
    weight and the folded norms on every forward (the eval step hands it
    fresh casts of the parameters each time): a change of a parameter or of
    a running statistic shows in the next forward, to the bit of a module
    built fresh from the same state, also through ``functional_call``."""
    from torch.func import functional_call
    from uncrtaints_tpu_torch.models.blocks import MBConv
    tm = _seeded_bf16_mbconv(rng)
    x = _t(rng.standard_normal((2, 8, 8, 128))).bfloat16()

    def fresh():
        m = MBConv(128, 128, expansion=2, norm="batch", fused_eval=True).eval()
        for p in m.parameters():
            p.data = p.data.bfloat16()
        m.load_state_dict(tm.state_dict())
        return m(x)

    with torch.inference_mode():
        last = tm(x)
        assert torch.equal(tm(x), last)
        changes = (lambda: tm.conv.fn[0].weight.mul_(1.5),          # pw1, in place
                   lambda: tm.conv.fn[3].weight.add_(0.25),         # depthwise, in place
                   lambda: tm.conv.fn[4].running_var.mul_(2.0),     # bn2 statistic
                   lambda: tm.load_state_dict({k: v * 1.25 if k.endswith("fn.8.weight") else v
                                               for k, v in tm.state_dict().items()}))
        for change in changes:
            change()
            y = tm(x)
            assert not torch.equal(y, last)
            assert torch.equal(y, fresh())
            last = y
        # fresh tensors in place of the parameters, as the eval step passes them
        params = {k: (p * 0.5).to(torch.bfloat16) for k, p in tm.named_parameters()}
        y = functional_call(tm, params, (x,))
        assert not torch.equal(y, last) and torch.equal(functional_call(tm, params, (x,)), y)
        assert torch.equal(tm(x), last)


# ---------------------------------------------------- ResidualConvBlock --

def _tree_state(variables, cfg, root_flax, root_torch):
    """The bridge's table for one submodule, re-rooted at it."""
    table = jax_to_torch_names(cfg)
    out = {}
    for coll, tag in (("params", ""), ("batch_stats", "B:")):
        for path, leaf in flax.traverse_util.flatten_dict(
                flax.core.unfreeze(variables.get(coll, {})), sep="/").items():
            name, tf = table[f"{tag}{root_flax}/{path}"]
            out[name[len(root_torch) + 1:]] = _t(tf(np.asarray(leaf)))
    return out


@pytest.mark.parametrize("norm", ["batch", "group"])
def test_residual_conv_block(rng, norm):
    """fp32, rtol/atol 1e-4 (three 3x3 convolutions' fp32 sums reordered);
    an all-pad frame is re-filled."""
    from uncrtaints_tpu.models.blocks import ResidualConvBlock as JRes
    from uncrtaints_tpu_torch.models.blocks import ResidualConvBlock
    C = 16
    x = rng.standard_normal((2, 3, 8, 8, C)).astype(np.float32)
    x[0, 1] = 0.0
    jm = JRes(C, norm=norm, pad_value=0.0)
    v = flax.core.unfreeze(jm.init(jax.random.PRNGKey(0), jnp.asarray(x), False))
    if "batch_stats" in v:
        v["batch_stats"] = jax.tree.map(
            lambda a: jnp.abs(jnp.asarray(rng.standard_normal(a.shape).astype(np.float32)) * 0.3) + 0.5,
            v["batch_stats"])
    ref = jm.apply(v, jnp.asarray(x), False)
    cfg = Config(block_type="residual", encoder_norm=norm, encoder_widths=[C])
    tm = ResidualConvBlock(C, norm=norm, pad_value=0.0).eval()
    tm.load_state_dict(_tree_state(v, cfg, "in_block0", "in_block.0"), strict=True)
    got = tm(_t(x))
    assert float(got[0, 1].detach().abs().max()) == 0.0
    _close(got, ref, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------- LTAE2d --

def _ltae2d_pair(rng, dropout=0.2):
    from uncrtaints_tpu.models.ltae import LTAE2d as JLTAE
    from uncrtaints_tpu_torch.models.ltae import LTAE2d
    x = rng.standard_normal((2, 3, 4, 5, 16)).astype(np.float32)
    pos = rng.integers(0, 1500, (2, 3)).astype(np.float32)
    pad = np.array([[False, False, False], [False, False, True]])
    kw = dict(in_channels=16, n_head=4, d_k=4, d_model=32, mlp=(32, 16),
              dropout=dropout, use_dropout=False)
    jm = JLTAE(**kw)
    v = flax.core.unfreeze(jm.init(jax.random.PRNGKey(3), jnp.asarray(x),
                                   batch_positions=jnp.asarray(pos)))
    v["batch_stats"] = jax.tree.map(
        lambda a: jnp.abs(jnp.asarray(rng.standard_normal(a.shape).astype(np.float32)) * 0.3) + 0.5,
        v["batch_stats"])
    # non-trivial norm affines, so out_norm's per-channel terms matter
    for k in ("in_norm", "out_norm"):
        v["params"][k] = jax.tree.map(
            lambda a: jnp.asarray(rng.standard_normal(a.shape).astype(np.float32)), v["params"][k])
    cfg = Config(use_v=True, encoder_widths=[16], d_model=32, n_head=4)
    tm = LTAE2d(**kw)
    tm.load_state_dict(_tree_state(v, cfg, "temporal_encoder", "temporal_encoder"),
                       strict=True)
    return jm, v, tm, x, pos, pad


def test_ltae2d_eval(rng):
    """Values and attention at fp32, rtol/atol 1e-5 (2e-5 on the values:
    they pass two norms)."""
    jm, v, tm, x, pos, pad = _ltae2d_pair(rng)
    ref, ratt = jm.apply(v, jnp.asarray(x), batch_positions=jnp.asarray(pos),
                         pad_mask=jnp.asarray(pad), train=False)
    got, att = tm.eval()(_t(x), batch_positions=_t(pos), pad_mask=torch.from_numpy(pad))
    assert got.shape == (2, 4, 5, 16) and att.shape == (2, 3, 4, 5, 4)
    _close(att, ratt)
    _close(got, ref, rtol=2e-5, atol=2e-5)


def test_ltae2d_out_norm_is_per_pixel(rng):
    """out_norm normalises each pixel's channel groups on its own: changing
    one pixel's input leaves every other pixel's output as it was."""
    _, _, tm, x, pos, pad = _ltae2d_pair(rng)
    tm.eval()
    a, _ = tm(_t(x), batch_positions=_t(pos))
    x2 = x.copy()
    x2[0, :, 1, 2] += 3.0
    b, _ = tm(_t(x2), batch_positions=_t(pos))
    changed = (a - b).abs().amax(dim=-1) > 0
    assert changed[0, 1, 2] and int(changed.sum()) == 1


def test_ltae2d_train_updates_batch_norm(rng):
    """Train mode with dropout 0: batch statistics over the flattened
    B*H*W pixels, and the updated running statistics (momentum: torch 0.1 =
    flax 0.9; the running variance takes flax's biased batch variance)."""
    jm, v, tm, x, pos, pad = _ltae2d_pair(rng, dropout=0.0)
    (ref, ratt), mut = jm.apply(v, jnp.asarray(x), batch_positions=jnp.asarray(pos),
                                pad_mask=jnp.asarray(pad), train=True,
                                mutable=["batch_stats"])
    got, att = tm.train()(_t(x), batch_positions=_t(pos), pad_mask=torch.from_numpy(pad))
    _close(att, ratt)
    _close(got, ref, rtol=1e-4, atol=1e-4)
    _close(tm.mlp[1].running_mean, mut["batch_stats"]["BatchNorm_0"]["mean"])
    _close(tm.mlp[1].running_var, mut["batch_stats"]["BatchNorm_0"]["var"])


def test_ltae2d_train_dropout_needs_generator(rng):
    _, _, tm, x, pos, _ = _ltae2d_pair(rng, dropout=0.2)
    with pytest.raises(ValueError, match="Generator"):
        tm.train()(_t(x), batch_positions=_t(pos))
    y, _ = tm(_t(x), batch_positions=_t(pos),
              dropout_generator=torch.Generator().manual_seed(0))
    assert torch.isfinite(y).all()
