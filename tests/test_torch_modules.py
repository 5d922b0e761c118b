"""The port's modules against the JAX package's, on the CPU: layers, L-TAE,
the temporal aggregator and the MBConv block (standard and fused bodies).

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
