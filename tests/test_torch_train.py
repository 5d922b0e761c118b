"""The port's train path against the JAX package's, on the CPU.

Gradients of each differentiated module (the depthwise Function and the
reflect Conv2d, the aggregator, MBConv, L-TAE, the norms, the MGNLL loss)
against ``jax.grad`` of the JAX module on the same weights and inputs, the
attention dropout's law, and the whole train step against
``uncrtaints_tpu.train.make_train_step`` at fp32 and small widths (32,
n_head 4, d_model 64, T=3) with weights carried by ``from_jax_variables``.
Inputs come from a numpy seed and go to both frameworks as numpy arrays.
The first step's gradients of the recipe and of each variant are finite
and zero only where exact arithmetic makes them zero.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import flax
import jax
import jax.numpy as jnp

from uncrtaints_tpu.config import Config, derive

from uncrtaints_tpu_torch.models import get_generator
from uncrtaints_tpu_torch.models import layers as tl
from uncrtaints_tpu_torch.models.jax_bridge import from_jax_variables, jax_to_torch_names
from uncrtaints_tpu_torch.train import (
    batch_to_device, create_train_state, epoch_lr, make_train_step, set_learning_rate)

from test_torch_variants import VARIANTS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _np(t):
    return t.detach().float().numpy()


def _close_to_max(got, ref, frac, floor=0.0):
    """max |got - ref| <= frac * max(max |ref|, floor) (one tensor)."""
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err, top = np.abs(got - ref).max(), np.abs(ref).max()
    assert err <= frac * max(top, floor), (err, top)


def _rounding_zero(grads):
    """Names of the gradients that are zero in exact arithmetic and only
    rounding noise in fp32: at most 1e-6 of the largest gradient. (A bias
    whose shift the next norm subtracts again, e.g. a batch-norm PreNorm's
    bias before the bias-free pw1 conv and its batch norm, or the L-TAE
    biases whose shift is constant over T under the softmax over T; measured
    at 1e-8 of the largest gradient, against 1e-3 for the smallest real
    one.)"""
    gmax = max(np.abs(np.asarray(g)).max() for g in grads.values())
    return {n for n, g in grads.items() if np.abs(np.asarray(g)).max() <= 1e-6 * gmax}, gmax


# ------------------------------------------------- depthwise conv grads --

@pytest.mark.parametrize("pads", [((0, 0), (0, 0)), ((1, 1), (1, 1)), ((1, 0), (0, 1))],
                         ids=["valid", "same", "asymmetric"])
def test_depthwise_function_matches_jax_vjp(rng, pads):
    """The K5 operator with its backward (plain versions of K5/K2 on the CPU) against jax.grad
    of lax.conv with the same zero pads: value and (gx, gw)."""
    N, H, W, C = 2, 9, 8, 16
    x = rng.standard_normal((N, H, W, C)).astype(np.float32)
    w = rng.standard_normal((3, 3, 1, C)).astype(np.float32)          # HWIO
    (pt, pb), (pl, pr) = pads
    cot = rng.standard_normal((N, H + pt + pb - 2, W + pl + pr - 2, C)).astype(np.float32)

    def f(x_, w_):
        y = jax.lax.conv_general_dilated(
            x_, w_, (1, 1), [tuple(pads[0]), tuple(pads[1])],
            dimension_numbers=("NHWC", "HWIO", "NHWC"), feature_group_count=C,
            precision=jax.lax.Precision.HIGHEST)
        return (y * cot).sum(), y

    (_, ref), (rgx, rgw) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x), jnp.asarray(w))
    tx = _t(x).requires_grad_()
    tw = _t(np.transpose(w, (3, 2, 0, 1))).requires_grad_()
    y = tl.dw_stencil(tx, tw.contiguous(), pads)
    (y * _t(cot)).sum().backward()
    _close_to_max(_np(y), ref, 1e-6)
    _close_to_max(_np(tx.grad), rgx, 1e-6)
    _close_to_max(_np(tw.grad), np.transpose(np.asarray(rgw), (3, 2, 0, 1)), 1e-6)


@pytest.mark.parametrize("hw", [(8, 8), (7, 10)])
def test_reflect_depthwise_conv2d_grads_match_jax(rng, hw):
    """Conv2d(groups=C, padding_mode='reflect'): the port's 5-D reflect pad
    and the K5 operator against jax.grad of the JAX Conv2d (zero-SAME conv
    plus border strips, each with its custom VJP)."""
    from uncrtaints_tpu.models import layers as jl
    C = 16
    x = rng.standard_normal((2, *hw, C)).astype(np.float32)
    cot = rng.standard_normal((2, *hw, C)).astype(np.float32)
    jm = jl.Conv2d(C, kernel=3, pad=1, padding_mode="reflect", use_bias=False, groups=C)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))

    def f(params, x_):
        y = jm.apply({"params": params}, x_)
        return (y * cot).sum(), y

    (_, ref), (gp, gx) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        v["params"], jnp.asarray(x))
    tm = tl.Conv2d(C, C, kernel=3, pad=1, padding_mode="reflect", bias=False, groups=C)
    tm.load_state_dict({"weight": _t(np.transpose(np.asarray(v["params"]["kernel"]),
                                                  (3, 2, 0, 1)))})
    tx = _t(x).requires_grad_()
    y = tm(tx)
    assert y.grad_fn is not None
    (y * _t(cot)).sum().backward()
    _close_to_max(_np(y), ref, 1e-6)
    _close_to_max(_np(tx.grad), gx, 1e-6)
    _close_to_max(_np(tm.weight.grad),
                  np.transpose(np.asarray(gp["kernel"]), (3, 2, 0, 1)), 1e-6)


def _graph_nodes(fn):
    """Names of every node of the autograd graph below ``fn``."""
    seen, stack, names = set(), [fn], []
    while stack:
        node = stack.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        names.append(type(node).__name__)
        stack.extend(n for n, _ in node.next_functions)
    return names


def _pads(names):
    """The pad nodes among ``names``: ATen's pads, and K7's reflect pad."""
    return [n for n in names if "Pad" in n or "reflect_pad" in n]


def test_depthwise_routing(rng):
    """Differentiated depthwise convs go through the K5 operator (dw_stencil); no-grad
    ones (the eval path) and grouped non-depthwise ones stay F.conv2d. The
    differentiated 3x3 reflect conv makes no padded tensor: its graph holds
    no pad node, other padding modes and the non-depthwise conv still pad."""
    tm = tl.Conv2d(8, 8, kernel=3, pad=1, groups=8, bias=False)
    x = _t(rng.standard_normal((1, 5, 5, 8)))
    y = tm(x)
    assert "dw_stencil" in type(y.grad_fn).__name__
    assert y.grad_fn.mode == "reflect"
    assert not _pads(_graph_nodes(y.grad_fn))
    assert not _pads(_graph_nodes(tm(x.clone().requires_grad_()).grad_fn))
    with torch.no_grad():
        assert tm(x).grad_fn is None
    grouped = tl.Conv2d(8, 8, kernel=3, pad=1, groups=4, bias=False)
    nodes = _graph_nodes(grouped(x.clone().requires_grad_()).grad_fn)
    assert "dw_stencil" not in type(grouped(x).grad_fn).__name__
    assert _pads(nodes)
    other = tl.Conv2d(8, 8, kernel=3, pad=1, groups=8, bias=False, padding_mode="replicate")
    yo = other(x.clone().requires_grad_())
    assert "dw_stencil" in type(yo.grad_fn).__name__ and yo.grad_fn.mode == "zeros"
    assert _pads(_graph_nodes(yo.grad_fn))


@pytest.mark.parametrize("hw", [(8, 8), (7, 10), (3, 5), (2, 2)])
def test_reflect_depthwise_function_matches_jax_and_autograd(rng, hw):
    """The K5 operator in reflect mode (the plain versions of K5 forward, the
    folded adjoint and K2 on the unpadded x): value, gx and gw against
    jax.grad of the JAX package's fused reflect conv _dw_reflect3x3 and
    against torch autograd through an explicit F.pad and F.conv2d."""
    import torch.nn.functional as F
    from uncrtaints_tpu.models import layers as jl
    C = 16
    x = rng.standard_normal((2, *hw, C)).astype(np.float32)
    w = rng.standard_normal((3, 3, 1, C)).astype(np.float32)          # HWIO
    cot = rng.standard_normal((2, *hw, C)).astype(np.float32)

    def f(x_, w_):
        y = jl._dw_reflect3x3(x_, w_)
        return (y * cot).sum(), y

    (_, ref), (rgx, rgw) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x), jnp.asarray(w))
    wt = np.ascontiguousarray(np.transpose(w, (3, 2, 0, 1)))           # [C,1,3,3]
    tx, tw = _t(x).requires_grad_(), _t(wt).requires_grad_()
    y = tl.dw_stencil(tx, tw, ((1, 1), (1, 1)), "reflect")
    (y * _t(cot)).sum().backward()
    _close_to_max(_np(y), ref, 1e-6)
    _close_to_max(_np(tx.grad), rgx, 1e-6)
    _close_to_max(_np(tw.grad), np.transpose(np.asarray(rgw), (3, 2, 0, 1)), 1e-6)

    ax, aw = _t(x).requires_grad_(), _t(wt).requires_grad_()
    xp = F.pad(ax.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect")
    ay = F.conv2d(xp, aw, groups=C).permute(0, 2, 3, 1)
    (ay * _t(cot)).sum().backward()
    _close_to_max(_np(y), _np(ay), 1e-6)
    _close_to_max(_np(tx.grad), _np(ax.grad), 1e-6)
    _close_to_max(_np(tw.grad), _np(aw.grad), 1e-6)


# ------------------------------------------------------ module gradients --

def _grads_close(named_torch_grads, jax_grads_by_torch_name, frac=1e-4):
    """Each gradient within frac of its own largest element; gradients that
    are zero up to rounding (:func:`_rounding_zero`) must be so on both
    sides."""
    assert set(named_torch_grads) == set(jax_grads_by_torch_name)
    zero, gmax = _rounding_zero(jax_grads_by_torch_name)
    for k, g in named_torch_grads.items():
        if k in zero:
            assert np.abs(_np(g)).max() <= 1e-6 * gmax, k
        else:
            _close_to_max(_np(g), jax_grads_by_torch_name[k], frac)


# batch-norm statistics are of order 1; a running mean that is zero in exact
# arithmetic (the batch mean after a zero-bias norm and a bias-free conv) is
# rounding noise, so the statistics' bound is 1e-5 of max(|stat|, 1)
STATS_FLOOR = 1.0


def test_aggregator_grads_match_jax(rng):
    """att_group with attention upsampled 8 -> 32 and a pad frame, at
    train=False (JAX applies no dropout there): the port's K1 Function and
    the upsample against jax.grad of the JAX aggregator (its XLA form)."""
    from uncrtaints_tpu.models.aggregator import TemporalAggregator as JAgg
    from uncrtaints_tpu_torch.models.aggregator import TemporalAggregator
    x = rng.standard_normal((2, 3, 32, 32, 16)).astype(np.float32)
    a = rng.random((2, 3, 8, 8, 4)).astype(np.float32)
    cot = rng.standard_normal((2, 32, 32, 16)).astype(np.float32)
    pad = np.array([[False, False, False], [False, True, False]])
    jm = JAgg(mode="att_group")
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), pad_mask=jnp.asarray(pad),
                attn_mask=jnp.asarray(a))

    def f(x_, a_):
        return (jm.apply(v, x_, pad_mask=jnp.asarray(pad), attn_mask=a_) * cot).sum()

    rgx, rga = jax.grad(f, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(a))
    tx, ta = _t(x).requires_grad_(), _t(a).requires_grad_()
    out = TemporalAggregator("att_group").eval()(tx, pad_mask=torch.from_numpy(pad),
                                                 attn_mask=ta)
    (out * _t(cot)).sum().backward()
    _close_to_max(_np(tx.grad), rgx, 1e-6)
    _close_to_max(_np(ta.grad), rga, 1e-5)


def test_attention_dropout_law_and_generator():
    from uncrtaints_tpu_torch.models.aggregator import attention_dropout
    a = torch.full((4, 3, 64, 64, 4), 0.5)
    p = 0.1
    y1 = attention_dropout(a, p, torch.Generator().manual_seed(7))
    y2 = attention_dropout(a, p, torch.Generator().manual_seed(7))
    y3 = attention_dropout(a, p, torch.Generator().manual_seed(8))
    assert torch.equal(y1, y2) and not torch.equal(y1, y3)
    kept = y1 != 0
    # kept values are scaled by 1/(1-p)
    assert torch.equal(y1[kept], torch.full_like(y1[kept], 0.5 / (1 - p)))
    # the kept share within 5 standard deviations of the binomial's mean
    n = a.numel()
    share = kept.float().mean().item()
    assert abs(share - (1 - p)) <= 5 * np.sqrt(p * (1 - p) / n), share
    with pytest.raises(ValueError, match="Generator"):
        attention_dropout(a, p, None)


def test_model_dropout_follows_generator():
    """In training the aggregator's dropout (attention upsampled 8 -> 16)
    draws from the generator passed to the model: the same seed gives the
    same output, another seed another one, the global RNG plays no part."""
    cfg = derive(Config(use_sar=True, encoder_widths=[16], decoder_widths=[16],
                        n_head=4, d_model=32, low_res_size=8, compute_dtype="float32"))
    model = get_generator(cfg, "cpu").train()
    x = _t(np.random.default_rng(3).random((1, 3, 16, 16, 15)))
    run = lambda seed: model(x, dropout_generator=torch.Generator().manual_seed(seed))
    torch.manual_seed(0)
    y1 = run(1)
    torch.manual_seed(123)
    y2 = run(1)
    assert torch.equal(y1, y2) and not torch.equal(y1, run(2))
    with pytest.raises(ValueError, match="Generator"):
        model(x)


def _block_table(variables, norm, C, block="in_block0", prefix="in_block.0."):
    table = jax_to_torch_names(Config(encoder_norm=norm, decoder_norm=norm,
                                      encoder_widths=[C], decoder_widths=[C]))
    flat = {}
    for coll, tag in (("params", ""), ("batch_stats", "B:")):
        for path, leaf in flax.traverse_util.flatten_dict(
                flax.core.unfreeze(variables.get(coll, {})), sep="/").items():
            flat[f"{tag}{block}/{path}"] = (table[f"{tag}{block}/{path}"][0][len(prefix):],
                                            table[f"{tag}{block}/{path}"][1], leaf)
    return flat


@pytest.mark.parametrize("norm", ["batch", "group"])
def test_mbconv_train_grads_match_jax(rng, norm):
    """MBConv's standard body in train mode (batch statistics, depthwise
    Function): value, parameter and input gradients, and the updated
    batch-norm statistics."""
    from uncrtaints_tpu.models.blocks import MBConv as JMB
    from uncrtaints_tpu_torch.models.blocks import MBConv
    C = 16
    x = rng.standard_normal((2, 3, 8, 8, C)).astype(np.float32)
    cot = rng.standard_normal(x.shape).astype(np.float32)
    jm = JMB(C, C, expansion=2, norm=norm)
    v = flax.core.unfreeze(jm.init(jax.random.PRNGKey(0), jnp.asarray(x), False))
    bs = v.get("batch_stats", {})

    def f(params, x_):
        y, mut = jm.apply({"params": params, "batch_stats": bs}, x_, True,
                          mutable=["batch_stats"])
        return (y * cot).sum(), (y, mut)

    (_, (ref, mut)), (gp, gx) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        v["params"], jnp.asarray(x))
    table = _block_table(v, norm, C)
    tm = MBConv(C, C, expansion=2, norm=norm).train()
    tm.load_state_dict({tn: _t(tf(np.asarray(leaf))) for tn, tf, leaf in table.values()},
                       strict=True)
    tx = _t(x).requires_grad_()
    y = tm(tx)
    (y * _t(cot)).sum().backward()
    _close_to_max(_np(y), ref, 1e-5)
    _close_to_max(_np(tx.grad), gx, 1e-4)
    flat_g = flax.traverse_util.flatten_dict(flax.core.unfreeze(gp), sep="/")
    _grads_close({n: p.grad for n, p in tm.named_parameters()},
                 {table[f"in_block0/{k}"][0]: table[f"in_block0/{k}"][1](np.asarray(g))
                  for k, g in flat_g.items()})
    if norm == "batch":
        new = flax.traverse_util.flatten_dict(flax.core.unfreeze(mut["batch_stats"]), sep="/")
        sd = tm.state_dict()
        for k, val in new.items():
            _close_to_max(_np(sd[table[f"B:in_block0/{k}"][0]]), val, 1e-5, STATS_FLOOR)


def test_ltae_grads_match_jax(rng):
    from uncrtaints_tpu.models.ltae import LTAE2dtiny as JLTAE
    from uncrtaints_tpu_torch.models.ltae import LTAE2dtiny
    x = rng.standard_normal((2, 3, 4, 5, 16)).astype(np.float32)
    pos = rng.integers(0, 1500, (2, 3)).astype(np.float32)
    pad = np.array([[False, False, False], [False, False, True]])
    cot = rng.standard_normal((2, 3, 4, 5, 4)).astype(np.float32)
    jm = JLTAE(in_channels=16, n_head=4, d_k=4, d_model=32)
    v = jm.init(jax.random.PRNGKey(3), jnp.asarray(x), batch_positions=jnp.asarray(pos))

    def f(params, x_):
        return (jm.apply({"params": params}, x_, batch_positions=jnp.asarray(pos),
                         pad_mask=jnp.asarray(pad)) * cot).sum()

    gp, gx = jax.grad(f, argnums=(0, 1))(v["params"], jnp.asarray(x))
    p = v["params"]
    tr = lambda a: _t(np.asarray(a).T)
    tm = LTAE2dtiny(in_channels=16, n_head=4, d_k=4, d_model=32)
    tm.load_state_dict({
        "in_norm.weight": _t(p["GroupNormCT_0"]["scale"]),
        "in_norm.bias": _t(p["GroupNormCT_0"]["bias"]),
        "inconv.weight": tr(p["inconv"]["kernel"])[..., None],
        "inconv.bias": _t(p["inconv"]["bias"]),
        "attention_heads.Q": _t(p["Q"]),
        "attention_heads.fc1_k.weight": tr(p["fc1_k"]["kernel"]),
        "attention_heads.fc1_k.bias": _t(p["fc1_k"]["bias"])}, strict=True)
    tx = _t(x).requires_grad_()
    (tm(tx, batch_positions=_t(pos), pad_mask=torch.from_numpy(pad)) * _t(cot)).sum().backward()
    _close_to_max(_np(tx.grad), gx, 1e-4)
    _grads_close({n: q.grad for n, q in tm.named_parameters()}, {
        "in_norm.weight": gp["GroupNormCT_0"]["scale"],
        "in_norm.bias": gp["GroupNormCT_0"]["bias"],
        "inconv.weight": np.asarray(gp["inconv"]["kernel"]).T[..., None],
        "inconv.bias": gp["inconv"]["bias"],
        "attention_heads.Q": gp["Q"],
        "attention_heads.fc1_k.weight": np.asarray(gp["fc1_k"]["kernel"]).T,
        "attention_heads.fc1_k.bias": gp["fc1_k"]["bias"]})


@pytest.mark.parametrize("covmode", ["diag", "iso"])
def test_mgnll_grads_match_jax(rng, covmode):
    from uncrtaints_tpu.losses import calc_loss as jcalc, get_loss as jget
    from uncrtaints_tpu_torch.losses import calc_loss, get_loss
    cfg = Config(loss="MGNLL", covmode=covmode)
    pred = rng.standard_normal((2, 1, 6, 5, 13)).astype(np.float32)
    targ = rng.standard_normal(pred.shape).astype(np.float32)
    # some variances below eps: the no-grad clamp is exercised
    var = (rng.random((2, 1, 6, 5, 1 if covmode == "iso" else 13)) - 0.05).astype(np.float32)
    f = lambda p_, v_: jcalc(jget(cfg), cfg, p_, jnp.asarray(targ), var=v_)[0]
    rgp, rgv = jax.grad(f, argnums=(0, 1))(jnp.asarray(pred), jnp.asarray(var))
    tp, tv = _t(pred).requires_grad_(), _t(var).requires_grad_()
    calc_loss(get_loss(cfg), cfg, tp, _t(targ), var=tv)[0].backward()
    _close_to_max(_np(tp.grad), rgp, 1e-5)
    _close_to_max(_np(tv.grad), rgv, 1e-5)


# ------------------------------------------------------ whole train step --

LR = 1e-3


def _cfg(**kw):
    # patch size = low_res_size: no attention upsample, so neither side
    # applies dropout and the two steps see the same noise (none)
    return derive(Config(use_sar=True, scale_by=10.0, encoder_widths=[32],
                         decoder_widths=[32, 32], n_head=4, d_model=64,
                         low_res_size=16, compute_dtype="float32", lr=LR,
                         batch_size=2, **kw))


def _batch(rng, raw: bool):
    B, T, H = 2, 3, 16
    dates = rng.integers(0, 1500, (B, T)).astype(np.float32)
    if raw:
        return {"x_s1": rng.random((B, T, H, H, 2)).astype(np.float32),
                "x_s2dn": rng.integers(0, 12000, (B, T, H, H, 13)).astype(np.uint16),
                "y_dn": rng.integers(0, 12000, (B, 1, H, H, 13)).astype(np.uint16),
                "dates": dates}
    return {"x": rng.random((B, T, H, H, 15)).astype(np.float32),
            "y": rng.random((B, 1, H, H, 13)).astype(np.float32), "dates": dates}


@pytest.fixture(scope="module")
def jax_state():
    """The JAX train state (non-trivial batch-norm statistics) as numpy."""
    from uncrtaints_tpu.models import get_generator as jax_generator
    from uncrtaints_tpu.train import create_train_state
    cfg = _cfg()
    rng = np.random.default_rng(0)
    st = create_train_state(cfg, jax_generator(cfg), jax.random.PRNGKey(0),
                            {k: jnp.asarray(v) for k, v in _batch(rng, False).items()})
    bs = jax.tree.map(lambda a: np.abs(rng.standard_normal(a.shape)).astype(np.float32)
                      * 0.3 + 0.5, st.batch_stats)
    return st.replace(batch_stats=bs)


def _fresh(st):
    """A copy of the JAX state whose buffers a donating step may consume."""
    return jax.tree.map(lambda a: jnp.array(np.asarray(a)), st)


def _flat(tree, tag=""):
    return {f"{tag}{k}": np.asarray(v) for k, v in flax.traverse_util.flatten_dict(
        flax.core.unfreeze(tree), sep="/").items()}


def _to_torch_names(cfg, flat):
    table = jax_to_torch_names(cfg)
    return {table[k][0]: table[k][1](v) for k, v in flat.items()}


def _jax_grads(cfg, st, batch, k):
    """jax.grad of the JAX step's loss (microbatches of the accumulating
    step in order, batch statistics carried), mean over microbatches."""
    from uncrtaints_tpu.losses import calc_loss, get_loss
    from uncrtaints_tpu.train.engine import _cast_for_forward, _prepare_xy, _split_out
    x, y, _ = _prepare_xy(cfg, batch)
    dates = batch["dates"]
    crit = get_loss(cfg)

    def loss_fn(params, bs, xm, ym, dm):
        fp, xc = _cast_for_forward(cfg, params, xm)
        out, mut = st.apply_fn({"params": fp, "batch_stats": bs}, xc, batch_positions=dm,
                               train=True, mutable=["batch_stats"])
        mean, var = _split_out(out.astype(jnp.float32), cfg)
        return calc_loss(crit, cfg, mean, ym, var=var)[0], mut["batch_stats"]

    gfn = jax.value_and_grad(loss_fn, has_aux=True)
    bs, gsum, m = st.batch_stats, None, x.shape[0] // k
    for i in range(k):
        sl = slice(i * m, (i + 1) * m)
        (_, bs), g = gfn(st.params, bs, x[sl], y[sl], dates[sl])
        gsum = g if gsum is None else jax.tree.map(jnp.add, gsum, g)
    return jax.tree.map(lambda a: a / k, gsum)


def _port_state(cfg, st):
    model = get_generator(cfg, "cpu")
    model.load_state_dict(from_jax_variables(
        {"params": st.params, "batch_stats": st.batch_stats}, cfg), strict=True)
    return create_train_state(cfg, model)


def _compare_steps(cfg, st0, batch, k=1, mask=None, lr=None):
    """One JAX step and one port step from the same weights; the bounds of
    the port's train-step parity."""
    from uncrtaints_tpu.train import make_train_step as jax_step, set_learning_rate as jax_lr
    jb = {kk: jnp.asarray(v) for kk, v in batch.items()}
    ts = _port_state(cfg, st0)
    p_before = {n: p.detach().clone() for n, p in ts.model.named_parameters()}
    ref_g = _to_torch_names(cfg, _flat(_jax_grads(cfg, _fresh(st0), jb, k)))
    jst = _fresh(st0)
    if mask is not None:
        table = jax_to_torch_names(cfg)
        jst = jst.replace(freeze_mask=flax.traverse_util.unflatten_dict(
            {tuple(p.split("/")): jnp.asarray(mask[table[p][0]], jnp.float32)
             for p in _flat(st0.params)}))
        ts.freeze_mask = mask
    if lr is not None:
        jst = jax_lr(jst, lr)
        set_learning_rate(ts, lr)
    jnew, jaux = jax_step(cfg)(jst, jb, jax.random.PRNGKey(1))
    ts, aux = make_train_step(cfg)(ts, batch_to_device(batch, "cpu"))
    assert ts.step == 1 and int(jnew.step) == 1

    rel = abs(float(aux["loss"]) / float(jaux["loss"]) - 1)
    assert rel <= 1e-5, rel
    for key in ("pred", "var"):
        d = _np(aux[key]) - np.asarray(jaux[key])
        assert np.sqrt((d ** 2).mean()) <= 1e-5 * np.abs(np.asarray(jaux[key])).max(), key
    _grads_close(aux["grads"], ref_g, 1e-4)
    for name, val in _to_torch_names(cfg, _flat(jnew.batch_stats, "B:")).items():
        _close_to_max(_np(ts.model.state_dict()[name]), val, 1e-5, STATS_FLOOR)
    mu = _to_torch_names(cfg, _flat(jnew.opt_state.inner_state[0].mu))
    nu = _to_torch_names(cfg, _flat(jnew.opt_state.inner_state[0].nu))
    new_p = _to_torch_names(cfg, _flat(jnew.params))
    eff_lr = LR if lr is None else lr
    zero, _ = _rounding_zero(ref_g)
    for n, p in ts.model.named_parameters():
        if n in zero:  # Adam's first step is lr * sign(rounding noise)
            continue
        _close_to_max(_np(ts.opt_state.mu[n]), mu[n], 1e-4)
        _close_to_max(_np(ts.opt_state.nu[n]), nu[n], 1e-4)
        g = np.abs(ref_g[n])
        big = g > 1e-3 * g.max()
        assert (np.abs(_np(p) - new_p[n])[big] <= 1e-3 * eff_lr).all(), n
    return ts, p_before


@pytest.mark.parametrize("raw", [False, True], ids=["processed", "raw_dn"])
def test_train_step_matches_jax(jax_state, raw):
    _compare_steps(_cfg(), jax_state, _batch(np.random.default_rng(1), raw))


def test_train_step_accum_matches_jax(jax_state):
    """accum_steps=2: two microbatches in order, the mean gradient, one
    update, batch statistics carried per microbatch."""
    _compare_steps(_cfg(accum_steps=2), jax_state, _batch(np.random.default_rng(2), False),
                   k=2)


def test_train_step_freeze_mask_and_lr_match_jax(jax_state):
    """Only the output head trains: frozen parameters stay as they were,
    their moments still update (optax semantics), the rest matches the JAX
    step. The learning rate is the ExponentialLR value of epoch 2."""
    from uncrtaints_tpu.train import epoch_lr as jax_epoch_lr
    cfg = _cfg(gamma=0.8)
    assert epoch_lr(cfg, 2) == pytest.approx(jax_epoch_lr(cfg, 2), rel=1e-12)
    assert epoch_lr(cfg, 2) == pytest.approx(LR * 0.64, rel=1e-12)
    names = list(_port_state(cfg, jax_state).model.state_dict())
    mask = {n: 1.0 if n.startswith("out_conv") else 0.0 for n in names}
    ts, before = _compare_steps(cfg, jax_state, _batch(np.random.default_rng(3), False),
                                mask=mask, lr=epoch_lr(cfg, 2))
    assert ts.tx.lr == pytest.approx(LR * 0.64)
    for n, p in ts.model.named_parameters():
        if mask[n]:
            assert not torch.equal(p, before[n]), n
        else:
            assert torch.equal(p, before[n]), n
            assert ts.opt_state.nu[n].abs().max() > 0, n


@pytest.mark.parametrize("name", ["paper", *VARIANTS])
def test_first_step_gradients_are_finite_and_zero_only_where_exact(name):
    """The first train step's gradients of the recipe and of each variant:
    finite, and non-zero but where exact arithmetic makes them zero
    (``chip_smoke.exact_zero_gradients``; there rounding leaves noise or an
    exact zero)."""
    from chip_smoke import exact_zero_gradients
    cfg = _cfg(**VARIANTS.get(name, {}))
    rng = np.random.default_rng(0)
    B, T, H = 2, cfg.input_t, 16
    batch = {"x": rng.random((B, T, H, H, 15)).astype(np.float32),
             "y": rng.random((B, 1, H, H, 13)).astype(np.float32),
             "dates": rng.integers(0, 1500, (B, T)).astype(np.float32)}
    model = get_generator(cfg, "cpu", generator=torch.Generator().manual_seed(0))
    state = create_train_state(cfg, model)
    _, aux = make_train_step(cfg)(state, batch_to_device(batch, "cpu"),
                                  torch.Generator().manual_seed(1))
    zero_ok = exact_zero_gradients(model)
    assert zero_ok <= set(aux["grads"])
    bad = sorted(n for n, g in aux["grads"].items()
                 if not bool(torch.isfinite(g).all()) or (float(g.abs().max()) == 0
                                                         and n not in zero_ok))
    assert not bad and bool(torch.isfinite(aux["loss"]))


def test_train_step_runs_without_jax():
    """The port's train step in a process where JAX is never imported."""
    code = (
        "import sys, torch\n"
        "from uncrtaints_tpu_torch.config import Config, derive\n"
        "from uncrtaints_tpu_torch.data import SyntheticSEN12MSCRTS, collate_multi\n"
        "from uncrtaints_tpu_torch.models import get_generator\n"
        "from uncrtaints_tpu_torch.train import (batch_to_device, create_train_state,\n"
        "                                        make_train_step)\n"
        "cfg = derive(Config(use_sar=True, scale_by=10.0, encoder_widths=[16],\n"
        "             decoder_widths=[16], n_head=4, d_model=32, low_res_size=8))\n"
        "ds = SyntheticSEN12MSCRTS(n_samples=2, patch_size=16)\n"
        "b = batch_to_device(collate_multi([ds[0], ds[1]]), 'cpu')\n"
        "st = create_train_state(cfg, get_generator(cfg, 'cpu'))\n"
        "st, aux = make_train_step(cfg)(st, b, torch.Generator().manual_seed(0))\n"
        "assert torch.isfinite(aux['loss']) and st.step == 1\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr[-2000:]
