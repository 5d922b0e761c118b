"""The remaining UnCRtainTS variants of the port against the JAX package's,
on the CPU: residual blocks, the full L-TAE with ``use_v``, the separate
output heads (with and without a variance head), and all three together.

A small model (widths 32, n_head 4, d_model 64, 32x32 patches with
low_res_size 8, T=3) is initialised in JAX with non-trivial batch-norm
statistics and carried over by ``from_jax_variables`` (``strict=True``);
the same numpy batch goes through both eval steps at fp32. Bound: the
repo's whole-model target of 1e-3 RMSE (BASELINE.md); the steps in fact
agree to below 1e-6 (fp32 sums in another order), and 1e-5 is asserted.
"""

import numpy as np
import pytest
import torch

import flax
import jax
import jax.numpy as jnp

from uncrtaints_tpu.config import Config, derive

from uncrtaints_tpu_torch.models import get_generator
from uncrtaints_tpu_torch.models.jax_bridge import from_jax_variables, jax_to_torch_names
from uncrtaints_tpu_torch.train import batch_to_device, make_eval_step

VARIANTS = {
    "residual": dict(block_type="residual"),
    "use_v": dict(use_v=True),
    "separate_out": dict(separate_out=True),
    "separate_out_mean_only": dict(separate_out=True, loss="l2"),
    "all_three": dict(block_type="residual", use_v=True, separate_out=True),
    "mono_use_v": dict(pretrain=True, use_v=True),  # use_v has no effect
}


def _cfg(**kw):
    return derive(Config(use_sar=True, scale_by=10.0, encoder_widths=[32],
                         decoder_widths=[32, 32], n_head=4, d_model=64,
                         low_res_size=8, compute_dtype="float32", **kw))


def _batch(rng, cfg, H=32):
    B, T = 2, cfg.input_t
    x = rng.random((B, T, H, H, 15)).astype(np.float32)
    if T > 1:
        x[1, 2] = 0.0  # an all-pad frame
    return {"x": x, "y": rng.random((B, 1, H, H, 13)).astype(np.float32),
            "dates": rng.integers(0, 1500, (B, T)).astype(np.float32)}


def _pair(cfg, rng, H=32):
    """(JAX state, port model) on one set of weights."""
    from uncrtaints_tpu.models import get_generator as jax_generator
    from uncrtaints_tpu.train import create_train_state
    state = create_train_state(cfg, jax_generator(cfg), jax.random.PRNGKey(0),
                               {k: jnp.asarray(v) for k, v in _batch(rng, cfg, H).items()})
    bs = jax.tree.map(
        lambda a: jnp.asarray(np.abs(rng.standard_normal(a.shape)) * 0.3 + 0.5,
                              jnp.float32), state.batch_stats)
    state = state.replace(batch_stats=bs)
    model = get_generator(cfg, "cpu")
    model.load_state_dict(from_jax_variables(
        {"params": state.params, "batch_stats": state.batch_stats}, cfg), strict=True)
    return state, model


@pytest.mark.parametrize("name", list(VARIANTS))
def test_variant_eval_matches_jax(name):
    from uncrtaints_tpu.train import make_eval_step as jax_eval_step
    cfg, rng = _cfg(**VARIANTS[name]), np.random.default_rng(0)
    state, model = _pair(cfg, rng)
    batch = _batch(np.random.default_rng(1), cfg)
    ref = jax_eval_step(cfg)(state, {k: jnp.asarray(v) for k, v in batch.items()})
    got = make_eval_step(cfg)(model, batch_to_device(batch, "cpu"))
    assert abs(float(got["loss"]) / float(ref["loss"]) - 1) <= 1e-5
    assert ("var" in got) == ("var" in ref) == (cfg.loss == "MGNLL")
    for k in ("pred", "var") if "var" in ref else ("pred",):
        assert got[k].shape == ref[k].shape
        rmse = float(np.sqrt(((got[k].numpy() - np.asarray(ref[k])) ** 2).mean()))
        assert rmse <= 1e-5, (k, rmse)


@pytest.mark.parametrize("name", list(VARIANTS))
def test_variant_bridge_table_matches_torch_import(name):
    """The port's name table is the inverse of torch_import's for every
    variant (a mean-only separate head has no variance conv in either
    model, though torch_import's table lists one)."""
    from uncrtaints_tpu.models.torch_import import uncrtaints_mapping
    cfg = _cfg(**VARIANTS[name])
    ours, theirs = jax_to_torch_names(cfg), uncrtaints_mapping(cfg)
    if name == "separate_out_mean_only":
        theirs = {k: v for k, v in theirs.items() if "out_conv_var_1" not in k}
    assert {k: v[0] for k, v in ours.items()} == {k: v[0] for k, v in theirs.items()}
    assert set(get_generator(cfg, "cpu").state_dict()) == {v[0] for v in ours.values()}


def test_unknown_block_type_rejected():
    with pytest.raises(NotImplementedError):
        get_generator(_cfg(block_type="convnext"), "cpu")


def test_generator_device_defaults_to_the_config():
    """``get_generator(cfg)`` builds on ``cfg.device``: the card by default,
    and it raises where there is none rather than moving to the CPU."""
    from uncrtaints_tpu_torch.config import Config as PortConfig, derive as port_derive
    kw = dict(use_sar=True, encoder_widths=[32], decoder_widths=[32, 32], n_head=4,
              d_model=64, low_res_size=8)
    assert PortConfig().device == "cuda"
    model = get_generator(port_derive(PortConfig(device="cpu", **kw)))
    assert {p.device.type for p in model.parameters()} == {"cpu"}
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            get_generator(port_derive(PortConfig(**kw)))


def test_variant_grads_match_jax():
    """jax.grad of the MGNLL loss of a residual + separate_out model in
    train mode (batch statistics) against the port's autograd, every
    parameter within 1e-4 of its gradient's largest element. patch =
    low_res_size, so neither side draws dropout noise."""
    from uncrtaints_tpu.losses import calc_loss, get_loss
    from uncrtaints_tpu.train.engine import _prepare_xy, _split_out
    from uncrtaints_tpu_torch.train import create_train_state, make_train_step
    cfg = _cfg(block_type="residual", separate_out=True).replace(low_res_size=16)
    rng = np.random.default_rng(0)
    state, model = _pair(cfg, rng, H=16)
    batch = _batch(np.random.default_rng(1), cfg, H=16)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    x, y, _ = _prepare_xy(cfg, jb)
    crit = get_loss(cfg)

    def loss_fn(params):
        out, _ = state.apply_fn({"params": params, "batch_stats": state.batch_stats}, x,
                                batch_positions=jb["dates"], train=True,
                                mutable=["batch_stats"])
        mean, var = _split_out(out.astype(jnp.float32), cfg)
        return calc_loss(crit, cfg, mean, y, var=var)[0]

    loss, g = jax.value_and_grad(loss_fn)(state.params)
    table = jax_to_torch_names(cfg)
    ref = {table[k][0]: table[k][1](np.asarray(v)) for k, v in
           flax.traverse_util.flatten_dict(flax.core.unfreeze(g), sep="/").items()}
    _, aux = make_train_step(cfg)(create_train_state(cfg, model), batch_to_device(batch, "cpu"))
    assert abs(float(aux["loss"]) / float(loss) - 1) <= 1e-5
    assert set(aux["grads"]) == set(ref)
    gmax = max(np.abs(v).max() for v in ref.values())
    for n, got in aux["grads"].items():
        top = np.abs(ref[n]).max()
        if top <= 1e-6 * gmax:  # zero in exact arithmetic: rounding noise on both sides
            assert float(got.abs().max()) <= 1e-6 * gmax, n
        else:
            assert np.abs(got.numpy() - ref[n]).max() <= 1e-4 * top, n


def test_use_v_train_forward_draws_from_generator():
    """In training the full L-TAE's MLP dropout draws from the step's
    generator: the same seed gives the same output, another seed another."""
    cfg = _cfg(use_v=True)
    model = get_generator(cfg, "cpu").train()
    b = batch_to_device(_batch(np.random.default_rng(2), cfg), "cpu")
    run = lambda seed: model(b["x"], batch_positions=b["dates"],
                             dropout_generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        a, a2, c = run(0), run(0), run(1)
    assert torch.equal(a, a2) and not torch.equal(a, c)
