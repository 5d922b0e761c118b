"""``--remat`` (block recomputation) and ``--debug_nans`` on the port's train
path, on the CPU at fp32 and tiny widths.

Remat runs each UnCRtainTS block under ``torch.utils.checkpoint``: its train
step must equal the plain step (loss, every gradient to 1e-6 of its largest
element, the running statistics after two steps; on one process the two
are bit-equal, as the recompute repeats the same arithmetic), with
``accum_steps=2`` too, and the JAX package's ``remat=True`` step within the
train-step tolerances of ``tests/test_torch_train.py``. The 2 x 2 mesh's
remat step is held in ``tests/test_torch_spatial.py``.

``--debug_nans``: a NaN in the input stops the port's step with a
``FloatingPointError`` naming a module, as the JAX step stops under
``jax_debug_nans``; without the flag both steps finish with a NaN loss.
"""

import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tests"))
from test_torch_train import _batch, _cfg, _compare_steps, _port_state, jax_state  # noqa: E402,F401

from uncrtaints_tpu_torch.config import Config, derive  # noqa: E402
from uncrtaints_tpu_torch.data import SyntheticSEN12MSCRTS, collate_multi  # noqa: E402
from uncrtaints_tpu_torch.models import get_generator  # noqa: E402
from uncrtaints_tpu_torch.models.blocks import MBConv, ResidualConvBlock  # noqa: E402
from uncrtaints_tpu_torch.train import (  # noqa: E402
    batch_to_device, create_train_state, make_eval_step, make_train_step)
from uncrtaints_tpu_torch.train.engine import check_nans  # noqa: E402


def _port_cfg(**kw):
    base = dict(use_sar=True, scale_by=10.0, encoder_widths=[16], decoder_widths=[16, 16],
                n_head=4, d_model=32, low_res_size=8, compute_dtype="float32", device="cpu",
                lr=1e-3)
    base.update(kw)
    return derive(Config(**base))


def _batches():
    """Two batches of 4 samples at 16x16: the attention (8x8) is upsampled,
    so the aggregator's dropout draws (outside the recomputed blocks)."""
    ds = SyntheticSEN12MSCRTS(n_samples=8, patch_size=16, seed=3)
    return [batch_to_device(collate_multi([ds[i] for i in range(j, j + 4)]), "cpu")
            for j in (0, 4)]


def _two_steps(cfg):
    state = create_train_state(cfg, get_generator(cfg))
    step, gen = make_train_step(cfg), torch.Generator().manual_seed(0)
    out = []
    for b in _batches():
        state, aux = step(state, b, gen)
        out.append((float(aux["loss"]), {k: v.clone() for k, v in aux["grads"].items()}))
    return out, {k: v.clone() for k, v in state.model.state_dict().items()}


@pytest.mark.parametrize("kw", [dict(), dict(accum_steps=2), dict(block_type="residual"),
                                dict(decoder_norm="group", use_v=True)],
                         ids=["mbconv", "accum2", "residual", "group_use_v"])
def test_remat_step_equals_the_plain_step(kw):
    """Loss and every gradient of two remat steps, and the parameters and
    running statistics after them, against the plain steps: the recompute
    leaves the batch norms' running statistics as one forward does."""
    plain, plain_sd = _two_steps(_port_cfg(**kw))
    remat, remat_sd = _two_steps(_port_cfg(remat=True, **kw))
    for (lp, gp), (lr, gr) in zip(plain, remat):
        assert lr == pytest.approx(lp, rel=1e-6)
        for n, g in gp.items():
            assert float((gr[n] - g).abs().max()) <= 1e-6 * float(g.abs().max()), n
    assert any("running_mean" in k for k in plain_sd) or kw.get("decoder_norm") == "group"
    for k, v in plain_sd.items():
        assert float((remat_sd[k] - v).abs().max()) <= 1e-6 * max(float(v.abs().max()), 1.0), k


def test_remat_recomputes_each_block_once_in_training_only():
    """A remat train step enters each MBConv forward twice (the step and its
    recompute, which stops once it has what the backward needs: a pre-hook
    counts it), a plain one once; the eval step never recomputes."""
    cfg = _port_cfg(remat=True)
    model = get_generator(cfg)
    assert model.remat and not get_generator(_port_cfg()).remat
    calls = {}
    for name, mod in model.named_modules():
        if isinstance(mod, (MBConv, ResidualConvBlock)):
            mod.register_forward_pre_hook(
                lambda m, a, name=name: calls.__setitem__(name, calls.get(name, 0) + 1))
    b = _batches()[0]
    make_train_step(cfg)(create_train_state(cfg, model), b, torch.Generator().manual_seed(0))
    assert calls == {"in_block.0": 2, "out_block.0": 2, "out_block.1": 2}
    calls.clear()
    make_eval_step(cfg)(model, b)
    assert calls == {"in_block.0": 1, "out_block.0": 1, "out_block.1": 1}


def test_remat_reaches_uncrtaints_only():
    """``remat`` is passed to UnCRtainTS alone, as the JAX registry does."""
    unet = get_generator(_port_cfg(model="unet", encoder_widths=[8, 16],
                                   decoder_widths=[8, 16], remat=True))
    assert not hasattr(unet, "remat")


def test_remat_step_matches_jax(jax_state):
    """The port's remat step against the JAX package's ``remat=True`` step
    (``nn.remat`` of each block) on the same weights: loss, outputs,
    gradients, batch statistics, Adam's moments and the update, within
    ``tests/test_torch_train.py``'s bounds."""
    ts, _ = _compare_steps(_cfg(remat=True), jax_state, _batch(np.random.default_rng(5), False))
    assert ts.model.remat


def _poisoned():
    b = _batch(np.random.default_rng(7), False)
    b["x"][0, 1, 3, 4, 2] = np.nan
    return b


def test_debug_nans_stops_the_step_that_made_a_nan(jax_state):
    """A NaN in one input pixel: without the flag the port's and the JAX
    package's train steps finish with a NaN loss; with it the port raises a
    FloatingPointError naming the first module whose output holds the NaN,
    and the JAX step raises under ``jax_debug_nans`` (restored after)."""
    import jax
    import jax.numpy as jnp
    from test_torch_train import _fresh
    from uncrtaints_tpu.train import make_train_step as jax_step
    cfg, b = _cfg(), _poisoned()
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    _, jaux = jax_step(cfg)(_fresh(jax_state), jb, jax.random.PRNGKey(1))
    assert np.isnan(float(jaux["loss"]))
    before = jax.config.jax_debug_nans
    jax.config.update("jax_debug_nans", True)
    try:  # a step built under the flag (a compiled one would not check)
        with pytest.raises(FloatingPointError, match="nan"):
            jax_step(cfg)(_fresh(jax_state), jb, jax.random.PRNGKey(1))
    finally:
        jax.config.update("jax_debug_nans", before)

    ts = _port_state(cfg, jax_state)
    _, aux = make_train_step(cfg)(ts, batch_to_device(b, "cpu"))
    assert np.isnan(float(aux["loss"]))
    ts = _port_state(cfg, jax_state)
    hooks = check_nans(ts.model)
    with pytest.raises(FloatingPointError, match=r"in_conv\.conv\.conv\.0 \(Conv2d\) holds a NaN"):
        make_train_step(cfg)(ts, batch_to_device(b, "cpu"))
    for h in hooks:
        h.remove()
    _, aux = make_train_step(cfg)(ts, batch_to_device(_batch(np.random.default_rng(8), False),
                                                      "cpu"))
    assert np.isfinite(float(aux["loss"]))


def test_debug_nans_in_the_train_cli(tmp_path, monkeypatch, capsys):
    """``cli.train --debug_nans`` turns on anomaly detection and the module
    checks, says so in one line, and trains a clean run to its end."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    from uncrtaints_tpu_torch.cli import train as cli_train
    from uncrtaints_tpu_torch.config import parse_config
    cfg = derive(parse_config(
        ["--synthetic_data", "--synthetic_patch", "16", "--max_samples_count", "4",
         "--epochs", "1", "--batch_size", "4", "--use_sar", "--scale_by", "10",
         "--encoder_widths", "[16]", "--decoder_widths", "[16]", "--n_head", "4",
         "--d_model", "32", "--device", "cpu", "--res_dir", str(tmp_path / "results"),
         "--experiment_name", "nans", "--debug_nans", "--remat", "--plot_every", "-1",
         "--export_every", "-1"], mode="train"))
    assert cfg.debug_nans and cfg.remat
    before = torch.is_anomaly_enabled()
    try:
        out = cli_train.main(cfg)
        assert torch.is_anomaly_enabled()
    finally:
        torch.autograd.set_detect_anomaly(before)
    assert np.isfinite(out["trainlog"][1]["train_loss"])
    said = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("debug_nans:")]
    assert len(said) == 1 and "anomaly detection" in said[0]
