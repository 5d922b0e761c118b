"""The port's serving slice against the JAX package's, on the CPU.

A small UnCRtainTS (encoder/decoder widths 32, n_head 4, d_model 64, 32x32
patches with low_res_size 8, so the attention upsample runs, T=3) is
initialised in JAX with non-trivial batch-norm statistics, converted with
the port's weight bridge, and both eval steps (forward, MGNLL, scale_by
rescale, image metrics) run on the same numpy batch at fp32.
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
from uncrtaints_tpu_torch.models.jax_bridge import from_jax_variables, jax_to_torch_names
from uncrtaints_tpu_torch.train import batch_to_device, make_eval_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfg(**kw):
    return derive(Config(use_sar=True, scale_by=10.0, encoder_widths=[32],
                         decoder_widths=[32, 32], n_head=4, d_model=64,
                         low_res_size=8, compute_dtype="float32", **kw))


def _batch(rng, raw: bool):
    B, T, H = 2, 3, 32
    dates = rng.integers(0, 1500, (B, T)).astype(np.float32)
    if raw:
        # DN codes past the 10000 clip, so the device radiometry clips
        return {"x_s1": rng.random((B, T, H, H, 2)).astype(np.float32),
                "x_s2dn": rng.integers(0, 12000, (B, T, H, H, 13)).astype(np.uint16),
                "y_dn": rng.integers(0, 12000, (B, 1, H, H, 13)).astype(np.uint16),
                "dates": dates}
    x = rng.random((B, T, H, H, 15)).astype(np.float32)
    x[1, 2] = 0.0  # an all-pad frame: the pad mask reaches L-TAE and the aggregator
    return {"x": x, "y": rng.random((B, 1, H, H, 13)).astype(np.float32),
            "dates": dates}


@pytest.fixture(scope="module")
def pair():
    """(cfg, JAX state, port model) sharing one set of weights."""
    from uncrtaints_tpu.models import get_generator as jax_generator
    from uncrtaints_tpu.train import create_train_state
    cfg = _cfg()
    rng = np.random.default_rng(0)
    state = create_train_state(cfg, jax_generator(cfg), jax.random.PRNGKey(0),
                               {k: jnp.asarray(v) for k, v in _batch(rng, False).items()})
    bs = jax.tree.map(
        lambda a: jnp.asarray(np.abs(rng.standard_normal(a.shape)) * 0.3 + 0.5,
                              jnp.float32), state.batch_stats)
    state = state.replace(batch_stats=bs)
    model = get_generator(cfg)
    model.load_state_dict(from_jax_variables(
        {"params": state.params, "batch_stats": state.batch_stats}, cfg), strict=True)
    return cfg, state, model


def _both_steps(pair, batch):
    from uncrtaints_tpu.train import make_eval_step as jax_eval_step
    cfg, state, model = pair
    ref = jax_eval_step(cfg, with_metrics=True)(
        state, {k: jnp.asarray(v) for k, v in batch.items()})
    got = make_eval_step(cfg, with_metrics=True)(model, batch_to_device(batch, "cpu"))
    return ref, got


@pytest.mark.parametrize("raw", [False, True], ids=["processed", "raw_dn"])
def test_eval_step_matches_jax(pair, raw):
    ref, got = _both_steps(pair, _batch(np.random.default_rng(1), raw))
    # the bound: loss rel 1e-5, pred/var RMSE <= 1e-4 (fp32, sums reordered)
    loss_rel = abs(float(got["loss"]) - float(ref["loss"])) / abs(float(ref["loss"]))
    assert loss_rel <= 1e-5, loss_rel
    for k in ("pred", "var"):
        d = got[k].numpy() - np.asarray(ref[k])
        assert got[k].shape == ref[k].shape
        assert np.sqrt((d ** 2).mean()) <= 1e-4, (k, np.sqrt((d ** 2).mean()))
    assert sorted(got["metrics"]) == sorted(ref["metrics"])
    for k, v in ref["metrics"].items():
        np.testing.assert_allclose(got["metrics"][k].numpy(), np.asarray(v),
                                   rtol=1e-4, atol=1e-5, err_msg=k)


def test_bf16_eval_tracks_fp32(pair):
    """The bf16 cast policy against the port's own fp32 step."""
    cfg, _, model = pair
    b = batch_to_device(_batch(np.random.default_rng(2), False), "cpu")
    f32 = make_eval_step(cfg)(model, b)
    b16 = make_eval_step(cfg.replace(compute_dtype="bfloat16"))(model, b)
    assert b16["pred"].dtype == torch.float32
    assert abs(float(b16["loss"]) / float(f32["loss"]) - 1) < 2e-2
    assert float((b16["pred"] - f32["pred"]).abs().max()) < 5e-2


def test_bridge_table_matches_torch_import():
    from uncrtaints_tpu.models.torch_import import uncrtaints_mapping
    cfg = derive(Config(use_sar=True))
    ours, theirs = jax_to_torch_names(cfg), uncrtaints_mapping(cfg)
    assert set(ours) == set(theirs)
    assert {k: v[0] for k, v in ours.items()} == {k: v[0] for k, v in theirs.items()}
    # each inverse transform undoes torch_import's forward one
    for k, (_, inv) in ours.items():
        a = np.arange(24, dtype=np.float32).reshape(
            (1, 2, 3, 4) if "Conv2d" in k else (4, 6) if k.endswith("kernel") else (24,))
        np.testing.assert_array_equal(theirs[k][1](inv(a)), a, err_msg=k)
    assert set(get_generator(cfg).state_dict()) == {v[0] for v in ours.values()}


def test_bridge_rejects_mismatched_variables(pair):
    cfg, state, _ = pair
    params = flax.core.unfreeze(state.params)
    del params["out_conv"]
    with pytest.raises(KeyError, match="missing"):
        from_jax_variables({"params": params, "batch_stats": state.batch_stats}, cfg)


def test_fused_eval_resolution():
    from uncrtaints_tpu_torch.models.registry import _resolve_fused_eval
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    cfg = _cfg()
    assert _resolve_fused_eval(cfg, cuda) and not _resolve_fused_eval(cfg, cpu)
    assert _resolve_fused_eval(cfg.replace(fused_eval="on"), cpu)
    assert not _resolve_fused_eval(cfg.replace(fused_eval="off"), cuda)
    with pytest.raises(ValueError):
        _resolve_fused_eval(cfg.replace(fused_eval="yes"), cpu)


def test_forward_runs_without_jax():
    code = (
        "import sys, numpy as np, torch\n"
        "from uncrtaints_tpu_torch.config import Config, derive\n"
        "from uncrtaints_tpu_torch.data import SyntheticSEN12MSCRTS, collate_multi\n"
        "from uncrtaints_tpu_torch.models import get_generator\n"
        "from uncrtaints_tpu_torch.train import batch_to_device, make_eval_step\n"
        "cfg = derive(Config(use_sar=True, scale_by=10.0, encoder_widths=[32],\n"
        "             decoder_widths=[32], n_head=4, d_model=64, low_res_size=8))\n"
        "ds = SyntheticSEN12MSCRTS(n_samples=2, patch_size=32)\n"
        "b = batch_to_device(collate_multi([ds[0], ds[1]]), 'cpu')\n"
        "aux = make_eval_step(cfg, with_metrics=True)(get_generator(cfg), b)\n"
        "assert torch.isfinite(aux['loss'])\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr[-2000:]
