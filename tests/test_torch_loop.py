"""The port's epoch loop against the JAX package's ``iterate``: one val epoch
and one train epoch over the same synthetic samples (a tail batch included)
from the same weights, carried over by ``models/jax_bridge.py``. fp32 on
both sides, small widths."""

import os
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uncrtaints_tpu import config as jc
from uncrtaints_tpu.data import pipeline as jp
from uncrtaints_tpu.data.synthetic import SyntheticSEN12MSCRTS
from uncrtaints_tpu_torch import config as tc
from uncrtaints_tpu_torch.data import pipeline as tp
from uncrtaints_tpu_torch.models import get_generator
from uncrtaints_tpu_torch.models.jax_bridge import from_jax_variables
from uncrtaints_tpu_torch.train import create_train_state, make_eval_step, make_train_step
from uncrtaints_tpu_torch.train import loop as tloop

N, B, PATCH = 8, 3, 16  # batches of 3, 3 and a tail of 2


def _kw(tmp_path, name, **kw):
    # patch = low_res_size: the attention is not upsampled, so neither side
    # applies attention dropout in training
    base = dict(use_sar=True, scale_by=10.0, encoder_widths=[16], decoder_widths=[16, 16],
                n_head=4, d_model=32, low_res_size=PATCH, compute_dtype="float32", lr=1e-3,
                batch_size=B, res_dir=str(tmp_path / name), experiment_name="run",
                plot_every=-1, export_every=3)
    base.update(kw)
    return base


@pytest.fixture(scope="module")
def jax_state():
    from uncrtaints_tpu.models import get_generator as jax_generator
    from uncrtaints_tpu.train import create_train_state as jax_create
    cfg = jc.derive(jc.Config(**_kw(pathlib.Path("."), "unused")))
    rng = np.random.default_rng(0)
    sample = {"x": jnp.zeros((1, 3, PATCH, PATCH, 15)), "y": jnp.zeros((1, 1, PATCH, PATCH, 13)),
              "dates": jnp.zeros((1, 3))}
    st = jax_create(cfg, jax_generator(cfg), jax.random.PRNGKey(0), sample)
    bs = jax.tree.map(lambda a: np.abs(rng.standard_normal(a.shape)).astype(np.float32)
                      * 0.3 + 0.5, st.batch_stats)
    return st.replace(batch_stats=bs)


def _port_state(cfg, st):
    model = get_generator(cfg, "cpu")
    model.load_state_dict(from_jax_variables(
        {"params": st.params, "batch_stats": st.batch_stats}, cfg), strict=True)
    return create_train_state(cfg, model)


def _loaders(seed, shuffle=False):
    ds = SyntheticSEN12MSCRTS(n_samples=N, n_input_t=3, patch_size=PATCH, seed=seed)
    kw = dict(batch_size=B, shuffle=shuffle, seed=1, drop_last=False, num_workers=2)
    return (jp.BatchLoader(ds, collate=jp.collate_multi, **kw),
            tp.BatchLoader(ds, collate=tp.collate_multi, **kw))


def _exports(root, epoch, mode):
    d = os.path.join(root, "run", "export", f"epoch_{epoch}", mode)
    return {f: np.load(os.path.join(d, f)) for f in sorted(os.listdir(d))}


def test_val_epoch_matches_the_jax_iterate(jax_state, tmp_path):
    """Loss, every image metric, UCE SE and AUCE SE within 1e-4 relative;
    the same export files with arrays within 1e-5."""
    from uncrtaints_tpu.train import make_eval_step as jax_eval
    from uncrtaints_tpu.train.loop import iterate as jax_iterate
    jcfg = jc.derive(jc.Config(**_kw(tmp_path, "jax")))
    tcfg = tc.derive(tc.Config(**_kw(tmp_path, "port"), device="cpu"))
    jl, tl = _loaders(seed=2)
    assert len(jl) == len(tl) == 3

    _, ref_m, ref_img = jax_iterate(jax_state, jl, jcfg, None, "val", 2,
                                    eval_step=jax_eval(jcfg, with_metrics=True))
    state = _port_state(tcfg, jax_state)
    _, got_m, got_img = tloop.iterate(state, tl, tcfg, None, "val", 2,
                                      eval_step=make_eval_step(tcfg, with_metrics=True))
    assert set(got_m) == set(ref_m) == {"val_epoch_time", "val_loss"}
    assert got_m["val_loss"] == pytest.approx(ref_m["val_loss"], rel=1e-4)
    assert set(got_img) == set(ref_img) and {"UCE SE", "AUCE SE", "mean var"} <= set(got_img)
    gaps = {k: abs(got_img[k] - v) / max(abs(v), ref_img["mean ae"]) for k, v in ref_img.items()}
    print(f"val epoch vs JAX: loss rel {abs(got_m['val_loss'] / ref_m['val_loss'] - 1):.3g}, "
          f"largest metric gap {max(gaps.values()):.3g} ({max(gaps, key=gaps.get)})")
    for k, v in ref_img.items():
        # the signed mean error is held against the mean absolute error
        assert got_img[k] == pytest.approx(v, rel=1e-4, abs=1e-4 * ref_img["mean ae"]), k

    ref_x, got_x = _exports(str(tmp_path / "jax"), 2, "val"), _exports(str(tmp_path / "port"), 2, "val")
    assert list(got_x) == list(ref_x) == [
        f"img-{i}_{m}.npy" for i in (0, 3, 6) for m in ("covar", "pred", "target")]
    for f, a in ref_x.items():
        assert got_x[f].shape == a.shape and got_x[f].dtype == a.dtype, f
        np.testing.assert_allclose(got_x[f], a, rtol=0, atol=1e-5, err_msg=f)
    print("val epoch vs JAX: largest export gap "
          f"{max(np.abs(got_x[f] - a).max() for f, a in ref_x.items()):.3g}")
    assert got_x["img-6_covar.npy"].shape == (13, 13, PATCH, PATCH)


def test_train_epoch_matches_the_jax_iterate(jax_state, tmp_path):
    """Three Adam steps (the tail batch too) from the same weights, no
    attention dropout: the epoch's mean loss within 1e-4 relative."""
    from uncrtaints_tpu.train import make_train_step as jax_train
    from uncrtaints_tpu.train.loop import iterate as jax_iterate
    jcfg = jc.derive(jc.Config(**_kw(tmp_path, "jax")))
    tcfg = tc.derive(tc.Config(**_kw(tmp_path, "port"), device="cpu"))
    jl, tl = _loaders(seed=3, shuffle=True)
    jl.set_epoch(1), tl.set_epoch(1)
    fresh = jax.tree.map(lambda a: jnp.array(np.asarray(a)), jax_state)  # the step donates it
    jnew, ref_m, none = jax_iterate(fresh, jl, jcfg, None, "train", 1, train_step=jax_train(jcfg))
    state = _port_state(tcfg, jax_state)
    before = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    state, got_m, img = tloop.iterate(state, tl, tcfg, None, "train", 1,
                                      train_step=make_train_step(tcfg))
    assert none is None and img is None
    assert set(got_m) == {"train_epoch_time", "train_loss"}
    print(f"train epoch vs JAX: loss rel {abs(got_m['train_loss'] / ref_m['train_loss'] - 1):.3g}")
    assert got_m["train_loss"] == pytest.approx(ref_m["train_loss"], rel=1e-4)
    assert state.step == int(jnew.step) == 3 and state.opt_state.count == 3
    assert all(not torch.equal(p, before[n]) for n, p in state.model.named_parameters())


def _tiny_port(tmp_path, **kw):
    cfg = tc.derive(tc.Config(**_kw(tmp_path, "port", **kw), device="cpu"))
    return cfg, create_train_state(cfg, get_generator(cfg))


def test_sample_ids_are_sequential_over_a_tail_batch(tmp_path):
    cfg, state = _tiny_port(tmp_path, export_every=1, loss="l2")
    _, tl = _loaders(seed=4)
    _, _, img = tloop.iterate(state, tl, cfg, None, "test", 1,
                              eval_step=make_eval_step(cfg, with_metrics=True))
    files = _exports(str(tmp_path / "port"), 1, "test")
    assert sorted(files) == sorted(f"img-{i}_{m}.npy" for i in range(N) for m in ("pred", "target"))
    assert "UCE SE" not in img and np.isnan(img["mean var"]) and np.isfinite(img["RMSE"])
    # each export is its own sample: the targets are the dataset's, in order
    ds = SyntheticSEN12MSCRTS(n_samples=N, n_input_t=3, patch_size=PATCH, seed=4)
    for i in range(N):
        np.testing.assert_array_equal(files[f"img-{i}_target.npy"], ds[i]["target"]["S2"][0])


def test_gnll_exports_the_compact_variance(tmp_path):
    cfg, state = _tiny_port(tmp_path, loss="GNLL", export_every=4)
    _, tl = _loaders(seed=4)
    _, _, img = tloop.iterate(state, tl, cfg, None, "val", 1,
                              eval_step=make_eval_step(cfg, with_metrics=True))
    files = _exports(str(tmp_path / "port"), 1, "val")
    assert sorted(files) == sorted(f"img-{i}_{m}.npy" for i in (0, 4)
                                   for m in ("pred", "target", "var"))
    assert files["img-4_var.npy"].shape == (13, PATCH, PATCH)
    assert np.isfinite(img["UCE SE"]) and np.isfinite(img["AUCE SE"])


def test_the_loop_refuses_an_empty_loader_and_a_step_without_outputs(tmp_path):
    cfg, state = _tiny_port(tmp_path)
    empty = tp.BatchLoader(SyntheticSEN12MSCRTS(n_samples=2, patch_size=PATCH), batch_size=B,
                           drop_last=True)
    with pytest.raises(ValueError, match="zero samples"):
        tloop.iterate(state, empty, cfg, None, "val", 1)
    _, tl = _loaders(seed=4)
    lean = make_eval_step(cfg, with_metrics=True, return_outputs=False)
    with pytest.raises(ValueError, match="return_outputs=False"):
        tloop.iterate(state, tl, cfg, None, "val", 1, eval_step=lean)
    quiet = cfg.replace(export_every=-1)
    _, m, img = tloop.iterate(state, tl, quiet, None, "val", 1, eval_step=lean)
    assert np.isfinite(m["val_loss"]) and np.isfinite(img["UCE SE"])
    bare = make_eval_step(quiet)  # no metrics in the step: the loop computes them
    _, m2, img2 = tloop.iterate(state, tl, quiet, None, "val", 1, eval_step=bare)
    assert m2["val_loss"] == m["val_loss"] and img2 == img


def test_the_dropout_generator_follows_the_global_step(tmp_path):
    """Epoch 2 of a run draws the same noise whether epoch 1 ran in this
    process or not: the loop re-seeds the generator from (seed, step)."""
    # patch 32 over low_res_size 16: the attention is upsampled and dropout is on
    cfg = tc.derive(tc.Config(**_kw(tmp_path, "port", low_res_size=16), device="cpu"))
    ds = SyntheticSEN12MSCRTS(n_samples=4, n_input_t=3, patch_size=32, seed=5)
    loader = tp.BatchLoader(ds, batch_size=2, drop_last=False, num_workers=1)
    step = make_train_step(cfg)
    finals = []
    for warm in (True, False):
        state = create_train_state(cfg, get_generator(cfg))
        gen = torch.Generator()
        if warm:  # leaves the generator in another state
            tloop.iterate(create_train_state(cfg, get_generator(cfg)), loader, cfg, None,
                          "train", 1, train_step=step, generator=gen)
        tloop.iterate(state, loader, cfg, None, "train", 2, train_step=step, generator=gen)
        finals.append({n: p.detach().clone() for n, p in state.model.named_parameters()})
    assert all(torch.equal(finals[0][n], finals[1][n]) for n in finals[0])
    assert tloop.step_seed(cfg, 3) != tloop.step_seed(cfg, 4)
    assert tloop.step_seed(cfg, 3) != tloop.step_seed(cfg.replace(rdm_seed=2), 3)


def test_log_train_and_log_aleatoric_write_their_panels(tmp_path, monkeypatch):
    import json
    import sys
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    from uncrtaints_tpu_torch.train.observe import Writer
    cfg, state = _tiny_port(tmp_path, display_step=2)
    _, tl = _loaders(seed=6)
    writer = Writer(str(tmp_path / "logs"))
    tloop.iterate(state, tl, cfg, writer, "train", 1, train_step=make_train_step(cfg))
    tloop.iterate(state, tl, cfg, writer, "val", 1,
                  eval_step=make_eval_step(cfg, with_metrics=True))
    writer.close()
    with open(tmp_path / "logs" / "scalars.jsonl") as f:
        rows = [json.loads(l) for l in f]
    tags = {(r["tag"], r["step"]) for r in rows}
    # steps 0 and 2 of the epoch's three hit display_step = 2
    assert {("train/MGNLL", 0), ("train/MGNLL", 2), ("train/OR m %", 2)} <= tags
    assert ("train/MGNLL", 1) not in tags
    for tag in ("Img/train/in_s1", "Img/train/out", "Img/train/AND m",
                "Img/train/patch covmat relative 0", "Hist/train/aleatoric"):
        assert (tag, 0) in tags, tag
    for tag in ("val/RMSE", "val/loss", "val/model/UCE SE", "Img/val/discard_uncertain",
                "Img/val/err_vs_var_L2", "Img/val/model/aleatoric [0,1]"):
        assert (tag, 3) in tags, tag
