"""The port's checkpoints: the save -> load round trip, the strict load, a
reference file's extra keys, partial transfer with freezing, and a file
written here read by the JAX package's ``load_torch_checkpoint``."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uncrtaints_tpu_torch.config import Config, derive
from uncrtaints_tpu_torch.data import SyntheticSEN12MSCRTS, collate_multi
from uncrtaints_tpu_torch.models import get_generator
from uncrtaints_tpu_torch.train import (
    batch_to_device, create_train_state, make_eval_step, make_train_step, set_learning_rate)
from uncrtaints_tpu_torch.train.checkpoint import (
    load_checkpoint, load_pretrained_partial, normalize_legacy_keys, save_checkpoint,
    unfreeze_all)


def _cfg(tmp_path, **kw):
    base = dict(use_sar=True, scale_by=10.0, encoder_widths=[16], decoder_widths=[16, 16],
                n_head=4, d_model=32, low_res_size=16, compute_dtype="float32", lr=1e-3,
                device="cpu", res_dir=str(tmp_path), experiment_name="ck")
    base.update(kw)
    return derive(Config(**base))


def _batch(seed=1, n=2, patch=16):
    ds = SyntheticSEN12MSCRTS(n_samples=n, n_input_t=3, patch_size=patch, seed=seed)
    return collate_multi([ds[i] for i in range(n)], use_sar=True)


def _trained_state(cfg, steps=2):
    """A state a few steps in: moments, count, step and batch-norm statistics
    all away from their initial values."""
    state = create_train_state(cfg, get_generator(cfg))
    step = make_train_step(cfg)
    for i in range(steps):
        state, _ = step(state, batch_to_device(_batch(seed=i + 1), "cpu"),
                        torch.Generator().manual_seed(i))
    return state


def _fresh_state(cfg, seed=99):
    return create_train_state(cfg.replace(rdm_seed=seed), get_generator(cfg.replace(rdm_seed=seed)))


def _assert_same_state(a, b, opt=True):
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert list(sa) == list(sb)
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    assert a.step == b.step
    if opt:
        assert a.opt_state.count == b.opt_state.count and a.tx.lr == b.tx.lr
        for moments in ("mu", "nu"):
            ma, mb = getattr(a.opt_state, moments), getattr(b.opt_state, moments)
            assert list(ma) == list(mb)
            for k in ma:
                assert torch.equal(ma[k], mb[k]), (moments, k)


def test_save_load_round_trip_is_bit_equal(tmp_path):
    cfg = _cfg(tmp_path)
    state = _trained_state(cfg)
    path = save_checkpoint(cfg, 3, state, "model_epoch_3", lr=2.5e-4)
    assert path == os.path.join(str(tmp_path), "ck", "model_epoch_3.pth.tar")
    assert os.listdir(os.path.dirname(path)) == ["model_epoch_3.pth.tar"]  # no .tmp left

    # the reference's layout, plain types only: weights_only=True reads it
    blob = torch.load(path, map_location="cpu", weights_only=True)
    assert set(blob) == {"epoch", "state_dict_G", "optimizer_G", "lr", "step"}
    assert blob["epoch"] == 3 and blob["step"] == 2 and blob["lr"] == 2.5e-4
    assert set(blob["optimizer_G"]) == {"count", "mu", "nu"} and blob["optimizer_G"]["count"] == 2
    assert not [k for k in blob["state_dict_G"] if "num_batches_tracked" in k]

    fresh = _fresh_state(cfg)
    assert not torch.equal(fresh.model.state_dict()["out_conv.conv.conv.0.weight"],
                           state.model.state_dict()["out_conv.conv.conv.0.weight"])
    fresh, meta = load_checkpoint(cfg, str(tmp_path), fresh, "model_epoch_3")
    assert meta == {"epoch": 3, "lr": 2.5e-4, "step": 2}
    set_learning_rate(state, 2.5e-4)
    _assert_same_state(fresh, state)

    # the next step of the restored state equals the original's, bit for bit
    step, b = make_train_step(cfg), batch_to_device(_batch(seed=9), "cpu")
    step(state, b, torch.Generator().manual_seed(5))
    step(fresh, b, torch.Generator().manual_seed(5))
    _assert_same_state(fresh, state)


def test_restore_opt_false_restores_the_model_and_the_step_only(tmp_path):
    cfg = _cfg(tmp_path)
    state = _trained_state(cfg)
    save_checkpoint(cfg, 1, state, "model", lr=5e-4)
    fresh = _fresh_state(cfg)
    fresh, meta = load_checkpoint(cfg, str(tmp_path), fresh, "model", restore_opt=False)
    _assert_same_state(fresh, state, opt=False)
    assert meta["epoch"] == 1 and fresh.tx.lr == cfg.lr and fresh.opt_state.count == 0
    assert all(not m.any() for m in fresh.opt_state.mu.values())


def test_a_missing_or_unexpected_key_raises_and_names_it(tmp_path):
    cfg = _cfg(tmp_path)
    state = _trained_state(cfg, steps=1)
    path = save_checkpoint(cfg, 1, state, "model", lr=1e-3)
    blob = torch.load(path, weights_only=True)
    dropped = blob["state_dict_G"].pop("out_conv.conv.conv.0.bias")
    torch.save(blob, path)
    with pytest.raises(KeyError, match="missing .*out_conv.conv.conv.0.bias"):
        load_checkpoint(cfg, str(tmp_path), _fresh_state(cfg), "model")
    blob["state_dict_G"]["out_conv.conv.conv.0.bias"] = dropped
    blob["state_dict_G"]["in_block.0.extra.weight"] = torch.zeros(3)
    torch.save(blob, path)
    with pytest.raises(KeyError, match="unexpected .*in_block.0.extra.weight"):
        load_checkpoint(cfg, str(tmp_path), _fresh_state(cfg), "model")
    del blob["state_dict_G"]["in_block.0.extra.weight"]
    del blob["optimizer_G"]["mu"]["out_conv.conv.conv.0.bias"]
    torch.save(blob, path)
    with pytest.raises(KeyError, match="optimizer_G"):
        load_checkpoint(cfg, str(tmp_path), _fresh_state(cfg), "model")
    load_checkpoint(cfg, str(tmp_path), _fresh_state(cfg), "model", restore_opt=False)
    with pytest.raises(FileNotFoundError):
        load_checkpoint(cfg, str(tmp_path), _fresh_state(cfg), "model_epoch_7")


def test_a_reference_file_loads(tmp_path, capsys):
    """A file as the reference writes it: ``num_batches_tracked`` counters,
    1-based block indices, no optimizer state of this package."""
    cfg = _cfg(tmp_path)
    state = _trained_state(cfg, steps=1)
    sd = {}
    for k, v in state.model.state_dict().items():
        head, _, rest = k.partition(".")
        if head in ("in_block", "out_block"):
            i, _, rest = rest.partition(".")
            k = f"{head}.{int(i) + 1}.{rest}"
        sd[k] = v.clone()
        if k.endswith("running_var"):
            sd[k.replace("running_var", "num_batches_tracked")] = torch.tensor(7)
    assert any("num_batches_tracked" in k for k in sd) and "in_block.1.conv.norm.weight" in sd
    path = os.path.join(str(tmp_path), "ck", "model.pth.tar")
    os.makedirs(os.path.dirname(path))
    torch.save({"epoch": 4, "state_dict_G": sd,
                "optimizer_G": {"state": {}, "param_groups": [{"lr": 0.01}]}}, path)

    got, meta = load_checkpoint(cfg, str(tmp_path), _fresh_state(cfg), "model",
                                restore_opt=False)
    _assert_same_state(got, create_train_state(cfg, state.model), opt=False)
    assert meta["epoch"] == 4 and got.step == 0

    dirty = _trained_state(cfg, steps=1)  # non-zero moments before the load
    got, _ = load_checkpoint(cfg, str(tmp_path), dirty, "model")
    assert "optimizer restarts" in capsys.readouterr().out
    assert got.opt_state.count == 0
    assert all(not m.any() for m in (*got.opt_state.mu.values(), *got.opt_state.nu.values()))


def test_normalize_legacy_keys_equals_the_jax_packages_and_drops_counters():
    from uncrtaints_tpu.models.torch_import import normalize_legacy_keys as ref
    rng = np.random.default_rng(0)
    names = ["in_conv.conv.conv.0.weight", "temporal_encoder.inconv.weight",
             "out_conv.conv.conv.0.bias"]
    for first in (0, 1):
        sd = {n: rng.random(3) for n in names}
        for blk in ("in_block", "out_block"):
            for i in range(first, first + 3):
                sd[f"{blk}.{i}.conv.fn.0.weight"] = rng.random(2)
                sd[f"{blk}.{i}.conv.fn.1.num_batches_tracked"] = np.int64(i)
        want = {k: v for k, v in ref(sd).items() if not k.endswith("num_batches_tracked")}
        got = normalize_legacy_keys(sd)
        assert list(got) == list(want) and all(got[k] is want[k] for k in want)
        assert "in_block.0.conv.fn.0.weight" in got and "in_block.3.conv.fn.0.weight" not in got


def test_partial_transfer_freezes_all_but_the_head(tmp_path):
    cfg = _cfg(tmp_path)
    src = _trained_state(cfg)
    path = save_checkpoint(cfg, 2, src, "pretrained", lr=1e-3)
    # the target has a wider attention: its temporal encoder differs in shape
    wide = _cfg(tmp_path, d_model=64, experiment_name="wide")
    state = _fresh_state(wide)
    init = {k: v.clone() for k, v in state.model.state_dict().items()}
    state, mask = load_pretrained_partial(wide, state, path)
    assert state.freeze_mask is mask and set(mask) == {n for n, _ in state.model.named_parameters()}
    src_sd, new_sd = src.model.state_dict(), state.model.state_dict()
    copied = [k for k in new_sd if k in src_sd and src_sd[k].shape == new_sd[k].shape]
    assert any("running_mean" in k for k in copied) and any("in_block" in k for k in copied)
    for k, v in new_sd.items():
        assert torch.equal(v, src_sd[k] if k in copied else init[k]), k
    for n, m in mask.items():
        assert m == (0.0 if n in copied and "out_conv" not in n else 1.0), n
    assert 0.0 in mask.values() and mask["out_conv.conv.conv.0.weight"] == 1.0
    assert any("temporal_encoder" in n and m == 1.0 for n, m in mask.items())  # shape mismatch

    # one step: the frozen parameters do not move, the others do
    before = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    make_train_step(wide)(state, batch_to_device(_batch(seed=5), "cpu"),
                          torch.Generator().manual_seed(0))
    moved = {n for n, p in state.model.named_parameters() if not torch.equal(p, before[n])}
    assert not {n for n in moved if mask[n] == 0.0}
    assert "out_conv.conv.conv.0.weight" in moved
    assert unfreeze_all(state).freeze_mask is None


def test_the_jax_package_reads_a_checkpoint_of_the_port(tmp_path):
    """save_checkpoint here -> uncrtaints_tpu's load_torch_checkpoint (and its
    load_checkpoint, which falls through to the .pth.tar) -> the JAX eval
    step gives the port's output: RMSE <= 1e-5 (fp32 on both sides)."""
    from uncrtaints_tpu import config as jc
    from uncrtaints_tpu.models import get_generator as jax_generator
    from uncrtaints_tpu.train import create_train_state as jax_state, make_eval_step as jax_eval
    from uncrtaints_tpu.train import checkpoint as jck

    cfg = _cfg(tmp_path)
    state = _trained_state(cfg)
    path = save_checkpoint(cfg, 2, state, "model", lr=1e-3)
    batch = _batch(seed=11, patch=32)
    got = make_eval_step(cfg)(state.model, batch_to_device(batch, "cpu"))

    jcfg = jc.Config.from_dict(cfg.to_dict())
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    fresh = lambda: jax_state(jcfg, jax_generator(jcfg), jax.random.PRNGKey(3), jb)
    direct, meta = jck.load_torch_checkpoint(jcfg, fresh(), path)
    through, meta2 = jck.load_checkpoint(jcfg, str(tmp_path), fresh(), "model", restore_opt=False)
    assert meta["epoch"] == meta2["epoch"] == 2
    for jstate in (direct, through):
        ref = jax_eval(jcfg)(jstate, jb)
        for k in ("pred", "var"):
            d = got[k].numpy() - np.asarray(ref[k])
            print(f"a checkpoint of the port read by the JAX package, {k}: RMSE "
                  f"{np.sqrt((d ** 2).mean()):.3g}")
            assert np.sqrt((d ** 2).mean()) <= 1e-5, (k, np.sqrt((d ** 2).mean()))
        assert abs(float(got["loss"]) / float(ref["loss"]) - 1) <= 1e-5
