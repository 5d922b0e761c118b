"""The port's CLIs end to end on the CPU at tiny widths: train -> val ->
checkpoints -> test, ``cli.test`` with the conf.json merge, resume, the tail
batch, and what the CLIs refuse."""

import json
import os

import numpy as np
import pytest
import torch

from uncrtaints_tpu_torch.cli import test as cli_test, train as cli_train
from uncrtaints_tpu_torch.config import Config, apply_resume, derive, parse_config

METRICS = ("RMSE", "MAE", "PSNR", "SAM", "SSIM", "mean var", "UCE SE", "AUCE SE")


def _tiny_cfg(tmp_path, **overrides):
    base = dict(
        use_sar=True, scale_by=10.0, batch_size=4, lr=1e-3, epochs=1, input_t=3,
        max_samples_count=8, synthetic_data=True, synthetic_patch=32, device="cpu",
        res_dir=str(tmp_path / "results"), experiment_name="smoke",
        encoder_widths=[16], decoder_widths=[16, 16], n_head=4, d_model=32,
        plot_every=4, export_every=4, display_step=1)
    base.update(overrides)
    return derive(Config(**base))


def _walk(root, ext):
    return sorted(f for _, _, files in os.walk(root) for f in files if f.endswith(ext))


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """One tiny train run that several tests read."""
    tmp = tmp_path_factory.mktemp("cli")
    cfg = _tiny_cfg(tmp)
    return tmp, cfg, cli_train.main(cfg)


def test_cli_train_end_to_end(trained):
    tmp, cfg, out = trained
    exp = os.path.join(cfg.res_dir, "smoke")
    for name in ("conf.json", "trainlog.json", "model.pth.tar", "model_epoch_1.pth.tar",
                 "test_metrics.json", "val_epoch_1_metrics.json"):
        assert os.path.isfile(os.path.join(exp, name)), name
    with open(os.path.join(exp, "test_metrics.json")) as f:
        tm = json.load(f)
    for key in METRICS:
        assert key in tm and np.isfinite(tm[key]), key
        assert tm[key] == out["test"][key]
    with open(os.path.join(exp, "conf.json")) as f:
        conf = json.load(f)
    n_params = sum(v.numel() for k, v in torch.load(
        os.path.join(exp, "model.pth.tar"), weights_only=True)["state_dict_G"].items()
        if "running_" not in k)
    assert conf["N_params"] == n_params > 0 and conf["out_conv"] == [26]
    with open(os.path.join(exp, "trainlog.json")) as f:
        log = json.load(f)
    assert set(log) == {"1"} and set(log["1"]) == {
        "train_epoch_time", "train_loss", "val_epoch_time", "val_loss"}

    # plot/export hooks fired (every 4th of 8 samples), all six panels
    plots = _walk(os.path.join(exp, "plots"), ".png")
    for panel in ("in", "pred", "target", "err", "var", "mask"):
        assert any(f"_{panel}" in f for f in plots), panel
    exports = _walk(os.path.join(exp, "export", "epoch_1", "test"), ".npy")
    assert exports == [f"img-{i}_{m}.npy" for i in (0, 4) for m in ("covar", "pred", "target")]
    # the discard curve of the final test pass, and the event log beside res_dir
    assert os.path.isfile(os.path.join(exp, "plot_test_SE_discard.png"))
    assert os.listdir(os.path.join(str(tmp), "logs", "smoke"))


def test_cli_test_merges_the_stored_config_and_reproduces_the_test(trained, tmp_path):
    tmp, cfg, out = trained
    argv = ["--experiment_name", "smoke", "--weight_folder", cfg.res_dir,
            "--res_dir", str(tmp_path / "inference"), "--max_samples_count", "8",
            "--batch_size", "3", "--input_t", "3", "--device", "cpu", "--export_every", "-1"]
    tcfg = cli_test.load_test_config(argv)
    # merged from the stored conf.json (the parser's defaults differ)
    assert tcfg.encoder_widths == [16] and tcfg.decoder_widths == [16, 16]
    assert tcfg.n_head == 4 and tcfg.d_model == 32 and tcfg.out_conv == [26]
    assert tcfg.synthetic_data and tcfg.synthetic_patch == 32 and tcfg.scale_by == 10.0
    # NO_OVERWRITE_TEST: the fresh flags win over the stored run's
    assert tcfg.res_dir == str(tmp_path / "inference") and tcfg.weight_folder == cfg.res_dir
    assert tcfg.batch_size == 3 and tcfg.export_every == -1 and tcfg.device == "cpu"
    assert tcfg.resume_at == -1  # the best checkpoint

    metrics = cli_test.main(tcfg)
    assert os.path.isfile(tmp_path / "inference" / "smoke" / "test_metrics.json")
    # another batch size sums in another order: 1e-5 relative, not bits
    for key in METRICS:
        assert metrics[key] == pytest.approx(out["test"][key], rel=1e-5), key
    assert not os.path.exists(tmp_path / "inference" / "smoke" / "export")

    # the same batch size and --resume_at 1 (the same weights): equal to the bit
    again = cli_test.main(cli_test.load_test_config(
        argv[:-6] + ["--batch_size", "4", "--device", "cpu", "--resume_at", "1",
                     "--input_t", "3"]))
    assert {k: again[k] for k in METRICS} == {k: out["test"][k] for k in METRICS}
    # test mode exports every sample by default
    exported = _walk(str(tmp_path / "inference" / "smoke" / "export" / "epoch_1" / "test"), ".npy")
    assert len(exported) == 3 * 8


def test_without_a_stored_config_cli_test_derives_its_own(tmp_path):
    cfg = cli_test.load_test_config(["--weight_folder", str(tmp_path), "--loss", "GNLL"])
    assert cfg.covmode == "uni" and cfg.out_conv == [26] and cfg.device == "cuda"


def _params(path):
    return torch.load(path, weights_only=True)


def test_two_epochs_equal_one_epoch_plus_resume(tmp_path):
    """gamma = 1: parameters, batch-norm statistics, moments, count and step
    of model_epoch_2 equal bit for bit, with dropout on (patch 32 over
    low_res_size 16) and a reshuffled, tail-batched train split."""
    kw = dict(plot_every=-1, export_every=-1, max_samples_count=6, low_res_size=16)
    whole = _tiny_cfg(tmp_path / "a", epochs=2, **kw)
    cli_train.main(whole)
    first = _tiny_cfg(tmp_path / "b", epochs=1, **kw)
    cli_train.main(first)
    ckpt = os.path.join(first.res_dir, "smoke", "model_epoch_1.pth.tar")
    resumed = apply_resume(_tiny_cfg(tmp_path / "b", epochs=2, resume_from=True,
                                     trained_checkp=ckpt, resume_at=1, **kw))
    out = cli_train.main(resumed)
    assert set(out["trainlog"]) == {2}  # only epoch 2 ran in the resumed process

    a = _params(os.path.join(whole.res_dir, "smoke", "model_epoch_2.pth.tar"))
    b = _params(os.path.join(first.res_dir, "smoke", "model_epoch_2.pth.tar"))
    assert a["epoch"] == b["epoch"] == 2 and a["step"] == b["step"] == 4 and a["lr"] == b["lr"]
    assert a["optimizer_G"]["count"] == b["optimizer_G"]["count"] == 4
    for part in (("state_dict_G",), ("optimizer_G", "mu"), ("optimizer_G", "nu")):
        ta, tb = a, b
        for p in part:
            ta, tb = ta[p], tb[p]
        assert list(ta) == list(tb)
        for k in ta:
            assert torch.equal(ta[k], tb[k]), (part, k)
    one = _params(ckpt)
    assert not torch.equal(one["state_dict_G"]["out_conv.conv.conv.0.weight"],
                           b["state_dict_G"]["out_conv.conv.conv.0.weight"])


def test_resume_lr_is_the_jax_packages(tmp_path):
    """gamma = 0.8, resume_at = 1: the lr of the resumed epoch 2 is what the
    JAX package's code path sets there (apply_resume, then main's
    epoch_lr(cfg, epoch - 1) over it), and the checkpoint records it.

    With --resume_from the stored conf.json's resume_at (0) replaces the
    flag's, so apply_resume leaves the lr alone and epoch 2 runs at the
    uninterrupted run's lr * gamma. --resume_at alone (no stored config)
    rescales the lr once in apply_resume and once more in main: both
    packages then give lr * gamma^2 for epoch 2."""
    import dataclasses
    from uncrtaints_tpu import config as jc
    from uncrtaints_tpu.train.engine import epoch_lr as jax_epoch_lr
    from uncrtaints_tpu_torch.train import epoch_lr
    kw = dict(plot_every=-1, export_every=-1, max_samples_count=4, gamma=0.8)
    first = _tiny_cfg(tmp_path, epochs=1, **kw)
    cli_train.main(first)
    exp = os.path.join(first.res_dir, "smoke")
    ckpt = os.path.join(exp, "model_epoch_1.pth.tar")
    assert _params(ckpt)["lr"] == 1e-3

    def both(**flags):
        port = apply_resume(_tiny_cfg(tmp_path, epochs=2, **kw, **flags))
        shared = {f.name for f in dataclasses.fields(jc.Config)}
        ref = jc.apply_resume(jc.Config.from_dict(
            {k: v for k, v in _tiny_cfg(tmp_path, epochs=2, **kw, **flags).to_dict().items()
             if k in shared}))
        assert (port.lr, port.resume_at) == (ref.lr, ref.resume_at)
        assert epoch_lr(port, 1) == jax_epoch_lr(ref, 1)
        return port, jax_epoch_lr(ref, 1)

    resumed, want = both(resume_from=True, trained_checkp=ckpt, resume_at=1)
    assert resumed.resume_at == 0 and resumed.lr == 1e-3
    assert want == pytest.approx(1e-3 * 0.8)  # the uninterrupted run's
    bare, twice = both(resume_at=1)
    assert bare.lr == pytest.approx(1e-3 * 0.8) and twice == pytest.approx(1e-3 * 0.8 ** 2)

    cli_train.main(resumed)
    two = _params(os.path.join(exp, "model_epoch_2.pth.tar"))
    assert two["lr"] == want and two["step"] == 2 and two["optimizer_G"]["count"] == 2


def test_cli_train_keeps_the_tail_batch(tmp_path):
    """10 samples at B=4: the tail batch of 2 trains and is evaluated and
    exported, under sequential sample ids."""
    cfg = _tiny_cfg(tmp_path, experiment_name="tail", max_samples_count=10,
                    plot_every=-1, export_every=1)
    out = cli_train.main(cfg)
    for key in ("RMSE", "MAE", "PSNR"):
        assert np.isfinite(out["test"][key])
    export_dir = os.path.join(cfg.res_dir, "tail", "export", "epoch_1", "test")
    preds = sorted(f for f in os.listdir(export_dir) if "_pred" in f)
    assert preds == sorted(f"img-{i}_pred.npy" for i in range(10))
    assert _params(os.path.join(cfg.res_dir, "tail", "model_epoch_1.pth.tar"))["step"] == 3


def test_cli_train_pretrain_mono_and_no_validation(tmp_path):
    """The mono-temporal recipe (collate_mono, no dates, no variance head)
    with validation never due: no best checkpoint, the last epoch is tested."""
    cfg = _tiny_cfg(tmp_path, experiment_name="mono", pretrain=True, loss="l2",
                    plot_every=-1, export_every=-1, val_after=5)
    assert cfg.input_t == 1 and cfg.n_head == 1
    out = cli_train.main(cfg)
    exp = os.path.join(cfg.res_dir, "mono")
    assert not os.path.exists(os.path.join(exp, "model.pth.tar"))
    assert os.path.isfile(os.path.join(exp, "model_epoch_1.pth.tar"))
    assert np.isfinite(out["test"]["RMSE"]) and "UCE SE" not in out["test"]
    assert set(out["trainlog"][1]) == {"train_epoch_time", "train_loss"}


def test_pretrained_weights_stay_frozen_until_the_gate(trained, tmp_path):
    tmp, cfg, _ = trained
    ckpt = os.path.join(cfg.res_dir, "smoke", "model_epoch_1.pth.tar")
    kw = dict(experiment_name="transfer", trained_checkp=ckpt, plot_every=-1,
              export_every=-1, max_samples_count=4)
    src = _params(ckpt)["state_dict_G"]
    cli_train.main(_tiny_cfg(tmp_path, unfreeze_after=1, **kw))
    got = _params(os.path.join(str(tmp_path / "results"), "transfer",
                               "model_epoch_1.pth.tar"))["state_dict_G"]
    frozen = [k for k in src if "out_conv" not in k and "running_" not in k]
    assert frozen and all(torch.equal(got[k], src[k]) for k in frozen)
    assert not torch.equal(got["out_conv.conv.conv.0.weight"], src["out_conv.conv.conv.0.weight"])
    cli_train.main(_tiny_cfg(tmp_path, unfreeze_after=0, **kw))  # the gate opens at epoch 1
    got = _params(os.path.join(str(tmp_path / "results"), "transfer",
                               "model_epoch_1.pth.tar"))["state_dict_G"]
    assert not any(torch.equal(got[k], src[k]) for k in frozen if "weight" in k)


def test_the_default_device_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    cfg = derive(parse_config(["--synthetic_data", "--res_dir", str(tmp_path / "r")]))
    assert cfg.device == "cuda"
    for main in (cli_train.main, cli_test.main):
        with pytest.raises((AssertionError, RuntimeError)):
            main(cfg.replace(max_samples_count=2, synthetic_patch=16))
    assert not os.path.exists(tmp_path / "r" / cfg.experiment_name / "trainlog.json")


@pytest.mark.parametrize("field, value", [
    ("mesh_shape", 2), ("ckpt_backend", "orbax"), ("trace_dir", "trace"),
    ("profile", True), ("synthetic_data", False), ("use_custom", True)])
def test_the_clis_refuse_what_is_not_ported(tmp_path, field, value):
    cfg = _tiny_cfg(tmp_path).replace(**{field: value})
    mains = [cli_test.main] if field == "use_custom" else [cli_train.main, cli_test.main]
    for main in mains:
        with pytest.raises(NotImplementedError, match="not ported"):
            main(cfg)
    assert not os.path.exists(os.path.join(cfg.res_dir, "smoke", "conf.json"))


def test_a_foreign_checkpoint_suffix_is_refused():
    assert cli_train.checkpoint_name("results/run/model_epoch_3.pth.tar") == "model_epoch_3"
    for path in ("results/run/model.ckpt", "results/run/model.orbax/"):
        with pytest.raises(ValueError, match=".pth.tar"):
            cli_train.checkpoint_name(path)
