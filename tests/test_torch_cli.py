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


@pytest.mark.parametrize("field, value, error, match", [
    ("mesh_shape", 2, RuntimeError, "requested 2 ranks but only 1")],
    ids=["mesh_shape-2"])
def test_the_clis_refuse_what_is_not_ported(tmp_path, field, value, error, match):
    """A mesh of 2 ranks needs a run of 2 processes (torchrun), and a single
    process refuses it."""
    cfg = _tiny_cfg(tmp_path).replace(**{field: value})
    for main in (cli_train.main, cli_test.main):
        with pytest.raises(error, match=match):
            main(cfg)
    assert not os.path.exists(os.path.join(cfg.res_dir, "smoke", "conf.json"))


def test_a_foreign_checkpoint_suffix_is_refused():
    """The JAX package's .ckpt files are read; its .orbax directories are
    refused, and the message names the formats that are read."""
    assert cli_train.checkpoint_name("results/run/model_epoch_3.pth.tar") == "model_epoch_3"
    assert cli_train.checkpoint_name("results/run/model_epoch_3.dcp/") == "model_epoch_3"
    assert cli_train.checkpoint_name("results/run/model_epoch_3.ckpt") == "model_epoch_3"
    for path in ("results/run/model.orbax/", "results/run/model.npz"):
        with pytest.raises(ValueError, match=".pth.tar"):
            cli_train.checkpoint_name(path)


# ------------------------------------------------ on a SEN12MS-CR-TS tree --

TREE_ROIS = {"ROIs1868/114": range(4), "ROIs1868/17": range(2), "ROIs1158/106": range(2)}
MASKS = "cloud_cloudshadow_mask"


@pytest.fixture(scope="module")
def real_run(tmp_path_factory):
    """cli.precompute on the train split of a written tree, then cli.train
    on the tree (no --synthetic_data) with the statistics imported."""
    from uncrtaints_tpu_torch.cli import precompute
    from uncrtaints_tpu_torch.data.synthetic_tree import write_sen12mscrts_tree
    tmp = tmp_path_factory.mktemp("real")
    root = str(tmp / "SEN12MSCRTS")
    write_sen12mscrts_tree(root, TREE_ROIS, hw=16, deflate=["ROIs1158/106"], workers=2)
    pre = str(tmp / "precomputed")
    precompute.main(precompute.create_parser().parse_args(
        ["--root", root, "--split", "train", "--cloud_masks", MASKS, "--out_dir", pre,
         "--device", "cpu"]))
    cfg = _tiny_cfg(tmp, synthetic_data=False, root1=root, root2=root, precomputed=pre,
                    cloud_masks=MASKS, batch_size=2, max_samples_count=4, low_res_size=16,
                    plot_every=-1, export_every=2, experiment_name="real")
    return tmp, cfg, cli_train.main(cfg)


def test_cli_train_runs_on_a_sen12mscrts_tree(real_run):
    tmp, cfg, out = real_run
    dt_train, dt_val, dt_test = cli_train.build_datasets(cfg)
    assert (len(dt_train), len(dt_val), len(dt_test)) == (4, 2, 2)
    assert dt_train.data_pairs is not None and dt_val.data_pairs is None  # the import is read
    assert dt_train.sampling == "random" and dt_train.device.type == "cpu"
    exp = os.path.join(cfg.res_dir, "real")
    for name in ("conf.json", "trainlog.json", "model.pth.tar", "model_epoch_1.pth.tar",
                 "test_metrics.json", "val_epoch_1_metrics.json"):
        assert os.path.isfile(os.path.join(exp, name)), name
    for key in METRICS:
        assert np.isfinite(out["test"][key]), key
    assert _params(os.path.join(exp, "model_epoch_1.pth.tar"))["step"] == 2
    exports = _walk(os.path.join(exp, "export", "epoch_1", "test"), ".npy")
    assert exports == [f"img-0_{m}.npy" for m in ("covar", "pred", "target")]
    assert np.load(os.path.join(exp, "export", "epoch_1", "test", "img-0_pred.npy")).shape == (
        13, 16, 16)


def test_cli_test_on_the_tree_reproduces_the_train_runs_test(real_run, tmp_path):
    tmp, cfg, out = real_run
    # root2 is a flag the stored conf.json does not overwrite: the user names it
    argv = ["--experiment_name", "real", "--weight_folder", cfg.res_dir, "--res_dir",
            str(tmp_path / "inference"), "--batch_size", "2", "--input_t", "3",
            "--device", "cpu", "--export_every", "-1", "--root2", cfg.root2]
    tcfg = cli_test.load_test_config(argv)
    assert not tcfg.synthetic_data and tcfg.cloud_masks == MASKS
    metrics = cli_test.main(tcfg)
    assert {k: metrics[k] for k in METRICS} == {k: out["test"][k] for k in METRICS}


def test_cli_test_use_custom(real_run, tmp_path):
    """--use_custom (mirrors tests/test_cli_use_custom.py): the 3x3 mosaic of
    ROIs1868/73 (48 x 48) under --root1, through the trained checkpoint."""
    from uncrtaints_tpu_torch.cli.test import CUSTOM_DATES, CUSTOM_PATCHES
    from uncrtaints_tpu_torch.data.synthetic_tree import write_sen12mscrts_tree
    tmp, cfg, _ = real_run
    root = str(tmp_path / "custom")
    write_sen12mscrts_tree(root, {"ROIs1868/73": CUSTOM_PATCHES}, hw=16,
                           time_points=sorted(CUSTOM_DATES), dates=CUSTOM_DATES, workers=2)
    tcfg = cli_test.load_test_config(
        ["--experiment_name", "real", "--weight_folder", cfg.res_dir, "--res_dir",
         str(tmp_path / "inference"), "--root1", root, "--use_custom", "--device", "cpu",
         "--export_every", "1"])
    assert tcfg.use_custom and tcfg.root1 == root
    metrics = cli_test.main(tcfg)
    for key in METRICS:
        assert key in metrics and np.isfinite(metrics[key]), key
    exp = tmp_path / "inference" / "real"
    with open(exp / "test_metrics.json") as f:
        assert json.load(f)["RMSE"] == pytest.approx(metrics["RMSE"])
    pred = np.load(exp / "export" / "epoch_1" / "test" / "img-0_pred.npy")
    assert pred.shape == (13, 48, 48) and np.isfinite(pred).all()


def test_the_default_detector_without_weights_is_a_hard_error(tmp_path, monkeypatch):
    """cli.train on a tree with the default --cloud_masks s2cloudless_mask and
    no weights raises the detector's error, with no fallback."""
    from uncrtaints_tpu_torch.data import masks
    from uncrtaints_tpu_torch.data.synthetic_tree import write_sen12mscrts_tree
    monkeypatch.setenv("S2CLOUDLESS_MODEL_PATH", str(tmp_path / "nope.txt"))
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path))
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(masks, "_S2C_CACHE", {"detector": None, "tried": False})
    root = str(tmp_path / "tree")
    write_sen12mscrts_tree(root, {"ROIs1868/114": range(1)}, hw=8, workers=2)
    cfg = _tiny_cfg(tmp_path, synthetic_data=False, root1=root, root2=root, batch_size=1,
                    max_samples_count=1, plot_every=-1, export_every=-1, experiment_name="s2c")
    assert cfg.cloud_masks == "s2cloudless_mask"
    with pytest.raises(RuntimeError, match="s2cloudless LightGBM weights"):
        cli_train.main(cfg)
    assert not os.path.exists(os.path.join(cfg.res_dir, "s2c", "trainlog.json"))


def test_cli_utae_train_then_test(tmp_path):
    """--model utae through cli.train and cli.test on the CPU: the
    variance-free path (MSE, no variance head) through the loop, the
    observer, the epoch-end calibration (none without a variance) and
    --export_every; cli.test reproduces the train run's test to the bit."""
    cfg = _tiny_cfg(tmp_path, model="utae", experiment_name="utae", encoder_widths=[8, 8, 16],
                    decoder_widths=[8, 8, 16], n_head=4, d_model=16, plot_every=2,
                    export_every=2)
    assert cfg.loss == "l2" and cfg.out_conv == [13]
    out = cli_train.main(cfg)
    exp = os.path.join(cfg.res_dir, "utae")
    for name in ("conf.json", "model.pth.tar", "model_epoch_1.pth.tar", "test_metrics.json"):
        assert os.path.isfile(os.path.join(exp, name)), name
    assert set(out["test"]) >= {"RMSE", "MAE", "PSNR", "SAM", "SSIM"}
    assert "UCE SE" not in out["test"] and np.isfinite(out["test"]["RMSE"])
    exports = _walk(os.path.join(exp, "export", "epoch_1", "test"), ".npy")
    assert exports == [f"img-{i}_{m}.npy" for i in (0, 2, 4, 6) for m in ("pred", "target")]
    plots = _walk(os.path.join(exp, "plots"), ".png")
    assert any("_pred" in f for f in plots) and not any("_var" in f for f in plots)
    sd = _params(os.path.join(exp, "model.pth.tar"))["state_dict_G"]
    assert "temporal_encoder.attention_heads.Q" in sd and "up_blocks.1.up.0.weight" in sd
    tested = cli_test.main(cli_test.load_test_config(
        ["--experiment_name", "utae", "--weight_folder", cfg.res_dir, "--res_dir",
         str(tmp_path / "inference"), "--max_samples_count", "8", "--batch_size", "4",
         "--input_t", "3", "--device", "cpu", "--export_every", "-1"]))
    finite = [k for k, v in out["test"].items() if np.isfinite(v)]  # no variance: NaN stays
    assert finite and {k: tested[k] for k in finite} == {k: out["test"][k] for k in finite}


@pytest.mark.parametrize("model, extra", [
    ("unet", {}), ("unet3d", dict(input_t=4)), ("uconvlstm", {}), ("buconvlstm", {}),
    ("convlstm", {}), ("convgru", {}), ("fpn", {})])
def test_cli_trains_and_tests_every_baseline(tmp_path, model, extra):
    """Every --model that get_generator builds runs one epoch of cli.train
    and its test (at build_recurrent's own widths for the recurrent ones),
    with the MSE loss, as the JAX package's tests drive them
    (tests/test_baselines.py): they have no variance nonlinearity, and a
    negative raw variance makes the MGNLL loss -inf in both packages
    (ROADMAP section 3)."""
    kw = dict(encoder_widths=[8, 8, 16], decoder_widths=[8, 8, 16]) if "unet" in model else {}
    cfg = _tiny_cfg(tmp_path, model=model, experiment_name=model, max_samples_count=4,
                    plot_every=-1, export_every=-1, loss="l2", **kw, **extra)
    out = cli_train.main(cfg)
    assert np.isfinite(out["test"]["RMSE"]) and np.isfinite(out["trainlog"][1]["train_loss"])
    assert os.path.isfile(os.path.join(cfg.res_dir, model, "model.pth.tar"))


def _analytic_mflops(hw=32, T=3, c_in=15, enc=16, hid=32, se=4, d_model=32, keys=16, out=26,
                     low_res=32):
    """The tiny recipe's eval forward per sample, from its layer shapes: two
    FLOPs a multiply-add of every convolution (2 k^2 Cin Cout H W / groups)
    and matrix product, and K1's T products an output (elementwise work
    uncounted, as torch's counter leaves it). The L-TAE runs at
    ``low_res_size`` (the attention is resized to the map for K1)."""
    HW, LR = hw * hw, low_res * low_res
    mbconv = lambda frames: ((2 * enc * hid + 2 * 9 * hid + 2 * hid * enc) * HW
                             + 2 * hid * se + 2 * se * hid) * frames
    flops = (2 * c_in * enc * HW * T + mbconv(T)                      # in_conv, in_block
             + (2 * enc * d_model + 2 * d_model * keys) * LR * T        # L-TAE inconv, keys
             + 2 * T * enc * HW                                         # K1
             + 2 * mbconv(1) + 2 * enc * out * HW)                      # decoder, out_conv
    return flops * 1e-6


def test_trace_dir_and_profile_in_both_clis(tmp_path, capsys):
    """--trace_dir writes a Chrome trace that names the kernels' operators
    the run went through (on the CPU: K1, K1-bwd, K5, K2; the fused K3 / K4
    need a card or widths of 128); --profile prints the eval forward's
    MFLOP per sample, equal to the count from the layer shapes."""
    cfg = _tiny_cfg(tmp_path, max_samples_count=2, batch_size=2, synthetic_patch=16,
                    plot_every=-1, export_every=-1, trace_dir=str(tmp_path / "trace"),
                    profile=True)
    cli_train.main(cfg)
    printed = capsys.readouterr().out
    mflops = [float(line.split(":")[1]) for line in printed.splitlines()
              if line.startswith("MFLOP count:")]
    assert mflops == [pytest.approx(_analytic_mflops(hw=16), rel=1e-9)]
    with open(tmp_path / "trace" / "trace_rank0.json") as f:
        trace = f.read()
    for op in ("att_group_aggregate", "att_group_aggregate_bwd", "dw_stencil",
               "dw_kernel_grad"):
        assert f'"uncrtaints::{op}"' in trace, op
    argv = ["--experiment_name", "smoke", "--weight_folder", cfg.res_dir, "--res_dir",
            str(tmp_path / "inference"), "--device", "cpu", "--max_samples_count", "2",
            "--trace_dir", str(tmp_path / "trace_test"), "--profile", "--plot_every", "-1",
            "--export_every", "-1"]
    cli_test.main(cli_test.load_test_config(argv))
    assert f"MFLOP count: {mflops[0]}" in capsys.readouterr().out
    with open(tmp_path / "trace_test" / "trace_rank0.json") as f:
        assert '"uncrtaints::att_group_aggregate"' in f.read()
