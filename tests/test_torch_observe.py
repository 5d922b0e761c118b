"""The port's observer: both writer backends (tensorboard's SummaryWriter and
the JSONL + media fallback), the file artifacts against the JAX package's
(same names, same bytes), and the rule for a machine without matplotlib."""

import glob
import json
import os
import sys

import numpy as np
import pytest

from uncrtaints_tpu.train import observe as jo
from uncrtaints_tpu_torch.train import observe as to


@pytest.fixture
def fallback_writer(tmp_path, monkeypatch):
    # poison the import so Writer takes the JSONL fallback
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    w = to.Writer(str(tmp_path / "logs"))
    assert w._writer is None, "fallback path not taken"
    yield w
    w.close()


def _jsonl_lines(logdir):
    with open(os.path.join(logdir, "scalars.jsonl")) as f:
        return [json.loads(l) for l in f if l.strip()]


def _figure():
    import matplotlib
    matplotlib.use("Agg")
    from matplotlib import pyplot as plt
    fig, ax = plt.subplots()
    ax.plot([0, 1], [1, 0])
    return fig, plt


def test_fallback_scalars_land_in_jsonl(fallback_writer):
    fallback_writer.add_scalar("train/loss", 0.5, 3)
    assert _jsonl_lines(fallback_writer.logdir) == [
        {"tag": "train/loss", "value": 0.5, "step": 3}]


@pytest.mark.parametrize("channels", [3, 1])
def test_fallback_images_persist_as_png(fallback_writer, channels):
    img = np.random.default_rng(0).random((16, 16, channels)).astype(np.float32)
    fallback_writer.add_image("Img/train/out", img, 7)
    rows = _jsonl_lines(fallback_writer.logdir)
    assert len(rows) == 1 and rows[0]["tag"] == "Img/train/out"
    path = os.path.join(fallback_writer.logdir, rows[0]["file"])
    assert path.endswith(".png") and os.path.getsize(path) > 0


def test_fallback_figures_persist_as_png(fallback_writer):
    fig, plt = _figure()
    fallback_writer.add_figure("Img/val/discard_uncertain", fig, 2)
    plt.close(fig)
    rows = _jsonl_lines(fallback_writer.logdir)
    path = os.path.join(fallback_writer.logdir, rows[0]["file"])
    assert os.path.exists(path) and os.path.getsize(path) > 0
    # the tag is sanitized into one flat path-safe file name
    assert "/" not in rows[0]["file"].split("media" + os.sep, 1)[1]


def test_fallback_histograms_persist_as_npy(fallback_writer):
    vals = np.arange(32, dtype=np.float32)
    fallback_writer.add_histogram("Hist/val/aleatoric", vals, 5)
    rows = _jsonl_lines(fallback_writer.logdir)
    np.testing.assert_array_equal(
        np.load(os.path.join(fallback_writer.logdir, rows[0]["file"])), vals)


def test_fallback_equals_the_jax_packages(tmp_path, monkeypatch):
    """The same calls through both packages' fallback writers: the same
    JSONL lines and the same media files."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    monkeypatch.setitem(sys.modules, "tensorflow", None)
    rng = np.random.default_rng(1)
    img, vals = rng.random((8, 8, 3)).astype(np.float32), rng.random(16)
    logs = {}
    for name, mod in (("jax", jo), ("port", to)):
        w = mod.Writer(str(tmp_path / name))
        w.add_scalar("a/b", 1.5, 1)
        w.add_image("Img/x y", img, 2)
        w.add_histogram("Hist/h", vals, 3)
        w.close()
        logs[name] = _jsonl_lines(w.logdir)
    assert logs["port"] == logs["jax"]
    for row in logs["port"][1:]:
        with open(tmp_path / "jax" / row["file"], "rb") as a, \
                open(tmp_path / "port" / row["file"], "rb") as b:
            assert a.read() == b.read(), row["file"]


def test_tensorboard_backend_writes_an_event_file(tmp_path):
    pytest.importorskip("torch.utils.tensorboard")
    w = to.Writer(str(tmp_path / "tb"))
    assert w._writer is not None and not hasattr(w, "_jsonl")
    w.add_scalar("train/loss", 0.25, 1)
    w.add_image("Img/one", np.zeros((8, 8, 1), np.float32), 1)
    w.add_image("Img/rgb", np.ones((2, 8, 8, 3), np.float32), 1)
    w.add_histogram("Hist/h", np.arange(32.0), 1)
    fig, plt = _figure()
    w.add_figure("Img/fig", fig, 1)
    plt.close(fig)
    w.close()
    events = glob.glob(str(tmp_path / "tb" / "events.out.tfevents.*"))
    assert events and os.path.getsize(events[0]) > 1000
    assert not os.path.exists(tmp_path / "tb" / "scalars.jsonl")


# ----------------------------------------------------- file artifacts --

def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _same_files(a, b):
    assert _files(a) == _files(b) and _files(a)
    for f in _files(a):
        with open(os.path.join(a, f), "rb") as x, open(os.path.join(b, f), "rb") as y:
            assert x.read() == y.read(), f


def test_export_and_diag_to_covar_equal_the_jax_packages(tmp_path):
    rng = np.random.default_rng(2)
    pred = rng.random((1, 6, 5, 13)).astype(np.float32)
    seq = rng.random((3, 6, 5, 13)).astype(np.float32)
    cov_ref, cov = jo.diag_to_covar(pred), to.diag_to_covar(pred)
    assert cov.shape == (1, 13, 13, 6, 5) and cov.dtype == np.float32
    np.testing.assert_array_equal(cov, cov_ref)
    for mod, root in ((jo, tmp_path / "jax"), (to, tmp_path / "port")):
        mod.export(pred, "pred", str(root), file_id=3)
        mod.export(seq, "in", str(root), file_id=3)
        mod.export(mod.diag_to_covar(pred), "covar", str(root), file_id=3)
    _same_files(str(tmp_path / "jax"), str(tmp_path / "port"))
    assert _files(str(tmp_path / "port")) == [
        "img-3_covar.npy", "img-3_in_t-0.npy", "img-3_in_t-1.npy", "img-3_in_t-2.npy",
        "img-3_pred.npy"]
    # CHW on disk
    assert np.load(tmp_path / "port" / "img-3_pred.npy").shape == (13, 6, 5)


def test_plot_img_and_plot_mask_equal_the_jax_packages(tmp_path):
    rng = np.random.default_rng(3)
    x = rng.random((3, 8, 8, 15)).astype(np.float32)
    y = rng.random((1, 8, 8, 13)).astype(np.float32)
    mask = rng.random((8, 8)).round()
    for mod, root in ((jo, str(tmp_path / "jax")), (to, str(tmp_path / "port"))):
        mod.plot_img(x, "in", root, file_id=0)
        mod.plot_img(y, "pred", root, file_id=0)
        mod.plot_img(y[..., :1] * 0.01, "err", root, file_id=0)
        mod.plot_img(y[..., :1] * 2e-5, "var", root, file_id=0)
        mod.plot_mask(mask, 3, root, file_id=0)
    _same_files(str(tmp_path / "jax"), str(tmp_path / "port"))
    with pytest.raises(NotImplementedError):
        to.plot_img(y, "nonsense", str(tmp_path / "port"), file_id=0)


def test_discard_and_err_vs_var_figures(tmp_path):
    from uncrtaints_tpu_torch.config import Config
    from uncrtaints_tpu_torch.metrics import compute_ece, compute_uce_auce
    rng = np.random.default_rng(4)
    var = rng.uniform(0.01, 1.0, 40)
    err = np.sqrt(var) * rng.standard_normal(40)
    cfg = Config(res_dir=str(tmp_path), experiment_name="e")
    to.plot_discard(compute_ece(var, err ** 2, 40), cfg, "test", 1, None)
    assert os.path.getsize(tmp_path / "e" / "plot_test_SE_discard.png") > 0
    assert os.path.getsize(tmp_path / "e" / "plot_test_SE_discard.pdf") > 0
    to.plot_err_vs_var(compute_uce_auce(var, err, 40)[2], "val", 1, None)


# ------------------------------------------------ without matplotlib --

@pytest.fixture
def no_matplotlib(monkeypatch):
    for name in [m for m in sys.modules if m.split(".")[0] == "matplotlib"]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    assert to.pyplot() is None


def test_without_matplotlib_the_epoch_end_figures_skip_with_a_line(
        no_matplotlib, tmp_path, capsys):
    from uncrtaints_tpu_torch.config import Config
    cfg = Config(res_dir=str(tmp_path), experiment_name="e")
    assert to.plot_discard(np.linspace(0, 1, 20), cfg, "test", 1, None) is None
    detail = {"bk_var": np.arange(20.0), "bk_err": np.arange(20.0)}
    assert to.plot_err_vs_var(detail, "test", 1, None) is None
    out = capsys.readouterr().out
    assert "plot_discard" in out and "plot_err_vs_var" in out and "matplotlib" in out
    assert not os.path.exists(tmp_path / "e")


def test_without_matplotlib_the_fallback_image_degrades_to_npy(no_matplotlib, fallback_writer):
    img = np.random.default_rng(5).random((8, 8, 3)).astype(np.float32)
    fallback_writer.add_image("Img/train/out", img, 1)
    rows = _jsonl_lines(fallback_writer.logdir)
    assert rows[0]["file"].endswith(".npy")
    np.testing.assert_array_equal(
        np.load(os.path.join(fallback_writer.logdir, rows[0]["file"])), img)


def test_without_matplotlib_plots_raise_and_the_clis_refuse_plot_every(
        no_matplotlib, tmp_path):
    from uncrtaints_tpu_torch.cli import test as cli_test, train as cli_train
    from uncrtaints_tpu_torch.config import Config, derive
    with pytest.raises(ImportError, match="matplotlib"):
        to.plot_img(np.zeros((1, 4, 4, 13), np.float32), "pred", str(tmp_path), file_id=0)
    with pytest.raises(ImportError, match="matplotlib"):
        to.plot_mask(np.zeros((4, 4)), 3, str(tmp_path), file_id=0)
    cfg = derive(Config(device="cpu", synthetic_data=True, plot_every=2,
                        res_dir=str(tmp_path / "r"), experiment_name="e"))
    for main in (cli_train.main, cli_test.main):
        with pytest.raises(ImportError, match="plot_every=2"):
            main(cfg)
    assert not os.path.exists(tmp_path / "r")  # refused before anything ran
