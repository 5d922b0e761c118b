"""The port's s2cloudless detector (uncrtaints_tpu_torch/data/s2cloudless.py),
mirroring tests/test_s2cloudless.py on a LightGBM model text the test
writes (the real weights are not in the repository): parsing, tree walks,
the disk post-processing (scipy cases skip without scipy), the detector
against the JAX package's copy, and the port's own weights cache."""

import os

import numpy as np
import pytest

from tests.test_s2cloudless import MODEL_TEXT
from uncrtaints_tpu.data import s2cloudless as js
from uncrtaints_tpu_torch.data import s2cloudless as ts


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def _detector(mod=ts):
    return mod.S2CloudlessDetector(model=mod.LightGBMModel.from_text(MODEL_TEXT),
                                   threshold=0.4, average_over=4, dilation_size=2)


def test_parse_and_predict_hand_walked():
    m = ts.LightGBMModel.from_text(MODEL_TEXT)
    assert len(m.trees) == 2 and m.num_features == 3
    x = np.array([[0.4, 0.1, 0.0], [0.4, 0.9, 0.9], [0.9, 0.0, 0.7]])
    np.testing.assert_allclose(m.raw_score(x), [-0.5, 1.5, 0.8])
    np.testing.assert_allclose(m.predict_proba(x), _sigmoid(np.array([-0.5, 1.5, 0.8])))


@pytest.mark.parametrize("row, want", [([0.5, 0.2, 0.7], -1.0 + 0.5),        # <= goes left
                                       ([np.nan, 0.9, np.nan], 2.0 + 0.5)])  # NaN default-left
def test_split_boundary_and_nan_go_left(row, want):
    m = ts.LightGBMModel.from_text(MODEL_TEXT)
    np.testing.assert_allclose(m.raw_score(np.array([row])), [want])


def test_single_leaf_tree_constant():
    txt = MODEL_TEXT.replace(
        "Tree=1\nnum_leaves=2\nnum_cat=0\nsplit_feature=2\nsplit_gain=1\n"
        "threshold=0.7\ndecision_type=2\nleft_child=-1\nright_child=-2\n"
        "leaf_value=0.5 -0.5",
        "Tree=1\nnum_leaves=1\nnum_cat=0\nsplit_feature=\nsplit_gain=\n"
        "threshold=\ndecision_type=\nleft_child=\nright_child=\n"
        "leaf_value=0.25")
    np.testing.assert_allclose(
        ts.LightGBMModel.from_text(txt).raw_score(np.array([[0.9, 0.0, 0.0]])), [0.3 + 0.25])


def test_no_trees_is_an_error():
    with pytest.raises(ValueError, match="no trees"):
        ts.LightGBMModel.from_text("tree\nversion=v3\n")


def test_disk_footprints():
    np.testing.assert_array_equal(ts.disk(1), [[0, 1, 0], [1, 1, 1], [0, 1, 0]])
    d2 = ts.disk(2)
    assert d2.shape == (5, 5) and d2.sum() == 13 and d2[0, 0] == 0


def test_average_and_dilate_vs_scipy():
    ndimage = pytest.importorskip("scipy.ndimage")
    rng = np.random.default_rng(0)
    p = rng.random((16, 16))
    k = ts.disk(4).astype(float)
    np.testing.assert_allclose(ts.average_disk(p, 4),
                               ndimage.convolve(p, k / k.sum(), mode="reflect"))
    np.testing.assert_array_equal(ts.dilate_disk(p > 0.6, 2),
                                  ndimage.binary_dilation(p > 0.6, structure=ts.disk(2)))


@pytest.mark.parametrize("seed", [1, 2])
def test_detector_equals_the_jax_packages(seed):
    pytest.importorskip("scipy.ndimage")
    rng = np.random.default_rng(seed)
    x = rng.random((2, 16, 16, 13))
    got, ref = _detector(ts), _detector(js)
    probs = got.get_cloud_probability_maps(x)
    assert probs.shape == (2, 16, 16)
    np.testing.assert_array_equal(probs, ref.get_cloud_probability_maps(x))
    feats = x[..., list(ts.MODEL_BAND_IDS)].reshape(-1, 10)
    np.testing.assert_allclose(probs, got.model.predict_proba(feats).reshape(2, 16, 16))
    masks = got.get_cloud_masks(x)
    assert masks.dtype == np.int8
    np.testing.assert_array_equal(masks, ref.get_cloud_masks(x))
    np.testing.assert_array_equal(masks[0], ts.dilate_disk(
        ts.average_disk(probs[0], 4) > 0.4, 2).astype(np.int8))
    assert ts.MODEL_BAND_IDS == js.MODEL_BAND_IDS


def test_find_model_file_env(tmp_path, monkeypatch):
    p = tmp_path / "model.txt"
    p.write_text(MODEL_TEXT)
    monkeypatch.setenv("S2CLOUDLESS_MODEL_PATH", str(p))
    assert ts.find_model_file() == str(p)
    det = ts.make_detector()
    assert det is not None and len(det.model.trees) == 2
    monkeypatch.setenv("S2CLOUDLESS_MODEL_PATH", str(tmp_path / "missing.txt"))
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path))
    monkeypatch.chdir(tmp_path)
    with pytest.raises(FileNotFoundError, match="uncrtaints_tpu_torch.cli.download"):
        ts.find_model_file(str(tmp_path / "missing.txt"))
    with pytest.warns(UserWarning, match="unavailable"):
        assert ts.make_detector() is None


def test_find_model_file_searches_the_ports_own_cache(tmp_path, monkeypatch):
    from uncrtaints_tpu.cli.download import s2cloudless_cache_dir as jax_cache
    from uncrtaints_tpu_torch.cli.download import (
        S2CLOUDLESS_MODEL, S2CLOUDLESS_URL, format_step, s2cloudless_cache_dir)

    monkeypatch.delenv("S2CLOUDLESS_MODEL_PATH", raising=False)
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path))
    monkeypatch.chdir(tmp_path)
    cache = s2cloudless_cache_dir()
    assert cache == os.path.join(str(tmp_path), "uncrtaints_tpu_torch") != jax_cache()
    # weights in the JAX package's cache only: the port does not look there
    os.makedirs(jax_cache())
    with open(os.path.join(jax_cache(), S2CLOUDLESS_MODEL), "w") as f:
        f.write(MODEL_TEXT)
    with pytest.raises(FileNotFoundError):
        ts.find_model_file()
    os.makedirs(cache)
    target = os.path.join(cache, S2CLOUDLESS_MODEL)
    with open(target, "w") as f:
        f.write(MODEL_TEXT)
    assert ts.find_model_file() == target
    # the download CLI plans a wget of the weights into exactly that path
    cmd = format_step(("download", S2CLOUDLESS_URL, target))
    assert cmd.startswith("wget") and target in cmd
