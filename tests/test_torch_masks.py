"""The port's cloud and shadow masks (uncrtaints_tpu_torch/data/masks.py)
against the JAX package's (uncrtaints_tpu/data/masks.py) on the same seeded
S2 stacks, on the CPU: the cloud score within 1e-6, the shadow and merged
masks equal, every detector mode of ``get_cloud_map``, the blank guard and
the batched call against the per-frame one."""

import warnings

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from uncrtaints_tpu.data import masks as jm
from uncrtaints_tpu_torch.data import masks as tm
from uncrtaints_tpu_torch.data.s2cloudless import LightGBMModel, S2CloudlessDetector

HW = 24


def scene(seed, T=4, H=HW, W=HW):
    """Raw S2 DN stacks [T, H, W, 13]: a textured ground, bright cloud blobs
    and dark shadow patches, so clouds, shadows and clear ground all occur."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:H, :W]
    # vegetation-like reflectance per band (B01..B12), a smooth texture, noise
    ground = np.array([600, 500, 700, 500, 1000, 2000, 2500, 3000, 3000, 1000, 100, 2000,
                       1000], np.float64)
    texture = 1.0 + 0.15 * np.sin(xx / 3.0 + seed)[..., None] * np.cos(yy / 4.0)[..., None]
    img = ground * texture * (1.0 + 0.02 * rng.standard_normal((T, H, W, 13)))
    for t in range(T):
        for _ in range(2):
            cy, cx, r = rng.integers(0, H), rng.integers(0, W), rng.integers(3, 8)
            blob = (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r
            img[t][blob] = 5000.0 + 4000.0 * rng.random((int(blob.sum()), 13))
        y0, x0 = rng.integers(0, H - 6), rng.integers(0, W - 6)
        img[t, y0:y0 + 6, x0:x0 + 6] *= 0.15
    return img.astype(np.float32)


def _detector():
    from tests.test_s2cloudless import MODEL_TEXT
    return S2CloudlessDetector(model=LightGBMModel.from_text(MODEL_TEXT),
                               threshold=0.4, average_over=4, dilation_size=2)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("moist", [False, True])
def test_cloud_score_within_1e6(seed, moist):
    img = scene(seed)
    ref = np.asarray(jax.jit(jm.get_cloud_mask, static_argnums=(1, 2, 3))(
        jnp.asarray(img), 0.2, False, moist))
    got = tm.get_cloud_mask(torch.from_numpy(img), use_moist_check=moist).numpy()
    assert got.shape == (4, HW, HW)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    assert 0.0 < (ref >= 0.2).mean() < 1.0  # the score binarizes to both labels


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_shadow_and_merged_masks_equal(seed):
    img = scene(seed)
    shadow = tm.get_shadow_mask(torch.from_numpy(img)).numpy()
    np.testing.assert_array_equal(shadow, np.asarray(jax.jit(jm.get_shadow_mask)(jnp.asarray(img))))
    assert (shadow < 0).any() and (shadow == 0).any()
    merged = tm.get_cloud_cloudshadow_mask(torch.from_numpy(img)).numpy()
    np.testing.assert_array_equal(merged, np.asarray(jm.cloud_cloudshadow_mask_batched(
        jnp.asarray(img))))
    assert 0.05 < merged.mean() < 0.95


@pytest.mark.parametrize("seed", [0, 3])
def test_get_cloud_map_threshold_detector_equals_the_jax_packages(seed):
    img = scene(seed)
    for t in range(len(img)):
        got = tm.get_cloud_map(img[t], "cloud_cloudshadow_mask", device="cpu")
        assert got.dtype == np.float32 and got.shape == (HW, HW)
        np.testing.assert_array_equal(got, jm.get_cloud_map(img[t], "cloud_cloudshadow_mask"))


@pytest.mark.parametrize("detector", ["s2cloudless_mask", "s2cloudless_map"])
def test_get_cloud_map_with_an_injected_s2cloudless_instance(detector):
    det = _detector()
    img = scene(4) * 1.3  # some DNs over 10000: the dispatch clips them
    for t in range(2):
        got = tm.get_cloud_map(img[t], detector, instance=det, device="cpu")
        ref = jm.get_cloud_map(img[t], detector, instance=det)
        assert got.dtype == np.float32 and got.shape == (HW, HW)
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    batched = tm.get_cloud_map(img[:2], detector, instance=det, device="cpu")
    np.testing.assert_array_equal(batched, np.stack(
        [tm.get_cloud_map(img[t], detector, instance=det, device="cpu") for t in range(2)]))


def test_missing_weights_is_a_hard_error(tmp_path, monkeypatch):
    monkeypatch.setenv("S2CLOUDLESS_MODEL_PATH", str(tmp_path / "nope.txt"))
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path))  # an empty cache
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(tm, "_S2C_CACHE", {"detector": None, "tried": False})
    img = scene(5, T=1)[0]
    for detector in tm.S2CLOUDLESS_MODES:
        with pytest.raises(RuntimeError, match="uncrtaints_tpu_torch.cli.download"):
            tm.get_cloud_map(img, detector, device="cpu")
    # the threshold detector, chosen explicitly, still runs
    assert tm.get_cloud_map(img, "cloud_cloudshadow_mask", device="cpu").shape == (HW, HW)


def test_unknown_detector_defaults_to_cloudy_with_a_warning():
    img = scene(6, T=2)
    with pytest.warns(UserWarning, match="not yet implemented"):
        got = tm.get_cloud_map(img, "no_such_mask", device="cpu")
    np.testing.assert_array_equal(got, np.ones((2, HW, HW), np.float32))


@pytest.mark.parametrize("detector", ["cloud_cloudshadow_mask", "s2cloudless_mask"])
def test_blank_guard_per_frame(detector):
    img = scene(7, T=3)
    img[1] = 0.0
    kw = dict(instance=_detector()) if detector != "cloud_cloudshadow_mask" else {}
    with pytest.warns(UserWarning, match="blank sample"):
        one = tm.get_cloud_map(img[1], detector, device="cpu", **kw)
    with pytest.warns(UserWarning, match="blank sample"):
        ref = jm.get_cloud_map(img[1], detector, **kw)
    np.testing.assert_array_equal(one, ref)
    np.testing.assert_array_equal(one, np.ones((HW, HW), np.float32))
    with pytest.warns(UserWarning, match="blank sample"):
        stack = tm.get_cloud_map(img, detector, device="cpu", **kw)
    np.testing.assert_array_equal(stack[1], one)
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # no warning for frames that are not blank
        for t in (0, 2):
            np.testing.assert_array_equal(stack[t], tm.get_cloud_map(img[t], detector,
                                                                     device="cpu", **kw))


def test_batched_call_equals_the_per_frame_one():
    """The datasets' call: a bands-last view of a bands-first frame stack,
    and a leading batch of stacks."""
    img = scene(8, T=6)
    per_frame = np.stack([tm.get_cloud_map(f, device="cpu") for f in img])
    chw = np.ascontiguousarray(np.moveaxis(img, -1, 1))            # [T, 13, H, W]
    np.testing.assert_array_equal(tm.get_cloud_map(np.moveaxis(chw, 1, -1), device="cpu"),
                                  per_frame)
    np.testing.assert_array_equal(tm.get_cloud_map(img, device="cpu"), per_frame)
    np.testing.assert_array_equal(tm.get_cloud_map(img.reshape(2, 3, HW, HW, 13), device="cpu"),
                                  per_frame.reshape(2, 3, HW, HW))
    # and equal to the JAX package's batched entry point
    np.testing.assert_array_equal(per_frame, np.asarray(jm.cloud_cloudshadow_mask_batched(
        jnp.asarray(np.clip(img, 0, 10000)))))


def test_the_default_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tm.get_cloud_map(scene(9, T=1)[0])
