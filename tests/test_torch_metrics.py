"""The port's metrics against the JAX package's: ``img_metrics`` (with the
pixelwise vectors), ``AvgImgMetrics`` and the calibration functions, on the
same numpy inputs made from a seed."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uncrtaints_tpu import metrics as jm
from uncrtaints_tpu_torch import metrics as tm

SCALARS = ("RMSE", "MAE", "PSNR", "SAM", "SSIM")
VAR_SCALARS = ("error", "mean ae", "mean se", "mean var")
PIXELWISE = ("pixelwise error", "pixelwise ae", "pixelwise se", "pixelwise var")


def _sample(seed, hw=32):
    rng = np.random.default_rng(seed)
    t = rng.random((1, hw, hw, 13)).astype(np.float32)
    p = np.clip(t + 0.05 * rng.standard_normal(t.shape).astype(np.float32), 0, 1)
    v = (0.01 + rng.random(t.shape)).astype(np.float32)
    return t, p, v


def test_exports_match_the_jax_packages():
    assert set(tm.__all__) == set(jm.__all__)
    assert all(hasattr(tm, n) for n in jm.__all__)


@pytest.mark.parametrize("seed", [0, 1])
def test_img_metrics_match_jax(seed):
    """fp32 on both sides: 1e-5 relative for every scalar."""
    t, p, _ = _sample(seed)
    ref = jm.img_metrics(jnp.asarray(t), jnp.asarray(p))
    got = tm.img_metrics(torch.from_numpy(t), torch.from_numpy(p))
    assert set(got) == set(ref) == set(SCALARS)
    for k in SCALARS:
        assert isinstance(got[k], float)
        assert got[k] == pytest.approx(ref[k], rel=1e-5), k


@pytest.mark.parametrize("pixelwise", [True, False])
def test_img_metrics_with_var_match_jax(pixelwise):
    """The error statistics and the pixelwise vectors, 1e-5 relative (the
    signed mean error against the mean absolute error, which bounds it)."""
    t, p, v = _sample(2)
    t[0, 3, 4, 5] = np.nan  # nanmean skips it
    ref = jm.img_metrics(jnp.asarray(t), jnp.asarray(p), var=jnp.asarray(v),
                         pixelwise=pixelwise)
    got = tm.img_metrics(torch.from_numpy(t), torch.from_numpy(p),
                         var=torch.from_numpy(v), pixelwise=pixelwise)
    assert set(got) == set(ref)
    assert ("pixelwise var" in got) == pixelwise
    for k in VAR_SCALARS:
        assert got[k] == pytest.approx(ref[k], rel=1e-5, abs=1e-5 * ref["mean ae"]), k
    if pixelwise:
        for k in PIXELWISE:
            assert isinstance(got[k], np.ndarray) and got[k].shape == (32 * 32,)
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, atol=1e-6)


def test_img_metrics_agree_with_the_batch_form():
    """One sample through img_metrics equals its row of img_metrics_batch."""
    rows = [_sample(s) for s in (3, 4)]
    T, P, V = (torch.from_numpy(np.stack([r[i] for r in rows])) for i in range(3))
    batch = tm.img_metrics_batch(T, P, var=V)
    for b in range(2):
        one = tm.img_metrics(T[b], P[b], var=V[b], pixelwise=False)
        for k, v in one.items():
            assert float(batch[k][b]) == pytest.approx(v, rel=1e-5, abs=1e-7), k


def test_avg_meter_nan_skipping_and_tensors():
    ref, got = jm.AvgImgMetrics(), tm.AvgImgMetrics()
    for m in (ref, got):
        m.add({"RMSE": 1.0, "PSNR": float("nan"), "unknown": 3.0})
        m.add({"RMSE": 3.0, "PSNR": 10.0, "pixelwise se": np.ones(4)})
        m.add({"SSIM": np.float32(0.5)})
    got.add({"SAM": torch.tensor(2.0), "MAE": torch.ones(3)})  # a vector is skipped
    ref.add({"SAM": 2.0})
    v = got.value()
    assert v["RMSE"] == 2.0 and v["PSNR"] == 10.0 and v["SAM"] == 2.0
    assert np.isnan(v["MAE"]) and "unknown" not in v
    assert {k: x for k, x in v.items() if not np.isnan(x)} == {
        k: x for k, x in ref.value().items() if not np.isnan(x)}
    got["UCE SE"] = 0.5
    assert got.value()["UCE SE"] == 0.5
    got.reset()
    assert got.counts["RMSE"] == 0 and "UCE SE" not in got.value()


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("n", [7, 20, 500])
def test_calibration_equals_the_jax_packages(seed, n):
    """numpy copies: equal to 1e-12."""
    rng = np.random.default_rng(seed)
    var = rng.uniform(0.01, 1.0, n)
    err = np.sqrt(var) * rng.standard_normal(n)
    np.testing.assert_allclose(tm.compute_ece(var, err ** 2, n, percent=5),
                               jm.compute_ece(var, err ** 2, n, percent=5),
                               rtol=1e-12, atol=0, equal_nan=True)
    for l2 in (True, False):
        ru, ra, rd = jm.compute_uce_auce(var, err, n, percent=5, l2=l2)
        gu, ga, gd = tm.compute_uce_auce(var, err, n, percent=5, l2=l2)
        assert gu == pytest.approx(ru, rel=1e-12) and ga == pytest.approx(ra, rel=1e-12)
        assert set(gd) == set(rd)
        for k in rd:
            np.testing.assert_allclose(gd[k], rd[k], rtol=1e-12, equal_nan=True)
    np.testing.assert_array_equal(tm.binarize(var, 20, var.min(), var.max()),
                                  jm.binarize(var, 20, var.min(), var.max()))


def test_compute_ece_discard_curve():
    variances = np.arange(20, dtype=np.float64)
    curve = tm.compute_ece(variances, variances.copy(), 20, percent=5)
    np.testing.assert_allclose(curve, [(r - 1) / 2 for r in range(1, 21)])
