"""The port's 2-D filters (uncrtaints_tpu_torch/ops/filters.py) against the
JAX package's (uncrtaints_tpu/ops/filters.py) on the same seeded inputs, on
the CPU: median and closing exact, box and gaussian within 1e-6."""

import jax
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from uncrtaints_tpu.ops import filters as jf
from uncrtaints_tpu_torch.ops import filters as tf

# leading batch axes, odd and even sides, a side shorter than the gaussian's
# radius of 8 (the symmetric pad wraps more than once)
SHAPES = [(40, 56), (3, 17, 23), (2, 3, 16, 9), (4, 6, 30)]


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _both(name, x, *args):
    # jitted: one compile of the whole filter instead of one per eager op
    ref = np.asarray(jax.jit(getattr(jf, name), static_argnums=1)(jnp.asarray(x), *args))
    got = getattr(tf, name)(torch.from_numpy(x), *args)
    assert got.dtype == torch.float32 and tuple(got.shape) == x.shape
    return got.numpy(), ref


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("k", [5, 7])
def test_median_filter_is_exact(shape, k):
    got, ref = _both("median_filter2d", _x(shape), k)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("k", [5, 7])
def test_grey_closing_is_exact(shape, k):
    got, ref = _both("grey_closing", _x(shape, 1), k)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("k", [5, 7])
def test_box_filter_within_1e6(shape, k):
    got, ref = _both("box_filter2d", _x(shape, 2), k)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("shape", SHAPES)
def test_gaussian_filter_within_1e6(shape):
    got, ref = _both("gaussian_filter2d", _x(shape, 3), 2.0)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


def test_filters_match_scipy():
    """The semantics the JAX filters were built for, held on the port too."""
    ndi = pytest.importorskip("scipy.ndimage")
    sig = pytest.importorskip("scipy.signal")
    x = _x((32, 40), 4)
    t = torch.from_numpy(x)
    np.testing.assert_allclose(tf.median_filter2d(t, 5).numpy(), sig.medfilt2d(x, 5), atol=1e-6)
    np.testing.assert_allclose(tf.grey_closing(t, 5).numpy(), ndi.grey_closing(x, size=(5, 5)),
                               atol=1e-6)
    np.testing.assert_allclose(tf.box_filter2d(t, 7).numpy(),
                               sig.convolve2d(x, np.ones((7, 7)) / 49.0, mode="same"),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tf.gaussian_filter2d(t, 2.0).numpy(),
                               ndi.gaussian_filter(x, sigma=2.0), rtol=1e-4, atol=1e-5)


def test_gaussian_taps_are_made_once_per_device_and_sigma():
    a = tf._gaussian_taps(torch.device("cpu"), 2.0, 4.0)
    assert a is tf._gaussian_taps(torch.device("cpu"), 2.0, 4.0)
    assert a.numel() == 17 and a.dtype == torch.float32
    assert abs(float(a.sum()) - 1.0) < 1e-6
    assert tf._gaussian_taps(torch.device("cpu"), 1.0, 4.0).numel() == 9
