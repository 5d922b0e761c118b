"""The port's native slab writers (``uncrtaints_tpu_torch/native``) against
the port's numpy path and the JAX package's ``uncrtaints_tpu.native`` on the
same frames — the counterpart of ``tests/test_native.py``.

Every comparison is byte-equal (``np.array_equal`` of the raw bytes): the
writers copy, look up a table made with the numpy path's fp32 arithmetic, or
round to bf16 to nearest even, so there is nothing to round apart.
"""

import ctypes

import numpy as np
import pytest
import torch
from ml_dtypes import bfloat16

from uncrtaints_tpu import native as jnative
from uncrtaints_tpu_torch import native
from uncrtaints_tpu_torch.data import pipeline
from uncrtaints_tpu_torch.data.preprocess import process_MS


def _bytes_equal(a, b):
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    return a.shape == b.shape and a.tobytes() == b.tobytes()


def _u16(rng, shape=(13, 24, 20)):
    return rng.integers(0, 14000, shape).astype(np.uint16)


def test_the_library_builds_into_the_checkout():
    so = native.build()
    assert so.parent.parent.name == "native" and so.parent.parent.parent.name == "build"
    assert isinstance(native.lib(), ctypes.CDLL)


def test_torch_bf16_lut_equals_ml_dtypes_over_all_values():
    """The bf16 table made by torch equals ml_dtypes' round to nearest even
    (the JAX package's table) for every uint16 code and both methods."""
    for method in ("default", "resnet"):
        got = native.ms_lut(method, bf16=True)
        ref = jnative.ms_lut(method, bfloat16).view(np.uint16)
        assert got.dtype == np.uint16 and got.shape == (65536,)
        assert _bytes_equal(got, ref)
        assert _bytes_equal(native.ms_lut(method), jnative.ms_lut(method, np.float32))
    v = np.random.default_rng(0).standard_normal(100_000).astype(np.float32) * 1e3
    assert _bytes_equal(native.bf16_bits(v), v.astype(bfloat16).view(np.uint16))


@pytest.mark.parametrize("method", ["default", "resnet"])
@pytest.mark.parametrize("c0", [0, 2])
def test_u16_lut_writers(rng, method, c0):
    """uint16 DN -> float32 slab and -> bf16 slab: the numpy radiometry,
    and the JAX package's writers, to the byte."""
    u16 = _u16(rng)
    C, H, W = u16.shape
    f32 = np.zeros((H, W, c0 + C), np.float32)
    native.frame_into_slab(f32, c0, u16, method)
    ref = np.moveaxis(process_MS(u16.astype(np.float32), method), 0, -1)
    assert _bytes_equal(f32[..., c0:], ref.astype(np.float32))
    jf32 = np.zeros_like(f32)
    assert jnative.frame_into_slab(jf32, c0, u16, method)
    assert _bytes_equal(f32, jf32)

    b16 = np.zeros((H, W, c0 + C), np.uint16)
    native.frame_into_slab(b16, c0, u16, method, bf16=True)
    assert _bytes_equal(b16[..., c0:], ref.astype(bfloat16).view(np.uint16))
    jb16 = np.zeros((H, W, c0 + C), bfloat16)
    assert jnative.frame_into_slab(jb16, c0, u16, method)
    assert _bytes_equal(b16, jb16.view(np.uint16))


@pytest.mark.parametrize("c0", [0, 3])
def test_f32_writers_copy_and_round_to_nearest_even(rng, c0):
    f32 = (rng.standard_normal((5, 17, 9)) * 300).astype(np.float32)
    f32[0, 0, :4] = [1.00390625, 1.01171875, -2.0078125, 3.0e-39]  # ties and a denormal
    C, H, W = f32.shape
    out = np.zeros((H, W, c0 + C), np.float32)
    native.frame_into_slab(out, c0, f32)
    assert _bytes_equal(out[..., c0:], np.moveaxis(f32, 0, -1))
    b16 = np.zeros((H, W, c0 + C), np.uint16)
    native.frame_into_slab(b16, c0, f32, bf16=True)
    ref = np.moveaxis(f32, 0, -1).astype(bfloat16).view(np.uint16)
    assert _bytes_equal(b16[..., c0:], ref)
    jb16 = np.zeros((H, W, c0 + C), bfloat16)
    assert jnative.frame_into_slab(jb16, c0, f32)
    assert _bytes_equal(b16, jb16.view(np.uint16))
    bits = torch.from_numpy(b16[..., c0:].copy()).view(torch.bfloat16)
    assert torch.equal(bits, torch.from_numpy(np.moveaxis(f32, 0, -1).copy()).bfloat16())


def test_u16_raw_copy_and_transpose(rng):
    u16 = _u16(rng, (13, 8, 11))
    out = np.zeros((8, 11, 15), np.uint16)
    native.frame_into_slab(out, 2, u16)
    assert _bytes_equal(out[..., 2:], np.moveaxis(u16, 0, -1)) and not out[..., :2].any()
    jout = np.zeros_like(out)
    assert jnative.frame_into_slab(jout, 2, u16)
    assert _bytes_equal(out, jout)
    f32 = rng.random((7, 9, 11)).astype(np.float32)
    assert _bytes_equal(native.chw_to_hwc(f32), jnative.chw_to_hwc(f32))
    assert _bytes_equal(native.chw_to_hwc(f32), np.moveaxis(f32, 0, -1))


def test_guard_rails_raise(rng):
    u16 = _u16(rng, (13, 8, 8))
    with pytest.raises(ValueError, match="slab"):
        native.frame_into_slab(np.zeros((8, 9, 13), np.float32), 0, u16)
    with pytest.raises(ValueError, match="exceed"):
        native.frame_into_slab(np.zeros((8, 8, 14), np.float32), 2, u16)
    with pytest.raises(ValueError, match="exceed"):
        native.frame_into_slab(np.zeros((8, 8, 14), np.float32), -1, u16)
    with pytest.raises(ValueError, match="contiguous"):
        native.frame_into_slab(np.zeros((8, 8, 26), np.float32)[..., ::2], 0, u16)
    with pytest.raises(TypeError, match="no writer"):
        native.frame_into_slab(np.zeros((8, 8, 13), np.float64), 0, u16)
    with pytest.raises(TypeError, match="no writer"):  # float32 into uint16 only as bf16
        native.frame_into_slab(np.zeros((8, 8, 13), np.uint16), 0, u16.astype(np.float32))
    with pytest.raises(ValueError, match="float32"):
        native.chw_to_hwc(u16)


def test_a_failed_build_raises_with_the_compilers_output(tmp_path, monkeypatch):
    """No silent fallback: a compiler that fails is reported, with its
    output, by the first write."""
    monkeypatch.setattr(native, "_BUILD_ROOT", tmp_path)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "CXX_FLAGS", native.CXX_FLAGS + ("-DUNCR_BROKEN", "-x",
                                                                  "c++", "-include", "nope.h"))
    with pytest.raises(RuntimeError, match="(?s)build failed.*nope.h"):
        native.frame_into_slab(np.zeros((8, 8, 13), np.float32), 0,
                               np.zeros((13, 8, 8), np.uint16))
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        native.build()


def test_collates_write_through_the_native_writers(rng, monkeypatch):
    """make_fast_collate, make_raw_collate and the generic collate's
    transposes call the writers (no numpy write of a supported pair)."""
    from uncrtaints_tpu_torch.data.synthetic import SyntheticSEN12MSCRTS
    ds = SyntheticSEN12MSCRTS(n_samples=2, n_input_t=3, patch_size=8, seed=2)
    samples = [ds[0], ds[1]]
    raw = [{**s, "input": dict(s["input"], S2=[_u16(rng, f.shape) for f in s["input"]["S2"]]),
            "target": dict(s["target"], S2=[_u16(rng, s["target"]["S2"][0].shape)])}
           for s in samples]
    calls = []
    write, hwc = native.frame_into_slab, native.chw_to_hwc
    monkeypatch.setattr(native, "frame_into_slab",
                        lambda *a, **k: (calls.append(a[2].dtype), write(*a, **k))[1])
    monkeypatch.setattr(native, "chw_to_hwc", lambda f: (calls.append("hwc"), hwc(f))[1])
    pipeline.make_fast_collate()(samples)
    assert calls.count(np.dtype(np.float32)) == 2 * (3 + 3) + 2  # S1, S2 frames, targets
    calls.clear()
    pipeline.make_raw_collate()(raw)
    assert calls.count(np.dtype(np.uint16)) == 2 * (3 + 1) and calls.count(np.float32) == 6
    calls.clear()
    pipeline.collate_multi(samples)
    assert calls.count("hwc") == 2 * (3 + 3 + 1)
    calls.clear()
    # a dtype the writers do not take goes through the generic collate
    pipeline.make_fast_collate(x_dtype=np.float16)(samples)
    assert "hwc" in calls and np.dtype(np.float32) not in calls
