"""The port's GeoTIFF codec (uncrtaints_tpu_torch/data/tiff.py), mirroring
tests/test_tiff.py: round trips through its own writer, cross-checks with
PIL (skipped without Pillow) and with the JAX package's codec, the merge,
and the writer's word alignment (a fix over the original: every strip,
external tag array and the IFD start on an even offset)."""

import io
import struct

import numpy as np
import pytest

from uncrtaints_tpu.data import tiff as jt
from uncrtaints_tpu_torch.data import tiff as tf


def _arr(dtype, S=3, H=21, W=17, seed=0):
    rng = np.random.default_rng(seed)
    if np.dtype(dtype).kind == "f":
        return (rng.standard_normal((S, H, W)) * 100).astype(dtype)
    info = np.iinfo(dtype)
    return rng.integers(info.min, info.max, (S, H, W), endpoint=True, dtype=dtype)


@pytest.fixture
def pil():
    return pytest.importorskip("PIL.Image", reason="Pillow not installed")


# ------------------------------------------------ writer -> reader round trips

@pytest.mark.parametrize("dtype", ["u1", "u2", "i2", "u4", "i4", "f4", "f8"])
@pytest.mark.parametrize("planar", [1, 2])
@pytest.mark.parametrize("compression", ["none", "deflate"])
def test_roundtrip(tmp_path, dtype, planar, compression):
    a = _arr(dtype)
    p = str(tmp_path / "t.tif")
    tf.write_tiff(p, a, planar=planar, compression=compression)
    b = tf.read_tiff(p)
    assert b.dtype == a.dtype
    np.testing.assert_array_equal(a, b)
    # the JAX package's reader decodes the port's file to the same array
    np.testing.assert_array_equal(jt.read_tiff(p), a)


@pytest.mark.parametrize("dtype", ["u2", "i2", "u1"])
def test_roundtrip_predictor(tmp_path, dtype):
    a = _arr(dtype)
    p = str(tmp_path / "t.tif")
    tf.write_tiff(p, a, compression="deflate", predictor=2)
    np.testing.assert_array_equal(a, tf.read_tiff(p))


def test_roundtrip_13band_sentinel_shape(tmp_path):
    rng = np.random.default_rng(7)
    a = rng.integers(0, 16384, (13, 64, 64), dtype=np.uint16)
    p = str(tmp_path / "s2.tif")
    tf.write_tiff(p, a, compression="deflate", predictor=2, rows_per_strip=16)
    np.testing.assert_array_equal(a, tf.read_tiff(p))


def test_roundtrip_multiple_strips_and_2d(tmp_path):
    a = _arr("u2", S=1, H=37, W=11)[0]
    p = str(tmp_path / "t.tif")
    tf.write_tiff(p, a, rows_per_strip=5)
    np.testing.assert_array_equal(a[None], tf.read_tiff(p))


def test_bounds_roundtrip(tmp_path):
    a = _arr("u2", S=2, H=16, W=32)
    p = str(tmp_path / "t.tif")
    bounds = [500000.0, 4100000.0, 500320.0, 4100160.0]  # 10 m pixels
    tf.write_tiff(p, a, bounds=bounds)
    np.testing.assert_allclose(tf.read_tiff_bounds(p), bounds, rtol=1e-12)
    assert tf.read_tiff_bounds(p) == jt.read_tiff_bounds(p)
    tf.write_tiff(p, a)  # no geo tags: zeros, as the rasterio fallback
    assert tf.read_tiff_bounds(p) == [0.0, 0.0, 0.0, 0.0]


@pytest.mark.parametrize("compression", ["none", "deflate"])
@pytest.mark.parametrize("planar", [1, 2])
def test_the_codecs_read_each_others_files(tmp_path, compression, planar):
    a = _arr("u2", S=13, H=19, W=23, seed=5)
    mine, theirs = str(tmp_path / "mine.tif"), str(tmp_path / "theirs.tif")
    bounds = [0.0, 0.0, 230.0, 190.0]
    tf.write_tiff(mine, a, planar=planar, compression=compression, bounds=bounds)
    jt.write_tiff(theirs, a, planar=planar, compression=compression, bounds=bounds)
    for p in (mine, theirs):
        np.testing.assert_array_equal(tf.read_tiff(p), jt.read_tiff(p))
        assert tf.read_tiff_bounds(p) == jt.read_tiff_bounds(p)


# ---------------------------------------- word alignment (the writer's fix)

def _layout(path):
    """(strip offsets, external array offsets, IFD offset) of a classic
    little-endian file."""
    buf = open(path, "rb").read()
    (ifd,) = struct.unpack_from("<L", buf, 4)
    (n,) = struct.unpack_from("<H", buf, ifd)
    strips, ext = [], []
    for i in range(n):
        tag, ftype, count = struct.unpack_from("<HHL", buf, ifd + 2 + 12 * i)
        size = tf._TYPES[ftype][1] * count
        if tag == 273:  # StripOffsets
            if size <= 4:
                strips += list(struct.unpack_from("<" + "L" * count, buf, ifd + 10 + 12 * i))
            else:
                (off,) = struct.unpack_from("<L", buf, ifd + 10 + 12 * i)
                strips += list(struct.unpack_from("<" + "L" * count, buf, off))
        if size > 4:
            ext.append(struct.unpack_from("<L", buf, ifd + 10 + 12 * i)[0])
    return strips, ext, ifd


@pytest.mark.parametrize("compression", ["none", "deflate"])
def test_writer_starts_strips_arrays_and_the_ifd_on_even_offsets(tmp_path, compression):
    # 1 band of uint8, odd width and rows: every raw strip has an odd length
    a = _arr("u1", S=1, H=9, W=7, seed=2)
    p = str(tmp_path / "odd.tif")
    tf.write_tiff(p, a, compression=compression, rows_per_strip=3,
                  bounds=[0.0, 0.0, 7.0, 9.0])
    strips, ext, ifd = _layout(p)
    assert len(strips) == 3 and ext
    assert all(o % 2 == 0 for o in strips + ext + [ifd]), (strips, ext, ifd)
    np.testing.assert_array_equal(tf.read_tiff(p), a)
    np.testing.assert_array_equal(jt.read_tiff(p), a)
    # the original writer leaves them odd: the difference this copy fixes
    jt.write_tiff(p, a, compression="none", rows_per_strip=3)
    assert any(o % 2 for o in _layout(p)[0])


def test_the_copy_leaves_out_the_unused_predictor_helper():
    assert hasattr(jt, "_undo_predictor") and not hasattr(tf, "_undo_predictor")


# --------------------------------------------- cross-validation against PIL

@pytest.mark.parametrize("pil_comp", [None, "tiff_lzw", "tiff_adobe_deflate", "packbits"])
def test_read_pil_written_uint8_rgb(tmp_path, pil, pil_comp):
    rng = np.random.default_rng(1)
    hwc = rng.integers(0, 255, (40, 33, 3), endpoint=True, dtype=np.uint8)
    p = str(tmp_path / "pil.tif")
    pil.fromarray(hwc, "RGB").save(p, format="TIFF",
                                   **({"compression": pil_comp} if pil_comp else {}))
    np.testing.assert_array_equal(tf.read_tiff(p), np.moveaxis(hwc, -1, 0))


@pytest.mark.parametrize("pil_comp", [None, "tiff_adobe_deflate", "tiff_lzw"])
def test_read_pil_written_uint16(tmp_path, pil, pil_comp):
    rng = np.random.default_rng(2)
    hw = rng.integers(0, 65535, (25, 31), endpoint=True, dtype=np.uint16)
    p = str(tmp_path / "pil16.tif")
    pil.fromarray(hw).save(p, format="TIFF", **({"compression": pil_comp} if pil_comp else {}))
    np.testing.assert_array_equal(tf.read_tiff(p), hw[None])


def test_pil_reads_our_files(tmp_path, pil):
    rng = np.random.default_rng(3)
    hw = rng.integers(0, 65535, (19, 23), endpoint=True, dtype=np.uint16)
    for comp in ("none", "deflate"):
        p = str(tmp_path / f"ours_{comp}.tif")
        tf.write_tiff(p, hw[None], compression=comp)
        with pil.open(p) as img:
            np.testing.assert_array_equal(np.asarray(img), hw)
    hwc = rng.integers(0, 255, (12, 15, 3), endpoint=True, dtype=np.uint8)
    p = str(tmp_path / "ours_rgb.tif")
    tf.write_tiff(p, np.moveaxis(hwc, -1, 0))
    with pil.open(p) as img:
        np.testing.assert_array_equal(np.asarray(img.convert("RGB")), hwc)


def test_lzw_long_runs(pil):
    rng = np.random.default_rng(4)
    a = np.concatenate([np.repeat(rng.integers(0, 50, 200, dtype=np.uint8), 37),
                        rng.integers(0, 255, 5000, endpoint=True, dtype=np.uint8)])
    bio = io.BytesIO()
    pil.fromarray(a.reshape(1, -1), "L").save(bio, format="TIFF", compression="tiff_lzw")
    np.testing.assert_array_equal(tf.TiffFile(bio.getvalue()).read()[0, 0], a)


# ------------------------------------------------- reader robustness details

def test_big_endian_and_tiled():
    """A hand-built big-endian tiled file (the two layouts the writer does
    not emit)."""
    H = W = 8
    tw = th = 4
    a = np.arange(H * W, dtype=">u2").reshape(H, W)
    tiles = [a[ty * th:(ty + 1) * th, tx * tw:(tx + 1) * tw].tobytes()
             for ty in range(2) for tx in range(2)]
    offs, pos = [], 8
    for t in tiles:
        offs.append(pos)
        pos += len(t)
    entries = [
        (256, 3, 1, (W,)), (257, 3, 1, (H,)), (258, 3, 1, (16,)),
        (259, 3, 1, (1,)), (277, 3, 1, (1,)),
        (322, 3, 1, (tw,)), (323, 3, 1, (th,)),
        (324, 4, 4, tuple(offs)), (325, 4, 4, tuple(len(t) for t in tiles)),
        (339, 3, 1, (1,)),
    ]
    ifd_off = pos + 4 * 4 * 2
    ext = b"".join(struct.pack(">4L", *entries[i][3]) for i in (7, 8))
    ent_bytes, ext_pos = b"", pos
    for tag, ftype, count, vals in entries:
        ent_bytes += struct.pack(">HHL", tag, ftype, count)
        size = {3: 2, 4: 4}[ftype] * count
        if size <= 4:
            ent_bytes += struct.pack({3: ">H", 4: ">L"}[ftype] * count, *vals).ljust(4, b"\0")
        else:
            ent_bytes += struct.pack(">L", ext_pos)
            ext_pos += size
    buf = (struct.pack(">2sHL", b"MM", 42, ifd_off) + b"".join(tiles) + ext
           + struct.pack(">H", len(entries)) + ent_bytes + struct.pack(">L", 0))
    np.testing.assert_array_equal(tf.TiffFile(buf).read(), a.astype("=u2")[None])


def test_unsupported_raises():
    with pytest.raises(ValueError, match="byte-order"):
        tf.TiffFile(b"XX\x00\x00garbage")
    with pytest.raises(ValueError, match="magic"):
        tf.TiffFile(b"II\x07\x00garbage")


# ------------------------------------------- merge_arrays (rasterio 'first')

def test_merge_2x2_grid():
    mk = lambda v: np.full((2, 4, 4), v, np.float32)
    bounds = [(0, 4, 4, 8), (4, 4, 8, 8), (0, 0, 4, 4), (4, 0, 8, 4)]
    out = tf.merge_arrays([mk(1), mk(2), mk(3), mk(4)], bounds)
    assert out.shape == (2, 8, 8)
    assert out[0, 0, 0] == 1 and out[0, 0, 7] == 2
    assert out[0, 7, 0] == 3 and out[0, 7, 7] == 4
    np.testing.assert_array_equal(out, jt.merge_arrays([mk(1), mk(2), mk(3), mk(4)], bounds))


def test_merge_overlap_first_wins_and_gaps_are_nodata():
    mk = lambda v, w=4: np.full((1, 4, w), v, np.float32)
    out = tf.merge_arrays([mk(9), mk(5)], [(0, 0, 4, 4), (2, 0, 6, 4)])
    assert out.shape == (1, 4, 6)
    assert (out[0, :, :4] == 9).all() and (out[0, :, 4:] == 5).all()
    out = tf.merge_arrays([mk(1, 2), mk(2, 2)], [(0, 0, 2, 4), (4, 0, 6, 4)])
    assert out.shape == (1, 4, 6) and (out[0, :, 2:4] == 0).all()
