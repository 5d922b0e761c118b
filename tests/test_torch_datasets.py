"""The port's datasets against the JAX package's on the same file trees of
real GeoTIFF bytes (written by the port's writer, read by both packages'
codecs), on the CPU; mirrors tests/test_fixture_tree.py and
tests/test_fixture_tree_realtif.py.

Paths, indices, dates, coverage and every array of every sample are held
equal (arrays within 1e-6) in all four acquisition modes of SEN12MSCRTS
(online with each sampler, imported indices with the epoch-wrapped index,
imported coverage, the custom mosaic) and for SEN12MSCR; get_pairedS1, the
precompute CLI's .npy and the HDF5 converter and source are held against
the JAX package's too."""

import os
import warnings

import numpy as np
import pytest
import torch

import uncrtaints_tpu.data.pipeline as jpipe
import uncrtaints_tpu.data.sen12mscr as jcr
import uncrtaints_tpu.data.sen12mscrts as jts
from uncrtaints_tpu_torch.cli.test import CUSTOM_DATES, CUSTOM_PATCHES
from uncrtaints_tpu_torch.config import Config, derive
from uncrtaints_tpu_torch.data import make_fast_collate, make_raw_collate
from uncrtaints_tpu_torch.data import sen12mscr as tcr, sen12mscrts as tts
from uncrtaints_tpu_torch.data.preprocess import process_MS
from uncrtaints_tpu_torch.data.synthetic_tree import (
    default_date, patch_name, write_sen12mscrts_tree)
from uncrtaints_tpu_torch.data.tiff import write_tiff
from uncrtaints_tpu_torch.train import batch_to_device
from uncrtaints_tpu_torch.train.engine import _prepare_xy

HW = 16
T = 30
TRAIN, VAL, TEST = "ROIs1868/114", "ROIs1868/17", "ROIs1158/106"
MASKS = "cloud_cloudshadow_mask"


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("sen12mscrts"))
    # the train ROI deflate-compressed, the others raw
    write_sen12mscrts_tree(root, {TRAIN: range(2), VAL: range(1), TEST: range(2)}, hw=HW,
                           deflate=[TRAIN], seed=3, workers=2)
    return root


@pytest.fixture(scope="module")
def custom_tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("custom"))
    write_sen12mscrts_tree(root, {"ROIs1868/73": CUSTOM_PATCHES}, hw=8,
                           time_points=sorted(CUSTOM_DATES), dates=CUSTOM_DATES, workers=2)
    return root


def same(got, ref, where="sample"):
    """Equal structure, types and values; arrays within 1e-6."""
    if isinstance(ref, dict):
        assert set(got) == set(ref), where
        for k in ref:
            same(got[k], ref[k], f"{where}[{k!r}]")
    elif isinstance(ref, (list, tuple)):
        assert type(got) is type(ref) and len(got) == len(ref), where
        for i, (g, r) in enumerate(zip(got, ref)):
            same(g, r, f"{where}[{i}]")
    elif isinstance(ref, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == ref.dtype, where
        assert got.shape == ref.shape, where
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6, err_msg=where)
    else:
        assert got == ref and type(got) is type(ref), (where, got, ref)


def pair(root, **kw):
    base = dict(split="train", region="all", cloud_masks=MASKS, sample_type="cloudy_cloudfree",
                sampler="fixed", n_input_samples=3)
    base.update(kw)
    return tts.SEN12MSCRTS(root, device="cpu", **base), jts.SEN12MSCRTS(root, **base)


def test_the_tree_reads_through_both_codecs(tree):
    assert jts.rasterio is None and tts.rasterio is None  # the GDAL-free codecs
    got, ref = pair(tree, split="train", sample_type="generic")
    assert len(got) == len(ref) == 2
    same(got[1], ref[1])
    # the deflate-compressed ROI decodes, and the masks do real work
    assert 0.0 in got[1]["coverage"] and max(got[1]["coverage"]) > 0.02


@pytest.mark.parametrize("split, n", [("train", 2), ("val", 1), ("test", 2), ("all", 5)])
def test_get_paths_per_split(tree, split, n):
    got, ref = pair(tree, split=split)
    assert len(got) == n and got.paths == ref.paths


@pytest.mark.parametrize("split, pdx", [("train", 0), ("train", 1), ("val", 0), ("test", 1)])
def test_online_fixed_sampler(tree, split, pdx):
    got, ref = pair(tree, split=split)
    same(got[pdx], ref[pdx])


@pytest.mark.parametrize("sampler", ["random", "fixedsubset"])
def test_online_other_samplers_over_epochs(tree, sampler):
    got, ref = pair(tree, sampler=sampler, seed=5)
    seen = set()
    for epoch in (0, 1, 2):
        got.set_epoch_count(epoch)
        ref.set_epoch_count(epoch)
        s = got[0]
        same(s, ref[0], f"epoch {epoch}")
        seen.add((tuple(s["input"]["idx"]), s["target"]["idx"]))
    assert len(seen) > 1 or sampler == "fixedsubset"


def _write_pairs(path, pairs):
    np.save(path, np.asarray(pairs, dtype=object), allow_pickle=True)
    return str(path)


def test_imported_index_mode_and_the_epoch_wrapped_index(tree, tmp_path):
    pairs = {0: {"input": [1, 5, 9], "target": 2}, 1: {"input": [2, 3, 4], "target": 0},
             2: {"input": [3, 6, 12], "target": 4}, 3: {"input": [7, 8, 29], "target": 8}}
    got, ref = pair(tree, import_data_path=_write_pairs(tmp_path / "idx.npy", pairs))
    assert len(got) == 2
    for epoch in range(3):  # epoch 2 wraps back to the first pairings
        for pdx in range(2):
            s = got[pdx]
            same(s, ref[pdx], f"epoch {epoch} pdx {pdx}")
            assert s["input"]["idx"] == pairs[(epoch * 2 + pdx) % 4]["input"]
        got.incr_epoch_count()
        ref.incr_epoch_count()


@pytest.mark.parametrize("sampler", ["fixed", "random"])
def test_imported_coverage_mode(tree, tmp_path, sampler):
    cov = [float(c) for c in tts.SEN12MSCRTS(tree, split="train", cloud_masks=MASKS,
                                             sample_type="generic", device="cpu")[0]["coverage"]]
    pairs = {0: {"coverage": cov, "paths": []}, 1: {"coverage": cov[::-1], "paths": []}}
    got, ref = pair(tree, sampler=sampler, import_data_path=_write_pairs(tmp_path / "c.npy", pairs))
    for pdx in range(2):
        same(got[pdx], ref[pdx])


def test_import_dir_resolves_the_conventional_name(tree, tmp_path):
    pairs = {0: {"input": [0, 1, 2], "target": 3}, 1: {"input": [0, 1, 2], "target": 3}}
    _write_pairs(tmp_path / f"generic_3_train_all_{MASKS}.npy", pairs)
    got, ref = pair(tree, import_data_path=str(tmp_path))
    assert got[0]["input"]["idx"] == [0, 1, 2]
    same(got[1], ref[1])


def test_without_masks_the_samples_are_generic(tree):
    got, ref = pair(tree, cloud_masks=None)
    assert got.sample_type == "generic" and got[0]["masks"] is None
    same(got[0], ref[0])


def test_custom_mosaic_mode(custom_tree):
    """The --use_custom sample: the 3x3 grid merged by bounds (24 x 24), the
    masks of the raw mosaics, dates from the first path's name, and the
    reference's target masks computed from the input rasters."""
    from uncrtaints_tpu_torch.cli.test import custom_dataset
    from uncrtaints_tpu_torch.config import Config
    got = custom_dataset(Config(root1=custom_tree, cloud_masks=MASKS, device="cpu"))
    ref = jts.SEN12MSCRTS(custom_tree, split="test", cloud_masks=MASKS,
                          custom_samples=got.custom_samples)
    entry = {k: {m: list(v) for m, v in d.items()} for k, d in got.custom_samples[0].items()}
    s = got[0]
    same(s, ref[0])
    assert s["input"]["S2"][0].shape == (13, 24, 24) and s["target"]["S1"][0].shape == (2, 24, 24)
    assert len(s["target"]["masks"][0]) == 3
    same(s["target"]["masks"][0], s["input"]["masks"])
    # the user's path lists stay as they were (iterdict gets a deep copy)
    assert got.custom_samples[0] == entry
    same(got[0], s)


def test_get_paired_s1(tree):
    patch = "/".join([TRAIN, "S2", "4", patch_name("S2", TRAIN, 4, default_date(4), 1)])
    for kw in ({}, {"time": 7}):
        got = tts.get_pairedS1([patch], tree, mod="s1", **kw)
        assert got == jts.get_pairedS1([patch], tree, mod="s1", **kw)
        assert got[0].startswith(f"{TRAIN}/S1/{kw.get('time', 4)}/s1_")


def test_natsorted_and_dates_equal():
    names = ["p_10.tif", "p_2.tif", "P_1.tif", "p_1a.tif"]
    assert tts.natsorted(names) == jts.natsorted(names)
    path = "x/s2_ROIs1868_114_ImgNo_4_2018-01-21_patch_1.tif"
    assert tts.days_since_launch(tts.date_from_patch_path(path)) == \
        jts.days_since_launch(jts.date_from_patch_path(path))


def test_precompute_npy_equals_the_jax_clis(tree, tmp_path):
    from uncrtaints_tpu.cli import precompute as jpc
    from uncrtaints_tpu_torch.cli import precompute as tpc
    argv = ["--root", tree, "--split", "train", "--region", "all", "--input_t", "3",
            "--cloud_masks", MASKS, "--sample_dates"]
    got = tpc.main(tpc.create_parser().parse_args(
        argv + ["--out_dir", str(tmp_path / "t"), "--device", "cpu"]))
    ref = jpc.main(jpc.create_parser().parse_args(argv + ["--out_dir", str(tmp_path / "j")]))
    assert os.path.basename(got) == os.path.basename(ref) == f"generic_3_train_all_{MASKS}.npy"
    got, ref = np.load(got, allow_pickle=True).item(), np.load(ref, allow_pickle=True).item()
    assert len(got) == 2
    same(got, ref)
    # a train run reads it back: the imported-coverage mode
    a, b = pair(tree, import_data_path=str(tmp_path / "t"))
    same(a[1], b[1])


@pytest.fixture(scope="module")
def cr_tree(tmp_path_factory):
    """SEN12MS-CR: s1 / s2 / s2_cloudy siblings of two train ROIs, and one
    unpaired s1 patch that the index skips."""
    root = str(tmp_path_factory.mktemp("sen12mscr"))
    seed = "ROIs1970_fall_s1"
    rng = np.random.default_rng(0)
    for roi in ("s1_3", "s1_22"):
        for p in range(2):
            for mod_seed, mod_roi in (("_s1", "s1"), ("_s2", "s2"), ("_s2_cloudy", "s2_cloudy")):
                sd, rd = seed.replace("_s1", mod_seed), roi.replace("s1", mod_roi)
                os.makedirs(os.path.join(root, sd, rd), exist_ok=True)
                if mod_roi == "s1":
                    arr = (-rng.random((2, HW, HW)) * 20).astype(np.float32)
                else:
                    arr = (rng.random((13, HW, HW)) * 6000).astype(np.uint16)
                write_tiff(os.path.join(root, sd, rd, f"{sd}_{roi.split('_')[1]}_p{p}.tif"), arr)
    write_tiff(os.path.join(root, seed, "s1_3", f"{seed}_3_p99.tif"), np.zeros((2, HW, HW),
                                                                                np.float32))
    return root


def test_sen12mscr_equals_the_jax_packages(cr_tree):
    got = tcr.SEN12MSCR(cr_tree, split="train", cloud_masks=MASKS, device="cpu")
    ref = jcr.SEN12MSCR(cr_tree, split="train", cloud_masks=MASKS)
    assert len(got) == 4 and got.paths == ref.paths
    for pdx in (0, 3):
        same(got[pdx], ref[pdx])
    assert "_s2_cloudy" in got[0]["input"]["S2 path"]
    with pytest.warns(UserWarning, match="No data samples"):
        assert len(tcr.SEN12MSCR(cr_tree, split="val", cloud_masks=MASKS, device="cpu")) == 0
    d = {"a": {"b": [1, 2]}, "c": 3}
    assert tcr.iterdict(dict(d, a=dict(d["a"])), str) == jcr.iterdict(dict(d, a=dict(d["a"])), str)


def test_convert_and_hdf5_equal_the_jax_packages(tree, tmp_path):
    pytest.importorskip("h5py")
    from uncrtaints_tpu.cli import convert as jcv
    from uncrtaints_tpu.data.hdf5 import HDF5SEN12MSCRTS as JH5
    from uncrtaints_tpu_torch.cli import convert as tcv
    from uncrtaints_tpu_torch.data.hdf5 import HDF5SEN12MSCRTS as TH5
    argv = ["--root", tree, "--split", "train", "--cloud_masks", MASKS]
    got = tcv.main(tcv.create_parser().parse_args(argv + ["--out", str(tmp_path / "t.h5"),
                                                          "--device", "cpu"]))
    ref = jcv.main(jcv.create_parser().parse_args(argv + ["--out", str(tmp_path / "j.h5")]))
    for sampler in ("fixed", "random"):
        for raw in (False, True):
            a = TH5(got, n_input_samples=3, sampler=sampler, raw_s2=raw)
            b = JH5(ref, n_input_samples=3, sampler=sampler, raw_s2=raw)
            assert len(a) == len(b) == 2
            same(a[1], b[1])
    # the store's sample is the tif source's, to a DN of requantization
    h5, tif = TH5(got, n_input_samples=3)[0], pair(tree, sample_type="cloudy_cloudfree")[0][0]
    assert h5["input"]["idx"] == tif["input"]["idx"]
    np.testing.assert_allclose(h5["target"]["S2"][0], tif["target"]["S2"][0], atol=1.01e-4)


def test_the_default_device_raises_without_a_card(tree, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    from uncrtaints_tpu_torch.cli import precompute as tpc
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tts.SEN12MSCRTS(tree, split="train", cloud_masks=MASKS)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcr.SEN12MSCR(tree, split="train", cloud_masks=MASKS)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpc.main(tpc.create_parser().parse_args(["--root", tree, "--cloud_masks", MASKS,
                                                 "--out_dir", str(tmp_path)]))
    assert not os.listdir(tmp_path)


def test_no_samples_warns(tmp_path):
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        ds = tts.SEN12MSCRTS(str(tmp_path), split="train", cloud_masks=MASKS, device="cpu")
    assert len(ds) == 0 and any("No data samples" in str(w.message) for w in seen)


def test_raw_dn_samples_of_the_tree_equal_the_jax_packages_batch(tree):
    """SEN12MSCRTS(raw_s2=True) -> the raw collate -> _prepare_xy against the
    JAX package's processed samples -> its collate_multi (x and y within
    1e-6 after scale_by); the single-pass collate's LUT likewise."""
    kw = dict(split="test", cloud_masks=MASKS, n_input_samples=3)
    raw = tts.SEN12MSCRTS(tree, device="cpu", raw_s2=True, **kw)
    ref = jts.SEN12MSCRTS(tree, **kw)
    samples = [raw[0], raw[1]]
    assert samples[0]["rescale_method"] == "default"
    assert samples[0]["input"]["S2"][0].dtype == np.uint16
    want = jpipe.collate_multi([ref[0], ref[1]], use_sar=True)
    cfg = derive(Config(use_sar=True, scale_by=10.0, device="cpu"))
    for collate in (make_raw_collate(), make_fast_collate()):
        got = batch_to_device(collate(samples, use_sar=True), "cpu")
        x, _, y = _prepare_xy(cfg, got)
        np.testing.assert_allclose(x.numpy() / cfg.scale_by, want["x"], rtol=0, atol=1e-6)
        np.testing.assert_allclose(y.numpy(), want["y"], rtol=0, atol=1e-6)
        np.testing.assert_array_equal(got["dates"].numpy(), want["dates"])


def test_a_tree_of_fewer_time_points_reads(tmp_path):
    root = str(tmp_path)
    write_sen12mscrts_tree(root, {TEST: range(2)}, hw=16, time_points=range(5), workers=2)
    kw = dict(cloud_masks=MASKS, n_input_samples=3, time_points=range(5), device="cpu")
    raw, done = tts.SEN12MSCRTS(root, raw_s2=True, **kw), tts.SEN12MSCRTS(root, **kw)
    assert len(raw) == 2 and len(raw.paths[1]["S2"]) == 5
    a, b = raw[1], done[1]
    assert a["input"]["idx"] == b["input"]["idx"] and len(a["input"]["S2"]) == 3
    for f, g in zip(a["input"]["S2"] + a["target"]["S2"], b["input"]["S2"] + b["target"]["S2"]):
        np.testing.assert_array_equal(process_MS(f.astype(np.float32), "default"), g)


def test_raw_dn_needs_cloudy_cloudfree_samples(tree):
    with pytest.raises(ValueError, match="raw_s2"):
        tts.SEN12MSCRTS(tree, cloud_masks=None, raw_s2=True, device="cpu")
