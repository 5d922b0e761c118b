"""The port stands alone: ``uncrtaints_tpu_torch`` and ``chip_smoke.py``
import nothing of JAX and nothing of the JAX package (nor tensorflow or
orbax, which that package logs and checkpoints with), and the port's own
copies of the config, the synthetic data source, the collates, the host
radiometry, the calibration metrics, the checkpoint key rule, the TIFF
codec, the samplers, the ROI tables, the s2cloudless reader,
``natsorted`` and the ensemble's fusion equal the JAX package's.
"""

import dataclasses
import os
import re
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "tensorflow", "uncrtaints_tpu")
# the entry points and what they stand on, which the walk must have found
ENTRY_MODULES = ("cli.train", "cli.test", "cli.precompute", "cli.convert", "cli.download",
                 "train.loop", "train.checkpoint", "train.observe", "metrics.calibration",
                 "metrics.image", "data.pipeline", "data.preprocess", "data.masks",
                 "data.samplers", "data.rois", "data.tiff", "data.s2cloudless",
                 "data.sen12mscrts", "data.sen12mscr", "data.hdf5", "data.synthetic_tree",
                 "ops.filters", "cli.ensemble", "models.unet", "models.utae", "models.unet3d",
                 "models.recurrent", "models.jax_bridge", "export", "parallel",
                 "parallel.mesh", "native", "infer", "models.layers", "models.blocks",
                 "models.uncrtaints", "ops.pooling", "ops.resize", "ops.ssim", "ops.dwconv",
                 "ops.dwgrad", "ops.mbconv")


def test_importing_the_port_loads_no_jax_and_no_jax_package():
    """Every module of the port and chip_smoke's module-level imports, in a
    fresh interpreter: none of the forbidden packages gets loaded."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import uncrtaints_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(uncrtaints_tpu_torch.__path__,\n"
        "                                               'uncrtaints_tpu_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "import chip_smoke\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "assert not bad, bad\n"
        "assert len(names) >= 49, names\n"
        f"missing = [m for m in {ENTRY_MODULES!r} if 'uncrtaints_tpu_torch.' + m not in names]\n"
        "assert not missing, missing\n"
        "print('ok', len(names))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and proc.stdout.startswith("ok"), proc.stderr[-2000:]


def _port_sources():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "uncrtaints_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return sorted(files)


def test_no_source_imports_jax_or_the_jax_package():
    """No ``import``/``from`` of a forbidden package in the port's sources
    (comments and docstrings naming the counterpart file are fine)."""
    pat = re.compile(r"^\s*(?:import|from)\s+(" + "|".join(FORBIDDEN) + r")(?:[\s.,]|$)", re.M)
    files = _port_sources()
    assert len(files) >= 51
    hits = {os.path.relpath(f, REPO): pat.findall(open(f).read()) for f in files}
    assert not {f: h for f, h in hits.items() if h}


# ------------------------------------------------------------- config --

CONFIGS = {
    "paper": dict(use_sar=True, scale_by=10.0),
    "mono": dict(pretrain=True),
    "uni": dict(covmode="uni", loss="GNLL"),
    "residual": dict(block_type="residual", encoder_widths="[64]", decoder_widths="64,64"),
    "use_v": dict(use_v=True, separate_out=True, covmode="iso"),
    "unet": dict(model="unet", encoder_widths="[64,64,64,128]", decoder_widths="[32,32,64,128]"),
    "utae": dict(model="utae", encoder_widths="[64,64,64,128]", decoder_widths="[32,32,64,128]"),
    "utae_pretrain": dict(model="utae", pretrain=True, encoder_widths="[8,16]",
                          decoder_widths="[8,16]"),
}
# fields that differ by design: the port's default device is the card, and
# it does not carry the JAX/TPU mechanisms remat, prng_impl and debug_nans
PORT_ONLY_DIFFERENCES = {"device"}
NOT_CARRIED = {"remat", "prng_impl", "debug_nans"}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_derived_config_equals_the_jax_packages(name):
    from uncrtaints_tpu import config as jc
    from uncrtaints_tpu_torch import config as tc
    ref = dataclasses.asdict(jc.derive(jc.Config(**CONFIGS[name])))
    got = dataclasses.asdict(tc.derive(tc.Config(**CONFIGS[name])))
    assert set(ref) - set(got) == NOT_CARRIED and not set(got) - set(ref)
    shared = set(got) - PORT_ONLY_DIFFERENCES
    assert {k: got[k] for k in shared} == {k: ref[k] for k in shared}
    assert tc.input_dim(tc.Config(**CONFIGS[name])) == jc.input_dim(jc.Config(**CONFIGS[name]))


def test_config_defaults_flags_and_json_round_trip(tmp_path):
    from uncrtaints_tpu import config as jc
    from uncrtaints_tpu_torch import config as tc
    assert tc.Config().device == "cuda"
    for mode in ("train", "test"):
        argv = ["--use_sar", "--scale_by", "10", "--encoder_widths", "[64]",
                "--mean_nonLinearity", "--fused_eval", "off"]
        ref = dataclasses.asdict(jc.parse_config(argv, mode))
        got = dataclasses.asdict(tc.parse_config(argv, mode))
        shared = set(got) - PORT_ONLY_DIFFERENCES
        assert {k: got[k] for k in shared} == {k: ref[k] for k in shared}
    # the port also keeps --use_custom, --mesh_shape, --trace_dir and
    # --profile over the stored run's (cli.test honours them)
    assert (tc.NO_OVERWRITE_RESUME, tc.NO_OVERWRITE_TEST) == (
        jc.NO_OVERWRITE_RESUME,
        jc.NO_OVERWRITE_TEST + ["use_custom", "mesh_shape", "trace_dir", "profile"])
    # a conf.json written by the JAX package loads in the port (the fields
    # it does not carry are dropped) and the other way round
    path = str(tmp_path / "conf.json")
    jc.derive(jc.Config(use_sar=True, remat=True)).save_json(path)
    cfg = tc.Config.load_json(path)
    assert cfg.use_sar and cfg.out_conv == [26] and not hasattr(cfg, "remat")
    cfg.save_json(path)
    assert jc.Config.load_json(path).out_conv == [26]
    with pytest.raises(TypeError):
        tc.Config(remat=True)


# --------------------------------------------------------------- data --

def _same_tree(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _same_tree(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same_tree(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    else:
        assert a == b and type(a) is type(b)


@pytest.mark.parametrize("seed", [1, 7])
def test_synthetic_source_is_bit_identical(seed):
    from uncrtaints_tpu.data import synthetic as js
    from uncrtaints_tpu_torch.data import synthetic as ts
    kw = dict(n_samples=4, n_input_t=3, patch_size=24, seed=seed)
    ref, got = js.SyntheticSEN12MSCRTS(**kw), ts.SyntheticSEN12MSCRTS(**kw)
    assert len(ref) == len(got) == 4
    for i in (0, 3):
        _same_tree(got[i], ref[i])
    _same_tree(ts.SyntheticSEN12MSCR(n_samples=2, patch_size=16, seed=seed)[1],
               js.SyntheticSEN12MSCR(n_samples=2, patch_size=16, seed=seed)[1])


@pytest.mark.parametrize("seed", [1, 7])
@pytest.mark.parametrize("use_sar", [True, False])
def test_collate_multi_is_bit_identical(seed, use_sar):
    from uncrtaints_tpu.data.pipeline import collate_multi as jax_collate
    from uncrtaints_tpu.data.synthetic import SyntheticSEN12MSCRTS
    from uncrtaints_tpu_torch.data import collate_multi
    ds = SyntheticSEN12MSCRTS(n_samples=3, n_input_t=3, patch_size=24, seed=seed)
    samples = [ds[i] for i in range(3)]
    ref, got = jax_collate(samples, use_sar=use_sar), collate_multi(samples, use_sar=use_sar)
    _same_tree(got, ref)
    assert got["x"].shape == (3, 3, 24, 24, 15 if use_sar else 13)
    assert got["x"].flags["C_CONTIGUOUS"]


# ------------------------------------------- the other numpy copies --

def _copy_calibration(rng):
    from uncrtaints_tpu.metrics import calibration as ref
    from uncrtaints_tpu_torch.metrics import calibration as got
    var = rng.uniform(0.01, 1.0, 60)
    err = np.sqrt(var) * rng.standard_normal(60)
    np.testing.assert_array_equal(got.compute_ece(var, err ** 2, 60), ref.compute_ece(var, err ** 2, 60))
    (gu, ga, gd), (ru, ra, rd) = got.compute_uce_auce(var, err, 60), ref.compute_uce_auce(var, err, 60)
    assert (gu, ga) == (ru, ra)
    _same_tree(gd, rd)


def _copy_collates(rng):
    from uncrtaints_tpu.data import pipeline as ref, synthetic
    from uncrtaints_tpu_torch.data import pipeline as got
    ds = synthetic.SyntheticSEN12MSCRTS(n_samples=2, n_input_t=3, patch_size=16,
                                        seed=int(rng.integers(1, 99)))
    samples = [ds[0], ds[1]]
    raw = []
    for s in samples:
        dn = lambda f: rng.integers(0, 12000, f.shape).astype(np.uint16)
        raw.append({**s, "input": dict(s["input"], S2=[dn(f) for f in s["input"]["S2"]]),
                    "target": dict(s["target"], S2=[dn(s["target"]["S2"][0])])})
    _same_tree(got.make_fast_collate()(samples), ref.make_fast_collate()(samples))
    _same_tree(got.make_fast_collate()(raw), ref.make_fast_collate()(raw))
    _same_tree(got.make_raw_collate()(raw), ref.make_raw_collate()(raw))
    _same_tree(got.pad_collate_multi(samples), ref.pad_collate_multi(samples))
    mono = synthetic.SyntheticSEN12MSCR(n_samples=2, patch_size=16, seed=3)
    _same_tree(got.collate_mono([mono[0], mono[1]]), ref.collate_mono([mono[0], mono[1]]))


def _copy_process_ms(rng):
    from uncrtaints_tpu.data.preprocess import process_MS as ref
    from uncrtaints_tpu_torch.data.preprocess import process_MS as got
    img = (rng.random((13, 6, 6)) * 12000 - 500).astype(np.float32)
    dn = np.clip(img, 0, 65535).astype(np.uint16)
    img[0, 0, 0] = np.nan
    for method in ("default", "resnet"):
        _same_tree(got(img, method), ref(img, method))
        _same_tree(got(dn, method), ref(dn, method))


def _copy_process_sar(rng):
    from uncrtaints_tpu.data.preprocess import process_SAR as ref
    from uncrtaints_tpu_torch.data.preprocess import process_SAR as got
    img = (rng.random((2, 6, 6)) * 40 - 35).astype(np.float32)
    img[1, 0, 0] = np.nan
    for method in ("default", "resnet"):
        _same_tree(got(img, method), ref(img, method))
        _same_tree(got(np.moveaxis(img, 0, -1), method, pol_axis=-1),
                   ref(np.moveaxis(img, 0, -1), method, pol_axis=-1))


def _copy_tiff(rng):
    """Each codec reads the other's files to the same arrays and bounds; the
    intended differences are the port's writer (every strip, tag array and
    the IFD on an even offset, so the bytes differ) and the unused
    ``_undo_predictor``, which the copy leaves out."""
    import tempfile
    from uncrtaints_tpu.data import tiff as ref
    from uncrtaints_tpu_torch.data import tiff as got
    arrays = [rng.integers(0, 10000, (13, 9, 7)).astype(np.uint16),
              rng.standard_normal((2, 5, 11)).astype(np.float32)]
    bounds = [500000.0, 4099930.0, 500070.0, 4100020.0]
    with tempfile.TemporaryDirectory() as d:
        for i, arr in enumerate(arrays):
            for comp, pred in (("none", 1), ("deflate", 2 if arr.dtype.kind == "u" else 1)):
                for name, writer in (("ref", ref.write_tiff), ("got", got.write_tiff)):
                    path = os.path.join(d, f"{name}{i}{comp}.tif")
                    writer(path, arr, compression=comp, predictor=pred, bounds=bounds)
                    _same_tree(got.read_tiff(path), ref.read_tiff(path))
                    assert got.read_tiff_bounds(path) == ref.read_tiff_bounds(path)
                    np.testing.assert_array_equal(got.read_tiff(path), arr)
    assert hasattr(ref, "_undo_predictor") and not hasattr(got, "_undo_predictor")
    tiles = [rng.random((2, 4, 4)).astype(np.float32) for _ in range(3)]
    tb = [[0.0, 0.0, 4.0, 4.0], [4.0, 0.0, 8.0, 4.0], [2.0, 2.0, 6.0, 6.0]]
    _same_tree(got.merge_arrays(tiles, tb), ref.merge_arrays(tiles, tb))


def _copy_samplers(rng):
    from uncrtaints_tpu.data import samplers as ref
    from uncrtaints_tpu_torch.data import samplers as got
    cov = list(rng.random(30) * (rng.random(30) > 0.2))
    for n in (1, 3, 5):
        for lo, hi in ((0.0, 1.0), (0.1, 0.5)):
            _same_tree(got.fixed_sampler(cov, n, lo, hi), ref.fixed_sampler(cov, n, lo, hi))
            _same_tree(got.fixedsubset_sampler(cov, n, 4, 20, lo, hi),
                       ref.fixedsubset_sampler(cov, n, 4, 20, lo, hi))
        seed = int(rng.integers(1 << 30))
        _same_tree(got.random_sampler(cov, n, np.random.default_rng(seed)),
                   ref.random_sampler(cov, n, np.random.default_rng(seed)))
        _same_tree(got.sliding_windows(30, n + 1), ref.sliding_windows(30, n + 1))


def _copy_rois(rng):
    from uncrtaints_tpu.data import rois as ref
    from uncrtaints_tpu_torch.data import rois as got
    assert got.ROI_TS == ref.ROI_TS and got.splits_cr() == ref.splits_cr()
    for region in ("all", "africa", "america", "asiaEast", "asiaWest", "europa"):
        assert got.splits_ts(region) == ref.splits_ts(region), region


def _copy_s2cloudless(rng):
    from tests.test_s2cloudless import MODEL_TEXT
    from uncrtaints_tpu.data import s2cloudless as ref
    from uncrtaints_tpu_torch.data import s2cloudless as got
    x = rng.random((50, 3))
    x[0, 1] = np.nan
    mg, mr = got.LightGBMModel.from_text(MODEL_TEXT), ref.LightGBMModel.from_text(MODEL_TEXT)
    _same_tree(mg.raw_score(x), mr.raw_score(x))
    _same_tree(mg.predict_proba(x), mr.predict_proba(x))
    for r in (1, 2, 4):
        _same_tree(got.disk(r), ref.disk(r))
    if got._ndi is not None:  # the disk post-processing needs scipy
        p = rng.random((12, 12))
        _same_tree(got.average_disk(p, 2), ref.average_disk(p, 2))
        _same_tree(got.dilate_disk(p > 0.8, 2), ref.dilate_disk(p > 0.8, 2))


def _copy_natsorted(rng):
    from uncrtaints_tpu.data.sen12mscrts import natsorted as ref
    from uncrtaints_tpu_torch.data.sen12mscrts import natsorted as got
    names = [f"s2_ROIs1868_73_ImgNo_{t}_2018-01-0{t % 9 + 1}_patch_{p}.tif"
             for t in rng.permutation(12) for p in rng.permutation(25)[:4]]
    names += ["B10", "b9", "a", "A2", "a10"]
    assert got(names) == ref(names)


def _copy_ensemble(rng):
    from uncrtaints_tpu.cli import ensemble as ref
    from uncrtaints_tpu_torch.cli import ensemble as got
    mu, var = rng.random((3, 13, 4, 5)), 0.1 + rng.random((3, 13, 4, 5))
    for mode in ("aleatoric", "epistemic", "both"):
        _same_tree(got.fuse(mu, var, mode), ref.fuse(mu, var, mode))
    assert got.member_dir("/nonexistent", 1, "test") == ref.member_dir("/nonexistent", 1, "test")
    assert got.create_parser().parse_args(["--members", "a"]).uncertainty == \
        ref.create_parser().parse_args(["--members", "a"]).uncertainty


def _copy_legacy_keys(rng):
    from uncrtaints_tpu.models.torch_import import normalize_legacy_keys as ref
    from uncrtaints_tpu_torch.train.checkpoint import normalize_legacy_keys as got
    for first in (0, 1):
        sd = {f"{b}.{i}.conv.fn.0.weight": rng.random(2) for b in ("in_block", "out_block")
              for i in range(first, first + 2)}
        sd["in_conv.conv.conv.0.weight"] = rng.random(2)
        _same_tree(got(sd), ref(sd))


@pytest.mark.parametrize("copy", [_copy_calibration, _copy_collates, _copy_process_ms,
                                  _copy_process_sar, _copy_legacy_keys, _copy_tiff,
                                  _copy_samplers, _copy_rois, _copy_s2cloudless,
                                  _copy_natsorted, _copy_ensemble], ids=lambda f: f.__name__[6:])
@pytest.mark.parametrize("seed", [1, 7])
def test_numpy_copies_equal_their_originals(copy, seed):
    copy(np.random.default_rng(seed))
