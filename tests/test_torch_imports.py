"""The port stands alone: ``uncrtaints_tpu_torch`` and ``chip_smoke.py``
import nothing of JAX and nothing of the JAX package (nor tensorflow or
orbax, which that package logs and checkpoints with), and the port's own
copies of the config, the synthetic data source, the collates, the host
radiometry, the calibration metrics and the checkpoint key rule equal the
JAX package's.
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
ENTRY_MODULES = ("cli.train", "cli.test", "train.loop", "train.checkpoint", "train.observe",
                 "metrics.calibration", "metrics.image", "data.pipeline", "data.preprocess")


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
        "assert len(names) >= 32, names\n"
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
    assert len(files) >= 37
    hits = {os.path.relpath(f, REPO): pat.findall(open(f).read()) for f in files}
    assert not {f: h for f, h in hits.items() if h}


# ------------------------------------------------------------- config --

CONFIGS = {
    "paper": dict(use_sar=True, scale_by=10.0),
    "mono": dict(pretrain=True),
    "uni": dict(covmode="uni", loss="GNLL"),
    "residual": dict(block_type="residual", encoder_widths="[64]", decoder_widths="64,64"),
    "use_v": dict(use_v=True, separate_out=True, covmode="iso"),
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
    assert (tc.NO_OVERWRITE_RESUME, tc.NO_OVERWRITE_TEST) == (
        jc.NO_OVERWRITE_RESUME, jc.NO_OVERWRITE_TEST)
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


def _copy_legacy_keys(rng):
    from uncrtaints_tpu.models.torch_import import normalize_legacy_keys as ref
    from uncrtaints_tpu_torch.train.checkpoint import normalize_legacy_keys as got
    for first in (0, 1):
        sd = {f"{b}.{i}.conv.fn.0.weight": rng.random(2) for b in ("in_block", "out_block")
              for i in range(first, first + 2)}
        sd["in_conv.conv.conv.0.weight"] = rng.random(2)
        _same_tree(got(sd), ref(sd))


@pytest.mark.parametrize("copy", [_copy_calibration, _copy_collates, _copy_process_ms,
                                  _copy_legacy_keys], ids=lambda f: f.__name__[6:])
@pytest.mark.parametrize("seed", [1, 7])
def test_numpy_copies_equal_their_originals(copy, seed):
    copy(np.random.default_rng(seed))
