"""The port stands alone: ``uncrtaints_tpu_torch`` and ``chip_smoke.py``
import nothing of JAX and nothing of the JAX package, and the port's own
copies of the config, the synthetic data source and the collate equal the
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
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "uncrtaints_tpu")


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
        "assert len(names) >= 25, names\n"
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
    assert len(files) >= 30
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
