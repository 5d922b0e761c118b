"""The port's deep-ensemble CLI against the JAX package's, on the CPU:
``fuse`` in the three modes, the covar -> diagonal member loading, the
one-time target dataset, the count-mismatch assert and the skip of a sample
a member lacks; ``main`` on member files the test writes, against
``uncrtaints_tpu.cli.ensemble.main`` on the same files (mirrors
tests/test_ensemble.py)."""

import argparse
import os

import numpy as np
import pytest

from uncrtaints_tpu.cli import ensemble as jax_ens

from uncrtaints_tpu_torch.cli import ensemble as ens
from uncrtaints_tpu_torch.train.observe import diag_to_covar

METRICS = ("RMSE", "MAE", "PSNR", "SAM", "SSIM", "mean var", "UCE SE", "AUCE SE")


def _args(**kw):
    base = dict(root="/nonexistent", mode="test", in_time=3, region="all",
                max_samples=int(1e9), uncertainty="both", ensemble=True,
                pixelwise=True, export_path=None, members=[], epoch=1,
                synthetic_data=True, cloud_masks="cloud_cloudshadow_mask", device="cpu")
    base.update(kw)
    return argparse.Namespace(**base)


class _TinyTargets:
    def __init__(self, n, hw=16):
        self.n, self.hw = n, hw

    def __len__(self):
        return self.n

    def __getitem__(self, idx):
        rng = np.random.default_rng(100 + idx)
        return {"target": {"S2": [rng.random((13, self.hw, self.hw)).astype(np.float32)]}}


def _write_member(base, n, hw, covar: bool, seed, skip=()):
    d = os.path.join(base, "export", "epoch_1", "test")
    os.makedirs(d)
    rng = np.random.default_rng(seed)
    for i in range(n):
        pred = rng.random((13, hw, hw)).astype(np.float32)
        var = (0.05 + rng.random((1, hw, hw, 13))).astype(np.float32)
        if i in skip:
            continue
        np.save(os.path.join(d, f"img-{i}_pred.npy"), pred)
        if covar:  # [C, C, H, W], the MGNLL export
            np.save(os.path.join(d, f"img-{i}_covar.npy"), diag_to_covar(var)[0])
        else:
            np.save(os.path.join(d, f"img-{i}_var.npy"), np.moveaxis(var[0], -1, 0))
    return base


@pytest.mark.parametrize("uncertainty", ["aleatoric", "epistemic", "both"])
def test_fuse_equals_the_jax_packages(uncertainty):
    rng = np.random.default_rng(0)
    mu = rng.random((3, 13, 4, 4)).astype(np.float32)
    var = (0.1 + rng.random((3, 13, 4, 4))).astype(np.float32)
    got, ref = ens.fuse(mu, var, uncertainty), jax_ens.fuse(mu, var, uncertainty)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(got[0], mu.mean(0), rtol=1e-6)
    with pytest.raises(NotImplementedError):
        ens.fuse(mu, var, "total")


def test_member_loading_equals_the_jax_packages(tmp_path):
    """A covar member and a var member load to the same stacked diagonal
    arrays as in the JAX package; a member without the sample gives None."""
    m1 = _write_member(str(tmp_path / "m1"), 2, 8, True, 7)
    m2 = _write_member(str(tmp_path / "m2"), 2, 8, False, 8, skip=(1,))
    paths = [ens.member_dir(m, 1, "test") for m in (m1, m2)]
    assert paths == [jax_ens.member_dir(m, 1, "test") for m in (m1, m2)]
    assert ens.member_dir(str(tmp_path / "m1"), 2, "test") == str(tmp_path / "m1")
    got, ref = ens.load_member_arrays(paths, "img-0_pred.npy"), \
        jax_ens.load_member_arrays(paths, "img-0_pred.npy")
    assert got[0].shape == got[1].shape == (2, 13, 8, 8)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    assert ens.load_member_arrays(paths, "img-1_pred.npy") == (None, None)


@pytest.mark.parametrize("uncertainty", ["aleatoric", "epistemic", "both"])
def test_main_equals_the_jax_packages(tmp_path, monkeypatch, uncertainty):
    """One covar member, one var member that lacks sample 2 (skipped): the
    port's main gives the JAX package's metrics (1e-5 relative: SSIM and the
    metrics sum in another order) and builds the targets once; the fused
    export equals the numpy fusion of the member files."""
    n, hw = 4, 16
    m1 = _write_member(str(tmp_path / "m1"), n, hw, True, 7)
    m2 = _write_member(str(tmp_path / "m2"), n, hw, False, 8, skip=(2,))
    builds = []

    def fake_build(args):
        builds.append(1)
        return _TinyTargets(n, hw)

    monkeypatch.setattr(ens, "build_target_dataset", fake_build)
    monkeypatch.setattr(jax_ens, "build_target_dataset", lambda a: _TinyTargets(n, hw))
    out_dir = str(tmp_path / "fused")
    got = ens.main(_args(members=[m1, m2], uncertainty=uncertainty, export_path=out_dir))
    ref = jax_ens.main(_args(members=[m1, m2], uncertainty=uncertainty))
    assert len(builds) == 1
    for k in METRICS:
        assert np.isfinite(got[k]) and got[k] == pytest.approx(float(ref[k]), rel=1e-5), k
    fused = os.path.join(out_dir, "export", "epoch_1", "test")
    assert sorted(os.listdir(fused)) == sorted(f"img-{i}_{m}.npy" for i in (0, 1, 3)
                                               for m in ("pred", "var"))
    paths = [ens.member_dir(m, 1, "test") for m in (m1, m2)]
    mean, var = ens.load_member_arrays(paths, "img-3_pred.npy")
    want = ens.fuse(mean, var, uncertainty)
    for m, w in zip(("pred", "var"), want):
        np.testing.assert_allclose(np.load(os.path.join(fused, f"img-3_{m}.npy")), w,
                                   rtol=1e-6, atol=1e-7)
    assert os.path.isfile(os.path.join(out_dir, f"pred_var_{uncertainty}.npy"))


def test_count_mismatch_asserts(tmp_path, monkeypatch):
    m1 = _write_member(str(tmp_path / "m1"), 4, 16, True, 7)
    monkeypatch.setattr(ens, "build_target_dataset", lambda a: _TinyTargets(2, 16))
    with pytest.raises(AssertionError, match="export/dataset mismatch"):
        ens.main(_args(members=[m1]))


def test_synthetic_targets_are_the_test_splits(tmp_path):
    """--synthetic_data targets: the synthetic test split cli.test exports
    (seed 3, 256x256), sample for sample."""
    from uncrtaints_tpu_torch.data.synthetic import SyntheticSEN12MSCRTS
    ds = ens.build_target_dataset(_args(max_samples=2))
    assert len(ds) == 2
    ref = SyntheticSEN12MSCRTS(n_samples=8, n_input_t=3, patch_size=256, seed=3)
    np.testing.assert_array_equal(ens.get_target(ds, 1),
                                  np.moveaxis(ref[1]["target"]["S2"][0], 0, -1)[None])
    args = ens.create_parser().parse_args(["--members", "a", "b"])
    assert args.device == "cuda" and args.uncertainty == "both" and args.ensemble
