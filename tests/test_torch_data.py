"""The port's host pipeline against the JAX package's: every collate
bit-identical on the same samples (with the JAX package's compiled slab
writers and with its numpy fallback), the numpy ``process_MS``, the bytes
of a sequence each collate hands to the device, and the loader's sample
order, length, sharding and thread lifetime."""

import threading
import time

import numpy as np
import pytest

from uncrtaints_tpu.data import pipeline as jp
from uncrtaints_tpu.data.synthetic import SyntheticSEN12MSCR, SyntheticSEN12MSCRTS
from uncrtaints_tpu_torch.data import pipeline as tp


@pytest.fixture(params=["native", "numpy"])
def jax_writers(request, monkeypatch):
    """The JAX collates as they run with their compiled slab writers (where
    this machine built them) and through their numpy fallback."""
    if request.param == "numpy":
        from uncrtaints_tpu import native
        monkeypatch.setattr(native, "available", lambda: False)
        monkeypatch.setattr(native, "frame_into_slab", lambda *a, **k: False)
    return request.param


def _same_batch(got, ref):
    assert set(got) == set(ref)
    for k in ref:
        if ref[k] is None:
            assert got[k] is None
            continue
        assert got[k].dtype == ref[k].dtype and got[k].shape == ref[k].shape, k
        assert np.array_equal(got[k], ref[k]), k


def _samples(seed, n=3, t=3, patch=24):
    ds = SyntheticSEN12MSCRTS(n_samples=n, n_input_t=t, patch_size=patch, seed=seed)
    return [ds[i] for i in range(n)]


def _raw(samples, seed, marker="default"):
    """The same samples with raw uint16 S2 codes (some past the 10000 clip)."""
    rng = np.random.default_rng(seed)
    dn = lambda f: rng.integers(0, 12000, np.asarray(f).shape).astype(np.uint16)
    out = []
    for s in samples:
        inp = dict(s["input"], S2=[dn(f) for f in s["input"]["S2"]])
        tgt = dict(s["target"], S2=[dn(s["target"]["S2"][0])])
        out.append({**s, "input": inp, "target": tgt, "rescale_method": marker})
    return out


@pytest.mark.parametrize("seed", [1, 7])
@pytest.mark.parametrize("use_sar", [True, False])
def test_fast_collate_is_bit_identical(jax_writers, seed, use_sar):
    samples = _samples(seed)
    ref = jp.make_fast_collate()(samples, use_sar=use_sar)
    got = tp.make_fast_collate()(samples, use_sar=use_sar)
    _same_batch(got, ref)
    _same_batch(got, tp.collate_multi(samples, use_sar=use_sar))
    assert got["x"].flags["C_CONTIGUOUS"]


@pytest.mark.parametrize("method", ["default", "resnet"])
def test_fast_collate_of_raw_samples_is_bit_identical(jax_writers, method):
    raw = _raw(_samples(3), 3, marker=method)
    _same_batch(tp.make_fast_collate(method)(raw), jp.make_fast_collate(method)(raw))


@pytest.mark.parametrize("use_sar", [True, False])
def test_raw_collate_is_bit_identical(jax_writers, use_sar):
    raw = _raw(_samples(5), 5)
    ref = jp.make_raw_collate()(raw, use_sar=use_sar)
    got = tp.make_raw_collate()(raw, use_sar=use_sar)
    _same_batch(got, ref)
    assert got["x_s2dn"].dtype == np.uint16 and got["y_dn"].dtype == np.uint16
    assert ("x_s1" in got) == use_sar


def test_raw_batch_feeds_the_steps_like_the_processed_one():
    """The raw-DN batch through the eval step's radiometry equals the batch
    the single-pass collate makes of the same samples on the host."""
    import torch
    from uncrtaints_tpu_torch.config import Config
    from uncrtaints_tpu_torch.train.engine import _prepare_xy, batch_to_device
    raw = _raw(_samples(6), 6)
    cfg = Config(scale_by=1.0)
    x, _, y = _prepare_xy(cfg, batch_to_device(tp.make_raw_collate()(raw), "cpu"))
    host = tp.make_fast_collate()(raw)
    torch.testing.assert_close(x, torch.from_numpy(host["x"]), rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(y, torch.from_numpy(host["y"]), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("radiometry", ["device_raw_dn", "host_lut"])
def test_bytes_a_sequence_hands_to_the_device(radiometry):
    """The keys a step receives of each collate's batch, through
    batch_to_device: raw, fp32 S1 (2 bands) and uint16 S2 (13) of T frames
    and the uint16 target; host, the fp32 x (15 bands) and y; both the fp32
    dates."""
    from uncrtaints_tpu_torch.config import Config
    from uncrtaints_tpu_torch.train.engine import _prepare_xy, batch_to_device
    B, T, P = 3, 3, 24
    raw = _raw(_samples(8, n=B, t=T, patch=P), 8)
    if radiometry == "device_raw_dn":
        collate, keys = tp.make_raw_collate(), ("x_s1", "x_s2dn", "y_dn", "dates")
        want = T * P * P * (2 * 4 + 13 * 2) + P * P * 13 * 2 + T * 4
    else:
        collate, keys = tp.make_fast_collate(), ("x", "y", "dates")
        want = T * P * P * 15 * 4 + P * P * 13 * 4 + T * 4
    batch = collate(raw)
    sent = batch_to_device({k: batch[k] for k in keys}, "cpu")
    _prepare_xy(Config(use_sar=True), sent)  # the step needs no other key
    assert sum(t.numel() * t.element_size() for t in sent.values()) == want * B


def test_marker_mismatch_and_wrong_inputs_raise():
    raw = _raw(_samples(2), 2, marker="resnet")
    for mk in (tp.make_raw_collate, tp.make_fast_collate):
        with pytest.raises(ValueError, match="rescale_method='resnet'"):
            mk("default")(raw)
        mk("resnet")(raw)
    with pytest.raises(ValueError, match="raw uint16"):
        tp.make_raw_collate()(_samples(2))
    ragged = _raw(_samples(2), 2)
    ragged[1]["input"]["S2"] = ragged[1]["input"]["S2"][:2]
    with pytest.raises(ValueError, match="uniform-T"):
        tp.make_raw_collate()(ragged)


def _variable_t(seed):
    out = []
    for t in (2, 3, 1):
        out.append(SyntheticSEN12MSCRTS(n_samples=1, n_input_t=t, patch_size=16, seed=seed + t)[0])
    return out


@pytest.mark.parametrize("use_sar", [True, False])
def test_pad_collate_is_bit_identical(use_sar):
    samples = _variable_t(4)
    ref = jp.pad_collate_multi(samples, use_sar=use_sar, pad_value=-1.0)
    got = tp.pad_collate_multi(samples, use_sar=use_sar, pad_value=-1.0)
    _same_batch(got, ref)
    assert got["x"].shape[:2] == (3, 3) and (got["x"][2, 1:] == -1.0).all()


@pytest.mark.parametrize("use_sar", [True, False])
def test_collate_mono_is_bit_identical(use_sar):
    ds = SyntheticSEN12MSCR(n_samples=3, patch_size=16, seed=2)
    samples = [ds[i] for i in range(3)]
    _same_batch(tp.collate_mono(samples, use_sar=use_sar),
                jp.collate_mono(samples, use_sar=use_sar))


def test_select_collate_follows_the_config():
    from uncrtaints_tpu_torch.config import Config
    assert tp.select_collate(Config(pretrain=True)) is tp.collate_mono
    assert tp.select_collate(Config(fast_collate=False)) is tp.collate_multi
    fast = tp.select_collate(Config())
    assert fast not in (tp.collate_mono, tp.collate_multi)
    _same_batch(fast(_samples(1)), tp.collate_multi(_samples(1)))


@pytest.mark.parametrize("method", ["default", "resnet", "other"])
def test_process_ms_equals_the_jax_packages(method):
    from uncrtaints_tpu.data.preprocess import process_MS as ref
    from uncrtaints_tpu_torch.data.preprocess import process_MS
    rng = np.random.default_rng(0)
    for img in ((rng.random((13, 8, 8)) * 12000 - 500).astype(np.float32),
                rng.integers(0, 12000, (13, 8, 8)).astype(np.uint16),
                np.array([np.nan, -1.0, 20000.0], np.float64)):
        got, want = process_MS(img, method), ref(img, method)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------- loader --

class _Ids:
    """A dataset whose samples are their own indices."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return int(i)


def _ids_collate(samples, use_sar=True):
    return {"ids": np.asarray(samples)}


def _order(mod, **kw):
    loader = mod.BatchLoader(_Ids(kw.pop("n")), collate=_ids_collate, num_workers=2, **kw)
    epochs = []
    for epoch in (0, 1, 5):
        loader.set_epoch(epoch)
        batches = [(b["ids"].tolist(), bool(b.get("_replicated_tail", False))) for b in loader]
        assert len(batches) == len(loader)
        epochs.append(batches)
    return epochs


@pytest.mark.parametrize("seed", [1, 2, 11])
@pytest.mark.parametrize("shuffle", [True, False])
@pytest.mark.parametrize("drop_last", [True, False])
def test_loader_order_and_length_equal_the_jax_loaders(seed, shuffle, drop_last):
    kw = dict(n=23, batch_size=4, shuffle=shuffle, seed=seed, drop_last=drop_last)
    got, ref = _order(tp, **kw), _order(jp, **kw)
    assert got == ref
    assert len(got[0]) == (5 if drop_last else 6)
    seen = sorted(i for ids, _ in got[0] for i in ids)
    assert seen == list(range(20 if drop_last else 23)) or shuffle
    if shuffle:
        assert got[0] != got[1]  # set_epoch reshuffles
    else:
        assert got[0] == got[1]


@pytest.mark.parametrize("drop_last", [True, False])
def test_loader_shards_equal_the_jax_loaders(drop_last):
    """Two processes: disjoint strided bodies, the same replicated tail."""
    per_rank = []
    for rank in (0, 1):
        kw = dict(n=23, batch_size=4, shuffle=True, seed=3, drop_last=drop_last,
                  shard=(rank, 2))
        got = _order(tp, **kw)
        assert got == _order(jp, **kw)
        per_rank.append(got[0])
    body = [set(ids) for batches in per_rank for ids, tail in batches if not tail]
    assert len(set().union(*body)) == 16 and sum(map(len, body)) == 16
    tails = [[ids for ids, tail in batches if tail] for batches in per_rank]
    assert tails[0] == tails[1] and len(tails[0]) == (0 if drop_last else 1)


def test_loader_yields_collated_batches_and_subset_passes_attributes():
    ds = SyntheticSEN12MSCRTS(n_samples=6, n_input_t=3, patch_size=16, seed=1)
    sub = tp.Subset(ds, range(1, 6))
    assert len(sub) == 5 and sub.patch_size == 16
    loader = tp.BatchLoader(sub, batch_size=2, collate=tp.make_fast_collate(),
                            drop_last=False, num_workers=2)
    batches = list(loader)
    assert [b["x"].shape[0] for b in batches] == [2, 2, 1]
    _same_batch(batches[0], tp.collate_multi([ds[1], ds[2]]))


def _loader_threads():
    return [t for t in threading.enumerate() if t is not threading.main_thread()]


def test_early_break_leaves_no_live_thread():
    before = set(_loader_threads())

    class Slow(_Ids):
        def __getitem__(self, i):
            time.sleep(0.005)
            return int(i)

    loader = tp.BatchLoader(Slow(64), batch_size=2, collate=_ids_collate, num_workers=3,
                            prefetch=2)
    for _ in range(3):  # the producer sits on a full queue when the consumer leaves
        it = iter(loader)
        assert next(it)["ids"].tolist() == [0, 1]
        time.sleep(0.1)
        it.close()
        assert set(_loader_threads()) <= before
    for i, _ in enumerate(loader):
        if i == 1:
            break
    assert set(_loader_threads()) <= before


def test_an_error_in_the_dataset_reaches_the_consumer():
    class Broken(_Ids):
        def __getitem__(self, i):
            if i == 5:
                raise RuntimeError("sample 5 is unreadable")
            return int(i)

    before = set(_loader_threads())
    loader = tp.BatchLoader(Broken(8), batch_size=2, collate=_ids_collate, num_workers=2)
    seen = []
    with pytest.raises(RuntimeError, match="sample 5"):
        for b in loader:
            seen.append(b["ids"].tolist())
    assert seen == [[0, 1], [2, 3]]
    assert set(_loader_threads()) <= before
