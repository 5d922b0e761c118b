"""The port's benchmark (``uncrtaints_tpu_torch/bench.py``) on the CPU.

Each of its four modes runs end to end at a tiny size with
``device="cpu"`` (encoder [16], decoder 2x[16], 4 heads, 32x32, T=3, B=2, 2
windows; the e2e tree 2 patches x 3 time points) and gives one line in the
root ``bench.py``'s form: its metric names, ``correct`` true, no device
metric. The eval FLOP count is ``profile_flops`` x B; without a card every
mode raises; a wrong launch table makes ``correct`` false and the command
exit 1. The e2e source's raw DN path (``SEN12MSCRTS(raw_s2=True)`` -> the
raw collate -> the radiometry in the step) is held against the JAX
package's processed samples and collate within 1e-6.
"""

import json
import os
import re

import numpy as np
import pytest
import torch

import uncrtaints_tpu.data.pipeline as jpipe
import uncrtaints_tpu.data.sen12mscrts as jts
from uncrtaints_tpu_torch import bench
from uncrtaints_tpu_torch.data import make_fast_collate, make_raw_collate
from uncrtaints_tpu_torch.data import sen12mscrts as tts
from uncrtaints_tpu_torch.data.preprocess import process_MS
from uncrtaints_tpu_torch.data.synthetic_tree import write_sen12mscrts_tree
from uncrtaints_tpu_torch.train import batch_to_device
from uncrtaints_tpu_torch.train.engine import _prepare_xy, profile_flops

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(encoder_widths=[16], decoder_widths=[16, 16], n_head=4, d_model=32)
SMALL = {  # each mode at the tests' size
    "eval": lambda **kw: bench.run_eval(2, windows=2, steps=2, patch=32, overrides=TINY, **kw),
    "train": lambda **kw: bench.run_train(2, windows=2, steps=2, patch=32, overrides=TINY,
                                          **kw),
    "scene": lambda **kw: bench.run_scene(2, windows=2, scene_hw=64, tile=32, overlap=8,
                                          overrides=TINY, **kw),
    "e2e": lambda **kw: bench.run_e2e(2, windows=2, n_patches=2, time_points=3, patch=32,
                                      num_workers=2, overrides=TINY, **kw),
}
DEVICE_METRICS = ("mfu", "tflops_per_sec", "peak_memory_gib", "device_busy_ms", "idle_share",
                  "device_ms_by_kind", "power_limit_w", "h2d_fresh_mb_per_sec")


def root_bench_metrics():
    """The metric names the root bench.py prints, read from its source."""
    src = open(os.path.join(REPO, "bench.py")).read()
    return set(re.findall(r'"(uncrtaints_[a-z0-9_]+_throughput)"', src))


@pytest.mark.parametrize("mode, kw", [("eval", {}), ("train", {}), ("scene", {}),
                                      ("e2e", {}), ("e2e", {"host_radiometry": True})])
def test_each_mode_gives_one_line_on_the_cpu(mode, kw):
    out = SMALL[mode](device="cpu", **kw)
    assert json.loads(json.dumps(out)) == out  # one JSON object
    assert out["metric"] == bench.METRICS[mode] and out["metric"] in root_bench_metrics()
    assert out["correct"] is True and out["device"] == "cpu"
    assert not [k for k in DEVICE_METRICS if k in out]
    assert out["value"] > 0 and out["windows"] == 2 and len(out["window_values"]) == 2
    assert out["value_q1"] <= out["value"] <= out["value_q3"]
    assert out["vs_baseline_estimated"] is True and out["seed"] == 0
    for key in ("unit", "vs_baseline", "baseline_source", "batch_size", "host_cpus",
                "step_ms_p50"):
        assert key in out
    if mode == "e2e":
        assert out["source"] == "tiff_tree" and out["radiometry"] == (
            "host_lut" if kw else "device_raw_dn")
        # only the keys the step receives: fp32 S1 (2 bands) + uint16 S2 (13) of 3 frames
        # and the uint16 target, or the fp32 x (15 bands) and y, and the dates
        px = 32 * 32
        want = (3 * px * 15 * 4 + px * 13 * 4 if kw else
                3 * px * (2 * 4 + 13 * 2) + px * 13 * 2) + 3 * 4
        assert out["h2d_mb_per_seq"] == pytest.approx(want / 1e6)
    if mode in ("eval", "train"):
        assert out["launches_per_step"] == {k: 0 for k in bench.EXPECTED_LAUNCHES[mode]}


def test_eval_flops_are_profile_flops_times_the_batch():
    out = SMALL["eval"](device="cpu")
    cfg = bench.paper_config(2, torch.device("cpu"), TINY)
    model = bench.seeded_model(cfg, torch.device("cpu"), 0)
    batch = bench.device_batch(cfg, 2, 32, 0, torch.device("cpu"))
    assert out["flops_per_step"] == round(profile_flops(cfg, model, batch) * 1e6 * 2) > 0


@pytest.mark.parametrize("mode", list(SMALL))
def test_every_mode_raises_without_a_card(mode, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SMALL[mode]()


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_a_launch_count_off_the_table_fails_correct(mode):
    wrong = dict(bench.EXPECTED_LAUNCHES[mode])  # the card's table, not the CPU's zeros
    out = SMALL[mode](device="cpu", expected=wrong)
    assert out["correct"] is False and out["checks"]["launches_ok"] is False


def test_the_command_prints_the_line_and_exits_1_when_incorrect(monkeypatch, capsys):
    seen = {}

    def fake(**kw):
        seen.update(kw)
        return {"metric": bench.METRICS["train"], "value": 1.0, "correct": False}

    monkeypatch.setattr(bench, "run_train", fake)
    assert bench.main(["--train", "--seed", "3"]) == 1
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1 and json.loads(lines[0])["correct"] is False
    assert seen == {"seed": 3}
    with pytest.raises(SystemExit):
        bench.main(["--host_radiometry"])  # an arm of --e2e only


def test_device_time_by_kind_sorts_kernels_by_the_first_fragment():
    from torch.autograd import DeviceType

    class Event:
        def __init__(self, key, count, us, device=DeviceType.CUDA):
            self.key, self.count, self.self_device_time_total = key, count, us
            self.device_type = device

    class Prof:
        def key_averages(self):
            return [Event("void att_group_bulk_kernel<16, true>", 1, 190.0),
                    Event("void dw_grad_tile_kernel", 6, 1000.0),
                    Event("vectorized_elementwise_kernel<gelu>", 36, 3680.0),
                    Event("vectorized_elementwise_kernel<mul>", 100, 500.0),
                    Event("aten::mul", 100, 0.0, DeviceType.CPU),
                    Event("some_kernel", 2, 20.0)]

    kinds, names, others = bench.device_time_by_kind(Prof(), bench.KERNEL_KINDS)
    assert kinds == {"K1 and K1-bwd": (0.19, 1), "K2 depthwise weight gradient": (1.0, 6),
                     "GELU": (3.68, 36), "elementwise": (0.5, 100), "other": (0.02, 2)}
    assert names["some_kernel"] == (2, 0.02) and others == [(0.02, 2, "some_kernel")]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("bench_tree"))
    write_sen12mscrts_tree(root, {bench.E2E_ROI: range(2)}, hw=16, seed=4, workers=2)
    return root


def test_raw_dn_samples_of_the_tree_equal_the_jax_packages_batch(tree):
    """SEN12MSCRTS(raw_s2=True) -> the raw collate -> _prepare_xy against the
    JAX package's processed samples -> its collate_multi (x and y within
    1e-6 after scale_by); the single-pass collate's LUT likewise."""
    kw = dict(split="test", cloud_masks=bench.E2E_MASKS, n_input_samples=3)
    raw = tts.SEN12MSCRTS(tree, device="cpu", raw_s2=True, **kw)
    ref = jts.SEN12MSCRTS(tree, **kw)
    samples = [raw[0], raw[1]]
    assert samples[0]["rescale_method"] == "default"
    assert samples[0]["input"]["S2"][0].dtype == np.uint16
    want = jpipe.collate_multi([ref[0], ref[1]], use_sar=True)
    cfg = bench.paper_config(2, torch.device("cpu"))
    for collate in (make_raw_collate(), make_fast_collate()):
        got = batch_to_device(collate(samples, use_sar=True), "cpu")
        x, _, y = _prepare_xy(cfg, got)
        np.testing.assert_allclose(x.numpy() / cfg.scale_by, want["x"], rtol=0, atol=1e-6)
        np.testing.assert_allclose(y.numpy(), want["y"], rtol=0, atol=1e-6)
        np.testing.assert_array_equal(got["dates"].numpy(), want["dates"])


def test_a_tree_of_fewer_time_points_reads(tmp_path):
    root = str(tmp_path)
    write_sen12mscrts_tree(root, {bench.E2E_ROI: range(2)}, hw=16, time_points=range(5),
                           workers=2)
    kw = dict(cloud_masks=bench.E2E_MASKS, n_input_samples=3, time_points=range(5),
              device="cpu")
    raw, done = tts.SEN12MSCRTS(root, raw_s2=True, **kw), tts.SEN12MSCRTS(root, **kw)
    assert len(raw) == 2 and len(raw.paths[1]["S2"]) == 5
    a, b = raw[1], done[1]
    assert a["input"]["idx"] == b["input"]["idx"] and len(a["input"]["S2"]) == 3
    for f, g in zip(a["input"]["S2"] + a["target"]["S2"], b["input"]["S2"] + b["target"]["S2"]):
        np.testing.assert_array_equal(process_MS(f.astype(np.float32), "default"), g)


def test_raw_dn_needs_cloudy_cloudfree_samples(tree):
    with pytest.raises(ValueError, match="raw_s2"):
        tts.SEN12MSCRTS(tree, cloud_masks=None, raw_s2=True, device="cpu")
