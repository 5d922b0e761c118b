"""The port's benchmark: throughput of the paper recipe on the card.

The counterpart of the JAX package's root ``bench.py``: the same four
modes and metric names, one JSON line a run, measured on an NVIDIA GPU::

    python -m uncrtaints_tpu_torch.bench            eval step
    python -m uncrtaints_tpu_torch.bench --train    train step
    python -m uncrtaints_tpu_torch.bench --scene    whole-scene serving
    python -m uncrtaints_tpu_torch.bench --e2e [--host_radiometry]

Every mode builds the paper recipe (``derive(Config(use_sar=True,
scale_by=10.0, batch_size=B, lr=1e-3))``: encoder [128], decoder 5x[128],
16 heads, d_model 256, MBConv, ``att_group``, diagonal MGNLL, bf16, T=3,
256x256) with weights drawn from ``--seed``, checks its outputs before it
times anything, and prints one line: ``metric``, ``value`` (the median of
the timed windows), ``unit``, ``vs_baseline`` against the V100 anchors of
the root ``bench.py`` (estimated, as there), ``correct`` and the fields
below. A failed check prints the line with ``"correct": false`` and exits
with 1.

- eval (``uncrtaints_256px_t3_eval_throughput``): the eval step (forward,
  MGNLL, rescale) on a batch drawn on the device (x, y ~ U[0,1), dates =
  floor(U[0,1500))); the fused eval (kernels K3 / K4) is held against
  ``fused_eval="off"`` first.
- train (``uncrtaints_256px_t3_train_throughput``): the train step
  (forward, MGNLL, backward, Adam at lr 1e-3, attention dropout drawn from
  a generator seeded with ``seed + 1``), the state threaded through; every
  step's loss finite, the first step's gradients finite and non-zero but
  where exact arithmetic makes them zero (:func:`exact_zero_gradients`).
- scene (``uncrtaints_scene_serving_throughput``): ``infer.predict_scene``
  on a seeded 1024x1024 scene, tile 256, overlap 64, batches of 8.
- e2e (``uncrtaints_256px_t3_e2e_eval_throughput``): a SEN12MS-CR-TS tree of
  GeoTIFFs (64 patches, 5 time points, written by
  ``data/synthetic_tree.py`` into a temporary directory; the threshold
  masks on the device) read by ``data/sen12mscrts.py`` as raw uint16 DN ->
  ``BatchLoader`` (8 threads; the raw collate, the radiometry on the
  device, or with ``--host_radiometry`` the single-pass collate, a lookup
  table on the host) -> the host-to-device copy -> the eval step with the
  image metrics, one synchronization an epoch.

Timing: 3 warm-up steps, each ending in a fetch of the loss, then R windows
of N steps queued back to back with one ``torch.cuda.synchronize()`` at the
end of each (scene: one scene a window; e2e: one epoch a window). ``value``
is the median of the windows' rates, with its quartiles and every window's
rate beside it; ``step_ms_p50`` is the median window's time a step.

Utilisation: ``mfu`` is the FLOPs of one step over the median step time
over the card's dense bf16 peak (:data:`PEAK_BF16_FLOPS`; a card not in the
table raises). The FLOPs are counted once, outside the timed windows, by
``torch.utils.flop_counter.FlopCounterMode``: matrix products, convolutions
and the kernels' registered formulas, no elementwise work (eval: the
``profile_flops`` count of the forward times B; train, scene, e2e: the
timed unit of work under the counter, the backward included). PyTorch has
no counterpart of XLA's "bytes accessed", so there is no ``hbm_fraction``.

One more step of eval and train runs under ``torch.profiler`` after the
windows: device-busy ms, the idle share against ``step_ms_p50``, device
ms and launches by kind, and the launches of each kernel in the step,
which must equal :data:`EXPECTED_LAUNCHES` (else ``correct`` is false).
``peak_memory_gib`` is ``max_memory_allocated`` over the timed windows.

There is no fallback: without a card every mode raises unless the caller
passes ``device="cpu"`` (the tests do); an out-of-memory error or a
kernel that fails to build or launch raises; nothing is retried at another
batch. A run on the CPU prints ``"device": "cpu"`` and no device metric
(no ``mfu``, no profile, no peak memory).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from uncrtaints_tpu_torch.config import Config, derive, input_dim

# The V100 anchors of the JAX package's bench.py (its :37-38, BASELINE.md
# "Grounding the V100 anchor"): the PyTorch reference measured on a CPU
# (eval fwd + MGNLL 0.199 sequences/s, train step 0.0328 at B=1, 256x256,
# T=3) scaled by the V100 / CPU fp32 peak ratio of 120. An extrapolation,
# not a V100 measurement: vs_baseline is marked estimated.
V100_REFERENCE_SEQ_PER_SEC = 23.9        # eval: 0.199 * 120
V100_REFERENCE_TRAIN_SEQ_PER_SEC = 3.94  # train: 0.0328 * 120
BASELINE_SOURCE = "cpu_measured_x_peak_flops_ratio"

# dense bf16 tensor-core peaks by torch.cuda.get_device_name (NVIDIA's data
# sheet: H100 SXM 989 TFLOP/s at its 700 W limit)
PEAK_BF16_FLOPS = {"NVIDIA H100 80GB HBM3": 989e12}
FLOPS_BASIS = ("torch.utils.flop_counter: matmuls, convolutions and the kernels' "
               "registered formulas, no elementwise work")

# the kernels' launches in one step of the paper recipe on a card
# (K6: the encoder's 5 group norms in eval, the decoder's batch norms being
# K3 / K4's; all 25 norms in train, each with its backward; K7: the eval
# encoder's depthwise 3x3, the one reflect conv that K4 or K5 does not fold)
EXPECTED_LAUNCHES = {
    "eval": {"K1": 1, "K1-bwd": 0, "K3": 10, "K4": 5, "K5": 0, "K2": 0, "K6": 5, "K6-bwd": 0,
             "K7": 1, "K7-adj": 0},
    "train": {"K1": 1, "K1-bwd": 1, "K3": 0, "K4": 0, "K5": 12, "K2": 6, "K6": 25,
              "K6-bwd": 25, "K7": 0, "K7-adj": 0},
}
METRICS = {"eval": "uncrtaints_256px_t3_eval_throughput",
           "train": "uncrtaints_256px_t3_train_throughput",
           "scene": "uncrtaints_scene_serving_throughput",
           "e2e": "uncrtaints_256px_t3_e2e_eval_throughput"}
E2E_ROI = "ROIs1158/106"
E2E_MASKS = "cloud_cloudshadow_mask"  # the threshold detector: no weights to load
WARMUP = 3

# device kernels of an eval step by kind: the first fragment found in a
# kernel's name decides (the hand-written kernels first)
EVAL_KINDS = (
    ("K1", ("att_group_",)),
    ("K7 reflect pad", ("reflect_pad_nhwc_kernel",)),
    ("K3", ("ngm_",)),
    ("K4 (with its pooled-sum pass)", ("ngd_", "channel_sum_kernel")),
    ("K6 norm + activation (with its statistics passes)", ("norm_part_", "norm_finalize_",
                                                          "norm_apply_", "group_stats_kernel")),
    ("GEMMs outside the kernels", ("gemm", "cutlass", "xmma", "nvjet", "cublas", "splitK")),
    ("convolutions (cuDNN)", ("cudnn", "conv", "Conv")),
    ("reductions", ("reduce_kernel",)),
    ("GELU", ("gelu", "Gelu")),
    ("dtype and layout copies", ("copy", "Copy", "CatArray", "Memcpy")),
    ("elementwise", ("elementwise",)),
)
# the same for a train step (a GELU or a copy is an elementwise kernel by
# name, so they come before it)
KERNEL_KINDS = (
    ("reflect pad", ("reflection_pad",)),
    ("K7 reflect pad and its adjoint", ("reflect_pad_nhwc_kernel",
                                        "reflect_pad_adjoint_nhwc_kernel")),
    ("K5 depthwise stencil", ("dw_tile_kernel", "dw_direct_kernel", "dw_adjoint_frame_kernel")),
    ("K2 depthwise weight gradient", ("dw_grad_",)),
    ("K1 and K1-bwd", ("att_group_",)),
    ("K6 and K6-bwd norm + activation", ("norm_part_", "norm_finalize_", "norm_apply_",
                                         "norm_bwd_", "norm_dx_", "group_stats_kernel")),
    ("GEMMs", ("gemm", "cutlass", "xmma", "nvjet", "cublas", "splitK")),
    ("reductions", ("reduce_kernel",)),
    ("GELU", ("gelu", "Gelu")),
    ("dtype and layout copies", ("copy", "Copy", "CatArray", "Memcpy")),
    ("Adam (_foreach)", ("multi_tensor_apply",)),
    ("elementwise", ("elementwise",)),
)


def device_time_by_kind(prof, kind_table):
    """({kind: (ms, launches)}, {kernel name: (launches, ms)}, the largest
    'other' kernels) of the device kernels a profile recorded."""
    from torch.autograd import DeviceType
    kinds, names, others = {}, {}, []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        kind = next((k for k, frags in kind_table if any(f in e.key for f in frags)), "other")
        t, n = kinds.get(kind, (0.0, 0))
        kinds[kind] = (t + us / 1e3, n + e.count)
        n0, t0 = names.get(e.key, (0, 0.0))
        names[e.key] = (n0 + e.count, t0 + us / 1e3)
        if kind == "other":
            others.append((round(us / 1e3, 3), e.count, e.key[:60]))
    return kinds, names, sorted(others, reverse=True)[:4]


def kernel_wrappers() -> Dict[str, Callable]:
    """The kernels' wrappers by counter name (each counts its launches; K6
    the norms with their activation, forward and backward; K7 the reflect
    pad and its adjoint)."""
    from uncrtaints_tpu_torch.ops import aggregate, dwconv, dwgrad, mbconv, norm, pad
    return {"K1": aggregate.att_group_aggregate, "K1-bwd": aggregate.att_group_aggregate_bwd,
            "K5": dwconv.dw_stencil, "K2": dwgrad.dw_kernel_grad,
            "K3": mbconv.norm_gelu_matmul, "K4": mbconv.norm_gelu_dwconv3x3,
            "K6": norm.norm_act, "K6-bwd": norm.norm_act_bwd,
            "K7": pad.reflect_pad, "K7-adj": pad.reflect_pad_adjoint}


def launch_counts() -> Dict[str, int]:
    """Every kernel's launch count so far (read, never reset here)."""
    return {k: f.launches for k, f in kernel_wrappers().items()}


def launches_since(before: Dict[str, int]) -> Dict[str, int]:
    return {k: n - before[k] for k, n in launch_counts().items()}


def exact_zero_gradients(model) -> set:
    """The parameters whose gradient is zero in exact arithmetic in a train
    step: a bias that feeds a batch norm in training (the norm takes out its
    mean), also through a bias-free convolution (a batch-norm MBConv's
    PreNorm bias ahead of pw1), and the L-TAE's key bias and, in the tiny
    L-TAE whose input feeds only the keys, its input norm's and input conv's
    biases (a shift of every logit of a pixel, under the softmax over T).
    Rounding leaves noise there, or an exact zero."""
    from uncrtaints_tpu_torch.models.blocks import MBConv
    from uncrtaints_tpu_torch.models.layers import Norm2d
    from uncrtaints_tpu_torch.models.ltae import BatchNorm1d, LTAE2dtiny
    names = set()
    for prefix, mod in model.named_modules():
        if isinstance(mod, MBConv) and mod.norm == "batch" and mod.expansion != 1:
            names.add(f"{prefix}.conv.norm.bias")
        if isinstance(mod, LTAE2dtiny):
            names |= {f"{prefix}.in_norm.bias", f"{prefix}.inconv.bias"}
        if isinstance(mod, torch.nn.Sequential):
            kids = list(mod.children())
            for i, (a, b) in enumerate(zip(kids, kids[1:])):
                batch_norm = isinstance(b, BatchNorm1d) or (isinstance(b, Norm2d)
                                                            and b.norm == "batch")
                if batch_norm and getattr(a, "bias", None) is not None:
                    names.add(f"{prefix}.{i}.bias")
    return names | {n for n, _ in model.named_parameters()
                    if n.endswith("attention_heads.fc1_k.bias")}


# ------------------------------------------------------------------ setup --

def resolve_device(device) -> torch.device:
    """The device to measure on; a CUDA device without a card raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("bench: no CUDA device (torch.cuda.is_available() is false); "
                           "pass device='cpu' (--device cpu) for a run on the CPU")
    return dev


def card(dev: torch.device) -> Dict:
    """The line's device fields: the card's name and power limit in watts
    (``nvidia-smi``), or just "cpu"."""
    if dev.type != "cuda":
        return {"device": "cpu"}
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    name = torch.cuda.get_device_name(index)
    if name not in PEAK_BF16_FLOPS:
        raise RuntimeError(f"bench: no bf16 peak known for {name!r} "
                           f"(known: {sorted(PEAK_BF16_FLOPS)})")
    out = subprocess.run(["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    watts = float(out.rsplit(",", 1)[1].split()[0])
    return {"device": name, "power_limit_w": watts}


def paper_config(batch_size: int, dev: torch.device, overrides: Optional[Dict] = None) -> Config:
    """The paper recipe at batch ``batch_size`` on ``dev`` (``overrides``:
    other Config fields, for small test models)."""
    return derive(Config(use_sar=True, scale_by=10.0, batch_size=batch_size, lr=1e-3,
                         device=str(dev), **(overrides or {})))


def seeded_model(cfg: Config, dev: torch.device, seed: int):
    from uncrtaints_tpu_torch.models import get_generator
    return get_generator(cfg, device=dev, generator=torch.Generator().manual_seed(seed))


def device_batch(cfg: Config, batch_size: int, patch: int, seed: int,
                 dev: torch.device) -> Dict[str, torch.Tensor]:
    """The root bench's batch, drawn on the device: x, y ~ U[0,1), dates =
    floor(U[0,1500))."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    T = cfg.input_t
    return {"x": torch.rand((batch_size, T, patch, patch, input_dim(cfg)), generator=gen,
                            device=dev),
            "y": torch.rand((batch_size, 1, patch, patch, 13), generator=gen, device=dev),
            "dates": torch.floor(1500.0 * torch.rand((batch_size, T), generator=gen,
                                                     device=dev))}


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def finite(t: torch.Tensor) -> bool:
    return bool(torch.isfinite(t).all())


def count_flops(fn: Callable) -> float:
    """The FLOPs ``fn()`` does, counted by ``FlopCounterMode``."""
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as counter:
        fn()
    return float(counter.get_total_flops())


# ----------------------------------------------------------------- timing --

def time_windows(run: Callable, windows: int, steps: int, dev: torch.device) -> List[float]:
    """Seconds of each of ``windows`` windows of ``steps`` calls of ``run``
    queued back to back, one synchronization at the end of each."""
    out = []
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(steps):
            run()
        sync(dev)
        out.append(time.perf_counter() - t0)
    return out


def rate_fields(seconds: List[float], work: float, steps: int) -> Dict:
    """``value`` (the median of the windows' rates, ``work`` units a
    window), its quartiles, every window's rate and the median window's ms
    a step."""
    rates = [work / s for s in seconds]
    q1, _, q3 = statistics.quantiles(rates, n=4) if len(rates) > 1 else rates * 3
    return {"value": statistics.median(rates), "value_q1": q1, "value_q3": q3,
            "window_values": rates, "windows": len(seconds), "steps_per_window": steps,
            "step_ms_p50": statistics.median(seconds) / steps * 1e3}


def utilization(flops: float, step_s: float, info: Dict) -> Dict:
    """mfu and achieved TFLOP/s of ``flops`` a step in ``step_s`` seconds
    (a card only: nothing on the CPU)."""
    out = {"flops_per_step": flops, "flops_basis": FLOPS_BASIS}
    if info["device"] in PEAK_BF16_FLOPS:
        out["tflops_per_sec"] = flops / step_s / 1e12
        out["mfu"] = flops / step_s / PEAK_BF16_FLOPS[info["device"]]
    return out


def traced_step(run: Callable, dev: torch.device, kind_table, step_ms: float,
                expected: Dict[str, int]) -> Dict:
    """One more step, its kernels' launches counted (they must equal
    ``expected``) and, on a card, under ``torch.profiler``: device-busy ms,
    the idle share against ``step_ms``, device ms and launches by kind."""
    before = launch_counts()
    out = {}
    if dev.type == "cuda":
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run()
            sync(dev)
        kinds, _, others = device_time_by_kind(prof, kind_table)
        busy = sum(t for t, _ in kinds.values())
        out = {"device_busy_ms": busy, "idle_share": 1 - busy / step_ms,
               "device_launches": sum(n for _, n in kinds.values()),
               "device_ms_by_kind": {k: {"ms": t, "launches": n} for k, (t, n) in
                                     sorted(kinds.items(), key=lambda kv: -kv[1][0])},
               "largest_other_kernels": others}
    else:
        run()
    counts = launches_since(before)
    out["launches_per_step"] = counts
    out["launches_ok"] = counts == expected
    return out


def expected_launches(mode: str, dev: torch.device, given: Optional[Dict] = None) -> Dict:
    """What one step must launch: ``given``, else the paper recipe's on a
    card, and nothing on the CPU (a wrapper runs its plain version there)."""
    if given is not None:
        return dict(given)
    if dev.type == "cuda":
        return dict(EXPECTED_LAUNCHES[mode])
    return {k: 0 for k in EXPECTED_LAUNCHES[mode]}


def line(mode: str, info: Dict, seed: int, batch_size: int, fields: Dict, checks: Dict,
         anchor: float, anchor_value: Optional[float] = None) -> Dict:
    """The JSON line of a run, in the root bench's form."""
    anchor_value = fields["value"] if anchor_value is None else anchor_value
    return {"metric": METRICS[mode], "value": fields["value"], "unit": "sequences/sec/chip",
            "vs_baseline": anchor_value / anchor, "vs_baseline_estimated": True,
            "baseline_source": BASELINE_SOURCE, "batch_size": batch_size,
            "host_cpus": os.cpu_count(), **info, "seed": seed,
            "correct": all(v for k, v in checks.items() if k.endswith("ok")),
            **fields, "checks": checks}


def peak_gib(dev: torch.device) -> Dict:
    if dev.type != "cuda":
        return {}
    return {"peak_memory_gib": torch.cuda.max_memory_allocated(dev) / 2**30}


def reset_peak(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def gap_ok(got: torch.Tensor, ref: torch.Tensor) -> Dict:
    """The fused-vs-standard gate of chip_smoke.py phase 3: max |gap| within
    0.02 and its RMSE within 5e-3 of max |ref|."""
    d = (got.float() - ref.float()).abs()
    top = float(ref.abs().max())
    mx, rmse = float(d.max()), float(d.square().mean().sqrt())
    return {"max": mx, "rmse": rmse, "max_ref": top,
            "ok": finite(got) and mx <= 0.02 * top and rmse <= 5e-3 * top}


# ------------------------------------------------------------------ modes --

def run_eval(batch_size: int = 4, *, device="cuda", seed: int = 0, windows: int = 10,
             steps: int = 25, patch: int = 256, overrides: Optional[Dict] = None,
             expected: Optional[Dict] = None) -> Dict:
    """The eval step's line (module docstring). A window of 25 steps at B=4
    lasts about half a second on an H100, as one of 5 train steps does."""
    from uncrtaints_tpu_torch.train import make_eval_step
    from uncrtaints_tpu_torch.train.engine import profile_flops
    dev = resolve_device(device)
    info = card(dev)
    cfg = paper_config(batch_size, dev, overrides)
    model = seeded_model(cfg, dev, seed)
    batch = device_batch(cfg, batch_size, patch, seed, dev)
    step = make_eval_step(cfg)

    fused = step(model, batch)
    off = seeded_model(cfg.replace(fused_eval="off"), dev, seed)
    off.load_state_dict(model.state_dict())
    std = step(off, batch)
    checks = {"loss_finite_ok": finite(fused["loss"])}
    for k in ("pred", "var"):
        gap = gap_ok(fused[k], std[k])
        checks[f"fused_vs_standard_{k}_ok"] = gap.pop("ok")
        checks[f"fused_vs_standard_{k}"] = gap
    del off, fused, std
    with contextlib.redirect_stdout(sys.stderr):  # profile_flops prints its count
        flops = round(profile_flops(cfg, model, batch) * 1e6 * batch_size)

    for _ in range(WARMUP):
        step(model, batch)["loss"].item()
    reset_peak(dev)
    fields = rate_fields(time_windows(lambda: step(model, batch), windows, steps, dev),
                         steps * batch_size, steps)
    fields.update(peak_gib(dev))
    if dev.type == "cuda":
        fields.update(utilization(flops, fields["step_ms_p50"] / 1e3, info))
    else:
        fields.update(flops_per_step=flops, flops_basis=FLOPS_BASIS)
    trace = traced_step(lambda: step(model, batch), dev, EVAL_KINDS, fields["step_ms_p50"],
                        expected_launches("eval", dev, expected))
    checks["launches_ok"] = trace.pop("launches_ok")
    fields.update(trace)
    return line("eval", info, seed, batch_size, fields, checks, V100_REFERENCE_SEQ_PER_SEC)


def run_train(batch_size: int = 4, *, device="cuda", seed: int = 0, windows: int = 10,
              steps: int = 5, patch: int = 256, overrides: Optional[Dict] = None,
              expected: Optional[Dict] = None) -> Dict:
    """The train step's line (module docstring)."""
    from uncrtaints_tpu_torch.train import create_train_state, make_train_step
    dev = resolve_device(device)
    info = card(dev)
    cfg = paper_config(batch_size, dev, overrides)
    model = seeded_model(cfg, dev, seed)
    batch = device_batch(cfg, batch_size, patch, seed, dev)
    state = create_train_state(cfg, model)
    step = make_train_step(cfg)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    losses: List[torch.Tensor] = []

    def run():
        _, aux = step(state, batch, gen)  # the model and Adam update in place
        losses.append(aux["loss"])

    _, aux = step(state, batch, gen)
    zero_ok = exact_zero_gradients(model)
    bad = sorted(n for n, g in aux["grads"].items()
                 if not finite(g) or (float(g.abs().max()) == 0 and n not in zero_ok))
    checks = {"first_step_gradients_ok": not bad, "gradients_zero_or_not_finite": bad[:8],
              "first_loss_finite_ok": finite(aux["loss"])}
    del aux
    flops = count_flops(run)

    for _ in range(WARMUP):
        run()
        losses[-1].item()
    reset_peak(dev)
    del losses[:]
    fields = rate_fields(time_windows(run, windows, steps, dev), steps * batch_size, steps)
    fields.update(peak_gib(dev))
    checks["losses_finite_ok"] = finite(torch.stack(losses))
    fields["loss_last"] = float(losses[-1])
    if dev.type == "cuda":
        fields.update(utilization(flops, fields["step_ms_p50"] / 1e3, info))
    else:
        fields.update(flops_per_step=flops, flops_basis=FLOPS_BASIS)
    trace = traced_step(run, dev, KERNEL_KINDS, fields["step_ms_p50"],
                        expected_launches("train", dev, expected))
    checks["launches_ok"] = trace.pop("launches_ok")
    fields.update(trace)
    return line("train", info, seed, batch_size, fields, checks,
                V100_REFERENCE_TRAIN_SEQ_PER_SEC)


def run_scene(batch_size: int = 8, *, device="cuda", seed: int = 0, windows: int = 3,
              scene_hw: int = 1024, tile: int = 256, overlap: int = 64,
              overrides: Optional[Dict] = None) -> Dict:
    """Whole-scene serving (``infer.predict_scene``): output Mpixel/s over
    ``windows`` scenes (one scene a window), the host's tiling, copies and
    blend included, and the 256x256-sequence equivalent."""
    from uncrtaints_tpu_torch.infer import predict_scene
    dev = resolve_device(device)
    info = card(dev)
    cfg = paper_config(batch_size, dev, overrides)
    model = seeded_model(cfg, dev, seed)
    rng = np.random.default_rng(seed)
    scene = rng.random((cfg.input_t, scene_hw, scene_hw, input_dim(cfg)), dtype=np.float32)
    dates = np.arange(cfg.input_t, dtype=np.float32) * 12.0
    outs = []

    def run():
        outs[:] = [predict_scene(model, cfg, scene, dates, tile=tile, overlap=overlap,
                                 batch_size=batch_size)]

    run()  # warm-up
    shape = (1, scene_hw, scene_hw, 13)
    checks = {f"{k}_ok": outs[0][k].shape == shape and bool(np.isfinite(outs[0][k]).all())
              for k in ("pred", "var")}
    flops = count_flops(run)
    stride = tile - min(overlap, tile // 2)  # predict_scene's windows
    n_win = math.ceil(max(scene_hw - tile, 0) / stride) + 1
    n_fwd = math.ceil(n_win * n_win / batch_size)
    before = launch_counts()
    reset_peak(dev)
    seconds = time_windows(run, windows, 1, dev)
    counts = launches_since(before)
    per_scene = {k: n * n_fwd for k, n in expected_launches("eval", dev).items()}
    checks["launches_ok"] = counts == {k: n * windows for k, n in per_scene.items()}
    pix = scene_hw * scene_hw
    fields = rate_fields(seconds, pix / 1e6, 1)
    fields.update(peak_gib(dev))
    fields.update({"seq256_equivalent_per_sec": fields["value"] * 1e6 / (256 * 256),
                   "windows_per_sec": n_win * n_win / statistics.median(seconds),
                   "scene_hw": scene_hw, "tile": tile, "overlap": overlap,
                   "scene_windows": n_win * n_win, "forwards_per_scene": n_fwd,
                   "launches_per_scene": {k: n / windows for k, n in counts.items()}})
    if dev.type == "cuda":
        fields.update(utilization(flops, statistics.median(seconds), info))
    out = line("scene", info, seed, batch_size, fields, checks, V100_REFERENCE_SEQ_PER_SEC,
               anchor_value=fields["seq256_equivalent_per_sec"])
    out["unit"] = "output_megapixels/sec/chip"
    return out


def run_e2e(batch_size: int = 4, *, device="cuda", seed: int = 0, windows: int = 4,
            n_patches: int = 64, time_points: int = 5, patch: int = 256,
            num_workers: int = 8, host_radiometry: bool = False,
            overrides: Optional[Dict] = None) -> Dict:
    """The whole pipeline (module docstring): the host-pipeline-only rate
    (one pass of the loader, no step) and the end-to-end rate over
    ``windows`` epochs, one synchronization an epoch."""
    from uncrtaints_tpu_torch.data import BatchLoader, make_fast_collate, make_raw_collate
    from uncrtaints_tpu_torch.data.sen12mscrts import SEN12MSCRTS
    from uncrtaints_tpu_torch.data.synthetic_tree import write_sen12mscrts_tree
    from uncrtaints_tpu_torch.train import batch_to_device, make_eval_step
    dev = resolve_device(device)
    info = card(dev)
    cfg = paper_config(batch_size, dev, overrides)
    model = seeded_model(cfg, dev, seed)
    if host_radiometry:  # the LUT in the host's single-pass collate, fp32 x
        collate, keys = make_fast_collate(), ("x", "y", "dates")
    else:  # uint16 DN to the device, the radiometry in the step
        collate, keys = make_raw_collate(), ("x_s1", "x_s2dn", "y_dn", "dates")
    step = make_eval_step(cfg, with_metrics=True)

    with tempfile.TemporaryDirectory(prefix="uncrtaints_e2e_") as root:
        t0 = time.perf_counter()
        tree_bytes = write_sen12mscrts_tree(root, {E2E_ROI: range(n_patches)}, hw=patch,
                                            time_points=range(time_points), seed=seed)
        write_s = time.perf_counter() - t0
        ds = SEN12MSCRTS(root, cloud_masks=E2E_MASKS, n_input_samples=cfg.input_t,
                         time_points=range(time_points), raw_s2=True, device=dev)
        loader = BatchLoader(ds, batch_size=batch_size, collate=collate, use_sar=True,
                             num_workers=num_workers, drop_last=True)

        def to_device(b):
            return batch_to_device({k: b[k] for k in keys}, dev)

        first = collate([ds[i] for i in range(batch_size)], use_sar=True)
        step(model, to_device(first))["loss"].item()  # warm-up
        flops = count_flops(lambda: step(model, to_device(first)))

        t0 = time.perf_counter()
        n_host = sum(1 for _ in loader) * batch_size
        host_rate = n_host / (time.perf_counter() - t0)

        before = launch_counts()
        reset_peak(dev)
        seconds, metrics, n_steps = [], [], 0
        for _ in range(windows):
            t0 = time.perf_counter()
            for b in loader:
                aux = step(model, to_device(b))
                metrics.append(aux["metrics"])
                n_steps += 1
            aux["loss"].item()
            seconds.append(time.perf_counter() - t0)
        counts = launches_since(before)
    per_epoch = n_steps // windows
    want = {k: n * n_steps for k, n in expected_launches("eval", dev).items()}
    vals = torch.stack([torch.stack(list(m.values())) for m in metrics])
    checks = {"metrics_finite_ok": finite(vals), "launches_ok": counts == want}
    fields = rate_fields(seconds, per_epoch * batch_size, per_epoch)
    fields.update(peak_gib(dev))
    h2d_bytes = sum(v.nbytes for k, v in first.items() if k in keys) / batch_size
    fields.update({"host_pipeline_only_seq_per_sec": host_rate, "includes_image_metrics": True,
                   "radiometry": "host_lut" if host_radiometry else "device_raw_dn",
                   "source": "tiff_tree", "patches": n_patches, "time_points": time_points,
                   "tree_mb": tree_bytes / 1e6, "tree_write_s": write_s,
                   "num_workers": num_workers, "h2d_mb_per_seq": h2d_bytes / 1e6,
                   "launches": counts})
    if dev.type == "cuda":
        fields.update(utilization(flops, fields["step_ms_p50"] / 1e3, info))
        # a fresh 64 MB host array copied as batch_to_device copies a batch
        fresh = torch.from_numpy(np.random.default_rng(seed + 1).integers(
            0, 65535, (32 << 20) // 2, dtype=np.uint16))
        t0 = time.perf_counter()
        fresh.to(dev)
        sync(dev)
        h2d_rate = fresh.numel() * 2 / (time.perf_counter() - t0)
        h2d_bound = h2d_rate / h2d_bytes
        fields.update({"h2d_fresh_mb_per_sec": h2d_rate / 1e6,
                       "h2d_bandwidth_bound_seq_per_sec": h2d_bound,
                       # the bus, not the loader, the tighter of the two host stages
                       "transfer_bound": bool(h2d_bound < host_rate)})
    return line("e2e", info, seed, batch_size, fields, checks, V100_REFERENCE_SEQ_PER_SEC)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--train", action="store_true", help="the train step instead of eval")
    mode.add_argument("--scene", action="store_true",
                      help="whole-scene serving (infer.predict_scene)")
    mode.add_argument("--e2e", action="store_true",
                      help="a GeoTIFF tree through the loader and the eval step")
    ap.add_argument("--host_radiometry", action="store_true",
                    help="e2e: the host's single-pass collate (a lookup table) instead of "
                         "raw DN with the radiometry on the device")
    ap.add_argument("--batch", type=int, default=None,
                    help="the batch (default: 4; the scene's 8)")
    ap.add_argument("--seed", type=int, default=0, help="weights, batch and scene")
    args = ap.parse_args(argv)
    name = "train" if args.train else "scene" if args.scene else "e2e" if args.e2e else "eval"
    if args.host_radiometry and name != "e2e":
        ap.error("--host_radiometry is an arm of --e2e")
    kw = {"seed": args.seed}
    if args.batch:
        kw["batch_size"] = args.batch
    if args.host_radiometry:
        kw["host_radiometry"] = True
    out = {"eval": run_eval, "train": run_train, "scene": run_scene, "e2e": run_e2e}[name](**kw)
    print(json.dumps(out))
    return 0 if out["correct"] else 1


if __name__ == "__main__":
    sys.exit(main())
