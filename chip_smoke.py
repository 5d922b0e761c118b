"""Drive the PyTorch port's serving path on one NVIDIA GPU and check it.

    python3 chip_smoke.py          (from the root of a checkout, one card)

Phase 1 builds the hand-written CUDA kernels of ``uncrtaints_tpu_torch``
from ``csrc/`` and holds each against its plain PyTorch version on the card,
at the shapes the serving path gives it and at a ragged shape, and times
both (CUDA events, median of 25 runs).
Phase 2 runs the port's eval step (forward, MGNLL, scale_by rescale, image
metrics) of the paper recipe in bf16 on 3 synthetic batches of B=4, T=3,
256x256 with seeded random weights, and checks that every forward went
through the kernels (1 K1 and 10 K3 launches) and that the outputs are
finite.
Phase 3 compares the fused eval path with the standard one on the card,
and the card with the CPU (the kernels' plain versions) on a small input.

Any failed check raises. The last line of stdout is the JSON result; the
line before it lists the kernels. Without a CUDA device the script exits
with an error and prints no result.
"""

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
TIMING_RUNS = 25
# the serving path's shapes: the paper batch, and K1/K3 as it calls them
B, T, PATCH = 4, 3, 256
K1_SHAPES = [(B, T, PATCH, PATCH, 128, 16), (2, 3, 7, 9, 20, 4)]  # + ragged
K3_CASES = {  # name: (N, P, C, C2, groups, se, stats, do_gelu)
    "pw1 [4,65536,128]->256": (B, PATCH * PATCH, 128, 256, 1, False, False, False),
    "pw2 [4,65536,256]->128": (B, PATCH * PATCH, 256, 128, 1, True, False, True),
    "stats [4,65536,128]->256 G=4": (B, PATCH * PATCH, 128, 256, 4, False, True, True),
    "ragged [3,384,96]->80 G=4": (3, 384, 96, 80, 4, True, True, True),
}


def check(ok, msg):
    if not ok:
        raise RuntimeError(f"check failed: {msg}")


def time_ms(fn, runs=TIMING_RUNS, warmup=3):
    """Median device time of ``fn`` in ms (CUDA events around each run)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase1_kernels(dev):
    from uncrtaints_tpu_torch import _build
    from uncrtaints_tpu_torch.ops import aggregate, mbconv

    t0 = time.perf_counter()
    _build.lib()
    print(f"phase 1: kernels built from {_build._CSRC} in "
          f"{time.perf_counter() - t0:.1f} s")
    g = torch.Generator(device=dev).manual_seed(SEED)
    randn = lambda *s: torch.randn(*s, generator=g, device=dev)
    out = {}

    # ---- K1: main path [4,3,256,256,128] heads 16, and a ragged shape
    k1_err, k1_ms = 0.0, {}
    for shape in K1_SHAPES:
        B, T, H, W, C, heads = shape
        for dtype in (torch.bfloat16, torch.float32):
            x = randn(B, T, H, W, C).to(dtype)
            a = torch.softmax(randn(B, T, H, W, heads), dim=1).to(dtype)
            got = aggregate.att_group_aggregate(x, a)
            torch.cuda.synchronize()
            ref = aggregate.att_group_aggregate_plain(x, a)
            err = float((got.float() - ref.float()).abs().max())
            top = max(1.0, float(ref.float().abs().max()))
            # fp32: the same fp32 products summed in the same order; bf16:
            # the final rounding may differ by one ulp at the top of range
            tol = (1e-5 if dtype == torch.float32 else 2 ** -7) * top
            line = (f"K1 att_group_aggregate {str(dtype)[6:]} {list(shape[:5])} "
                    f"heads={heads}: max_abs_err={err:.3g} (tol {tol:.3g})")
            if shape == K1_SHAPES[0]:
                kms = time_ms(lambda: aggregate.att_group_aggregate(x, a))
                pms = time_ms(lambda: aggregate.att_group_aggregate_plain(x, a))
                k1_ms[dtype] = (kms, pms)
                line += f", kernel {kms:.4f} ms, plain {pms:.4f} ms"
            print(line)
            check(err <= tol, f"K1 {dtype} {shape} disagrees with its plain version")
            k1_err = max(k1_err, err)
    out["att_group_aggregate"] = (k1_err, *k1_ms[torch.bfloat16])

    # ---- K3: the two decoder GEMMs of the fused MBConv (N=4 frames of
    # 256x256), a statistics case, and a ragged shape
    def k3_case(N, P, C, C2, G, se, stats, do_gelu):
        x = randn(N, P, C).bfloat16()
        w = (randn(C, C2) * 0.05).bfloat16()
        if G == 1:
            mean, coef = torch.zeros(N, 1, device=dev), torch.ones(N, 1, device=dev)
        else:
            xg = x.float().view(N, P, G, C // G)
            mean = xg.mean(dim=(1, 3))
            coef = torch.rsqrt(xg.var(dim=(1, 3), correction=0) + 1e-5)
        args = (x, mean, coef, randn(C), randn(C), w)
        kw = dict(se=torch.sigmoid(randn(N, C)) if se else None, groups_in=G,
                  groups_out=G if stats else 4, do_gelu=do_gelu,
                  out_affine=(randn(C2), randn(C2)), out_gelu=not se,
                  do_stats=stats)
        return args, kw

    k3_err, k3_ms, k3_pms = 0.0, 0.0, 0.0
    for name, case in K3_CASES.items():
        args, kw = k3_case(*case)
        got = mbconv.norm_gelu_matmul(*args, **kw)
        torch.cuda.synchronize()
        ref = mbconv.norm_gelu_matmul_plain(*args, **kw)
        err = float((got[0].float() - ref[0].float()).abs().max())
        # bf16 output: at most one ulp at the top of its range (the fp32 GEMM
        # sums in another order, then both round once)
        tol = 2 ** -7 * float(ref[0].float().abs().max())
        line = f"K3 norm_gelu_matmul {name}: max_abs_err={err:.3g} (tol {tol:.3g})"
        bad = err > tol
        if kw["do_stats"]:
            N, P, C2, G = got[0].shape[0], got[0].shape[1], got[0].shape[2], kw["groups_out"]
            og = ref[0].float().view(N, P, G, C2 // G)
            abs_sum = og.abs().sum(dim=(1, 3))
            e1 = float(((got[1] - ref[1]).abs() / abs_sum).max())
            e2 = float(((got[2] - ref[2]).abs() / ref[2]).max())
            # fp32 sums of up to 4M terms in another order: 1e-4 relative
            line += f", stats rel_err sum={e1:.3g} sumsq={e2:.3g} (tol 1e-4)"
            bad = bad or e1 > 1e-4 or e2 > 1e-4
        if name.startswith("pw"):
            kms = time_ms(lambda: mbconv.norm_gelu_matmul(*args, **kw))
            pms = time_ms(lambda: mbconv.norm_gelu_matmul_plain(*args, **kw))
            k3_ms, k3_pms = k3_ms + kms, k3_pms + pms
            line += f", kernel {kms:.4f} ms, plain {pms:.4f} ms"
        print(line)
        check(not bad, f"K3 {name} disagrees with its plain version")
        k3_err = max(k3_err, err)
    out["norm_gelu_matmul"] = (k3_err, k3_ms, k3_pms)
    return out


def seeded_model(cfg, dev):
    """Seeded weights, and batch-norm running statistics drawn from the same
    generator (so the folded affines are not the identity)."""
    from uncrtaints_tpu_torch.models import get_generator
    from uncrtaints_tpu_torch.models.layers import Norm2d
    gen = torch.Generator().manual_seed(SEED)
    model = get_generator(cfg, device=dev, generator=gen)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, Norm2d) and m.norm == "batch":
                C = m.running_mean.numel()
                m.running_mean.copy_(0.3 * torch.randn(C, generator=gen))
                m.running_var.copy_(0.5 + 0.3 * torch.randn(C, generator=gen).abs())
    return model


def finite(t):
    return bool(torch.isfinite(t).all())


def phase2_slice(dev):
    from uncrtaints_tpu_torch.config import Config, derive
    from uncrtaints_tpu_torch.data import SyntheticSEN12MSCRTS, collate_multi
    from uncrtaints_tpu_torch.ops import aggregate, mbconv
    from uncrtaints_tpu_torch.train import batch_to_device, make_eval_step

    cfg = derive(Config(use_sar=True, scale_by=10.0))  # the paper recipe
    check(cfg.compute_dtype == "bfloat16", "paper recipe computes in bf16")
    P = PATCH
    ds = SyntheticSEN12MSCRTS(n_samples=3 * B, n_input_t=T, patch_size=P, seed=SEED + 1)
    batches = [batch_to_device(collate_multi([ds[i * B + j] for j in range(B)],
                                             use_sar=True), dev) for i in range(3)]
    model = seeded_model(cfg, dev)
    n_params = sum(p.numel() for p in model.parameters())
    step = make_eval_step(cfg, with_metrics=True)
    step(model, batches[0])  # warm-up (cuDNN plans, allocator)
    torch.cuda.synchronize()

    aggregate.att_group_aggregate.launches = 0
    mbconv.norm_gelu_matmul.launches = 0
    times, results = [], []
    for _ in range(2):
        for b in batches:
            t0 = time.perf_counter()
            aux = step(model, b)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            results.append(aux)
    k1, k3 = aggregate.att_group_aggregate.launches, mbconv.norm_gelu_matmul.launches
    n_fwd = len(times)
    print(f"phase 2: paper recipe (bf16, {n_params} parameters), {n_fwd} eval "
          f"steps of B={B}, T={T}, {P}x{P}: K1 launches {k1}, K3 launches {k3}")
    check(k1 == n_fwd, f"K1 launched {k1} times in {n_fwd} forwards (1 each expected)")
    check(k3 == 10 * n_fwd, f"K3 launched {k3} times in {n_fwd} forwards (10 each expected)")
    for i, aux in enumerate(results[:3]):
        check(finite(aux["loss"]), f"batch {i}: loss not finite")
        for k in ("pred", "var"):
            check(tuple(aux[k].shape) == (B, 1, P, P, 13), f"{k} shape {tuple(aux[k].shape)}")
            check(finite(aux[k]), f"batch {i}: {k} not finite")
        check(len(aux["metrics"]) == 9, "nine image metrics")
        for k, v in aux["metrics"].items():
            check(tuple(v.shape) == (B,) and finite(v), f"batch {i}: metric {k}")
        mets = {k: round(float(v.mean()), 6) for k, v in aux["metrics"].items()}
        print(f"  batch {i}: loss {float(aux['loss']):.6f}, metrics (batch mean) {mets}")
    ms = statistics.median(times)
    print(f"  eval step: {ms:.3f} ms median of {n_fwd} (min {min(times):.3f}, "
          f"max {max(times):.3f}), {B / ms * 1e3:.2f} sequences/s")
    return cfg, model, batches, k1, k3


def phase3_references(dev, cfg, model, batch):
    from uncrtaints_tpu_torch.models import get_generator
    from uncrtaints_tpu_torch.ops import mbconv
    from uncrtaints_tpu_torch.train import make_eval_step

    step = make_eval_step(cfg)
    fused = step(model, batch)
    off = get_generator(cfg.replace(fused_eval="off"), device=dev)
    off.load_state_dict(model.state_dict())
    n = mbconv.norm_gelu_matmul.launches
    std = step(off, batch)
    check(mbconv.norm_gelu_matmul.launches == n, "fused_eval=off launched K3")
    for k in ("pred", "var"):
        y, d = std[k], (fused[k] - std[k]).abs()
        top = float(y.abs().max())
        mx, rmse = float(d.max()), float(d.square().mean().sqrt())
        print(f"phase 3: fused vs standard eval on the card, {k}: max {mx:.4g} "
              f"(<= {0.02 * top:.4g}), RMSE {rmse:.4g} (<= {5e-3 * top:.4g})")
        check(mx <= 0.02 * top and rmse <= 5e-3 * top, f"fused/standard gap in {k}")

    # the card (kernels) against the CPU (their plain versions), fp32
    # compute, fused eval on both, widths 128 so the fused body runs; both
    # batch forms, the raw one with uint16 DN codes converted on the card
    from uncrtaints_tpu_torch.config import Config, derive
    from uncrtaints_tpu_torch.data import SyntheticSEN12MSCRTS, collate_multi
    from uncrtaints_tpu_torch.train import batch_to_device
    small = derive(Config(use_sar=True, scale_by=10.0, decoder_widths=[128, 128],
                          low_res_size=8, compute_dtype="float32", fused_eval="on"))
    ds = SyntheticSEN12MSCRTS(n_samples=2, n_input_t=3, patch_size=32, seed=SEED + 2)
    nb = collate_multi([ds[0], ds[1]], use_sar=True)
    rng = np.random.default_rng(SEED + 3)
    raw = {"x_s1": nb["x"][..., :2].astype(np.float32), "dates": nb["dates"],
           # DN codes past the 10000 clip, so the radiometry clips
           "x_s2dn": rng.integers(0, 12000, nb["x"].shape[:-1] + (13,)).astype(np.uint16),
           "y_dn": rng.integers(0, 12000, nb["y"].shape).astype(np.uint16)}
    gpu_model = seeded_model(small, dev)
    cpu_model = seeded_model(small, torch.device("cpu"))
    sstep = make_eval_step(small)
    for form, b in (("processed", nb), ("raw-DN", raw)):
        g = sstep(gpu_model, batch_to_device(b, dev))
        c = sstep(cpu_model, batch_to_device(b, "cpu"))
        for k in ("pred", "var"):
            d = g[k].cpu() - c[k]
            rmse = float(d.square().mean().sqrt())
            print(f"phase 3: card vs CPU, fp32, {form} 2x3x32x32, {k}: RMSE "
                  f"{rmse:.4g} (<= 1e-3)")
            check(rmse <= 1e-3, f"card/CPU gap in {k} ({form})")
        rel = abs(float(g["loss"]) / float(c["loss"]) - 1)
        print(f"phase 3: card vs CPU, {form}, loss rel {rel:.3g} (<= 1e-3)")
        check(rel <= 1e-3, f"card/CPU loss gap ({form})")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 1
    import uncrtaints_tpu_torch  # noqa: F401  (fails outside a checkout)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}")
    dev = torch.device("cuda", 0)

    kern = phase1_kernels(dev)
    cfg, model, batches, k1, k3 = phase2_slice(dev)
    phase3_references(dev, cfg, model, batches[0])

    meta = {
        "att_group_aggregate": ("uncrtaints_tpu_torch/csrc/aggregate.cu",
                                "uncrtaints_tpu/ops/pallas_aggregate.py:268", k1),
        "norm_gelu_matmul": ("uncrtaints_tpu_torch/csrc/norm_gelu_matmul.cu",
                             "uncrtaints_tpu/ops/pallas_mbconv.py:136", k3),
    }
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": n, "max_abs_err": kern[name][0], "ms": kern[name][1],
         "plain_ms": kern[name][2]}
        for name, (src, rep, n) in meta.items()]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
