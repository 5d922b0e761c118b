"""Drive the PyTorch port's serving and training paths on one NVIDIA GPU
and check them.

    python3 chip_smoke.py          (from the root of a checkout, one card)

Phase 1 builds the hand-written CUDA kernels of ``uncrtaints_tpu_torch``
from ``csrc/`` (one nvcc per source, in parallel) and holds each against its
plain PyTorch version on the card, at the shapes the two paths give it and
at a ragged shape, and times both (CUDA events, median of 25 runs); the
depthwise stencil K5 is also timed against cuDNN's depthwise convolution.
Phase 2 runs the port's eval step (forward, MGNLL, scale_by rescale, image
metrics) of the paper recipe in bf16 on 3 synthetic batches of B=4, T=3,
256x256 with seeded random weights, and checks that every forward went
through the kernels (1 K1 and 10 K3 launches, no backward kernel) and that
the outputs are finite.
Phase 3 compares the fused eval path with the standard one on the card,
and the card with the CPU (the kernels' plain versions) on a small input.
Phase 4 runs the port's train step (forward, MGNLL, backward, Adam, the
rescale) of the paper recipe in bf16: 6 steps of B=4, T=3, 256x256 over the
3 batches with an explicit dropout generator. It checks the launches per
step (K1 1, K1-bwd 1, K5 12, K2 6), finite losses, a finite non-zero
gradient for every parameter on the first step, and that the parameters
moved; it prints the step time and the peak device memory.
Phase 5 compares one fp32 train step on the card with the same step on
the CPU on a small input.

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
TRAIN_STEPS = 6
# the paths' shapes: the paper batch, and the kernels as the paths call them
B, T, PATCH = 4, 3, 256
K1_SHAPES = [(B, T, PATCH, PATCH, 128, 16), (2, 3, 7, 9, 20, 4)]  # + ragged
HIDDEN = 256  # the MBConv depthwise width (expansion 2 of 128)
# K5 and K2 on the train path: the encoder's depthwise conv over B*T frames
# and the decoder's over B maps, on the reflect-padded 258x258 input (VALID);
# the input gradient is K5 on the 256x256 output gradient with pads 2 (FULL)
DW_CASES = {  # name: (N, H, W, C, (kh, kw), pads, dtype)
    "fwd enc [12,258,258,256]": (B * T, PATCH + 2, PATCH + 2, HIDDEN, (3, 3), ((0, 0), (0, 0)),
                                 torch.bfloat16),
    "fwd dec [4,258,258,256]": (B, PATCH + 2, PATCH + 2, HIDDEN, (3, 3), ((0, 0), (0, 0)),
                                torch.bfloat16),
    "gx enc [12,256,256,256] pads 2": (B * T, PATCH, PATCH, HIDDEN, (3, 3), ((2, 2), (2, 2)),
                                       torch.bfloat16),
    "gx dec [4,256,256,256] pads 2": (B, PATCH, PATCH, HIDDEN, (3, 3), ((2, 2), (2, 2)),
                                      torch.bfloat16),
    "ragged [3,37,70,20] 3x1 fp32": (3, 37, 70, 20, (3, 1), ((1, 1), (0, 0)), torch.float32),
}
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
    from uncrtaints_tpu_torch.ops import aggregate, dwconv, dwgrad, mbconv

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

    # ---- K1-bwd: the aggregator's backward at the main path shape, ragged
    kb_err = 0.0
    for shape in K1_SHAPES:
        B_, T_, H, W, C, heads = shape
        for dtype in (torch.bfloat16, torch.float32):
            x = randn(B_, T_, H, W, C).to(dtype)
            a = torch.softmax(randn(B_, T_, H, W, heads), dim=1).to(dtype)
            gy = randn(B_, H, W, C).to(dtype)
            dx, da = aggregate.att_group_aggregate_bwd(x, a, gy)
            torch.cuda.synchronize()
            rdx, rda = aggregate.att_group_aggregate_bwd_plain(x, a, gy)
            err = max(float((dx.float() - rdx.float()).abs().max()),
                      float((da.float() - rda.float()).abs().max()))
            top = max(float(rdx.float().abs().max()), float(rda.float().abs().max()))
            # bf16: one ulp of the largest output (dattn's head sum runs in
            # another order before its one rounding); fp32: 1e-6 of it
            tol = (1e-6 if dtype == torch.float32 else 2 ** -7) * top
            line = (f"K1-bwd att_group_aggregate_bwd {str(dtype)[6:]} {list(shape[:5])} "
                    f"heads={heads}: max_abs_err={err:.3g} (tol {tol:.3g})")
            if shape == K1_SHAPES[0] and dtype == torch.bfloat16:
                kms = time_ms(lambda: aggregate.att_group_aggregate_bwd(x, a, gy))
                pms = time_ms(lambda: aggregate.att_group_aggregate_bwd_plain(x, a, gy))
                kb_ms = (kms, pms)
                line += f", kernel {kms:.4f} ms, plain {pms:.4f} ms"
            print(line)
            check(err <= tol, f"K1-bwd {dtype} {shape} disagrees with its plain version")
            kb_err = max(kb_err, err)
    out["att_group_aggregate_bwd"] = (kb_err, *kb_ms)

    # ---- K5 (forward and input-gradient shapes) and K2 (weight gradient)
    k5_err, k2_err = 0.0, 0.0
    for name, (N, H, W, C, (kh, kw), pads, dtype) in DW_CASES.items():
        x = randn(N, H, W, C).to(dtype)
        w = (randn(C, 1, kh, kw) * 0.3).to(dtype)
        got = dwconv.dw_stencil(x, w, pads)
        torch.cuda.synchronize()
        ref = dwconv.dw_stencil_plain(x, w, pads)
        err = float((got.float() - ref.float()).abs().max())
        # one bf16 ulp of the largest output (the kernel keeps the plain
        # version's fp32 roundings; fp32: 1e-6 of it)
        tol = (1e-6 if dtype == torch.float32 else 2 ** -7) * float(ref.float().abs().max())
        line = f"K5 dw_stencil {name}: max_abs_err={err:.3g} (tol {tol:.3g})"
        if dtype == torch.bfloat16:
            # cuDNN's depthwise conv on the NCHW view of the NHWC memory
            # (channels_last), symmetric zero pads
            xc, pad = x.permute(0, 3, 1, 2), pads[0][0]
            kms = time_ms(lambda: dwconv.dw_stencil(x, w, pads))
            pms = time_ms(lambda: dwconv.dw_stencil_plain(x, w, pads))
            cms = time_ms(lambda: torch.nn.functional.conv2d(xc, w, padding=pad, groups=C))
            line += f", kernel {kms:.4f} ms, plain {pms:.4f} ms, cuDNN {cms:.4f} ms"
            if name.startswith("fwd enc"):
                out["dw_stencil"] = [0.0, kms, pms]
        print(line)
        check(err <= tol, f"K5 {name} disagrees with its plain version")
        k5_err = max(k5_err, err)
        if name.startswith("gx"):
            continue  # K2 pairs the primal input with the output gradient
        Ho, Wo = dwconv.out_hw(H, W, kh, kw, pads)
        gy = randn(N, Ho, Wo, C).to(dtype)
        gw = dwgrad.dw_kernel_grad(x, gy, pads, kh, kw)
        torch.cuda.synchronize()
        ref = dwgrad.dw_kernel_grad_plain(x, gy, pads, kh, kw)
        scale = dwgrad.dw_kernel_grad_plain(x.abs(), gy.abs(), pads, kh, kw)
        rel = float(((gw - ref).abs() / scale).max())
        err = float((gw - ref).abs().max())
        again = dwgrad.dw_kernel_grad(x, gy, pads, kh, kw)
        # fp32 sums of N*Ho*Wo products in another order: 1e-4 of sum |x*g|
        line = (f"K2 dw_kernel_grad {name.replace('fwd ', '')}: max_abs_err={err:.3g}, "
                f"rel to sum|x*g| {rel:.3g} (tol 1e-4), deterministic "
                f"{bool(torch.equal(gw, again))}")
        if dtype == torch.bfloat16:
            kms = time_ms(lambda: dwgrad.dw_kernel_grad(x, gy, pads, kh, kw))
            pms = time_ms(lambda: dwgrad.dw_kernel_grad_plain(x, gy, pads, kh, kw))
            line += f", kernel {kms:.4f} ms, plain {pms:.4f} ms"
            if name.startswith("fwd enc"):
                out["dw_kernel_grad"] = [0.0, kms, pms]
        print(line)
        check(rel <= 1e-4, f"K2 {name} disagrees with its plain version")
        check(torch.equal(gw, again), f"K2 {name} is not deterministic")
        k2_err = max(k2_err, err)
    out["dw_stencil"][0], out["dw_kernel_grad"][0] = k5_err, k2_err
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
    from uncrtaints_tpu_torch.ops import aggregate, dwconv, dwgrad, mbconv
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

    train_kernels = (aggregate.att_group_aggregate_bwd, dwconv.dw_stencil,
                     dwgrad.dw_kernel_grad)
    for f in (aggregate.att_group_aggregate, mbconv.norm_gelu_matmul, *train_kernels):
        f.launches = 0
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
    check(all(f.launches == 0 for f in train_kernels),
          "the eval step launched a backward or train-only kernel (K1-bwd, K5, K2)")
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


def phase4_train(dev, batches):
    from uncrtaints_tpu_torch.config import Config, derive
    from uncrtaints_tpu_torch.ops import aggregate, dwconv, dwgrad, mbconv
    from uncrtaints_tpu_torch.train import create_train_state, make_train_step

    cfg = derive(Config(use_sar=True, scale_by=10.0))  # the paper recipe, bf16
    model = seeded_model(cfg, dev)
    state = create_train_state(cfg, model)
    step = make_train_step(cfg)
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    step(state, batches[0], gen)  # warm-up (cuDNN plans, allocator)
    torch.cuda.synchronize()
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    kernels = {"K1": aggregate.att_group_aggregate, "K1-bwd": aggregate.att_group_aggregate_bwd,
               "K5": dwconv.dw_stencil, "K2": dwgrad.dw_kernel_grad,
               "K3": mbconv.norm_gelu_matmul}
    torch.cuda.reset_peak_memory_stats(dev)
    for f in kernels.values():
        f.launches = 0
    times, losses, first_grads = [], [], None
    for i in range(TRAIN_STEPS):
        b = batches[i % len(batches)]
        t0 = time.perf_counter()
        state, aux = step(state, b, gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(aux["loss"]))
        if first_grads is None:
            first_grads = {n: (bool(torch.isfinite(g).all()), float(g.abs().max()))
                           for n, g in aux["grads"].items()}
    counts = {k: f.launches for k, f in kernels.items()}
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"phase 4: paper recipe train step (bf16, Adam lr {cfg.lr}), {TRAIN_STEPS} steps of "
          f"B={B}, T={T}, {PATCH}x{PATCH}: launches {counts}")
    per_step = {"K1": 1, "K1-bwd": 1, "K5": 12, "K2": 6, "K3": 0}
    for k, n in per_step.items():
        check(counts[k] == n * TRAIN_STEPS,
              f"{k} launched {counts[k]} times in {TRAIN_STEPS} train steps ({n} each expected)")
    print(f"  losses {[round(v, 4) for v in losses]}")
    check(all(np.isfinite(v) for v in losses), "a train loss is not finite")
    bad = [n for n, (fin, mx) in first_grads.items() if not (fin and mx > 0)]
    print(f"  step 1: {len(first_grads)} parameter gradients, {len(bad)} zero or not finite; "
          f"smallest max|g| {min(mx for _, mx in first_grads.values()):.3g} "
          f"({min(first_grads, key=lambda n: first_grads[n][1])})")
    check(not bad, f"parameters without a finite non-zero gradient on step 1: {bad[:8]}")
    for key in ("in_conv.conv.conv.0.weight", "in_block.0.conv.fn.3.weight",
                "temporal_encoder.attention_heads.fc1_k.weight"):
        check(first_grads[key][1] > 0, f"no gradient reached {key}")
    moved = [n for n, p in model.named_parameters() if not torch.equal(p, before[n])]
    check(len(moved) == len(before), f"parameters that did not move: "
          f"{sorted(set(before) - set(moved))[:8]}")
    ms = statistics.median(times)
    print(f"  train step: {ms:.3f} ms median of {TRAIN_STEPS} (min {min(times):.3f}, "
          f"max {max(times):.3f}), {B / ms * 1e3:.2f} sequences/s, peak device memory "
          f"{peak / 2**30:.2f} GiB ({peak} bytes)")
    return counts


def phase5_train_reference(dev):
    """One fp32 train step of a small model on the card (the kernels) and
    on the CPU (their plain versions), from the same weights and batch."""
    from uncrtaints_tpu_torch.config import Config, derive
    from uncrtaints_tpu_torch.data import SyntheticSEN12MSCRTS, collate_multi
    from uncrtaints_tpu_torch.train import batch_to_device, create_train_state, make_train_step
    # patch = low_res_size: no attention upsample, so no dropout noise,
    # which the card's and the CPU's generators would draw differently
    small = derive(Config(use_sar=True, scale_by=10.0, encoder_widths=[32],
                          decoder_widths=[32, 32], n_head=4, d_model=64, low_res_size=32,
                          compute_dtype="float32", lr=1e-3))
    ds = SyntheticSEN12MSCRTS(n_samples=2, n_input_t=3, patch_size=32, seed=SEED + 5)
    nb = collate_multi([ds[0], ds[1]], use_sar=True)
    res = []
    for d in (dev, torch.device("cpu")):
        st = create_train_state(small, seeded_model(small, d))
        _, aux = make_train_step(small)(st, batch_to_device(nb, d))
        res.append((float(aux["loss"]), {n: g.cpu() for n, g in aux["grads"].items()}))
    (lg, gg), (lc, gc) = res
    rel = abs(lg / lc - 1)
    gmax = max(float(g.abs().max()) for g in gc.values())
    worst, worst_name = 0.0, ""
    for n, ref in gc.items():
        top = float(ref.abs().max())
        err = float((gg[n] - ref).abs().max())
        if top <= 1e-6 * gmax:
            # zero in exact arithmetic (a shift the next norm removes):
            # rounding noise on both sides
            check(float(gg[n].abs().max()) <= 1e-6 * gmax, f"card gradient of {n} not ~0")
            continue
        if err / top > worst:
            worst, worst_name = err / top, n
    print(f"phase 5: train step card vs CPU, fp32 2x3x32x32: loss rel {rel:.3g} (<= 1e-3), "
          f"worst gradient max abs / max|g| {worst:.3g} (<= 1e-3, {worst_name})")
    check(rel <= 1e-3, "card/CPU train loss gap")
    check(worst <= 1e-3, f"card/CPU gradient gap in {worst_name}")


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
    del model
    train = phase4_train(dev, batches)
    phase5_train_reference(dev)
    print(f"launches by path: eval K1 {k1}, K3 {k3}; train {train}")

    meta = {  # launches: the eval and train runs of phases 2 and 4
        "att_group_aggregate": ("uncrtaints_tpu_torch/csrc/aggregate.cu",
                                "uncrtaints_tpu/ops/pallas_aggregate.py:268", k1 + train["K1"]),
        "att_group_aggregate_bwd": ("uncrtaints_tpu_torch/csrc/aggregate.cu",
                                    "uncrtaints_tpu/ops/pallas_aggregate.py:164",
                                    train["K1-bwd"]),
        "norm_gelu_matmul": ("uncrtaints_tpu_torch/csrc/norm_gelu_matmul.cu",
                             "uncrtaints_tpu/ops/pallas_mbconv.py:136", k3),
        "dw_stencil": ("uncrtaints_tpu_torch/csrc/dwconv.cu",
                       "uncrtaints_tpu/ops/pallas_dwconv.py:92", train["K5"]),
        "dw_kernel_grad": ("uncrtaints_tpu_torch/csrc/dwgrad.cu",
                           "uncrtaints_tpu/ops/pallas_dwgrad.py:80", train["K2"]),
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
