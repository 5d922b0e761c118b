"""Drive the PyTorch port's serving, scene-inference and training paths, its
train / test command-line entry points, its real-data path, its baseline
model families, its deep-ensemble tool, its serving export, its data
parallel over NCCL, its trace and FLOP count and its native slab writers on
one NVIDIA GPU and check them.

    python3 chip_smoke.py          (from the root of a checkout, one card)

Phase 1 builds the six hand-written CUDA kernels of ``uncrtaints_tpu_torch``
from ``csrc/`` (one nvcc per source, in parallel) and holds each against its
plain PyTorch version on the card, at the shapes the paths give it (K1 and
K1-bwd also at U-TAE's three skip levels, [4,3,s,s,64] with 16 heads of 4
channels for s = 64, 128, 256) and at a ragged shape, and times both (CUDA events: a kernel or library call as the
median of 7 samples of 8 calls queued behind a 3 ms spin on the device, so
that the host's launch path is not in the number; a plain version as the
median of 15 single calls, 7 for the slow ones of K5, K2 and K4). K3 is
timed in the two forms the fused block calls (the first GEMM without an
epilogue) and must run its pipelined wgmma kernel at both decoder shapes
and its tiled WMMA kernel at the ragged one; K4 is held
in the form the fused block calls (no statistics, the pooled sum of the
squeeze-and-excitation mean) and with statistics, each twice for equal bits,
and the eager pass the pooled sum replaces is timed alone. Where one
library call or composition computes the same function it is timed beside
the kernel as a yardstick the port never calls: ``torch.einsum`` (K1, and two
of them for K1-bwd), cuDNN's depthwise convolution, input gradient and weight
gradient (K5 and K2; in reflect mode behind a reflect ``F.pad`` or before its
backward, the composition the port ran before the border was folded into the
kernels), the bare bf16 ``torch.matmul`` (K3), and gelu -> reflect pad ->
cuDNN depthwise conv (K4). Each kernel's
bound is the larger of its bytes over 3.35 TB/s and its operations over the
card's peak for their type; an exact GELU counts as the 20 fp32 operations
of its arithmetic and one special-function instruction. For K3 and K4 the
time the SMs need to dispatch the 32 instructions of the compiled GELU is
printed beside the bound and is no part of it.
Phase 2 runs the port's eval step (forward, MGNLL, scale_by rescale, image
metrics) of the paper recipe in bf16 on 3 synthetic batches of B=4, T=3,
256x256 with seeded random weights, and checks that every forward went
through the kernels (1 K1, 10 K3 and 5 K4 launches, no backward kernel) and
that the outputs are finite. One more step runs under ``torch.profiler``:
device time by kind, the idle share, the kernels by name (10 wgmma K3, 5 K4
and their 5 pooled-sum passes, no statistics pass), and the five fused
decoder blocks alone with recorded shapes, where no GELU, mean or sum over a
whole [B,256,256,C] map may run outside the kernels.
Phase 3 compares the fused eval path with the standard one on the card,
and the card with the CPU (the kernels' plain versions) on a small input,
for the paper recipe's architecture and for the residual + ``use_v`` +
``separate_out`` variant.
The scene phase runs ``predict_scene`` of the paper recipe on a synthetic
T=3, 1024x1024 scene (tile 256, overlap 64, batches of 4: 25 windows in 7
forwards), checks shapes, finiteness, a positive variance and the launches
(7 K1, 70 K3, 35 K4, no train kernel), holds a single-window scene against
the eval step and the tiled result against the standard (unfused) path,
and prints windows/s.
Phase 4 runs the port's train step (forward, MGNLL, backward, Adam, the
rescale) of the paper recipe in bf16: 4 steps of B=4, T=3, 256x256 over the
3 batches with an explicit dropout generator. It checks the launches per
step (K1 1, K1-bwd 1, K5 12, K2 6, no K3 or K4), finite losses, a finite non-zero
gradient for every parameter on the first step, and that the parameters
moved; it prints the step time and the peak device memory. One more step
runs under ``torch.profiler``: no ``reflection_pad`` kernel may appear (the
reflect border lives in K5 and K2), and the device time is printed by kind.
Phase 5 compares one fp32 train step on the card with the same step on
the CPU on a small input.
Phase 6 runs the entry points a user starts, in a temporary directory, at
the paper recipe's full width (bf16, B=4, T=3, 256x256, synthetic data, 8
samples a split, gamma 0.8): ``cli.train.main`` for one epoch, the same run
resumed to two epochs through ``apply_resume``, and ``cli.test.main`` twice.
It checks the files (conf.json, trainlog.json, the best and the per-epoch
checkpoints, the metrics files, the exported pred / target / covar arrays),
finite test metrics, that the two test runs equal each other and the train
run's final test to the bit, that the resumed epoch continued Adam's count
and the step and ran at the lr the schedule sets there, and that the
launches over the chain are exactly (train steps) x (1 K1 + 1 K1-bwd + 12 K5
+ 6 K2) + (eval forwards) x (1 K1 + 10 K3 + 5 K4). After the counters are
read it holds what only a card runs: a checkpoint saved from the card and
loaded into a fresh model gives the same eval step to the bit; the batches
the side-stream prefetch hands out equal the host's; a val epoch with the
prefetch equals one without it to the bit, and so does a one-step train
epoch (longer train epochs within 5e-3: the bilinear upsample's backward
sums with atomics, and the steps drift apart); and it prints the epochs'
sequences/s beside the bare steps' of phases 2 and 4, the host
synchronizations PyTorch reports in each epoch by the line that made them,
and the time of one ``save_checkpoint``.
Phase 7 runs the real-data path in a temporary directory: it writes a
SEN12MS-CR-TS tree with the port's TIFF writer (256x256 patches, 30 time
points, uint16 S2 and float32 S1 with bright blobs and dark patches, 4
patches in a train, a val and a test ROI, the test ROI deflate-compressed,
and the nine ROIs1868/73 patches of ``--use_custom``), masks the 30-frame
stack of one patch on the card and through the plain path on the CPU (at
most 1e-4 of the pixels may differ), runs ``cli.precompute`` on the train
split on the card and on the CPU (coverage within 1e-6), ``cli.train`` for
one epoch at the paper recipe's full width with those statistics and then
``cli.test`` (files, finite and bit-equal metrics, launches exactly 1 train
step and 3 eval forwards), the train and val epochs once more through the
loop with the host synchronizations by line (the step loop's must be the
one fetch of ``loop.py``; the masks' from the loader threads are printed
apart) beside the loader alone and the bare steps, ``cli.test
--use_custom`` on the 768x768 mosaic (1 K1 + 10 K3 + 5 K4), and
``cli.train`` with the default s2cloudless detector and no weights, which
must stop with its error.
Phase 8 runs U-TAE at its published widths (encoder [64,64,64,128], decoder
[32,32,64,128], 16 heads, d_model 256; the MSE loss ``derive`` sets) through
``cli.train`` (one epoch, 8 samples a split) and ``cli.test`` at B=4, T=3,
256x256, bf16 (files, no variance export, bit-equal test metrics, launches
exactly 3 K1 a forward and 3 K1 + 3 K1-bwd a train step and nothing else),
then its bare steps (launches per step, step times, peak memory, a finite
gradient for every parameter, non-zero but for those zero in exact
arithmetic, one train step under ``torch.profiler`` by kind) and the card
against the CPU at 32x32 (fp32: eval RMSE and one train step's loss). Every
other family (U-Net pretrain, UNet3D at T=4, the two recurrent U-Nets,
ConvLSTM, ConvGRU, FPN + ConvLSTM, at the JAX package's default widths and
the MSE loss) runs three eval forwards and train steps at 256x256 (finite
outputs and gradients, no kernel launch) and is held card against CPU at
32x32. Last, a second paper-recipe member is trained at another seed, both
members' test splits are exported by ``cli.test --export_every 1``, and
``cli.ensemble`` fuses them in its three modes: the fused mean and variance
must equal numpy's fusion of the exported files to 1e-6, the metrics be
finite.

Phases 6 and 7 also time the loader alone with the single-pass collate's
native slab writers and with the generic collate (``--no_fast_collate``),
in turns, and hold their batches byte-equal.
Phase 9 runs ``cli.train`` (one epoch, 8 samples a split) under
``torchrun`` with one NCCL rank a card (``--mesh_shape``; world 1 on one
card, where every all-reduce still runs) in the background; meanwhile it
exports the paper recipe with a symbolic batch (``export.py``) and runs the
same ``cli.train`` in this process with ``--trace_dir --profile``, where the
trace must name the six ``uncrtaints::`` operators and the FLOP count must
equal the one the forward gives, and the card's count the CPU's at 32x32.
Then it holds one exported call at B=4 against the live eval forward
(exactly 1 K1, 10 K3 and 5 K4 launches), times both, runs ``predict_scene``
through the artifact against the live model, holds the NCCL run's train
loss against this process's within 5e-3 and its test metrics against this
process's ``cli.test`` of its checkpoint within 1e-6, and prints the loader
rates of phases 6 and 7 with and without the native writers.
Phase 1 also holds the halo modes of K5 (forward and folded adjoint), K2
and K4 (a map that is one band of rows of a scene split over ranks, with
its neighbours' edge rows) at the paper shapes split into 2 and 4 bands:
each band against its plain version, the bands stitched against the
whole-tensor kernel (K5's forward and K4 bit-equal, the adjoint with the
halo gradients added back, K2's and K4's summed partials), and times each
halo mode at 2 bands beside the whole-mode kernel on the same rows, its
bound and the library composition (the halo rows, F.pad, cuDNN).
Phase 10 runs the 2-D data x spatial mesh: ``torchrun --nproc_per_node 2``
starts this script as two ranks of a 1 x 2 mesh (``--spatial-rank``; gloo,
since the two ranks share the card and NCCL refuses that), each holding one
band of 128 rows of the paper recipe's B=4, 256x256 batch. Their eval step
(loss, pred, var, metrics), one train step (loss, a finite non-zero
gradient for every parameter but those zero in exact arithmetic) and
``predict_scene(mesh=)`` on a 512x512 scene are held against this process,
and each rank's launches (1 K1 + 10 K3 + 5 K4 a forward, K4 in halo mode; 1
K1 + 1 K1-bwd + 12 K5 + 6 K2 a train step, K5 and K2 in halo mode), its
train-step peak memory and its collectives' host time are printed.
Meanwhile this process runs ``cli.train --ckpt_backend orbax`` (asynchronous
``.dcp`` checkpoints) for one epoch, resumed to two, and ``cli.test``, whose
metrics must equal to the bit a ``cli.test`` of the same weights written
as ``.pth.tar``; its train losses are held against phase 6's within 5e-3.
Any failed check raises. The last line of stdout is the JSON result; the
line before it lists the kernels. Without a CUDA device the script exits
with an error and prints no result.
"""

import collections
import contextlib
import importlib.util
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

SEED = 0
TIMING_RUNS = 15
SPIN_CYCLES = 5_000_000  # about 3 ms of the device's clock
TRAIN_STEPS = 4
# the paths' shapes: the paper batch, and the kernels as the paths call them
B, T, PATCH = 4, 3, 256
K1_SHAPES = [(B, T, PATCH, PATCH, 128, 16), (2, 3, 7, 9, 20, 4)]  # + ragged
# U-TAE's three skip levels at its published widths: 64 channels, 16 heads of
# 4 channels (the bf16 backward's scalar path), at 64^2, 128^2 and 256^2
UTAE_K1_SHAPES = [(B, T, s, s, 64, 16) for s in (64, 128, 256)]
HIDDEN = 256  # the MBConv depthwise width (expansion 2 of 128)
# K5 and K2 on the train path: the encoder's depthwise conv over B*T frames
# and the decoder's over B maps, in reflect mode on the unpadded 256x256 input
# (forward, weight gradient) and output gradient (the folded adjoint). The
# zero-pad cases are the same convs as the port ran them before, on a
# reflect-padded 258x258 copy (VALID) with the input gradient as K5 on the
# output gradient with pads 2 (FULL); they stay as the zero mode's check.
ONE, NONE, FULL = ((1, 1), (1, 1)), ((0, 0), (0, 0)), ((2, 2), (2, 2))
BF16, FP32 = torch.bfloat16, torch.float32
DW_CASES = {  # name: (N, H, W, C, (kh, kw), pads, mode, dtype); "adjoint" = K5's third rule
    "reflect enc [12,256,256,256]": (B * T, PATCH, PATCH, HIDDEN, (3, 3), ONE, "reflect", BF16),
    "reflect dec [4,256,256,256]": (B, PATCH, PATCH, HIDDEN, (3, 3), ONE, "reflect", BF16),
    "adjoint enc [12,256,256,256]": (B * T, PATCH, PATCH, HIDDEN, (3, 3), ONE, "adjoint", BF16),
    "adjoint dec [4,256,256,256]": (B, PATCH, PATCH, HIDDEN, (3, 3), ONE, "adjoint", BF16),
    "reflect fp32 [2,64,64,128]": (2, 64, 64, 128, (3, 3), ONE, "reflect", FP32),
    "adjoint fp32 [2,64,64,128]": (2, 64, 64, 128, (3, 3), ONE, "adjoint", FP32),
    # odd H and W, H of 3 (row 1 takes both folds), C % 8 != 0: the direct kernel
    "reflect ragged [3,3,37,20]": (3, 3, 37, 20, (3, 3), ONE, "reflect", BF16),
    "adjoint ragged [3,3,37,20]": (3, 3, 37, 20, (3, 3), ONE, "adjoint", BF16),
    # W of 2 (every column reflects), a ragged channel tile: the tiled kernel
    "reflect ragged [2,35,2,72]": (2, 35, 2, 72, (3, 3), ONE, "reflect", BF16),
    "adjoint ragged [2,35,2,72]": (2, 35, 2, 72, (3, 3), ONE, "adjoint", BF16),
    "zeros fwd enc [12,258,258,256]": (B * T, PATCH + 2, PATCH + 2, HIDDEN, (3, 3), NONE, "zeros",
                                       BF16),
    "zeros fwd dec [4,258,258,256]": (B, PATCH + 2, PATCH + 2, HIDDEN, (3, 3), NONE, "zeros",
                                      BF16),
    "zeros gx enc [12,256,256,256] pads 2": (B * T, PATCH, PATCH, HIDDEN, (3, 3), FULL, "zeros",
                                             BF16),
    "zeros gx dec [4,256,256,256] pads 2": (B, PATCH, PATCH, HIDDEN, (3, 3), FULL, "zeros", BF16),
    "zeros ragged [3,37,70,20] 3x1 fp32": (3, 37, 70, 20, (3, 1), ((1, 1), (0, 0)), "zeros", FP32),
}
K4_CASES = {  # name: (N, H, W, C, groups, dtype, stats, pool); groups 1 = the batch-norm form
    # the form the fused block calls: no statistics, the pooled sum
    "path [4,256,256,256] G=1": (B, PATCH, PATCH, HIDDEN, 1, torch.bfloat16, False, True),
    "path, neither [4,256,256,256] G=1": (B, PATCH, PATCH, HIDDEN, 1, torch.bfloat16, False,
                                          False),
    "group [4,256,256,256] G=4": (B, PATCH, PATCH, HIDDEN, 4, torch.bfloat16, True, False),
    "group, both [4,256,256,256] G=4": (B, PATCH, PATCH, HIDDEN, 4, torch.bfloat16, True, True),
    "fp32 [2,64,64,128] G=4": (2, 64, 64, 128, 4, torch.float32, True, True),
    "ragged [3,37,70,24] G=3": (3, 37, 70, 24, 3, torch.bfloat16, True, True),
}
# The arithmetic an exact GELU 0.5 x (1 + erf(x / sqrt 2)) needs in fp32: a
# multiply for the argument and one for its square, a polynomial of 7 fused
# multiply-adds (2 operations each), the tail's 1 - 2^p, and 0.5 x, 1 + erf
# and their product: 2 + 14 + 1 + 3 = 20 operations, and one exponential on
# the special-function unit. Selects, compares and moves are not operations.
GELU_OPS, GELU_SFU = 20, 1
# What the compiled GELU costs the SM's instruction dispatch: 32 instructions
# (tools/tune_mbconv_h100.py lists them from the SASS) at one a lane a clock,
# half the fused multiply-add operation rate. Printed only; no bound uses it.
GELU_SLOTS = 32
# the card's published peaks (H100 SXM): device memory, dense bf16 tensor
# cores, fp32 outside the tensor cores; the special-function unit has 16
# lanes an SM to the 128 of fp32, each one result a clock
PEAK_BYTES, PEAK_BF16, PEAK_FP32 = 3.35e12, 989e12, 67e12
PEAK_SFU = PEAK_FP32 / 2 / 8
K3_CASES = {  # name: (N, P, C, C2, groups, se, stats, do_gelu, epilogue)
    # the two GEMMs as the fused block calls them: the first without an
    # epilogue, the second with the SE gate and the folded batch norm after it
    "pw1 [4,65536,128]->256": (B, PATCH * PATCH, 128, 256, 1, False, False, False, False),
    "pw2 [4,65536,256]->128": (B, PATCH * PATCH, 256, 128, 1, True, False, True, True),
    "stats [4,65536,128]->256 G=4": (B, PATCH * PATCH, 128, 256, 4, False, True, True, True),
    "ragged [3,384,96]->80 G=4": (3, 384, 96, 80, 4, True, True, True, True),
}


def check(ok, msg):
    if not ok:
        raise RuntimeError(f"check failed: {msg}")


def time_ms(fn, runs=TIMING_RUNS, warmup=3, queue=1):
    """Median device time of ``fn`` in ms over ``runs`` samples (CUDA
    events). With ``queue`` > 1 a sample is the mean of that many calls
    enqueued behind a spin of about 3 ms on the device: the host's launch
    path (the Python wrapper, ctypes, the allocator) then runs ahead of the
    device and is not in the number, as it is not when a model's forward
    keeps the stream full. With ``queue`` = 1 the events surround one call
    made on an idle stream, which adds the host's path to a fast kernel."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if queue > 1:
            torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        for _ in range(queue):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / queue)
    return statistics.median(times)


def time_kernel(fn):
    """:func:`time_ms` for a kernel's wrapper or a library call: 7 samples
    of 8 queued calls."""
    return time_ms(fn, runs=7, queue=8)


def bound(n_bytes, *ops):
    """(bound_ms, bound_by): the least time the card could take to move
    ``n_bytes`` (each input read once, each output written once) or to do
    the operations, given as (count, peak rate) pairs per type, whichever
    is larger."""
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    t_ops = max(n / peak for n, peak in ops) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def phase1_kernels(dev):
    """Returns {kernel name: dict(max_abs_err, ms, plain_ms, bound_ms,
    bound_by, library_ms)} at the main path's shape of each kernel."""
    from uncrtaints_tpu_torch import _build
    from uncrtaints_tpu_torch.ops import aggregate, dwconv, dwgrad, mbconv

    t0 = time.perf_counter()
    _build.lib()
    print(f"phase 1: kernels built from {_build._CSRC} in "
          f"{time.perf_counter() - t0:.1f} s")
    g = torch.Generator(device=dev).manual_seed(SEED)
    randn = lambda *s: torch.randn(*s, generator=g, device=dev)
    out = {}
    result = lambda err, ms, plain_ms, bound_ms, bound_by, library_ms: dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, library_ms=library_ms)

    # ---- K1: main path [4,3,256,256,128] heads 16, a ragged shape, and
    # U-TAE's three skip levels (timed too)
    k1_err, k1_ms = 0.0, {}
    for shape in K1_SHAPES + UTAE_K1_SHAPES:
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
            if shape == K1_SHAPES[0] or (shape in UTAE_K1_SHAPES and dtype == BF16):
                kms = time_kernel(lambda: aggregate.att_group_aggregate(x, a))
                pms = time_ms(lambda: aggregate.att_group_aggregate_plain(x, a))
                # the one library call of the same function: an einsum over
                # t with the channels split into (head, channel of the head)
                xv = x.view(B, T, H, W, heads, C // heads)
                lib = lambda: torch.einsum("bthwn,bthwnc->bhwnc", a, xv)
                lms = time_kernel(lib)
                lerr = float((lib().reshape(ref.shape).float() - ref.float()).abs().max())
                check(lerr <= 4 * tol, f"K1 {dtype}: the einsum computes another function")
                # one multiply-add per (b, t, pixel, channel), fp32
                k1_ms[shape, dtype] = (kms, pms,
                                       *bound(nbytes(x, a, got), (2 * x.numel(), PEAK_FP32)),
                                       lms)
                bms = k1_ms[shape, dtype][2]
                line += (f", kernel {kms:.4f} ms, plain {pms:.4f} ms, bound {bms:.4f} ms "
                         f"({nbytes(x, a, got) / 1e6:.1f} MB; kernel at {bms / kms:.0%} of it), "
                         f"torch.einsum {lms:.4f} ms (max_abs_err {lerr:.3g})")
            print(line)
            check(err <= tol, f"K1 {dtype} {shape} disagrees with its plain version")
            k1_err = max(k1_err, err)
    out["att_group_aggregate"] = result(k1_err, *k1_ms[K1_SHAPES[0], BF16])

    # ---- K3: the two decoder GEMMs of the fused MBConv (N=4 frames of
    # 256x256), a statistics case, and a ragged shape
    def k3_case(N, P, C, C2, G, se, stats, do_gelu, epilogue):
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
                  out_affine=(randn(C2), randn(C2)) if epilogue else None,
                  out_gelu=epilogue and not se, do_stats=stats)
        return args, kw

    k3_err, k3_ms, k3_pms, k3_bound, k3_lib, k3_by = 0.0, 0.0, 0.0, 0.0, 0.0, ("", 0.0)
    for name, case in K3_CASES.items():
        args, kw = k3_case(*case)
        n_wg = mbconv.norm_gelu_matmul.wgmma_launches
        got = mbconv.norm_gelu_matmul(*args, **kw)
        torch.cuda.synchronize()
        # the decoder widths run the pipelined wgmma kernel, the ragged
        # widths the tiled WMMA kernel
        ran_wg = mbconv.norm_gelu_matmul.wgmma_launches - n_wg
        check(ran_wg == (0 if name.startswith("ragged") else 1),
              f"K3 {name} ran the {'wgmma' if ran_wg else 'WMMA'} kernel")
        ref = mbconv.norm_gelu_matmul_plain(*args, **kw)
        err = float((got[0].float() - ref[0].float()).abs().max())
        # bf16 output: at most one ulp at the top of its range (the fp32 GEMM
        # sums in another order, then both round once)
        tol = 2 ** -7 * float(ref[0].float().abs().max())
        line = (f"K3 norm_gelu_matmul {name} ({'wgmma' if ran_wg else 'WMMA'} kernel): "
                f"max_abs_err={err:.3g} (tol {tol:.3g})")
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
            kms = time_kernel(lambda: mbconv.norm_gelu_matmul(*args, **kw))
            pms = time_ms(lambda: mbconv.norm_gelu_matmul_plain(*args, **kw))
            # the bare bf16 GEMM of the same shape: the floor a library
            # reaches without the prologue and the epilogue
            x2, w2 = args[0].view(-1, args[0].shape[-1]), args[5]
            lms = time_kernel(lambda: torch.matmul(x2, w2))
            # tensor-core operations of the GEMM; fp32 operations per input
            # element: the prologue's 4, the GELU and the SE product where
            # they run, and per output element the affine's 2 where it runs
            n_in, n_out = x2.numel(), x2.shape[0] * w2.shape[1]
            n_gelu = n_in if kw["do_gelu"] else 0
            fp32_ops = (4 * n_in + GELU_OPS * n_gelu + (kw["se"] is not None) * n_in
                        + 2 * n_out * (kw["out_affine"] is not None))
            n_byte = nbytes(*args, got[0], *(kw["out_affine"] or ()),
                            *([kw["se"]] if kw["se"] is not None else []))
            bms, by = bound(n_byte, (2 * n_in * w2.shape[1], PEAK_BF16), (fp32_ops, PEAK_FP32),
                            (GELU_SFU * n_gelu, PEAK_SFU))
            # both GEMMs are bound by their bytes: the second's GELU per input
            # element is 1.7 G operations, 0.026 ms at the fp32 peak
            check(by == "bytes", f"K3 {name} is bound by {by}")
            k3_ms, k3_pms, k3_bound, k3_lib = k3_ms + kms, k3_pms + pms, k3_bound + bms, k3_lib + lms
            k3_by = max(k3_by, (by, bms), key=lambda t: t[1])
            line += (f", kernel {kms:.4f} ms, plain {pms:.4f} ms, bound {bms:.4f} ms ({by}: "
                     f"{n_byte / 1e6:.0f} MB are {n_byte / PEAK_BYTES * 1e3:.4f} ms, "
                     f"{fp32_ops / 1e9:.2f} G fp32 operations {fp32_ops / PEAK_FP32 * 1e3:.4f} ms), "
                     f"torch.matmul alone {lms:.4f} ms")
            if n_gelu:
                line += (f"; dispatching the compiled GELU's {GELU_SLOTS} instructions "
                         f"{n_gelu / 1e6:.0f} M times takes the SMs "
                         f"{GELU_SLOTS * n_gelu / (PEAK_FP32 / 2) * 1e3:.4f} ms (no bound)")
        print(line)
        check(not bad, f"K3 {name} disagrees with its plain version")
        k3_err = max(k3_err, err)
    # the two decoder GEMMs together: a fused block runs one of each (bound
    # by what bounds the slower of the two)
    out["norm_gelu_matmul"] = result(k3_err, k3_ms, k3_pms, k3_bound, k3_by[0], k3_lib)

    # ---- K4: the decoder's fused norm -> GELU -> reflect depthwise 3x3
    # (N=4 maps of 256x256x256, the batch-norm form) as the fused block calls
    # it (no statistics, the pooled sum) and bare, a group-norm form with its
    # statistics and with both, fp32, and a ragged shape whose every border
    # reflects, the last two with statistics and the pooled sum
    def k4_case(N, H, W, C, G, dtype, stats, pool):
        x = randn(N, H, W, C).to(dtype)
        if G == 1:
            mean, coef = torch.zeros(N, 1, device=dev), torch.ones(N, 1, device=dev)
        else:
            xg = x.float().view(N, H * W, G, C // G)
            mean = xg.mean(dim=(1, 3))
            coef = torch.rsqrt(xg.var(dim=(1, 3), correction=0) + 1e-5)
        return (x, mean, coef, randn(C), randn(C), randn(3, 3, C) * 0.3), dict(
            groups_in=G, groups_out=G, do_stats=stats,
            pool_affine=(randn(C), randn(C)) if pool else None)

    k4_err = 0.0
    for name, case in K4_CASES.items():
        args, kw = k4_case(*case)
        got = mbconv.norm_gelu_dwconv3x3(*args, **kw)
        torch.cuda.synchronize()
        again = mbconv.norm_gelu_dwconv3x3(*args, **kw)
        ref = mbconv.norm_gelu_dwconv3x3_plain(*args, **kw)
        err = float((got[0].float() - ref[0].float()).abs().max())
        top = float(ref[0].float().abs().max())
        # fp32 sums of nine taps, one fused multiply-add each against the
        # plain version's product and sum rounded apart, then one cast: one
        # bf16 ulp of the largest output, or 1e-5 of it in fp32
        tol = (1e-5 if case[5] == torch.float32 else 2 ** -7) * top
        N, G, C, stats, pool = case[0], kw["groups_out"], case[3], case[6], case[7]
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        line = (f"K4 norm_gelu_dwconv3x3 {name}: max_abs_err={err:.3g} (tol {tol:.3g}), "
                f"two runs bit-identical {same}")
        check(len(got) == (4 if pool else 3), f"K4 {name}: {len(got)} return values")
        e1 = e2 = ep = 0.0
        if stats:
            # fp32 sums of up to 4M terms in another order: 1e-5 relative
            # (of the sum of |terms|); a rounding that falls the other way
            # moves a term by one ulp, far inside that
            abs_sum = ref[0].float().abs().view(N, -1, G, C // G).sum(dim=(1, 3))
            e1 = float(((got[1] - ref[1]).abs() / abs_sum).max())
            e2 = float(((got[2] - ref[2]).abs() / ref[2]).max())
            line += f", stats rel_err sum={e1:.3g} sumsq={e2:.3g} (tol 1e-5)"
        else:
            check(not got[1].any() and not got[2].any(), f"K4 {name}: statistics not zero")
        if pool:
            # the pooled sum of the kernel's own rounded output, so that the
            # reduction is held apart from the one-ulp gap of the outputs:
            # 1e-5 of the sum of |gelu(.)| (fp32 sums in another order)
            psc, pbi = kw["pool_affine"]
            act = torch.nn.functional.gelu(got[0].float() * psc + pbi)
            ep = float(((got[3] - act.sum(dim=(1, 2))).abs() / act.abs().sum(dim=(1, 2))).max())
            # and against the plain version's, whose outputs may differ by an ulp
            ep_plain = float(((got[3] - ref[3]).abs() / act.abs().sum(dim=(1, 2))).max())
            line += (f", pooled sum rel_err {ep:.3g} (tol 1e-5; against the plain version's "
                     f"{ep_plain:.3g}, tol 1e-3)")
            check(ep_plain <= 1e-3, f"K4 {name}: pooled sum far from the plain version's")
        if name.startswith("path"):
            x, _, _, sc, bi, w = args
            kms = time_kernel(lambda: mbconv.norm_gelu_dwconv3x3(*args, **kw))
            line += f", kernel {kms:.4f} ms"
        if name.startswith("path ["):
            pms = time_ms(lambda: mbconv.norm_gelu_dwconv3x3_plain(*args, **kw), runs=7)
            # what the fused body ran before K4: the norm affine and GELU in
            # bf16, a reflect pad that keeps NHWC, cuDNN's depthwise conv
            wc = w.permute(2, 0, 1)[:, None].contiguous().to(x.dtype)
            scb, bib = sc.to(x.dtype), bi.to(x.dtype)

            def composition():
                h = torch.nn.functional.gelu(x * scb + bib)
                hp = torch.nn.functional.pad(h.unsqueeze(1), (0, 0, 1, 1, 1, 1),
                                             mode="reflect").squeeze(1)
                return torch.nn.functional.conv2d(hp.permute(0, 3, 1, 2), wc, groups=C)

            lms = time_kernel(composition)
            # fp32 operations per element: the prologue's 4 and its GELU, 9
            # multiply-adds, the pooled sum's affine, GELU and add
            ops = (4 + GELU_OPS + 18 + 3 + GELU_OPS) * x.numel()
            n_byte = nbytes(*args, got[0], *kw["pool_affine"], got[3])
            bms, by = bound(n_byte, (ops, PEAK_FP32), (2 * GELU_SFU * x.numel(), PEAK_SFU))
            check(by == "bytes", f"K4 is bound by {by}")
            out["norm_gelu_dwconv3x3"] = result(0.0, kms, pms, bms, by, lms)
            # the eager pass the pooled sum replaces, alone: the SE mean of
            # the fused block as it ran between K4 and the second K3
            h2 = got[0]
            se_ms = time_kernel(
                lambda: torch.nn.functional.gelu(h2.float() * psc + pbi).mean(dim=(1, 2)))
            line += (f", plain {pms:.4f} ms, bound {bms:.4f} ms ({by}: {n_byte / 1e6:.0f} MB are "
                     f"{n_byte / PEAK_BYTES * 1e3:.4f} ms, {ops / 1e9:.2f} G fp32 operations "
                     f"{ops / PEAK_FP32 * 1e3:.4f} ms), gelu + reflect pad + cuDNN depthwise "
                     f"{lms:.4f} ms; dispatching the compiled GELU's {GELU_SLOTS} instructions "
                     f"twice an output takes the SMs "
                     f"{2 * GELU_SLOTS * x.numel() / (PEAK_FP32 / 2) * 1e3:.4f} ms (no bound)")
            print(f"K4 the eager SE pass the pooled sum replaces, gelu(h2.float() * c2 + o2)"
                  f".mean((1, 2)) on [4,256,256,256] bf16, alone: {se_ms:.4f} ms")
        print(line)
        check(err <= tol, f"K4 {name} disagrees with its plain version")
        check(e1 <= 1e-5 and e2 <= 1e-5, f"K4 {name}: statistics disagree")
        check(ep <= 1e-5, f"K4 {name}: the pooled sum disagrees")
        check(same, f"K4 {name} is not deterministic")
        k4_err = max(k4_err, err)
    out["norm_gelu_dwconv3x3"]["max_abs_err"] = k4_err

    # ---- K1-bwd: the aggregator's backward at the main path shape, ragged
    kb_err, kb_ms = 0.0, {}
    for shape in K1_SHAPES + UTAE_K1_SHAPES:
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
            if (shape == K1_SHAPES[0] or shape in UTAE_K1_SHAPES) and dtype == BF16:
                kms = time_kernel(lambda: aggregate.att_group_aggregate_bwd(x, a, gy))
                pms = time_ms(lambda: aggregate.att_group_aggregate_bwd_plain(x, a, gy))
                # the library's way to the same two results: one einsum each
                xv = x.view(B_, T_, H, W, heads, C // heads)
                gv = gy.view(B_, H, W, heads, C // heads)

                def lib():
                    return (torch.einsum("bthwn,bhwnc->bthwnc", a, gv),
                            torch.einsum("bthwnc,bhwnc->bthwn", xv, gv))

                lms = time_kernel(lib)
                ldx, lda = lib()
                lerr = max(float((ldx.reshape(rdx.shape).float() - rdx.float()).abs().max()),
                           float((lda.float() - rda.float()).abs().max()))
                check(lerr <= 4 * tol, "K1-bwd: the einsums compute another function")
                # per (b, t, pixel, channel): dx = a * gy and one term of da
                kb_ms[shape] = (kms, pms,
                                *bound(nbytes(x, a, gy, dx, da), (4 * x.numel(), PEAK_FP32)),
                                lms)
                bms = kb_ms[shape][2]
                line += (f", kernel {kms:.4f} ms, plain {pms:.4f} ms, bound {bms:.4f} ms "
                         f"({nbytes(x, a, gy, dx, da) / 1e6:.1f} MB; kernel at {bms / kms:.0%} of "
                         f"it), two torch.einsum {lms:.4f} ms (max_abs_err {lerr:.3g})")
            print(line)
            check(err <= tol, f"K1-bwd {dtype} {shape} disagrees with its plain version")
            kb_err = max(kb_err, err)
    out["att_group_aggregate_bwd"] = result(kb_err, *kb_ms[K1_SHAPES[0]])

    # ---- K5 (forward, folded adjoint, zero-pad shapes) and K2 (weight gradient)
    Fn = torch.nn.functional
    k5_err, k2_err = 0.0, 0.0
    for name, (N, H, W, C, (kh, kw), pads, mode, dtype) in DW_CASES.items():
        x = randn(N, H, W, C).to(dtype)
        w = (randn(C, 1, kh, kw) * 0.3).to(dtype)
        xc, pad = x.permute(0, 3, 1, 2), pads[0][0]  # the NCHW view (channels_last)
        if mode == "adjoint":  # x is the output gradient here
            kernel = lambda: dwconv.dw_stencil_reflect_adjoint(x, w)
            plain = lambda: dwconv.dw_stencil_reflect_adjoint_plain(x, w)
            # what the port ran before: autograd's input gradient of cuDNN's
            # conv on the padded input, then the reflect pad's backward
            leaf = torch.zeros_like(x).requires_grad_()
            y = Fn.conv2d(dwconv.reflect_pad(leaf).permute(0, 3, 1, 2), w, groups=C)
            library = lambda: torch.autograd.grad(y, leaf, xc, retain_graph=True)[0]
            bare = lambda: torch.nn.grad.conv2d_input((N, C, H, W), w, xc, padding=1, groups=C)
            bare_name = "torch.nn.grad.conv2d_input alone"
            lib_name = "autograd of reflect F.pad + cuDNN conv"
        else:
            kernel = lambda: dwconv.dw_stencil(x, w, pads, mode)
            plain = lambda: dwconv.dw_stencil_plain(x, w, pads, mode)
            bare = lambda: Fn.conv2d(xc, w, padding=pad, groups=C)
            bare_name = "cuDNN alone"
            if mode == "reflect":  # what the port ran before: the pad, then cuDNN
                library = lambda: Fn.conv2d(dwconv.reflect_pad(x).permute(0, 3, 1, 2), w,
                                            groups=C).permute(0, 2, 3, 1)
                lib_name = "reflect F.pad + cuDNN"
            else:
                library, lib_name = None, ""
        got = kernel()
        torch.cuda.synchronize()
        ref = plain()
        err = float((got.float() - ref.float()).abs().max())
        top = float(ref.float().abs().max())
        # one bf16 ulp of the largest output (fp32 sums in another order, one
        # fused multiply-add per tap, then one rounding; fp32: 1e-6 of it)
        tol = (1e-6 if dtype == torch.float32 else 2 ** -7) * top
        line = f"K5 dw_stencil {name}: max_abs_err={err:.3g} (tol {tol:.3g})"
        if dtype == torch.bfloat16 and N * H * W * C > 1e7:
            kms, pms, cms = time_kernel(kernel), time_ms(plain, runs=7), time_kernel(bare)
            bms, by = bound(nbytes(x, w, got), (2 * kh * kw * got.numel(), PEAK_FP32))
            line += (f", kernel {kms:.4f} ms, plain {pms:.4f} ms, bound {bms:.4f} ms, "
                     f"{bare_name} {cms:.4f} ms")
            if library is not None:
                lerr = float((library().float() - ref.float()).abs().max())
                check(lerr <= 4 * tol, f"K5 {name}: the library composition computes "
                                       f"another function (max_abs_err {lerr:.3g})")
                lms = time_kernel(library)
                line += f", {lib_name} {lms:.4f} ms"
            if name.startswith("reflect enc"):
                out["dw_stencil"] = result(0.0, kms, pms, bms, by, lms)
        print(line)
        check(err <= tol, f"K5 {name} disagrees with its plain version")
        k5_err = max(k5_err, err)
        if mode == "adjoint" or "gx" in name:
            continue  # K2 pairs the primal input with the output gradient
        Ho, Wo = dwconv.out_hw(H, W, kh, kw, pads)
        gy = randn(N, Ho, Wo, C).to(dtype)
        gw = dwgrad.dw_kernel_grad(x, gy, pads, kh, kw, mode)
        torch.cuda.synchronize()
        ref = dwgrad.dw_kernel_grad_plain(x, gy, pads, kh, kw, mode)
        scale = dwgrad.dw_kernel_grad_plain(x.abs(), gy.abs(), pads, kh, kw, mode)
        rel = float(((gw - ref).abs() / scale).max())
        err = float((gw - ref).abs().max())
        again = dwgrad.dw_kernel_grad(x, gy, pads, kh, kw, mode)
        # fp32 sums of N*Ho*Wo products in another order: 1e-4 of sum |x*g|
        line = (f"K2 dw_kernel_grad {name}: max_abs_err={err:.3g}, "
                f"rel to sum|x*g| {rel:.3g} (tol 1e-4), deterministic "
                f"{bool(torch.equal(gw, again))}")
        if dtype == torch.bfloat16 and N * H * W * C > 1e7:
            kms = time_kernel(lambda: dwgrad.dw_kernel_grad(x, gy, pads, kh, kw, mode))
            pms = time_ms(lambda: dwgrad.dw_kernel_grad_plain(x, gy, pads, kh, kw, mode), runs=7)
            # cuDNN's weight gradient of the same depthwise convolution
            gc = gy.permute(0, 3, 1, 2)
            cms = time_kernel(lambda: torch.nn.grad.conv2d_weight(
                xc, (C, 1, kh, kw), gc, padding=pad, groups=C))
            bms, by = bound(nbytes(x, gy, gw), (2 * kh * kw * gy.numel(), PEAK_FP32))
            line += (f", kernel {kms:.4f} ms, plain {pms:.4f} ms, bound {bms:.4f} ms, "
                     f"cuDNN weight gradient alone {cms:.4f} ms")
            if mode == "reflect":  # what the port ran before: the pad, then cuDNN
                library = lambda: torch.nn.grad.conv2d_weight(
                    dwconv.reflect_pad(x).permute(0, 3, 1, 2), (C, 1, kh, kw), gc, groups=C)
                lrel = float(((library().float() - ref).abs() / scale).max())
                # cuDNN may sum in bf16-rounded partials: 1e-2 of sum |x*g|
                check(lrel <= 1e-2, f"K2 {name}: the library composition computes another "
                                    f"function (rel {lrel:.3g})")
                lms = time_kernel(library)
                line += f", reflect F.pad + cuDNN weight gradient {lms:.4f} ms"
                if name.startswith("reflect enc"):
                    out["dw_kernel_grad"] = result(0.0, kms, pms, bms, by, lms)
        print(line)
        check(rel <= 1e-4, f"K2 {name} disagrees with its plain version")
        check(torch.equal(gw, again), f"K2 {name} is not deterministic")
        k2_err = max(k2_err, err)
    out["dw_stencil"]["max_abs_err"] = k5_err
    out["dw_kernel_grad"]["max_abs_err"] = k2_err
    halo = phase1_halo_modes(dev, randn)
    for name, err in halo.items():
        out[name]["max_abs_err"] = max(out[name]["max_abs_err"], err)
    return out


# the halo modes at the paper shapes, split into bands of rows: K5 and K2 at
# the encoder's and the decoder's depthwise conv, K4 at the decoder's
HALO_SPLITS = (2, 4)
HALO_CASES = {"enc": (B * T, PATCH, PATCH, HIDDEN), "dec": (B, PATCH, PATCH, HIDDEN)}


def _bands(x, n):
    rows = x.shape[1] // n
    return [x[:, i * rows:(i + 1) * rows].contiguous() for i in range(n)]


def _halos(bands):
    """(top, bot) of each band: the neighbours' edge rows, None at the edge."""
    n = len(bands)
    return [(bands[i - 1][:, -1:].contiguous() if i > 0 else None,
             bands[i + 1][:, :1].contiguous() if i < n - 1 else None) for i in range(n)]


def phase1_halo_modes(dev, randn):
    """The halo modes of K5 (forward and folded adjoint), K2 and K4 at the
    paper shapes split into 2 and 4 bands of rows: each band's launch
    against its plain version; the bands stitched against the whole-tensor
    kernel (K5's forward and K4's output bit-equal, the adjoint with the
    halo gradients added back to the rows they came from within two bf16
    ulps (two roundings where the whole kernel has one), K2's and K4's
    summed partials within 1e-5 relative); and, at 2 bands, each halo
    mode's time against the whole-mode kernel on the same band rows, its
    byte bound and the library composition it replaces (the halo rows
    concatenated, F.pad, cuDNN). Returns each kernel's largest error
    against its plain version."""
    from uncrtaints_tpu_torch.ops import dwconv, dwgrad, mbconv
    Fn = torch.nn.functional
    err = {"dw_stencil": 0.0, "dw_kernel_grad": 0.0, "norm_gelu_dwconv3x3": 0.0}
    ulp = 2 ** -7
    for case, (N, H, W, C) in HALO_CASES.items():
        x = randn(N, H, W, C).bfloat16()
        w = (randn(C, 1, 3, 3) * 0.3).bfloat16()
        gy = randn(N, H, W, C).bfloat16()
        whole = dwconv.dw_stencil(x, w, ONE, "reflect")
        whole_gx = dwconv.dw_stencil_reflect_adjoint(gy, w)
        whole_gw = dwgrad.dw_kernel_grad(x, gy, ONE, 3, 3, "reflect")
        scale = dwgrad.dw_kernel_grad_plain(x.abs(), gy.abs(), ONE, 3, 3, "reflect")
        for n in HALO_SPLITS:
            rows = H // n
            xb, gb = _bands(x, n), _bands(gy, n)
            hb = _halos(xb)
            n0 = dwconv.dw_stencil.halo_launches
            fwd = [dwconv.dw_stencil(b, w, ONE, "reflect", halo=h) for b, h in zip(xb, hb)]
            adj = [dwconv.dw_stencil_reflect_adjoint(g, w, halo=(i > 0, i < n - 1))
                   for i, g in enumerate(gb)]
            gws = [dwgrad.dw_kernel_grad(b, g, ONE, 3, 3, "reflect", halo=h)
                   for b, g, h in zip(xb, gb, hb)]
            torch.cuda.synchronize()
            check(dwconv.dw_stencil.halo_launches - n0 == 2 * n,
                  f"K5 halo {case}/{n}: {dwconv.dw_stencil.halo_launches - n0} halo launches")
            e_f = e_a = e_g = 0.0
            for i, (b, g, h) in enumerate(zip(xb, gb, hb)):
                ref = dwconv.dw_stencil_halo_plain(b, w, *h)
                top = float(ref.float().abs().max())
                e = float((fwd[i].float() - ref.float()).abs().max())
                check(e <= ulp * top, f"K5 halo {case}/{n} band {i}: {e} from its plain version")
                e_f = max(e_f, e)
                rgx, rgt, rgb = dwconv.dw_stencil_halo_adjoint_plain(g, w, i > 0, i < n - 1)
                for got, want in ((adj[i][0], rgx), (adj[i][1], rgt), (adj[i][2], rgb)):
                    if got is None:
                        continue
                    e = float((got.float() - want.float()).abs().max())
                    check(e <= ulp * float(want.float().abs().max()),
                          f"K5 halo adjoint {case}/{n} band {i}: {e} from its plain version")
                    e_a = max(e_a, e)
                rgw = dwgrad.dw_kernel_grad_halo_plain(b, g, *h)
                e = float(((gws[i] - rgw).abs() / scale).max())
                check(e <= 1e-4, f"K2 halo {case}/{n} band {i}: rel {e} from its plain version")
                e_g = max(e_g, float((gws[i] - rgw).abs().max()))
            stitched = torch.cat(fwd, 1)
            check(torch.equal(stitched, whole), f"K5 halo {case}/{n}: the bands differ from "
                  f"the whole kernel by {float((stitched.float() - whole.float()).abs().max())}")
            gx = torch.cat([a[0] for a in adj], 1).float()
            for i, (_, gt, gbot) in enumerate(adj):
                if gt is not None:
                    gx[:, i * rows - 1] += gt[:, 0].float()
                if gbot is not None:
                    gx[:, (i + 1) * rows] += gbot[:, 0].float()
            ea = float((gx - whole_gx.float()).abs().max())
            check(ea <= 2 * ulp * float(whole_gx.float().abs().max()),
                  f"K5 halo adjoint {case}/{n}: stitched {ea} from the whole kernel")
            eg = float(((sum(gws) - whole_gw).abs() / scale).max())
            check(eg <= 1e-5, f"K2 halo {case}/{n}: summed partials rel {eg}")
            print(f"K5/K2 halo modes {case} [{N},{H},{W},{C}] in {n} bands of {rows} rows: "
                  f"against the plain versions max_abs_err fwd {e_f:.3g}, adjoint {e_a:.3g}, "
                  f"K2 {e_g:.3g}; stitched forward bit-equal to the whole kernel; adjoint with "
                  f"the halo gradients added back {ea:.3g} (tol two bf16 ulps); K2 summed "
                  f"partials rel {eg:.3g} (tol 1e-5)")
            err["dw_stencil"] = max(err["dw_stencil"], e_f, e_a)
            err["dw_kernel_grad"] = max(err["dw_kernel_grad"], e_g)
            if n != 2:
                continue
            # time the middle-less band 0 of 2 (one neighbour below) against
            # the whole-mode kernel on the same rows and the library composition
            b, h, g = xb[0], hb[0], gb[0]
            wc = w.contiguous()
            t_halo = time_kernel(lambda: dwconv.dw_stencil(b, w, ONE, "reflect", halo=h))
            t_plain = time_ms(lambda: dwconv.dw_stencil_halo_plain(b, w, *h), runs=7)
            t_whole = time_kernel(lambda: dwconv.dw_stencil(b, w, ONE, "reflect"))

            def lib_fwd():  # the halo rows, the reflect pad, cuDNN
                xe = torch.cat([b[:, 1:2], b, h[1]], 1)
                xp = Fn.pad(xe.unsqueeze(1), (0, 0, 1, 1, 0, 0), mode="reflect").squeeze(1)
                return Fn.conv2d(xp.permute(0, 3, 1, 2), wc, groups=C)

            t_lib = time_kernel(lib_fwd)
            lerr = float((lib_fwd().permute(0, 2, 3, 1).float() - fwd[0].float()).abs().max())
            check(lerr <= 4 * ulp * float(fwd[0].float().abs().max()),
                  f"K5 halo {case}: the library composition computes another function")
            bms, by = bound(nbytes(b, w, h[1], fwd[0]), (2 * 9 * b.numel(), PEAK_FP32))
            t_adj = time_kernel(lambda: dwconv.dw_stencil_reflect_adjoint(g, w, halo=(False, True)))
            t_adj_whole = time_kernel(lambda: dwconv.dw_stencil_reflect_adjoint(g, w))
            t_adj_plain = time_ms(lambda: dwconv.dw_stencil_halo_adjoint_plain(g, w, False, True),
                                  runs=7)
            abms, _ = bound(nbytes(g, w, g, adj[0][2]), (2 * 9 * g.numel(), PEAK_FP32))
            t_gw = time_kernel(lambda: dwgrad.dw_kernel_grad(b, g, ONE, 3, 3, "reflect", halo=h))
            t_gw_whole = time_kernel(lambda: dwgrad.dw_kernel_grad(b, g, ONE, 3, 3, "reflect"))
            t_gw_plain = time_ms(lambda: dwgrad.dw_kernel_grad_halo_plain(b, g, *h), runs=7)
            gc = g.permute(0, 3, 1, 2)

            def lib_gw():
                xe = torch.cat([b[:, 1:2], b, h[1]], 1)
                xp = Fn.pad(xe.unsqueeze(1), (0, 0, 1, 1, 0, 0), mode="reflect").squeeze(1)
                return torch.nn.grad.conv2d_weight(xp.permute(0, 3, 1, 2), (C, 1, 3, 3), gc,
                                                   groups=C)

            t_gw_lib = time_kernel(lib_gw)
            gbms, _ = bound(nbytes(b, g, h[1], gws[0]), (2 * 9 * g.numel(), PEAK_FP32))
            print(f"  halo timing, band 0 of 2 {list(b.shape)} bf16: K5 fwd {t_halo:.4f} ms "
                  f"(whole-mode kernel on the band {t_whole:.4f}, plain {t_plain:.4f}, bound "
                  f"{bms:.4f} ({by}), halo concat + reflect F.pad + cuDNN {t_lib:.4f}); K5 "
                  f"adjoint {t_adj:.4f} (whole-mode {t_adj_whole:.4f}, plain {t_adj_plain:.4f}, "
                  f"bound {abms:.4f}); K2 {t_gw:.4f} (whole-mode {t_gw_whole:.4f}, plain "
                  f"{t_gw_plain:.4f}, bound {gbms:.4f}, halo concat + F.pad + cuDNN weight "
                  f"gradient {t_gw_lib:.4f})")

    # ---- K4 at the decoder's fused block (batch-norm form, the pooled sum)
    N, H, W, C = HALO_CASES["dec"]
    x = randn(N, H, W, C).bfloat16()
    zero, one = torch.zeros(N, 1, device=dev), torch.ones(N, 1, device=dev)
    args = (zero, one, randn(C), randn(C), randn(3, 3, C) * 0.3)
    pa = (randn(C), randn(C))
    kw = dict(groups_in=1, groups_out=1, do_stats=False, pool_affine=pa)
    whole = mbconv.norm_gelu_dwconv3x3(x, *args, **kw)
    for n in HALO_SPLITS:
        xb = _bands(x, n)
        hb = _halos(xb)
        n0 = mbconv.norm_gelu_dwconv3x3.halo_launches
        parts = [mbconv.norm_gelu_dwconv3x3(b, *args, halo=h, **kw) for b, h in zip(xb, hb)]
        torch.cuda.synchronize()
        check(mbconv.norm_gelu_dwconv3x3.halo_launches - n0 == n, f"K4 halo {n}: launches")
        e4 = 0.0
        for i, (b, h) in enumerate(zip(xb, hb)):
            ref = mbconv.norm_gelu_dwconv3x3_plain(b, *args, halo=h, **kw)
            e = float((parts[i][0].float() - ref[0].float()).abs().max())
            check(e <= ulp * float(ref[0].float().abs().max()),
                  f"K4 halo {n} band {i}: {e} from its plain version")
            e4 = max(e4, e)
        stitched = torch.cat([p[0] for p in parts], 1)
        check(torch.equal(stitched, whole[0]), f"K4 halo {n}: the bands differ from the whole "
              f"kernel by {float((stitched.float() - whole[0].float()).abs().max())}")
        act = torch.nn.functional.gelu(whole[0].float() * pa[0] + pa[1]).abs().sum(dim=(1, 2))
        ep = float(((sum(p[3] for p in parts) - whole[3]).abs() / act).max())
        check(ep <= 1e-5, f"K4 halo {n}: summed pooled partials rel {ep}")
        print(f"K4 halo mode [{N},{H},{W},{C}] in {n} bands: against the plain version "
              f"max_abs_err {e4:.3g}; stitched bit-equal to the whole kernel; pooled partial "
              f"sums rel {ep:.3g} (tol 1e-5)")
        err["norm_gelu_dwconv3x3"] = max(err["norm_gelu_dwconv3x3"], e4)
        if n != 2:
            continue
        b, h = xb[0], hb[0]
        t_halo = time_kernel(lambda: mbconv.norm_gelu_dwconv3x3(b, *args, halo=h, **kw))
        t_whole = time_kernel(lambda: mbconv.norm_gelu_dwconv3x3(b, *args, **kw))
        t_plain = time_ms(lambda: mbconv.norm_gelu_dwconv3x3_plain(b, *args, halo=h, **kw),
                          runs=7)
        wc = args[4].permute(2, 0, 1)[:, None].contiguous().bfloat16()
        scb, bib = args[2].bfloat16(), args[3].bfloat16()

        def lib_k4():  # GELU, the halo rows, the reflect pad, cuDNN
            xe = torch.cat([b[:, 1:2], b, h[1]], 1)
            he = Fn.gelu(xe * scb + bib)
            hp = Fn.pad(he.unsqueeze(1), (0, 0, 1, 1, 0, 0), mode="reflect").squeeze(1)
            return Fn.conv2d(hp.permute(0, 3, 1, 2), wc, groups=C)

        t_lib = time_kernel(lib_k4)
        ops = (4 + GELU_OPS + 18 + 3 + GELU_OPS) * b.numel()
        bms, by = bound(nbytes(b, h[1], *args, parts[0][0], *pa, parts[0][3]), (ops, PEAK_FP32),
                        (2 * GELU_SFU * b.numel(), PEAK_SFU))
        print(f"  halo timing, band 0 of 2 {list(b.shape)} bf16: K4 {t_halo:.4f} ms (whole-mode "
              f"kernel on the band {t_whole:.4f}, plain {t_plain:.4f}, bound {bms:.4f} ({by}), "
              f"GELU + halo concat + reflect F.pad + cuDNN {t_lib:.4f})")
    return err


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
    for f in (aggregate.att_group_aggregate, mbconv.norm_gelu_matmul,
              mbconv.norm_gelu_dwconv3x3, *train_kernels):
        f.launches = 0
    mbconv.norm_gelu_matmul.wgmma_launches = 0
    times, results = [], []
    for _ in range(2):
        for b in batches:
            t0 = time.perf_counter()
            aux = step(model, b)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            results.append(aux)
    k1, k3 = aggregate.att_group_aggregate.launches, mbconv.norm_gelu_matmul.launches
    k4 = mbconv.norm_gelu_dwconv3x3.launches
    n_fwd = len(times)
    print(f"phase 2: paper recipe (bf16, {n_params} parameters), {n_fwd} eval "
          f"steps of B={B}, T={T}, {P}x{P}: K1 launches {k1}, K3 launches {k3}, "
          f"K4 launches {k4}")
    check(k1 == n_fwd, f"K1 launched {k1} times in {n_fwd} forwards (1 each expected)")
    check(k3 == 10 * n_fwd, f"K3 launched {k3} times in {n_fwd} forwards (10 each expected)")
    check(k4 == 5 * n_fwd, f"K4 launched {k4} times in {n_fwd} forwards (5 each expected)")
    check(mbconv.norm_gelu_matmul.wgmma_launches == k3,
          f"only {mbconv.norm_gelu_matmul.wgmma_launches} of the {k3} K3 launches ran the "
          "wgmma kernel")
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
    profile_eval_step(step, model, batches[0], ms)
    return cfg, model, batches, {"K1": k1, "K3": k3, "K4": k4}, ms


# device kernels of an eval step by kind, as KERNEL_KINDS below
EVAL_KINDS = (
    ("K1", ("att_group_",)),
    ("K3", ("ngm_",)),
    ("K4 (with its pooled-sum and statistics passes)", ("ngd_", "channel_sum_kernel",
                                                        "group_stats_kernel")),
    ("GEMMs outside the kernels", ("gemm", "cutlass", "xmma", "nvjet", "cublas", "splitK")),
    ("convolutions (cuDNN)", ("cudnn", "conv", "Conv")),
    ("reductions", ("reduce_kernel",)),
    ("GELU", ("gelu", "Gelu")),
    ("dtype and layout copies", ("copy", "Copy", "CatArray", "Memcpy")),
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


def profile_eval_step(step, model, batch, step_ms):
    """One more eval step under ``torch.profiler``, reported by
    :func:`eval_step_report`: the step must run 1 K1, 10 K3 through the
    wgmma kernel and 5 K4 each with its pooled-sum pass and none with
    statistics, and the five fused decoder blocks no GELU, mean or sum over
    a whole map outside the kernels."""
    found, eager = eval_step_report(step, model, batch, step_ms)
    want = {"att_group_": 1, "ngm_wg_kernel": 10, "ngm_kernel": 0, "ngd_tile_kernel": 5,
            "channel_sum_kernel": 5, "group_stats_kernel": 0}
    check(found == want,
          f"the eval step's kernels {found}, expected {want} (1 K1, 10 K3 through "
          "the wgmma kernel, 5 K4 each with its pooled-sum pass and none with statistics)")
    check(not eager, "a fused decoder block ran an eager GELU or reduction over a whole map")


def eval_step_report(step, model, batch, step_ms):
    """Print the profile of one eval step under ``torch.profiler``: device
    time by kind and the idle share against the unprofiled step time
    ``step_ms``, the K3 and K4 kernels by name, then the five fused decoder
    blocks alone with recorded shapes. Returns ({kernel name fragment:
    launches in the step}, the eager GELU, mean or sum calls over a whole
    map in the blocks); ``tools/profile_eval_h100.py`` prints the same for
    an older tree."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        step(model, batch)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
    kinds, names, others = device_time_by_kind(prof, EVAL_KINDS)
    busy = sum(t for t, _ in kinds.values())
    check(busy > 0, "the profiler recorded no device time")
    print(f"  profile of one eval step ({host_ms:.1f} ms on the host under the profiler): device "
          f"busy {busy:.2f} ms in {sum(n for _, n in kinds.values())} kernels; against the "
          f"unprofiled step of {step_ms:.2f} ms the device idles {1 - busy / step_ms:.1%}")
    for kind, (t, n) in sorted(kinds.items(), key=lambda kv: -kv[1][0]):
        print(f"    {kind}: {t:.3f} ms, {n} launches")
    print(f"    the largest of 'other': {others}")
    count = lambda frag: sum(n for k, (n, _) in names.items() if frag in k)
    found = {f: count(f) for f in ("att_group_", "ngm_wg_kernel", "ngm_kernel", "ngd_tile_kernel",
                                   "channel_sum_kernel", "group_stats_kernel")}
    print(f"    kernels by name: {found}")
    # the hand-written kernels one by one (template arguments tell the two K3 shapes apart)
    for key, (n, ms) in sorted(names.items()):
        if any(f in key for f in ("ngm_", "ngd_", "channel_sum_kernel", "att_group_")):
            short = key[key.find("ng"):] if "::ng" in key else key
            print(f"      {short[:70]}: {n} launches, {ms / n:.4f} ms each")

    # the five fused decoder blocks alone, shapes recorded
    x = torch.randn(B, PATCH, PATCH, 128, device=batch["x"].device).bfloat16()
    with torch.inference_mode():
        for blk in model.out_block:  # warm-up
            blk(x)
        torch.cuda.synchronize()
        with profile(activities=acts, record_shapes=True) as prof:
            y = x
            for blk in model.out_block:
                y = blk(y)
            torch.cuda.synchronize()
    kinds, _, _ = device_time_by_kind(prof, EVAL_KINDS)
    busy = sum(t for t, _ in kinds.values())
    parts = ", ".join(f"{k} {t:.3f} ms / {n}" for k, (t, n) in
                      sorted(kinds.items(), key=lambda kv: -kv[1][0]))
    print(f"  the {len(model.out_block)} fused decoder blocks alone on [{B},{PATCH},{PATCH},128] "
          f"bf16: device busy {busy:.3f} ms: {parts}")
    whole_map = B * PATCH * PATCH * 128
    eager = [(e.name, e.input_shapes) for e in prof.events()
             if e.name in ("aten::gelu", "aten::mean", "aten::sum")
             and any(len(sh) and int(np.prod(sh)) >= whole_map for sh in e.input_shapes or [])]
    print(f"    eager GELU, mean or sum over a whole map in the blocks: {eager[:4] or 'none'}")
    return found, eager


def phase3_references(dev, cfg, model, batch):
    from uncrtaints_tpu_torch.models import get_generator
    from uncrtaints_tpu_torch.ops import mbconv
    from uncrtaints_tpu_torch.train import make_eval_step

    step = make_eval_step(cfg)
    fused = step(model, batch)
    off = get_generator(cfg.replace(fused_eval="off"), device=dev)
    off.load_state_dict(model.state_dict())
    n = mbconv.norm_gelu_matmul.launches, mbconv.norm_gelu_dwconv3x3.launches
    std = step(off, batch)
    check((mbconv.norm_gelu_matmul.launches, mbconv.norm_gelu_dwconv3x3.launches) == n,
          "fused_eval=off launched K3 or K4")
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

    # the other UnCRtainTS variants run on the device too: residual blocks,
    # the full L-TAE with include_v, separate mean and variance heads
    variant = derive(Config(use_sar=True, scale_by=10.0, block_type="residual", use_v=True,
                            separate_out=True, encoder_widths=[32], decoder_widths=[32, 32],
                            n_head=4, d_model=64, low_res_size=8, compute_dtype="float32"))
    vstep = make_eval_step(variant)
    g = vstep(seeded_model(variant, dev), batch_to_device(nb, dev))
    c = vstep(seeded_model(variant, torch.device("cpu")), batch_to_device(nb, "cpu"))
    for k in ("pred", "var"):
        rmse = float((g[k].cpu() - c[k]).square().mean().sqrt())
        print(f"phase 3: residual + use_v + separate_out, card vs CPU, fp32 2x3x32x32, {k}: "
              f"RMSE {rmse:.4g} (<= 1e-3)")
        check(finite(g[k]) and rmse <= 1e-3, f"card/CPU gap of the variant model in {k}")
    return off


def phase_scene(dev, cfg, model, off):
    """Whole-scene inference of the paper recipe at full width: the fused
    path on a 1024x1024 scene, against the eval step on one window and
    against the standard path on the whole scene."""
    from uncrtaints_tpu_torch.data import SyntheticSEN12MSCRTS, collate_multi
    from uncrtaints_tpu_torch.infer import predict_scene
    from uncrtaints_tpu_torch.ops import aggregate, dwconv, dwgrad, mbconv
    from uncrtaints_tpu_torch.train import batch_to_device, make_eval_step

    S, tile, overlap, bs = 1024, PATCH, 64, B
    nb = collate_multi([SyntheticSEN12MSCRTS(n_samples=1, n_input_t=T, patch_size=S,
                                             seed=SEED + 6)[0]], use_sar=True)
    scene, dates = nb["x"][0], nb["dates"][0]
    kernels = {"K1": aggregate.att_group_aggregate, "K3": mbconv.norm_gelu_matmul,
               "K4": mbconv.norm_gelu_dwconv3x3, "K1-bwd": aggregate.att_group_aggregate_bwd,
               "K5": dwconv.dw_stencil, "K2": dwgrad.dw_kernel_grad}
    kw = dict(tile=tile, overlap=overlap, batch_size=bs)
    predict_scene(model, cfg, scene[:, :tile, :tile], dates, **kw)  # warm-up
    for f in kernels.values():
        f.launches = 0
    mbconv.norm_gelu_matmul.wgmma_launches = 0
    t0 = time.perf_counter()
    out = predict_scene(model, cfg, scene, dates, **kw)
    sec = time.perf_counter() - t0
    counts = {k: f.launches for k, f in kernels.items()}
    n_win, n_fwd = 25, 7
    print(f"scene phase: paper recipe (bf16), T={T}, {S}x{S}x{scene.shape[-1]}, tile {tile}, "
          f"overlap {overlap}, batches of {bs}: {n_win} windows in {n_fwd} forwards, "
          f"launches {counts}")
    print(f"  {sec * 1e3:.1f} ms for the scene (host tiling and blend included): "
          f"{n_win / sec:.2f} windows/s, {S * S / sec / 1e6:.3f} Mpixel/s")
    want = {"K1": n_fwd, "K3": 10 * n_fwd, "K4": 5 * n_fwd, "K1-bwd": 0, "K5": 0, "K2": 0}
    check(counts == want, f"scene launches {counts}, expected {want}")
    check(mbconv.norm_gelu_matmul.wgmma_launches == counts["K3"],
          "a K3 launch of the scene did not run the wgmma kernel")
    for k in ("pred", "var"):
        check(out[k].shape == (1, S, S, 13), f"scene {k} shape {out[k].shape}")
        check(bool(np.isfinite(out[k]).all()), f"scene {k} not finite")
    check(bool((out["var"] > 0).all()), "scene variance not positive")

    # one window: the scene path is the eval step's forward (same shapes,
    # same kernels), so the two agree to the bit or within 1e-6
    one = predict_scene(model, cfg, scene[:, :tile, :tile], dates, tile=tile,
                        overlap=overlap, batch_size=1)
    batch = {"x": scene[None, :, :tile, :tile], "dates": dates[None],
             "y": np.zeros((1, 1, tile, tile, 13), np.float32)}
    direct = make_eval_step(cfg)(model, batch_to_device(batch, dev))
    for k in ("pred", "var"):
        gap = float(np.abs(one[k] - direct[k][:, 0].cpu().numpy()).max())
        print(f"  single window vs the eval step, {k}: max abs {gap:.3g} (<= 1e-6)")
        check(gap <= 1e-6, f"single-window scene differs from the eval step in {k}")

    std = predict_scene(off, cfg, scene, dates, **kw)
    for k in ("pred", "var"):
        d, top = np.abs(out[k] - std[k]), float(np.abs(std[k]).max())
        mx, rmse = float(d.max()), float(np.sqrt((d ** 2).mean()))
        print(f"  fused vs standard scene, {k}: max {mx:.4g} (<= {0.02 * top:.4g}), "
              f"RMSE {rmse:.4g} (<= {5e-3 * top:.4g})")
        check(mx <= 0.02 * top and rmse <= 5e-3 * top, f"fused/standard scene gap in {k}")
    return counts


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
               "K3": mbconv.norm_gelu_matmul, "K4": mbconv.norm_gelu_dwconv3x3}
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
    per_step = {"K1": 1, "K1-bwd": 1, "K5": 12, "K2": 6, "K3": 0, "K4": 0}
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
    profile_train_step(step, state, batches[0], gen)
    return counts, ms


# device kernels of a train step by kind: the first fragment found in a
# kernel's name decides (the hand-written kernels first; a GELU or a copy is
# an elementwise kernel by name, so they come before it)
KERNEL_KINDS = (
    ("reflect pad", ("reflection_pad",)),
    ("K5 depthwise stencil", ("dw_tile_kernel", "dw_direct_kernel", "dw_adjoint_frame_kernel")),
    ("K2 depthwise weight gradient", ("dw_grad_",)),
    ("K1 and K1-bwd", ("att_group_",)),
    ("GEMMs", ("gemm", "cutlass", "xmma", "nvjet", "cublas", "splitK")),
    ("reductions", ("reduce_kernel",)),
    ("GELU", ("gelu", "Gelu")),
    ("dtype and layout copies", ("copy", "Copy", "CatArray", "Memcpy")),
    ("Adam (_foreach)", ("multi_tensor_apply",)),
    ("elementwise", ("elementwise",)),
)


def profile_train_step(step, state, batch, gen, paper_recipe=True, step_ms=None):
    """One more train step under ``torch.profiler``; prints the device time
    by kind (and, given the unprofiled ``step_ms``, the device's idle share
    and the largest kernels). For the paper recipe it fails if a reflect-pad
    kernel runs or K5 or K2 is missing (U-TAE pads its 3x3 convolutions for
    cuDNN)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, batch, gen)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
    kinds, names, others = device_time_by_kind(prof, KERNEL_KINDS)
    busy = sum(t for t, _ in kinds.values())
    check(busy > 0, "the profiler recorded no device time")
    idle = f"; against the unprofiled step of {step_ms:.2f} ms the device idles " \
           f"{1 - busy / step_ms:.1%}" if step_ms else ""
    print(f"  profile of one train step ({host_ms:.1f} ms on the host under the profiler): "
          f"device busy {busy:.2f} ms in {sum(n for _, n in kinds.values())} kernels{idle}")
    for kind, (t, n) in sorted(kinds.items(), key=lambda kv: -kv[1][0]):
        print(f"    {kind}: {t:.3f} ms, {n} launches")
    print(f"    the largest of 'other': {others}")
    if not paper_recipe:
        top = sorted(names.items(), key=lambda kv: -kv[1][1])[:6]
        print("    the largest kernels: " + "; ".join(f"{k[:64]} x{n} {ms:.3f} ms"
                                                     for k, (n, ms) in top))
        return
    check("reflect pad" not in kinds, "the train step ran a reflection_pad kernel: "
          "the differentiated reflect depthwise conv must not pad")
    check(kinds.get("K5 depthwise stencil", (0, 0))[1] >= 12
          and kinds.get("K2 depthwise weight gradient", (0, 0))[1] >= 12,
          f"the profile misses K5 or K2 kernels: {kinds}")


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


class count_syncs:
    """Record the host synchronizations PyTorch reports while the block
    runs (``torch.cuda.set_sync_debug_mode("warn")``): ``by_line`` counts
    them by the Python line that made them."""

    def __enter__(self):
        self._catch = warnings.catch_warnings(record=True)
        self._seen = self._catch.__enter__()
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        self.by_line = collections.Counter()
        return self

    def __exit__(self, *exc):
        torch.cuda.set_sync_debug_mode("default")
        for w in self._seen:
            if "synchroniz" in str(w.message):
                self.by_line[f"{os.path.basename(w.filename)}:{w.lineno}"] += 1
        return self._catch.__exit__(*exc)

    @property
    def n(self):
        return sum(self.by_line.values())


def kernel_wrappers():
    """The six kernels' wrappers by counter name (each counts its launches)."""
    from uncrtaints_tpu_torch.ops import aggregate, dwconv, dwgrad, mbconv
    return {"K1": aggregate.att_group_aggregate, "K1-bwd": aggregate.att_group_aggregate_bwd,
            "K5": dwconv.dw_stencil, "K2": dwgrad.dw_kernel_grad,
            "K3": mbconv.norm_gelu_matmul, "K4": mbconv.norm_gelu_dwconv3x3}


def native_vs_numpy(label, ds, cfg, native):
    """The loader alone over ``ds`` with the single-pass collate's native
    slab writers and with the generic collate (``--no_fast_collate``), in
    turns (native, numpy, numpy, native; 4 threads): sequences/s of each
    into ``native[label]``, and every batch byte-equal between the two."""
    from uncrtaints_tpu_torch.data import BatchLoader, select_collate
    runs = {"native": [], "numpy": []}
    batches = {}
    for kind in ("native", "numpy", "numpy", "native"):
        collate = select_collate(cfg.replace(fast_collate=kind == "native"))
        t0 = time.perf_counter()
        got = list(BatchLoader(ds, batch_size=B, collate=collate, num_workers=4,
                               drop_last=False))
        runs[kind].append(len(ds) / (time.perf_counter() - t0))
        batches.setdefault(kind, got)
    for i, (a, b) in enumerate(zip(batches["native"], batches["numpy"])):
        for k in ("x", "y", "dates", "masks"):
            check(a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes(),
                  f"{label}: batch {i} {k} differs between the native and the numpy collate")
    native[label] = {k: statistics.mean(v) for k, v in runs.items()}
    print(f"  the loader alone, {label} ({len(ds)} samples, 4 threads): native slab writers "
          f"{native[label]['native']:.2f}, --no_fast_collate {native[label]['numpy']:.2f} "
          f"sequences/s (mean of 2 each); the batches byte-equal")


def chain_launches(train_steps, eval_forwards):
    """The launches a run of that many train steps and eval forwards makes."""
    return {"K1": train_steps + eval_forwards, "K1-bwd": train_steps, "K5": 12 * train_steps,
            "K2": 6 * train_steps, "K3": 10 * eval_forwards, "K4": 5 * eval_forwards}


def phase6_cli(dev, eval_ms, train_ms, tmp, native):
    """The train and test CLIs at the paper recipe's full width, in the
    directory ``tmp`` (phase 8 fuses its test exports with a second
    member's); returns the launches of the chain."""
    from uncrtaints_tpu_torch.cli import test as cli_test, train as cli_train
    from uncrtaints_tpu_torch.config import Config, apply_resume, derive
    from uncrtaints_tpu_torch.data import (BatchLoader, Subset, SyntheticSEN12MSCRTS,
                                           select_collate)
    from uncrtaints_tpu_torch.models import get_generator
    from uncrtaints_tpu_torch.train import (create_train_state, epoch_lr, make_eval_step,
                                            make_train_step)
    from uncrtaints_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
    from uncrtaints_tpu_torch.train.loop import _device_batches, iterate

    print("phase 6: optional packages on this machine: " + ", ".join(
        f"{m} {'found' if importlib.util.find_spec(m) else 'missing'}"
        for m in ("tensorboard", "matplotlib")))
    kernels = kernel_wrappers()
    n_samples, gamma = 8, 0.8
    n_batches = math.ceil(n_samples / B)
    res = os.path.join(tmp, "results")
    exp = os.path.join(res, "smoke")

    def recipe(**kw):  # the paper recipe, as the train CLI's flags would give it
        return derive(Config(
            use_sar=True, scale_by=10.0, gamma=gamma, synthetic_data=True,
            synthetic_patch=PATCH, batch_size=B, input_t=T, max_samples_count=n_samples,
            num_workers=4, plot_every=-1, export_every=4, res_dir=res,
            experiment_name="smoke", **kw))

    cfg = recipe(epochs=1)
    check(cfg.device == "cuda" and cfg.compute_dtype == "bfloat16"
          and cfg.encoder_widths == [128] and cfg.decoder_widths == [128] * 5,
          "phase 6 runs the paper recipe at full width on the card")
    for f in kernels.values():
        f.launches = 0
    t0 = time.perf_counter()
    first = cli_train.main(cfg)
    ckpt1 = os.path.join(exp, "model_epoch_1.pth.tar")
    resumed = apply_resume(recipe(epochs=2, resume_from=True, trained_checkp=ckpt1,
                                  resume_at=1))
    second = cli_train.main(resumed)
    argv = ["--experiment_name", "smoke", "--weight_folder", res, "--res_dir",
            os.path.join(tmp, "inference"), "--max_samples_count", str(n_samples),
            "--batch_size", str(B), "--input_t", str(T), "--num_workers", "4",
            "--export_every", "4"]
    tests = [cli_test.main(cli_test.load_test_config(argv)) for _ in range(2)]
    chain_s = time.perf_counter() - t0
    counts = {k: f.launches for k, f in kernels.items()}

    train_steps = 2 * n_batches
    evals = (2 * 2 + 2) * n_batches  # a val and a test epoch per train run, two test runs
    want = chain_launches(train_steps, evals)
    print(f"phase 6: cli.train (1 epoch), cli.train resumed to 2 epochs, cli.test twice, paper "
          f"recipe (bf16), {n_samples} samples a split in batches of {B}: {chain_s:.1f} s, "
          f"{train_steps} train steps and {evals} eval forwards, launches {counts}")
    check(counts == want, f"the CLI chain launched {counts}, expected {want}")

    files = ["conf.json", "trainlog.json", "model.pth.tar", "model_epoch_1.pth.tar",
             "model_epoch_2.pth.tar", "test_metrics.json", "val_epoch_1_metrics.json",
             "val_epoch_2_metrics.json"]
    files += [os.path.join("export", f"epoch_{e}", mode, f"img-{i}_{m}.npy")
              for e, mode in ((1, "val"), (1, "test"), (2, "val"), (2, "test"))
              for i in (0, 4) for m in ("pred", "target", "covar")]
    missing = [f for f in files if not os.path.isfile(os.path.join(exp, f))]
    check(not missing, f"files the CLI chain did not write: {missing}")
    covar = np.load(os.path.join(exp, "export", "epoch_2", "test", "img-4_covar.npy"))
    check(covar.shape == (13, 13, PATCH, PATCH) and bool(np.isfinite(covar).all()),
          f"exported covar {covar.shape}")
    with open(os.path.join(exp, "test_metrics.json")) as f:
        tm = json.load(f)
    names = ("RMSE", "MAE", "PSNR", "SAM", "SSIM", "mean var", "UCE SE", "AUCE SE")
    check(all(k in tm for k in names) and all(np.isfinite(v) for v in tm.values()),
          f"test_metrics.json {tm}")
    print(f"  test_metrics.json: { {k: round(v, 6) for k, v in tm.items()} }")
    check(tests[0] == tests[1], f"two cli.test runs differ: {tests}")
    check(tests[0] == second["test"],
          f"cli.test {tests[0]} differs from the train run's final test {second['test']}")
    check(tm == {k: float(v) for k, v in second["test"].items()},
          "test_metrics.json is not the train run's final test")
    print("  two cli.test runs and the train run's final test on model.pth.tar: equal to the bit")

    # the resumed epoch: Adam's count and the step go on, the lr is the schedule's
    one = torch.load(ckpt1, weights_only=True)
    two = torch.load(os.path.join(exp, "model_epoch_2.pth.tar"), weights_only=True)
    got = [(c["epoch"], c["step"], c["optimizer_G"]["count"], c["lr"]) for c in (one, two)]
    want_lr = [epoch_lr(cfg, 0), epoch_lr(resumed, 1)]
    print(f"  checkpoints (epoch, step, Adam count, lr): {got}; the schedule's lr {want_lr}")
    check(got == [(1, n_batches, n_batches, want_lr[0]),
                  (2, 2 * n_batches, 2 * n_batches, want_lr[1])]
          and want_lr[1] == cfg.lr * gamma, "the resumed epoch's step, count or lr")
    check(set(map(int, second["trainlog"])) == {2} and set(map(int, first["trainlog"])) == {1},
          "the resumed run trained other epochs than the second")
    with open(os.path.join(exp, "trainlog.json")) as f:
        log2 = json.load(f)["2"]
    check(all(np.isfinite(v) for v in log2.values()), f"trainlog.json {log2}")

    # ---- after the counted chain: what only a card runs
    rcfg = resumed.replace(export_every=-1)
    state = create_train_state(rcfg, get_generator(rcfg))
    state, meta = load_checkpoint(rcfg, res, state, "model_epoch_2")
    check(meta["epoch"] == 2 and state.step == 2 * n_batches
          and {p.device.type for p in state.model.parameters()} == {"cuda"},
          "load_checkpoint on the card")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    path = save_checkpoint(rcfg.replace(experiment_name="round"), 2, state, "trip", 1e-3)
    save_ms = (time.perf_counter() - t0) * 1e3
    print(f"  one save_checkpoint (model, moments, {os.path.getsize(path) / 2**20:.1f} MiB): "
          f"{save_ms:.1f} ms")
    fresh = create_train_state(rcfg, get_generator(rcfg.replace(rdm_seed=7)))
    fresh, _ = load_checkpoint(rcfg.replace(experiment_name="round"), res, fresh, "trip")
    ds = SyntheticSEN12MSCRTS(n_samples=32, n_input_t=T, patch_size=PATCH, seed=SEED + 8)
    mk_loader = lambda n=None: BatchLoader(
        Subset(ds, range(n or len(ds))), batch_size=B, collate=select_collate(rcfg),
        num_workers=4, drop_last=False)
    eval_step = make_eval_step(rcfg, with_metrics=True)
    _, dev_batch = next(iter(_device_batches(mk_loader(), dev, False)))
    a, b = eval_step(state.model, dev_batch), eval_step(fresh.model, dev_batch)
    same = (torch.equal(a["loss"], b["loss"]) and torch.equal(a["pred"], b["pred"])
            and torch.equal(a["var"], b["var"])
            and all(torch.equal(a["metrics"][k], b["metrics"][k]) for k in a["metrics"]))
    check(same and all(torch.equal(m, fresh.opt_state.mu[n]) for n, m in
                       state.opt_state.mu.items()),
          "save -> fresh model -> load changes the eval step or the moments")
    print("  checkpoint round trip on the card (save, fresh model, load, one eval step): "
          "equal to the bit")

    # the side-stream prefetch hands out the host's batches, with the
    # consumer's stream kept busy while the next copy runs
    n_seen = 0
    for host, devb in _device_batches(mk_loader(), dev, True):
        torch.cuda._sleep(SPIN_CYCLES)
        for k, v in devb.items():  # the host batch also holds its rows' ids
            check(torch.equal(v.cpu(), torch.from_numpy(host[k])),
                  f"prefetched batch {n_seen}: {k} differs from the host's")
        n_seen += 1
    check(n_seen == len(ds) // B, f"the prefetch handed out {n_seen} of {len(ds) // B} batches")

    def epoch(mode, prefetch, samples=None, **step):
        model_state = create_train_state(rcfg, get_generator(rcfg))
        load_checkpoint(rcfg, res, model_state, "model_epoch_2")
        with count_syncs() as syncs:
            _, m, img = iterate(model_state, mk_loader(samples), rcfg, None, mode, 3,
                                prefetch=prefetch, **step)
        return m, img, syncs

    eval_step = make_eval_step(rcfg, with_metrics=True,
                               return_outputs=cli_train.need_outputs(rcfg))
    train_step = make_train_step(rcfg)
    t0 = time.perf_counter()
    n_loaded = sum(len(b["y"]) for b in mk_loader())
    loader_s = time.perf_counter() - t0
    check(n_loaded == len(ds), f"the loader yielded {n_loaded} of {len(ds)} samples")
    print(f"  the loader alone (synthetic source, single-pass collate, 4 threads), {n_loaded} "
          f"samples: {loader_s * 1e3:.1f} ms, {n_loaded / loader_s:.2f} sequences/s")
    native_vs_numpy("phase 6, synthetic source", ds, rcfg, native)
    epoch("val", True, eval_step=eval_step)  # warm-up of the loop's own shapes
    # with the prefetch, without, without, with: the host's load drifts
    order = (True, False, False, True)
    val = [epoch("val", p, eval_step=eval_step) for p in order]
    train = [epoch("train", p, train_step=train_step) for p in order]
    for (m, img, _) in val[1:]:
        check(m["val_loss"] == val[0][0]["val_loss"] and img == val[0][1],
              f"val epoch with the prefetch {val[0][:2]} and without {m, img}")
    # a train step's backward sums with atomics (the bilinear upsample's),
    # so only the first step of an epoch repeats to the bit; later steps
    # drift apart (1e-4 of the loss after 8 steps at this lr), while a
    # wrong or stale batch would move the loss by percents
    first = [epoch("train", p, train_step=train_step, samples=B)[0]["train_loss"]
             for p in (True, False)]
    check(first[0] == first[1], f"one-step train epoch with the prefetch and without {first}")
    losses = [m["train_loss"] for m, _, _ in train]
    rel = max(abs(v / losses[0] - 1) for v in losses)
    check(rel <= 5e-3, f"train epoch losses with and without the prefetch {losses}")
    print(f"  prefetch on, off, off, on, {len(ds)} samples: val epoch loss and every metric "
          f"equal to the bit; a one-step train epoch equal to the bit; the 8-step train "
          f"epochs' losses within {rel:.3g} (<= 5e-3; bit-equal {len(set(losses)) == 1})")
    n = len(ds)
    for mode, runs, bare in (("train", train, train_ms), ("val", val, eval_ms)):
        ms = [m[f"{mode}_epoch_time"] * 1e3 for m, _, _ in runs]
        on, off = (ms[0] + ms[3]) / 2, (ms[1] + ms[2]) / 2
        print(f"  {mode} epoch through the loader and the loop, {n} samples, prefetch on, off, "
              f"off, on: {', '.join(f'{t:.1f}' for t in ms)} ms; on {n / on * 1e3:.2f}, off "
              f"{n / off * 1e3:.2f} sequences/s; the bare "
              f"{mode if mode == 'train' else 'eval'} step of phase "
              f"{4 if mode == 'train' else 2}: {bare:.2f} ms, {B / bare * 1e3:.2f} sequences/s")
        syncs = runs[0][2]
        print(f"  host synchronizations in the {mode} epoch ({n // B} steps): {syncs.n}, by "
              f"line {dict(syncs.by_line)}")
    cli_epochs = {k: round(n_samples / v, 2) for k, v in log2.items() if k.endswith("_time")}
    print(f"  the CLI's own second epoch ({n_samples} samples, trainlog.json), sequences/s: "
          f"{cli_epochs}")
    return counts


# phase 7's SEN12MS-CR-TS tree: 4 patches in a train, a val and a test ROI of
# the official splits, the test ROI deflate-compressed (S2 with the predictor)
REAL_ROIS = {"ROIs1868/114": range(4), "ROIs1868/17": range(4), "ROIs1158/106": range(4)}
DEFLATE_ROI = "ROIs1158/106"
THRESHOLD_MASKS = "cloud_cloudshadow_mask"


def phase7_real_data(dev, eval_ms, train_ms, native):
    """The real-data path on a SEN12MS-CR-TS tree written in a temporary
    directory: the masks card against CPU, cli.precompute, cli.train and
    cli.test, cli.test --use_custom and the default detector without its
    weights. Returns the launches of the CLI runs."""
    from uncrtaints_tpu_torch.cli import precompute, test as cli_test, train as cli_train
    from uncrtaints_tpu_torch.cli.test import CUSTOM_DATES, CUSTOM_PATCHES
    from uncrtaints_tpu_torch.config import apply_resume, derive, parse_config
    from uncrtaints_tpu_torch.data import BatchLoader, get_cloud_map, masks, select_collate
    from uncrtaints_tpu_torch.data.sen12mscrts import SEN12MSCRTS, read_tif_bounds, read_tif_img
    from uncrtaints_tpu_torch.data.synthetic_tree import write_sen12mscrts_tree
    from uncrtaints_tpu_torch.models import get_generator
    from uncrtaints_tpu_torch.train import create_train_state, make_eval_step, make_train_step
    from uncrtaints_tpu_torch.train.checkpoint import load_checkpoint
    from uncrtaints_tpu_torch.train.loop import iterate

    kernels = kernel_wrappers()
    with tempfile.TemporaryDirectory() as tmp:
        # ---- (a) the tree, written with the port's TIFF writer
        root, custom_root = os.path.join(tmp, "SEN12MSCRTS"), os.path.join(tmp, "custom")
        t0 = time.perf_counter()
        size = write_sen12mscrts_tree(root, REAL_ROIS, hw=PATCH, deflate=[DEFLATE_ROI], seed=SEED)
        size += write_sen12mscrts_tree(custom_root, {"ROIs1868/73": CUSTOM_PATCHES}, hw=PATCH,
                                       time_points=sorted(CUSTOM_DATES), dates=CUSTOM_DATES,
                                       seed=SEED)
        print(f"phase 7: a SEN12MS-CR-TS tree of {PATCH}x{PATCH} patches, 30 time points, "
              f"{', '.join(f'{r} x{len(p)}' for r, p in REAL_ROIS.items())} ({DEFLATE_ROI} "
              f"deflate), and ROIs1868/73 x{len(CUSTOM_PATCHES)} at time points "
              f"{sorted(CUSTOM_DATES)}: {size / 2**30:.2f} GiB in "
              f"{time.perf_counter() - t0:.1f} s")

        # ---- (b) the 30-frame stack of one patch, masked on the card and on the CPU
        raw = SEN12MSCRTS(root, split="train", cloud_masks=None, device=dev).get_imgs(0)[1]
        stack = np.moveaxis(np.stack(raw), 1, -1)  # [30, H, W, 13] raw DN
        on_card, ms_card = [], []
        for _ in range(6):
            t0 = time.perf_counter()
            on_card.append(get_cloud_map(stack, THRESHOLD_MASKS, device=dev))
            ms_card.append((time.perf_counter() - t0) * 1e3)
        on_device = torch.from_numpy(stack).to(dev)
        device_ms = time_ms(lambda: masks.get_cloud_cloudshadow_mask(on_device), runs=7)
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            masks.get_cloud_cloudshadow_mask(on_device)
            torch.cuda.synchronize()
        del on_device
        names = device_time_by_kind(prof, ())[1]
        top = sorted(names.items(), key=lambda kv: -kv[1][1])[:4]
        t0 = time.perf_counter()
        on_cpu = get_cloud_map(stack, THRESHOLD_MASKS, device="cpu")
        ms_cpu = (time.perf_counter() - t0) * 1e3
        differ = int((on_card[0] != on_cpu).sum())
        cov = on_cpu.mean(axis=(1, 2))
        print(f"  masks of a 30-frame stack [{', '.join(map(str, stack.shape))}]: card "
              f"{statistics.median(ms_card[1:]):.1f} ms (median of 5 after one warm-up, host "
              f"clock, the copies included; the masks alone on a stack already on the card "
              f"{device_ms:.2f} ms, CUDA events), CPU {ms_cpu:.1f} ms; {differ} of "
              f"{on_cpu.size} pixels differ; coverage per frame {cov.min():.3f}.."
              f"{cov.max():.3f}, {int((cov < 1e-3).sum())} frames clear")
        print(f"    the masks under torch.profiler: {sum(n for n, _ in names.values())} kernels, "
              f"device busy {sum(ms for _, ms in names.values()):.2f} ms; the largest: "
              + "; ".join(f"{k[:48]} x{n} {ms:.2f} ms" for k, (n, ms) in top))
        check(all(np.array_equal(m, on_card[0]) for m in on_card), "masks on the card repeat")
        check(on_card[0].shape == on_cpu.shape and differ <= 1e-4 * on_cpu.size,
              f"card and CPU masks differ in {differ} of {on_cpu.size} pixels")
        check(cov.min() < 1e-3 and cov.max() > 0.05, f"coverage per frame {cov}")

        # ---- (c) cli.precompute on the train split, on the card and on the CPU
        pre = {}
        for where in (dev.type, "cpu"):
            args = precompute.create_parser().parse_args(
                ["--root", root, "--split", "train", "--cloud_masks", THRESHOLD_MASKS,
                 "--out_dir", os.path.join(tmp, f"precomputed_{where}"), "--device", where])
            t0 = time.perf_counter()
            pre[where] = np.load(precompute.main(args), allow_pickle=True).item()
            sec = time.perf_counter() - t0
            print(f"  cli.precompute --device {where}, {len(pre[where])} train patches: "
                  f"{sec:.2f} s, {len(pre[where]) / sec:.2f} patches/s")
        a, b = pre[dev.type], pre["cpu"]
        gap = max(float(np.abs(a[k]["coverage"] - b[k]["coverage"]).max()) for k in a)
        check(sorted(a) == sorted(b) == list(range(len(REAL_ROIS["ROIs1868/114"])))
              and all(a[k]["paths"] == b[k]["paths"] for k in a) and gap <= 1e-6,
              f"precompute card vs CPU: coverage gap {gap}")
        print(f"  precompute card vs CPU: the same patches and paths, coverage within {gap:.3g}")

        # ---- (d) cli.train one epoch on the tree with the statistics, then cli.test
        res = os.path.join(tmp, "results")
        common = ["--batch_size", str(B), "--input_t", str(T), "--num_workers", "4",
                  "--plot_every", "-1", "--export_every", "4", "--device", dev.type]
        argv = ["--experiment_name", "real", "--res_dir", res, "--root1", root, "--root2", root,
                "--precomputed", os.path.join(tmp, f"precomputed_{dev.type}"), "--use_sar",
                "--scale_by", "10", "--epochs", "1"] + common
        cfg = apply_resume(derive(parse_config(argv + ["--cloud_masks", THRESHOLD_MASKS])))
        check(cfg.device == dev.type and cfg.compute_dtype == "bfloat16" and not cfg.synthetic_data
              and cfg.encoder_widths == [128] and cfg.decoder_widths == [128] * 5,
              "phase 7 runs the paper recipe at full width on the card")
        for f in kernels.values():
            f.launches = 0
        t0 = time.perf_counter()
        out = cli_train.main(cfg)
        tested = cli_test.main(cli_test.load_test_config(
            ["--experiment_name", "real", "--weight_folder", res, "--res_dir",
             os.path.join(tmp, "inference"), "--root1", root, "--root2", root] + common))
        chain_s = time.perf_counter() - t0
        counts = {k: f.launches for k, f in kernels.items()}
        n_split = len(REAL_ROIS["ROIs1868/114"])
        steps = math.ceil(n_split / B)
        want = chain_launches(steps, 3 * steps)  # val and test in cli.train, cli.test
        print(f"  cli.train (1 epoch, the train split's statistics imported) and cli.test: "
              f"{chain_s:.1f} s, {steps} train step(s) and {3 * steps} eval forwards, "
              f"launches {counts}")
        check(counts == want, f"the real-data chain launched {counts}, expected {want}")
        exp = os.path.join(res, "real")
        files = ["conf.json", "trainlog.json", "model.pth.tar", "model_epoch_1.pth.tar",
                 "test_metrics.json", "val_epoch_1_metrics.json"]
        files += [os.path.join("export", "epoch_1", mode, f"img-0_{m}.npy")
                  for mode in ("val", "test") for m in ("pred", "target", "covar")]
        missing = [f for f in files if not os.path.isfile(os.path.join(exp, f))]
        check(not missing, f"files the real-data chain did not write: {missing}")
        names = ("RMSE", "MAE", "PSNR", "SAM", "SSIM", "mean var", "UCE SE", "AUCE SE")
        check(all(k in tested and np.isfinite(tested[k]) for k in names),
              f"cli.test metrics {tested}")
        check(tested == out["test"], f"cli.test {tested} differs from cli.train's test "
                                     f"{out['test']}")
        print(f"  cli.test on the tree: { {k: round(v, 6) for k, v in tested.items()} }, equal "
              f"to the bit to cli.train's final test")

        # the epochs again, through the loop, with the host synchronizations by
        # line (no export, whose copies are the loop's cadence, not its steps)
        cfg = cfg.replace(export_every=-1)
        dt_train, dt_val, _ = cli_train.build_datasets(cfg)
        # where a sample's host time goes: one online val sample in this thread
        paths = [os.path.join(root, p) for m in ("S1", "S2") for p in dt_val.paths[0][m]]
        t0 = time.perf_counter()
        frames = [read_tif_img(p) for p in paths]
        decode_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        for p in paths[len(paths) // 2:]:
            read_tif_bounds(p)
        bounds_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        get_cloud_map(np.moveaxis(np.stack(frames[len(frames) // 2:]), 1, -1), THRESHOLD_MASKS,
                      device=dev)
        mask_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        dt_val[0]
        sample_ms = (time.perf_counter() - t0) * 1e3
        print(f"  one online val sample in the main thread: {sample_ms:.1f} ms, of which the "
              f"decode of its {len(paths)} GeoTIFFs {decode_ms:.1f} ms, their 30 S2 bounds "
              f"{bounds_ms:.1f} ms, the stack and its mask call {mask_ms:.1f} ms")
        mk_loader = lambda ds: BatchLoader(ds, batch_size=B, collate=select_collate(cfg),
                                           num_workers=4, drop_last=False)
        state = create_train_state(cfg, get_generator(cfg))
        state, _ = load_checkpoint(cfg, res, state, "model_epoch_1")
        runs = {"train": (dt_train, dict(train_step=make_train_step(cfg)), train_ms),
                "val": (dt_val, dict(eval_step=make_eval_step(
                    cfg, with_metrics=True, return_outputs=cli_train.need_outputs(cfg))),
                    eval_ms)}
        for mode, (ds, step, bare) in runs.items():
            t0 = time.perf_counter()
            n_loaded = sum(len(b["y"]) for b in mk_loader(ds))
            loader_s = time.perf_counter() - t0
            with count_syncs() as syncs:
                _, m, _ = iterate(state, mk_loader(ds), cfg, None, mode, 2, **step)
            # the masks' from the loader threads apart from the step loop's
            mask_lines = {k: v for k, v in syncs.by_line.items() if k.startswith("masks.py:")}
            rest = {k: v for k, v in syncs.by_line.items() if k not in mask_lines}
            n = len(ds)
            print(f"  {mode} split ({n} samples, {'imported coverage' if ds.data_pairs else 'online: 30 frames a sample'}): "
                  f"epoch {m[f'{mode}_epoch_time'] * 1e3:.1f} ms, "
                  f"{n / m[f'{mode}_epoch_time']:.2f} sequences/s; the loader alone (decode + mask "
                  f"+ collate, 4 threads) {n_loaded / loader_s:.2f} sequences/s; the bare "
                  f"{'train' if mode == 'train' else 'eval'} step {B / bare * 1e3:.2f} sequences/s")
            print(f"    host synchronizations of the step loop {sum(rest.values())}, by line "
                  f"{rest}; of the masks in the loader threads {sum(mask_lines.values())}, "
                  f"by line {mask_lines}")
            check(n_loaded == n and sum(rest.values()) == 1
                  and all(k.startswith("loop.py:") for k in rest),
                  f"the {mode} epoch's step loop synchronized {rest}")
        for mode, (ds, _, _) in runs.items():
            native_vs_numpy(f"phase 7, the tree's {mode} split", ds, cfg, native)
        log = {k: round(n_split / v, 2) for k, v in out["trainlog"][1].items()
               if k.endswith("_time")}
        print(f"  cli.train's own epoch ({n_split} samples a split, trainlog), sequences/s: {log}")

        # ---- (e) cli.test --use_custom: the 3x3 mosaic of ROIs1868/73
        for f in kernels.values():
            f.launches = 0
        t0 = time.perf_counter()
        custom = cli_test.main(cli_test.load_test_config(
            ["--experiment_name", "real", "--weight_folder", res, "--res_dir",
             os.path.join(tmp, "custom_inference"), "--root1", custom_root, "--use_custom",
             "--input_t", str(T), "--num_workers", "4", "--export_every", "1", "--device",
             dev.type]))
        custom_s = time.perf_counter() - t0
        custom_counts = {k: f.launches for k, f in kernels.items()}
        pred = np.load(os.path.join(tmp, "custom_inference", "real", "export", "epoch_1", "test",
                                    "img-0_pred.npy"))
        side = 3 * PATCH
        print(f"  cli.test --use_custom ({side}x{side} mosaic): {custom_s:.1f} s, launches "
              f"{custom_counts}, RMSE {custom['RMSE']:.6f}")
        check(custom_counts == chain_launches(0, 1),
              f"--use_custom launched {custom_counts}")
        check(pred.shape == (13, side, side) and bool(np.isfinite(pred).all())
              and all(np.isfinite(custom[k]) for k in names), f"--use_custom output {pred.shape}")

        # ---- (f) the default detector without its weights: a hard error
        saved = {k: os.environ.get(k) for k in ("S2CLOUDLESS_MODEL_PATH", "XDG_CACHE_HOME")}
        os.environ["S2CLOUDLESS_MODEL_PATH"] = os.path.join(tmp, "absent.txt")
        os.environ["XDG_CACHE_HOME"] = tmp
        masks._S2C_CACHE.update(detector=None, tried=False)
        dcfg = apply_resume(derive(parse_config(
            [a if a != "real" else "default_detector" for a in argv])))
        check(dcfg.cloud_masks == "s2cloudless_mask", "the default detector is s2cloudless")
        error = None
        try:
            cli_train.main(dcfg)
        except RuntimeError as e:
            error = str(e)
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k)
                else:
                    os.environ[k] = v
            masks._S2C_CACHE.update(detector=None, tried=False)
        check(error is not None and "s2cloudless LightGBM weights" in error,
              f"cli.train without the s2cloudless weights: {error or 'no error'}")
        check(not os.path.exists(os.path.join(res, "default_detector", "trainlog.json")),
              "an epoch ran without the s2cloudless weights")
        print("  cli.train with the default --cloud_masks s2cloudless_mask and no weights: "
              "the hard error, no epoch")
    return {k: counts[k] + custom_counts[k] for k in counts}


# phase 8: U-TAE at its published widths (UTAE's own defaults), through the CLIs
UTAE_FLAGS = ["--model", "utae", "--encoder_widths", "[64,64,64,128]",
              "--decoder_widths", "[32,32,64,128]", "--out_conv", "[13]", "--n_head", "16",
              "--d_model", "256", "--d_k", "4", "--use_sar"]
# every other family at the JAX package's default widths; the MSE loss, as the
# JAX package's tests drive them (no variance nonlinearity: a negative raw
# variance makes the MGNLL loss -inf in both packages)
FAMILIES = {"unet (pretrain)": dict(model="unet", encoder_widths=[64, 64, 64, 128],
                                    decoder_widths=[32, 32, 64, 128]),
            "unet3d": dict(model="unet3d", input_t=4), "uconvlstm": dict(model="uconvlstm"),
            "buconvlstm": dict(model="buconvlstm"), "convlstm": dict(model="convlstm"),
            "convgru": dict(model="convgru"), "fpn": dict(model="fpn")}


def exact_zero_gradients(model):
    """The parameters whose gradient is zero in exact arithmetic in a train
    step: a bias that feeds a batch norm in training (the norm takes out its
    mean) and the L-TAE's key bias (a shift of every logit of a pixel, under
    the softmax over T). Rounding leaves noise there, or an exact zero."""
    from uncrtaints_tpu_torch.models.layers import Norm2d
    from uncrtaints_tpu_torch.models.ltae import BatchNorm1d
    names = set()
    for prefix, mod in model.named_modules():
        if isinstance(mod, torch.nn.Sequential):
            kids = list(mod.children())
            for i, (a, b) in enumerate(zip(kids, kids[1:])):
                batch_norm = isinstance(b, BatchNorm1d) or (isinstance(b, Norm2d)
                                                            and b.norm == "batch")
                if batch_norm and getattr(a, "bias", None) is not None:
                    names.add(f"{prefix}.{i}.bias")
    return names | {n for n, _ in model.named_parameters()
                    if n.endswith("attention_heads.fc1_k.bias")}


def _synthetic_batches(cfg, n, patch, seed, dev):
    from uncrtaints_tpu_torch.data import (SyntheticSEN12MSCR, SyntheticSEN12MSCRTS,
                                           select_collate)
    from uncrtaints_tpu_torch.train import batch_to_device
    if cfg.pretrain:
        ds = SyntheticSEN12MSCR(n_samples=n * B, patch_size=patch, seed=seed)
    else:
        ds = SyntheticSEN12MSCRTS(n_samples=n * B, n_input_t=cfg.input_t, patch_size=patch,
                                  seed=seed)
    collate = select_collate(cfg)
    return [batch_to_device(collate([ds[i * B + j] for j in range(B)]), dev) for i in range(n)]


def _card_vs_cpu(dev, cfg, name):
    """fp32 at 32x32: one eval step and one train step of the same seeded
    model and batch on the card and on the CPU (dropout off)."""
    from uncrtaints_tpu_torch.train import create_train_state, make_eval_step, make_train_step
    small = cfg.replace(compute_dtype="float32", lr=1e-3)
    out = []
    for d in (dev, torch.device("cpu")):
        model = seeded_model(small, d)
        te = getattr(model, "temporal_encoder", None)
        if te is not None and hasattr(te, "use_dropout"):  # the two generators differ
            te.use_dropout, te.dropout = False, 0.0
        b = _synthetic_batches(small, 1, 32, SEED + 9, d)[0]
        ev = make_eval_step(small)(model, b)
        _, aux = make_train_step(small)(create_train_state(small, model), b)
        out.append((ev["pred"].cpu(), float(aux["loss"])))
    (pg, lg), (pc, lc) = out
    rmse = float((pg - pc).square().mean().sqrt())
    rel = abs(lg / lc - 1)
    print(f"  {name}: card vs CPU, fp32 {B}x{small.input_t}x32x32: eval pred RMSE {rmse:.3g} "
          f"(<= 1e-3), train loss rel {rel:.3g} (<= 1e-3)")
    check(rmse <= 1e-3 and rel <= 1e-3, f"{name}: card/CPU gap")


def phase8_utae(dev, tmp):
    """U-TAE at its published widths: cli.train one epoch and cli.test at
    256x256, B=4, T=3, bf16; the bare steps with their launches, step times,
    memory, gradients and a profile; card vs CPU. Returns the launches."""
    from uncrtaints_tpu_torch.cli import test as cli_test, train as cli_train
    from uncrtaints_tpu_torch.config import apply_resume, derive, parse_config
    from uncrtaints_tpu_torch.train import create_train_state, make_eval_step, make_train_step

    kernels = kernel_wrappers()
    res, n_samples = os.path.join(tmp, "utae_results"), 8
    argv = UTAE_FLAGS + ["--synthetic_data", "--synthetic_patch", str(PATCH), "--batch_size",
                         str(B), "--input_t", str(T), "--max_samples_count", str(n_samples),
                         "--epochs", "1", "--num_workers", "4", "--plot_every", "-1",
                         "--export_every", "4", "--res_dir", res, "--experiment_name", "utae"]
    cfg = apply_resume(derive(parse_config(argv)))
    check(cfg.device == "cuda" and cfg.compute_dtype == "bfloat16" and cfg.loss == "l2"
          and cfg.encoder_widths == [64, 64, 64, 128] and cfg.n_head == 16,
          "phase 8 runs U-TAE at its published widths on the card")
    for f in kernels.values():
        f.launches = 0
    t0 = time.perf_counter()
    out = cli_train.main(cfg)
    tested = cli_test.main(cli_test.load_test_config(
        ["--experiment_name", "utae", "--weight_folder", res, "--res_dir",
         os.path.join(tmp, "utae_inference"), "--max_samples_count", str(n_samples),
         "--batch_size", str(B), "--input_t", str(T), "--num_workers", "4"]))
    chain_s = time.perf_counter() - t0
    counts = {k: f.launches for k, f in kernels.items()}
    steps = n_samples // B
    evals = 3 * steps  # val and test in cli.train, cli.test
    want = {"K1": 3 * (steps + evals), "K1-bwd": 3 * steps, "K5": 0, "K2": 0, "K3": 0, "K4": 0}
    print(f"phase 8: U-TAE (encoder [64,64,64,128], decoder [32,32,64,128], 16 heads, d_model "
          f"256; bf16, B={B}, T={T}, {PATCH}x{PATCH}): cli.train 1 epoch and cli.test, "
          f"{chain_s:.1f} s, {steps} train steps and {evals} eval forwards, launches {counts}")
    check(counts == want, f"the U-TAE chain launched {counts}, expected {want} (3 K1 a forward, "
                          "3 K1-bwd a train step, nothing else)")
    exp = os.path.join(res, "utae")
    files = ["conf.json", "trainlog.json", "model.pth.tar", "model_epoch_1.pth.tar",
             "test_metrics.json"] + [os.path.join("export", "epoch_1", "test", f"img-{i}_{m}.npy")
                                     for i in (0, 4) for m in ("pred", "target")]
    missing = [f for f in files if not os.path.isfile(os.path.join(exp, f))]
    check(not missing, f"files the U-TAE chain did not write: {missing}")
    check(not any("_var" in f or "_covar" in f for f in os.listdir(
        os.path.join(exp, "export", "epoch_1", "test"))), "U-TAE (MSE) exported a variance")
    names = ("RMSE", "MAE", "PSNR", "SAM", "SSIM")
    check(all(np.isfinite(tested[k]) and tested[k] == out["test"][k] for k in names)
          and "UCE SE" not in tested, f"U-TAE cli.test {tested} against cli.train's {out['test']}")
    print(f"  cli.test: { {k: round(tested[k], 6) for k in names} }, equal to the bit to "
          f"cli.train's final test; no variance, no calibration")

    # the bare steps: launches per step, times, memory, gradients, profile
    model = seeded_model(cfg, dev)
    state = create_train_state(cfg, model)
    batches = _synthetic_batches(cfg, 2, PATCH, SEED + 10, dev)
    eval_step, train_step = make_eval_step(cfg, with_metrics=True), make_train_step(cfg)
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    eval_step(model, batches[0])
    train_step(state, batches[0], gen)
    torch.cuda.synchronize()
    for f in kernels.values():
        f.launches = 0
    ev_ms = []
    for i in range(6):
        t0 = time.perf_counter()
        aux = eval_step(model, batches[i % 2])
        torch.cuda.synchronize()
        ev_ms.append((time.perf_counter() - t0) * 1e3)
        check(finite(aux["pred"]) and "var" not in aux, "U-TAE eval output")
    ev_counts = {k: f.launches for k, f in kernels.items()}
    torch.cuda.reset_peak_memory_stats(dev)
    tr_ms, grads = [], None
    for i in range(4):
        t0 = time.perf_counter()
        state, aux = train_step(state, batches[i % 2], gen)
        torch.cuda.synchronize()
        tr_ms.append((time.perf_counter() - t0) * 1e3)
        check(np.isfinite(float(aux["loss"])), "U-TAE train loss not finite")
        grads = grads or {n: (bool(torch.isfinite(g).all()), float(g.abs().max()))
                          for n, g in aux["grads"].items()}
    peak = torch.cuda.max_memory_allocated(dev)
    all_counts = {k: f.launches for k, f in kernels.items()}
    tr_counts = {k: all_counts[k] - ev_counts[k] for k in all_counts}
    check(ev_counts == {"K1": 18, "K1-bwd": 0, "K5": 0, "K2": 0, "K3": 0, "K4": 0}
          and tr_counts == {"K1": 12, "K1-bwd": 12, "K5": 0, "K2": 0, "K3": 0, "K4": 0},
          f"U-TAE bare steps launched {ev_counts} in 6 eval forwards and {tr_counts} in 4 train "
          "steps (3 K1 a forward, 3 K1-bwd a train step)")
    zero_ok = exact_zero_gradients(model)
    bad = [n for n, (fin, mx) in grads.items() if not fin or (mx == 0 and n not in zero_ok)]
    zeros = sorted(n for n, (_, mx) in grads.items() if n in zero_ok)
    print(f"  bare steps: eval {statistics.median(ev_ms):.3f} ms (median of 6; "
          f"{B / statistics.median(ev_ms) * 1e3:.2f} sequences/s), train "
          f"{statistics.median(tr_ms):.3f} ms (median of 4; "
          f"{B / statistics.median(tr_ms) * 1e3:.2f} sequences/s), peak device memory of the "
          f"train steps {peak / 2**30:.2f} GiB; launches per eval forward "
          f"{ {k: v // 6 for k, v in ev_counts.items() if v} }, per train step "
          f"{ {k: v // 4 for k, v in tr_counts.items() if v} }")
    print(f"  step 1: {len(grads)} parameter gradients, none zero or not finite but the "
          f"{len(zeros)} zero in exact arithmetic (biases feeding a batch norm in training, the "
          f"L-TAE key bias): max|g| there {max(grads[n][1] for n in zeros):.3g}")
    check(not bad, f"U-TAE parameters without a finite non-zero gradient: {bad[:8]}")
    profile_train_step(train_step, state, batches[0], gen, paper_recipe=False,
                       step_ms=statistics.median(tr_ms))
    _card_vs_cpu(dev, derive(parse_config(
        ["--model", "utae", "--encoder_widths", "[16,16,16,32]", "--decoder_widths",
         "[16,16,16,32]", "--n_head", "4", "--d_model", "32", "--use_sar"])), "U-TAE")
    del model, state, batches
    return {k: counts[k] + all_counts[k] for k in counts}


def phase8_families(dev):
    """One train step and one eval forward of every other family at 256x256
    (bf16), finite outputs and no kernel launch; card vs CPU at 32x32."""
    from uncrtaints_tpu_torch.config import Config, derive
    from uncrtaints_tpu_torch.train import create_train_state, make_eval_step, make_train_step

    kernels = kernel_wrappers()
    for f in kernels.values():
        f.launches = 0
    for name, kw in FAMILIES.items():
        cfg = derive(Config(use_sar=True, loss="l2", **kw))
        model = seeded_model(cfg, dev)
        n_params = sum(p.numel() for p in model.parameters())
        b = _synthetic_batches(cfg, 1, PATCH, SEED + 12, dev)[0]
        state = create_train_state(cfg, model)
        eval_step, train_step = make_eval_step(cfg), make_train_step(cfg)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        times = []
        torch.cuda.reset_peak_memory_stats(dev)
        for _ in range(3):  # the first of each is the warm-up
            t0 = time.perf_counter()
            ev = eval_step(model, b)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            state, aux = train_step(state, b, gen)
            torch.cuda.synchronize()
            times.append(((t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3))
        peak = torch.cuda.max_memory_allocated(dev)
        grads_ok = all(bool(torch.isfinite(g).all()) for g in aux["grads"].values())
        print(f"phase 8: {name} ({n_params} parameters; bf16, B={B}, T={cfg.input_t}, "
              f"{PATCH}x{PATCH}, MSE): eval {min(t[0] for t in times[1:]):.2f} ms, train step "
              f"{min(t[1] for t in times[1:]):.2f} ms (best of 2 after a warm-up), peak "
              f"{peak / 2**30:.2f} GiB; pred {tuple(ev['pred'].shape)}, loss "
              f"{float(aux['loss']):.5f}, gradients finite {grads_ok}")
        check(tuple(ev["pred"].shape) == (B, 1, PATCH, PATCH, 13) and finite(ev["pred"])
              and np.isfinite(float(aux["loss"])) and grads_ok, f"{name}: outputs not finite")
        del model, state, b
        _card_vs_cpu(dev, cfg, name)
    counts = {k: f.launches for k, f in kernels.items()}
    check(not any(counts.values()), f"the baseline families launched kernels: {counts}")
    return counts


def phase8_ensemble(dev, tmp):
    """Two members' test exports (phase 6's paper-recipe run, and one more
    trained at another seed), fused by cli.ensemble in the three modes and
    held against a numpy fusion of the exported files. Returns the launches
    of the member runs."""
    from uncrtaints_tpu_torch.cli import ensemble, test as cli_test, train as cli_train
    from uncrtaints_tpu_torch.config import apply_resume, derive, parse_config

    kernels = kernel_wrappers()
    for f in kernels.values():
        f.launches = 0
    n = 4
    common = ["--max_samples_count", str(n), "--batch_size", str(B), "--input_t", str(T),
              "--num_workers", "4"]
    res = os.path.join(tmp, "results")
    argv = ["--synthetic_data", "--synthetic_patch", str(PATCH), "--use_sar", "--scale_by", "10",
            "--epochs", "1", "--rdm_seed", "2", "--plot_every", "-1", "--export_every", "-1",
            "--res_dir", res,
            "--experiment_name", "member2"] + common
    cli_train.main(apply_resume(derive(parse_config(argv))))
    members = []
    for exp in ("smoke", "member2"):  # phase 6's run, and the second member
        out = os.path.join(tmp, "ensemble_members")
        cli_test.main(cli_test.load_test_config(
            ["--experiment_name", exp, "--weight_folder", res, "--res_dir", out,
             "--export_every", "1"] + common))
        export = os.path.join(out, exp, "export")
        members.append(os.path.join(export, os.listdir(export)[0], "test"))
    counts = {k: f.launches for k, f in kernels.items()}
    want = chain_launches(1, 1 + 1 + 2)  # member2: 1 train step, val, test; two cli.test
    check(counts == want, f"the ensemble members launched {counts}, expected {want}")
    files = sorted(os.listdir(members[0]))
    check(files == sorted(f"img-{i}_{m}.npy" for i in range(n) for m in ("pred", "target", "covar"))
          and files == sorted(os.listdir(members[1])), f"member exports {files}")
    for mode in ("aleatoric", "epistemic", "both"):
        out = os.path.join(tmp, f"ensemble_{mode}")
        t0 = time.perf_counter()
        metrics = ensemble.main(ensemble.create_parser().parse_args(
            ["--members", *members, "--synthetic_data", "--max_samples", str(n), "--uncertainty",
             mode, "--export_path", out, "--device", dev.type]))
        sec = time.perf_counter() - t0
        fused = os.path.join(out, "export", "epoch_1", "test")
        gap = 0.0
        for i in range(n):
            mean, var = ensemble.load_member_arrays(members, f"img-{i}_pred.npy")
            # numpy's fusion of the member files, in float64
            mu, v = mean.astype(np.float64), var.astype(np.float64)
            want_m = mu.mean(0)
            want_v = {"aleatoric": v.mean(0), "epistemic": (mu ** 2).mean(0) - want_m ** 2,
                      "both": (v + mu ** 2).mean(0) - want_m ** 2}[mode]
            for got, w in ((np.load(os.path.join(fused, f"img-{i}_pred.npy")), want_m),
                           (np.load(os.path.join(fused, f"img-{i}_var.npy")), want_v)):
                gap = max(gap, float(np.abs(got - w).max()))
        print(f"phase 8: cli.ensemble --uncertainty {mode} over 2 members x {n} samples of "
              f"{PATCH}x{PATCH}: {sec:.1f} s; fused mean and variance against numpy's fusion of "
              f"the exported files: max abs {gap:.3g} (<= 1e-6); metrics "
              f"{ {k: round(float(metrics[k]), 6) for k in ('RMSE', 'SSIM', 'mean var', 'UCE SE', 'AUCE SE')} }")
        check(gap <= 1e-6, f"ensemble {mode}: fused arrays differ from numpy's by {gap}")
        check(all(np.isfinite(float(metrics[k])) for k in
                  ("RMSE", "MAE", "PSNR", "SAM", "SSIM", "mean var", "UCE SE", "AUCE SE")),
              f"ensemble {mode}: metrics {metrics}")
    return counts


# phase 9: the serving export, data parallel over
# NCCL, the trace and the FLOP count, and the native writers' loader rates
PHASE9_SAMPLES = 8


def _relgap(a, b):
    return abs(a - b) / max(abs(b), 1e-12)


def phase9_modules(dev, tmp, native):
    """``cli.train`` under ``torchrun`` with one NCCL rank a card
    (``--mesh_shape``, started first, in the background); meanwhile the
    serving export of the paper recipe (symbolic batch) and the same
    ``cli.train`` run in this process with ``--trace_dir --profile`` (the
    trace must name the six operators, the FLOP count equal the forward's and,
    at 32x32, the CPU's). Then, on an idle card: one exported call against
    the live eval forward (its launches, bit-equality, both times),
    ``predict_scene`` through the artifact, the NCCL run's train loss against
    this process's, and this process's ``cli.test`` of the NCCL run's
    checkpoint against that run's own test metrics; last the native slab
    writers' loader rates of phases 6 and 7. Returns the launches of one
    exported call and of this process's runs."""
    import contextlib
    import io
    import socket
    from uncrtaints_tpu_torch.cli import test as cli_test, train as cli_train
    from uncrtaints_tpu_torch.config import Config, derive, parse_config
    from uncrtaints_tpu_torch.data import SyntheticSEN12MSCRTS, collate_multi
    from uncrtaints_tpu_torch.export import load_serving, save_serving
    from uncrtaints_tpu_torch.infer import predict_scene
    from uncrtaints_tpu_torch.train import batch_to_device
    from uncrtaints_tpu_torch.train.engine import eval_forward, profile_flops

    kernels = kernel_wrappers()
    zero = lambda: [setattr(f, "launches", 0) for f in kernels.values()]
    counts = lambda: {k: f.launches for k, f in kernels.items()}
    sync = torch.cuda.synchronize

    # ---- (a) the run under torchrun, one NCCL rank a card, in the background
    world = torch.cuda.device_count()
    res = os.path.join(tmp, "phase9")
    argv = ["--synthetic_data", "--synthetic_patch", str(PATCH), "--batch_size", str(B),
            "--input_t", str(T), "--max_samples_count", str(PHASE9_SAMPLES), "--use_sar",
            "--scale_by", "10", "--num_workers", "4", "--plot_every", "-1",
            "--export_every", "-1", "--epochs", "1", "--res_dir", res]
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env["PYTHONPATH"] = os.path.dirname(os.path.abspath(__file__))
    t_dp = time.perf_counter()
    dp = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", f"--nproc_per_node={world}",
         "--master_addr=127.0.0.1", f"--master_port={port}", "-m",
         "uncrtaints_tpu_torch.cli.train", *argv, "--experiment_name", "dp",
         "--mesh_shape", str(world)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        # ---- (b) the export: traced on the card, symbolic batch
        cfg = derive(Config(use_sar=True, scale_by=10.0))
        s = cfg.scale_by
        model = seeded_model(cfg, dev)
        ds = SyntheticSEN12MSCRTS(n_samples=B, n_input_t=T, patch_size=PATCH, seed=SEED + 9)
        batch = batch_to_device(collate_multi([ds[j] for j in range(B)]), dev)
        x, dates = batch["x"], batch["dates"]
        path = os.path.join(tmp, "paper.pt2")
        t0 = time.perf_counter()
        save_serving(model, cfg, path)
        serve = load_serving(path)
        export_s = time.perf_counter() - t0

        # ---- (c) the same run as the NCCL one in this process, traced and counted
        trace_dir = os.path.join(tmp, "trace")
        single = derive(parse_config(argv + ["--experiment_name", "single", "--trace_dir",
                                             trace_dir, "--profile"]))
        zero()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            out = cli_train.main(single)
        run_s = time.perf_counter() - t0
        run_counts = counts()
        mflop = [float(line.split(":")[1]) for line in buf.getvalue().splitlines()
                 if line.startswith("MFLOP count:")]
        trace_path = os.path.join(trace_dir, "trace_rank0.json")
        with open(trace_path) as f:
            trace = f.read()
        ops = ("att_group_aggregate", "att_group_aggregate_bwd", "dw_stencil",
               "dw_kernel_grad", "norm_gelu_matmul", "norm_gelu_dwconv3x3")
        missing = [o for o in ops if f'"uncrtaints::{o}"' not in trace]
        print(f"phase 9: cli.train --trace_dir --profile (one epoch, {PHASE9_SAMPLES} samples a "
              f"split, B={B}): {run_s:.1f} s, launches {run_counts}; trace "
              f"{os.path.getsize(trace_path) / 2**20:.1f} MiB, operators not named: {missing}; "
              f"MFLOP count a sample {mflop}")
        check(not missing, f"the trace does not name {missing}")
        with torch.inference_mode():
            full = profile_flops(cfg, model, batch)
        check(mflop == [full], f"--profile printed {mflop}, the forward counts {full}")
        small = {"x": np.random.default_rng(1).random((2, T, 32, 32, 15), dtype=np.float32),
                 "y": np.zeros((2, 1, 32, 32, 13), np.float32),
                 "dates": np.zeros((2, T), np.float32)}
        card_f = profile_flops(cfg, model, batch_to_device(small, dev))
        cpu_cfg = cfg.replace(device="cpu")
        cpu_f = profile_flops(cpu_cfg, seeded_model(cpu_cfg, torch.device("cpu")),
                              batch_to_device(small, "cpu"))
        print(f"  MFLOP a sample at 32x32: card (K3, K4, K1 by their formulas) {card_f}, CPU "
              f"(plain layers) {cpu_f}; at {PATCH}x{PATCH} {full}")
        check(card_f == cpu_f, f"FLOP count card {card_f} vs CPU {cpu_f}")
    finally:
        try:
            log, _ = dp.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            dp.kill()
            log, _ = dp.communicate()
    dp_s = time.perf_counter() - t_dp
    check(dp.returncode == 0, f"torchrun cli.train failed (rc {dp.returncode}):\n{log[-4000:]}")

    # ---- (d) on an idle card: one exported call against the live forward
    def live():
        with torch.inference_mode():
            model.eval()
            mean, var = eval_forward(cfg, model, s * x.float(), dates)
            return {"pred": mean / s, "var": var / (s * s)}

    got, ref = serve(x, dates), live()
    sync()
    zero()
    serve(x, dates)
    sync()
    one = counts()
    want = {"K1": 1, "K1-bwd": 0, "K5": 0, "K2": 0, "K3": 10, "K4": 5}
    check(one == want, f"one exported call launched {one}, expected {want}")
    gaps = {k: float((got[k] - ref[k]).abs().max()) for k in ("pred", "var")}
    same = all(torch.equal(got[k], ref[k]) for k in ("pred", "var"))
    for k in ("pred", "var"):
        check(tuple(got[k].shape) == (B, 1, PATCH, PATCH, 13) and finite(got[k]),
              f"exported {k} {tuple(got[k].shape)}")
        top = float(ref[k].abs().max())
        check(gaps[k] <= 1e-3 * top, f"exported {k} differs from the live forward by {gaps[k]}")
    times = {"export": [], "live": []}
    for name in ("export", "live", "live", "export"):
        fn = (lambda: serve(x, dates)) if name == "export" else live
        for _ in range(6):
            t0 = time.perf_counter()
            fn()
            sync()
            times[name].append((time.perf_counter() - t0) * 1e3)
    ms = {k: statistics.median(v) for k, v in times.items()}
    print(f"phase 9: export of the paper recipe (symbolic batch) traced, saved and loaded in "
          f"{export_s:.1f} s ({os.path.getsize(path) / 2**20:.1f} MiB); one call at B={B}: "
          f"launches {one}; against the live eval forward: bit-equal {same}, max abs "
          f"pred {gaps['pred']:.3g}, var {gaps['var']:.3g}")
    print(f"  the exported call {ms['export']:.3f} ms, the live eval forward {ms['live']:.3f} ms "
          f"(host clock, median of 12 each, in turns)")
    S = 2 * PATCH
    sc = collate_multi([SyntheticSEN12MSCRTS(n_samples=1, n_input_t=T, patch_size=S,
                                             seed=SEED + 10)[0]])
    kw = dict(tile=PATCH, overlap=64, batch_size=B)
    a = predict_scene(model, cfg, sc["x"][0], sc["dates"][0], **kw)
    b = predict_scene(None, None, sc["x"][0], sc["dates"][0], device=dev, forward_fn=serve, **kw)
    sgap = {k: float(np.abs(a[k] - b[k]).max()) for k in ("pred", "var")}
    print(f"  predict_scene on a {S}x{S} scene through the artifact against the live model: "
          f"max abs {sgap}")
    check(all(v <= 1e-3 * float(np.abs(a[k]).max()) for k, v in sgap.items()),
          f"predict_scene through the artifact {sgap}")

    # ---- (e) the NCCL run against this process: its train loss (the card
    # does not repeat a train epoch to the bit: the bilinear backward sums
    # with atomics; 5e-3 as phase 6), and its test split evaluated here on
    # its own checkpoint (an eval epoch repeats to the bit)
    lines = [ln for ln in log.splitlines() if ln.startswith("Data parallel:")]
    check(lines, "the torchrun run did not report its data-parallel rank")
    with open(os.path.join(res, "dp", "trainlog.json")) as f:
        dlog = json.load(f)["1"]
    with open(os.path.join(res, "dp", "test_metrics.json")) as f:
        dtest = json.load(f)
    zero()
    with contextlib.redirect_stdout(io.StringIO()):
        here = cli_test.main(cli_test.load_test_config(
            ["--experiment_name", "dp", "--weight_folder", res, "--res_dir",
             os.path.join(tmp, "phase9_test"), "--max_samples_count", str(PHASE9_SAMPLES),
             "--batch_size", str(B), "--input_t", str(T), "--num_workers", "4",
             "--plot_every", "-1", "--export_every", "-1"]))
    test_counts = counts()
    train_gap = _relgap(dlog["train_loss"], out["trainlog"][1]["train_loss"])
    test_gap = max(_relgap(v, float(here[k])) for k, v in dtest.items())
    print(f"phase 9: cli.train under torchrun, {world} NCCL rank(s) (--mesh_shape {world}), "
          f"{dp_s:.1f} s beside the steps above: {lines[0]}; train loss "
          f"{dlog['train_loss']:.6f} against this process's "
          f"{out['trainlog'][1]['train_loss']:.6f} (relative gap {train_gap:.3g}, <= 5e-3); "
          f"its test metrics against one process's cli.test of its checkpoint: largest "
          f"relative gap {test_gap:.3g} (<= 1e-6)")
    check(train_gap <= 5e-3, f"the NCCL train loss differs from one process's by {train_gap}")
    check(test_gap <= 1e-6, f"the NCCL test metrics differ from one process's by {test_gap}")
    for label, r in native.items():
        print(f"phase 9: native slab writers, {label}: {r['native']:.2f} sequences/s against "
              f"{r['numpy']:.2f} with --no_fast_collate ({r['native'] / r['numpy']:.2f}x)")
    return {k: one[k] + run_counts[k] + test_counts[k] for k in one}


# phase 10: the 2-D data x spatial mesh, two ranks on one card
SPATIAL = 2
SCENE_2D = 2 * PATCH


def _spatial_inputs():
    """The paper-recipe batch and the scene both sides of phase 10 run (numpy)."""
    from uncrtaints_tpu_torch.data import SyntheticSEN12MSCRTS, collate_multi
    ds = SyntheticSEN12MSCRTS(n_samples=B, n_input_t=T, patch_size=PATCH, seed=SEED + 11)
    batch = collate_multi([ds[j] for j in range(B)])
    sc = collate_multi([SyntheticSEN12MSCRTS(n_samples=1, n_input_t=T, patch_size=SCENE_2D,
                                             seed=SEED + 12)[0]])
    return batch, (sc["x"][0], sc["dates"][0])


def _phase10_steps(dev, batch, scene, mesh=None, timing=None):
    """The eval step, predict_scene and two train steps of the seeded paper
    recipe on ``batch`` (this rank's band under ``mesh``): outputs, the
    launches of each, the first train step's loss and gradients, and the
    second step's peak device memory. ``timing``, a context manager that
    yields a dict, times one more eval and train step with the collectives'
    host time collected in that dict."""
    from uncrtaints_tpu_torch.config import Config, derive
    from uncrtaints_tpu_torch.infer import predict_scene
    from uncrtaints_tpu_torch.train import (batch_to_device, create_train_state,
                                            make_eval_step, make_train_step)
    cfg = derive(Config(use_sar=True, scale_by=10.0))
    kernels = kernel_wrappers()
    halo = {k: f for k, f in kernels.items() if k in ("K5", "K2", "K4")}

    def counted(fn):
        for f in kernels.values():
            f.launches = 0
        for f in halo.values():
            f.halo_launches = 0
        r = fn()
        torch.cuda.synchronize()
        return r, {k: f.launches for k, f in kernels.items()}, {
            k: f.halo_launches for k, f in halo.items()}

    b = batch_to_device(batch, dev)
    model = seeded_model(cfg, dev)
    step = make_eval_step(cfg, with_metrics=True)
    step(model, b)  # warm-up
    res = {}
    aux, res["eval counts"], res["eval halo"] = counted(lambda: step(model, b))
    res["eval"] = {"loss": float(aux["loss"]), "pred": aux["pred"].float().cpu(),
                   "var": aux["var"].float().cpu(),
                   "metrics": {k: v.cpu() for k, v in aux["metrics"].items()}}
    kw = dict(tile=PATCH, overlap=64, batch_size=B)
    sc, res["scene counts"], _ = counted(lambda: predict_scene(model, cfg, *scene, mesh=mesh,
                                                               **kw))
    res["scene"] = sc
    state = create_train_state(cfg, model)
    tstep = make_train_step(cfg)
    gen = torch.Generator(device=dev).manual_seed(SEED + 4 + (mesh.rank if mesh else 0))
    (state, aux), res["train counts"], res["train halo"] = counted(
        lambda: tstep(state, b, gen))
    res["train loss"] = float(aux["loss"])
    res["grads"] = {n: (bool(torch.isfinite(g).all()), float(g.abs().max()))
                    for n, g in aux["grads"].items()}
    res["zero ok"] = sorted(exact_zero_gradients(model))
    torch.cuda.reset_peak_memory_stats(dev)
    tstep(state, b, gen)
    torch.cuda.synchronize()
    res["peak"] = torch.cuda.max_memory_allocated(dev)
    if timing is not None:
        from torch.profiler import ProfilerActivity, profile
        for name, fn in (("eval", lambda: step(model, b)),
                         ("train", lambda: tstep(state, b, gen))):
            with timing() as timed:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                res[f"{name} collectives"] = (dict(timed), (time.perf_counter() - t0) * 1e3)
            # the device's side of the collectives: gloo moves a CUDA tensor
            # through the host, so its share is the step's host <-> device copies
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            kinds, _, _ = device_time_by_kind(prof, (("copies", ("Memcpy",)),
                                                     ("nccl", ("nccl", "NCCL"))))
            res[f"{name} device"] = (sum(t for t, _ in kinds.values()),
                                     kinds.get("copies", (0.0, 0)), kinds.get("nccl", (0.0, 0)))
    for name, fn in (("eval", lambda: step(model, b)), ("train", lambda: tstep(state, b, gen))):
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        res[f"{name} ms"] = statistics.median(times)
    return res


def spatial_rank(out_dir, n_data, n_spatial):
    """One rank of an n_data x n_spatial mesh (phase 10, started by
    torchrun): NCCL with a card a rank, else gloo (ranks sharing a card:
    NCCL refuses that), this rank's samples and band of the batch, the steps
    of :func:`_phase10_steps`; written to ``rank<r>.pt`` under ``out_dir``."""
    from uncrtaints_tpu_torch.parallel import mesh as mesh_mod
    from uncrtaints_tpu_torch.parallel import make_mesh_2d, maybe_init_distributed, shard_batch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    world = int(os.environ["WORLD_SIZE"])
    backend = "gloo" if torch.cuda.device_count() < world else None
    rank, world = maybe_init_distributed("cuda", backend=backend)
    try:
        m = make_mesh_2d(n_data, n_spatial)
        dev = torch.device("cuda", torch.cuda.current_device())
        batch, scene = _spatial_inputs()

        @contextlib.contextmanager
        def timing():
            """The collectives' host time (each synchronized before and after,
            so it holds the device's wait for them) while the block runs."""
            timed, saved = {}, (mesh_mod._gather, mesh_mod.all_reduce_sum)

            def timer(name, fn):
                def run(*a, **k):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    r = fn(*a, **k)
                    torch.cuda.synchronize()
                    n, ms = timed.get(name, (0, 0.0))
                    timed[name] = (n + 1, ms + (time.perf_counter() - t0) * 1e3)
                    return r
                return run

            mesh_mod._gather = timer("halo all_gather", saved[0])
            mesh_mod.all_reduce_sum = timer("all_reduce", saved[1])
            try:
                yield timed
            finally:
                mesh_mod._gather, mesh_mod.all_reduce_sum = saved

        res = _phase10_steps(dev, shard_batch(batch, m), scene, mesh=m, timing=timing)
        res["coords"] = (m.data_rank, m.spatial_rank)
        res["backend"] = torch.distributed.get_backend()
        if rank:
            res.pop("scene")  # the same on every rank: rank 0's is held
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()
    return 0


def _phase10_orbax(tmp):
    """``cli.train --ckpt_backend orbax`` for one epoch, resumed to two from
    its ``.dcp``, and ``cli.test``; then the same weights written as
    ``.pth.tar`` and tested again. Returns the launches of the chain."""
    import contextlib
    import io
    import shutil
    from uncrtaints_tpu_torch.cli import test as cli_test, train as cli_train
    from uncrtaints_tpu_torch.config import Config, apply_resume, derive
    from uncrtaints_tpu_torch.models import get_generator
    from uncrtaints_tpu_torch.train import create_train_state
    from uncrtaints_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
    kernels = kernel_wrappers()
    res = os.path.join(tmp, "results")  # phase 6's, whose "smoke" run is the yardstick
    exp = os.path.join(res, "orbax")

    def recipe(**kw):  # phase 6's recipe
        return derive(Config(
            use_sar=True, scale_by=10.0, gamma=0.8, synthetic_data=True, synthetic_patch=PATCH,
            batch_size=B, input_t=T, max_samples_count=8, num_workers=4, plot_every=-1,
            export_every=-1, res_dir=res, experiment_name="orbax", ckpt_backend="orbax", **kw))

    for f in kernels.values():
        f.launches = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        cli_train.main(recipe(epochs=1))
        ckpt1 = os.path.join(exp, "model_epoch_1.dcp")
        second = cli_train.main(apply_resume(recipe(epochs=2, resume_from=True,
                                                    trained_checkp=ckpt1, resume_at=1)))
        argv = ["--weight_folder", res, "--max_samples_count", "8", "--batch_size", str(B),
                "--input_t", str(T), "--num_workers", "4", "--export_every", "-1"]
        dcp_test = cli_test.main(cli_test.load_test_config(
            ["--experiment_name", "orbax", "--res_dir", os.path.join(tmp, "orbax_test"), *argv]))
        # the same weights as a .pth.tar under another name, tested again
        cfg = recipe(epochs=2)
        state, _ = load_checkpoint(cfg, res, create_train_state(cfg, get_generator(cfg)),
                                   "model")
        twin = os.path.join(res, "orbax_pth")
        os.makedirs(twin, exist_ok=True)
        shutil.copyfile(os.path.join(exp, "conf.json"), os.path.join(twin, "conf.json"))
        save_checkpoint(cfg.replace(experiment_name="orbax_pth", ckpt_backend="msgpack"), 2,
                        state, "model", cfg.lr)
        pth_test = cli_test.main(cli_test.load_test_config(
            ["--experiment_name", "orbax_pth", "--res_dir", os.path.join(tmp, "orbax_pth_test"),
             *argv]))
    chain_s = time.perf_counter() - t0
    counts = {k: f.launches for k, f in kernels.items()}
    have = sorted(os.listdir(exp))
    dirs = ["model.dcp", "model_epoch_1.dcp", "model_epoch_2.dcp"]
    check(all(os.path.isdir(os.path.join(exp, d)) for d in dirs)
          and not any(".tmp" in f or ".prev" in f for f in have)
          and not any(f.endswith(".pth.tar") for f in have),
          f"the orbax run's directory holds {have}")
    with open(os.path.join(res, "smoke", "trainlog.json")) as f:
        ref = json.load(f)
    with open(os.path.join(exp, "trainlog.json")) as f:
        got = json.load(f)
    # a resumed run's trainlog.json holds the epochs it ran: epoch 2 on both sides
    gaps = {e: _relgap(got[e]["train_loss"], ref[e]["train_loss"]) for e in sorted(set(got)
                                                                                   & set(ref))}
    check(gaps, f"no common epoch in the trainlogs: {sorted(got)}, {sorted(ref)}")
    want = chain_launches(4, 12)  # 2 x 2 train steps; val + test a run, two cli.test
    print(f"phase 10: cli.train --ckpt_backend orbax (1 epoch), resumed from "
          f"model_epoch_1.dcp to 2, cli.test on model.dcp, and cli.test of the same weights "
          f"as model.pth.tar: {chain_s:.1f} s, launches {counts}; files {have}; train losses "
          f"against phase 6's .pth.tar run, relative gaps {gaps} (<= 5e-3); test metrics "
          f".dcp vs .pth.tar bit-equal {dcp_test == pth_test}")
    check(counts == want, f"the orbax chain launched {counts}, expected {want}")
    check(all(g <= 5e-3 for g in gaps.values()), f"orbax run's train losses {gaps}")
    check(dcp_test == pth_test, f"cli.test of model.dcp {dcp_test} and of the same weights "
                                f"as .pth.tar {pth_test} differ")
    check(dcp_test == {k: v for k, v in second["test"].items()},
          "cli.test of model.dcp differs from the train run's final test")
    return counts


def start_spatial_ranks(out, n_data, n_spatial):
    """``torchrun`` of this script's :func:`spatial_rank` as the ranks of an
    n_data x n_spatial mesh, writing into ``out``; returns the process."""
    import socket
    os.makedirs(out, exist_ok=True)
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    here = os.path.dirname(os.path.abspath(__file__))
    env["PYTHONPATH"] = here
    return subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run",
         f"--nproc_per_node={n_data * n_spatial}", "--master_addr=127.0.0.1",
         f"--master_port={port}", os.path.join(here, "chip_smoke.py"), "--spatial-rank", out,
         str(n_data), str(n_spatial)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def finish_spatial_ranks(ranks, out, n_data, n_spatial):
    """Wait for the ranks of :func:`start_spatial_ranks`; their results."""
    try:
        log, _ = ranks.communicate(timeout=600)
    except subprocess.TimeoutExpired:
        ranks.kill()
        log, _ = ranks.communicate()
    check(ranks.returncode == 0, f"the spatial ranks failed (rc {ranks.returncode}):\n"
                                 f"{log[-4000:]}")
    got = [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
           for r in range(n_data * n_spatial)]
    check([g["coords"] for g in got] == [(d, s) for d in range(n_data) for s in range(n_spatial)],
          "rank coordinates")
    return got


def spatial_report(one, got, batch, n_data, n_spatial, label):
    """Hold the ranks' results ``got`` of an n_data x n_spatial mesh against
    one process's ``one`` (both :func:`_phase10_steps`) and print them;
    returns the launches of all of them."""
    ns = n_spatial
    groups = [got[d * ns:(d + 1) * ns] for d in range(n_data)]

    # the eval step: the bands stitched, the data ranks' samples in order
    e1 = one["eval"]
    loss = [g["eval"]["loss"] for g in got]
    lgap = _relgap(statistics.mean(g[0]["eval"]["loss"] for g in groups), e1["loss"])
    sgap = max(_relgap(v["eval"]["loss"], g[0]["eval"]["loss"]) for g in groups for v in g)
    top = float(batch["y"].max())
    rmse = {}
    for k in ("pred", "var"):
        whole = torch.cat([torch.cat([v["eval"][k] for v in g], dim=2) for g in groups])
        check(tuple(whole.shape) == tuple(e1[k].shape), f"stitched {k} {tuple(whole.shape)}")
        rmse[k] = float((whole - e1[k]).square().mean().sqrt()) / top
    # relative, or absolute below 1e-2 (the mean signed error is near 0)
    mgap = 0.0
    for k, ref in e1["metrics"].items():
        for v in got:
            mine = torch.cat([g[v["coords"][1]]["eval"]["metrics"][k] for g in groups])
            mgap = max(mgap, float(((mine - ref).abs() / ref.abs().clamp(min=1e-2)).max()))
    print(f"{label}: the {n_data} x {ns} mesh, bands of {PATCH // ns} rows, paper recipe bf16 "
          f"B={len(e1['pred'])}: eval loss {loss} (the spatial groups agree to {sgap:.3g}); "
          f"their mean against one process's {e1['loss']:.6f}: relative gap {lgap:.3g} "
          f"(<= 1e-3); pred and var RMSE over max|y| {rmse} (<= 5e-3); metrics largest "
          f"relative gap {mgap:.3g} (<= 1e-3)")
    check(lgap <= 1e-3 and sgap <= 1e-6, f"spatial eval loss gap {lgap}, {sgap}")
    check(all(v <= 5e-3 for v in rmse.values()), f"spatial eval pred/var {rmse}")
    check(mgap <= 1e-3, f"spatial eval metrics gap {mgap}")

    # launches: every rank runs the whole forward on its band, through the halo modes
    fwd = {"K1": 1, "K1-bwd": 0, "K5": 0, "K2": 0, "K3": 10, "K4": 5}
    trn = {"K1": 1, "K1-bwd": 1, "K5": 12, "K2": 6, "K3": 0, "K4": 0}
    n_scene = -(-one["scene counts"]["K1"] // n_data)  # rounds of one batch a data rank
    for r, g in enumerate(got):
        print(f"  rank {r}: eval launches {g['eval counts']} (halo mode {g['eval halo']}), "
              f"train step {g['train counts']} (halo mode {g['train halo']}), scene "
              f"{g['scene counts']}")
        check(g["eval counts"] == fwd and g["eval halo"] == {"K5": 0, "K2": 0, "K4": 5},
              f"rank {r}'s eval forward launched {g['eval counts']} {g['eval halo']}")
        check(g["train counts"] == trn and g["train halo"] == {"K5": 12, "K2": 6, "K4": 0},
              f"rank {r}'s train step launched {g['train counts']} {g['train halo']}")
        check(g["scene counts"] == {k: n_scene * v for k, v in fwd.items()},
              f"rank {r}'s scene launched {g['scene counts']}")

    # one train step
    tgap = max(_relgap(g["train loss"], one["train loss"]) for g in got)
    for r, g in enumerate(got):
        bad = [n for n, (fin, mx) in g["grads"].items()
               if not fin or (mx == 0 and n not in g["zero ok"])]
        check(not bad, f"rank {r}: parameters without a finite non-zero gradient: {bad[:8]}")
    print(f"  train step loss {[g['train loss'] for g in got]} against one process's "
          f"{one['train loss']:.6f} (largest relative gap {tgap:.3g}, <= 5e-3); every gradient "
          f"finite and non-zero but those zero in exact arithmetic")
    check(tgap <= 5e-3, f"spatial train loss gap {tgap}")

    # the scene, as the eval step: RMSE over the largest value (bf16: a single
    # output one ulp apart is 4e-3-8e-3 of its value, so the largest gap is
    # printed only)
    diff = {k: got[0]["scene"][k] - one["scene"][k] for k in ("pred", "var")}
    top = {k: float(np.abs(one["scene"][k]).max()) for k in diff}
    srmse = {k: float(np.sqrt(np.mean(np.square(d)))) / top[k] for k, d in diff.items()}
    smax = {k: float(np.abs(d).max()) / top[k] for k, d in diff.items()}
    print(f"  predict_scene(mesh=) on a {SCENE_2D}x{SCENE_2D} scene ({n_scene} forwards a rank) "
          f"against one process: RMSE over max {srmse} (<= 5e-3), largest gap over max {smax}")
    check(all(v <= 5e-3 for v in srmse.values()), f"predict_scene on the mesh {srmse}")

    # memory and time
    gib = lambda b: b / 2 ** 30
    print(f"  train-step peak device memory: ranks {[round(gib(g['peak']), 3) for g in got]} GiB "
          f"against one process's {gib(one['peak']):.3f} GiB (ratios "
          f"{[round(g['peak'] / one['peak'], 3) for g in got]})")
    print(f"  one process: eval step {one['eval ms']:.2f} ms, train step {one['train ms']:.2f} "
          f"ms (host clock, median of 3)")
    for r, g in enumerate(got):
        for name in ("eval", "train"):
            calls, ms = g[f"{name} collectives"]
            busy, (copy_ms, n_copy), (nccl_ms, n_nccl) = g[f"{name} device"]
            print(f"  rank {r} ({g['backend']}) {name} step: {g[name + ' ms']:.2f} ms (host "
                  f"clock, median of 3); with each collective synchronized {ms:.2f} ms, "
                  f"collectives {calls} (calls, host ms); under the profiler the device is "
                  f"busy {busy:.2f} ms, of it {copy_ms:.2f} ms in {n_copy} host <-> device "
                  f"copies and {nccl_ms:.2f} ms in {n_nccl} NCCL kernels")
    counts = lambda g: {k: g["eval counts"][k] + g["train counts"][k] + g["scene counts"][k]
                        for k in fwd}
    return {k: counts(one)[k] + sum(counts(g)[k] for g in got) for k in fwd}


def phase10_spatial(dev, tmp):
    """Two ranks of a 1 x 2 data x spatial mesh under torchrun (gloo on the
    shared card) against this process; meanwhile the orbax-counterpart CLI
    chain here. Returns the launches of the ranks' and this process's runs."""
    out = os.path.join(tmp, "phase10")
    ranks = start_spatial_ranks(out, 1, SPATIAL)
    try:
        batch, scene = _spatial_inputs()
        one = _phase10_steps(dev, batch, scene)
        orbax = _phase10_orbax(tmp)
    finally:
        got = finish_spatial_ranks(ranks, out, 1, SPATIAL)
    counts = spatial_report(one, got, batch, 1, SPATIAL, "phase 10")
    return {k: orbax[k] + n for k, n in counts.items()}


def main():
    if len(sys.argv) == 5 and sys.argv[1] == "--spatial-rank":
        return spatial_rank(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]))
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

    clock = [time.perf_counter()]

    def took(what):
        clock.append(time.perf_counter())
        print(f"[{what} took {clock[-1] - clock[-2]:.1f} s]")

    kern = phase1_kernels(dev)
    took("phase 1")
    cfg, model, batches, evalc, eval_ms = phase2_slice(dev)
    took("phase 2")
    off = phase3_references(dev, cfg, model, batches[0])
    took("phase 3")
    scene = phase_scene(dev, cfg, model, off)
    took("the scene phase")
    del model, off
    train, train_ms = phase4_train(dev, batches)
    took("phase 4")
    phase5_train_reference(dev)
    took("phase 5")
    del batches
    native = {}  # the loader alone with and without the native slab writers
    with tempfile.TemporaryDirectory() as work:
        cli = phase6_cli(dev, eval_ms, train_ms, work, native)
        took("phase 6")
        real = phase7_real_data(dev, eval_ms, train_ms, native)
        took("phase 7")
        utae = phase8_utae(dev, work)
        took("phase 8, U-TAE")
        families = phase8_families(dev)
        took("phase 8, the other families")
        members = phase8_ensemble(dev, work)
        took("phase 8, the ensemble")
        modules = phase9_modules(dev, work, native)
        took("phase 9")
        spatial = phase10_spatial(dev, work)
        took("phase 10")
    print(f"launches by path: eval {evalc}; scene {scene}; train {train}; CLIs {cli}; "
          f"real data {real}; U-TAE {utae}; other families {families}; ensemble members "
          f"{members}; export and the traced run {modules}; spatial mesh and orbax {spatial}")

    # launches: the sum over the paths' runs (eval, scene, train, the CLI
    # chain, the real-data CLIs, U-TAE's CLIs and bare steps, the other
    # families, the ensemble's members, one exported call and the traced
    # run, the spatial ranks and the orbax chain), each counted from 0 just
    # before the path to just after it
    paths = (evalc, scene, train, cli, real, utae, families, members, modules, spatial)
    meta = {  # name: (source, the TPU kernel it replaces, its counter)
        "att_group_aggregate": ("aggregate.cu", "pallas_aggregate.py:268", "K1"),
        "att_group_aggregate_bwd": ("aggregate.cu", "pallas_aggregate.py:164", "K1-bwd"),
        "norm_gelu_matmul": ("norm_gelu_matmul.cu", "pallas_mbconv.py:136", "K3"),
        "norm_gelu_dwconv3x3": ("norm_gelu_dwconv.cu", "pallas_mbconv.py:254", "K4"),
        "dw_stencil": ("dwconv.cu", "pallas_dwconv.py:92", "K5"),
        "dw_kernel_grad": ("dwgrad.cu", "pallas_dwgrad.py:80", "K2"),
    }
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": f"uncrtaints_tpu_torch/csrc/{src}",
         "replaces": f"uncrtaints_tpu/ops/{rep}",
         "launches": sum(p.get(key, 0) for p in paths), **kern[name]}
        for name, (src, rep, key) in meta.items()]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
