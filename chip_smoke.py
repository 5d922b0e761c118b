"""Drive the PyTorch port's serving, scene-inference and training paths, its
train / test command-line entry points, its real-data path, its baseline
model families, its deep-ensemble tool, its serving export, its data
parallel over NCCL, its trace and FLOP count and its native slab writers on
one NVIDIA GPU and check them.

    python3 chip_smoke.py          (from the root of a checkout, one card)

Phase 1 builds the hand-written CUDA kernels of ``uncrtaints_tpu_torch``
from ``csrc/`` (one nvcc per source, in parallel) and holds each against its
plain PyTorch version on the card, at the shapes the paths give it (K1 and
K1-bwd also at U-TAE's three skip levels, [4,3,s,s,64] with 16 heads of 4
channels for s = 64, 128, 256, and at the band [4,3,128,256,128] of a 1 x 2
mesh, all timed; and, checked only, at T of 1, 2, 5 and 8, at 16 and 32
channels a head, at an H*W that is not a multiple of the forward's tile and
with x a contiguous view off 16 bytes; U-TAE's 64^2 and 128^2 levels, which
fit in L2, are timed once more with their inputs rotated over copies of more
than 100 MB) and at a ragged shape, and times both (CUDA events: a kernel or library call as the
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
kernels), the bare bf16 ``torch.matmul`` and the whole function composed of
PyTorch calls in bf16 (K3), and gelu -> reflect pad -> cuDNN depthwise conv
(K4). K6, the norms with their activation (``ops/norm.py``), is held
forward and backward at the paper encoder's group norms, the decoder's batch
norms, U-TAE's narrowest width and the benchmark cells' group norms
(``K6_CASES``): the statistics against the twins', the apply bit-equal to
the eager formula on the kernel's coef / off, the backward within a stated
relative tolerance, two runs bit-equal, timed beside the eager formula it
replaces (its autograd for the backward) and torch's batch / group norm
with the activation; a group norm that takes one pass is timed through the
two-pass kernels too. ``python3 chip_smoke.py --k6`` runs that part of
phase 1 alone. The encoder's group-norm block at the benchmark's 48 frames
runs as the group chain against its standard body, both timed, each pass of
the chain timed beside its bound and the pooled-sum pass held against its
twin and run twice. K7, the reflect pad and
its adjoint (``ops/pad.py``), is held at ``K7_CASES``: the forward bit-equal
to ``F.pad``, the adjoint bit-equal to its plain version and to itself run
twice, within rounding of autograd's ``reflection_pad3d_backward``, and at
the paper eval encoder's and U-TAE's widest padded maps timed against
``F.pad`` and that backward. Each kernel's
bound is the larger of its bytes over 3.35 TB/s and its operations over the
card's peak for their type; an exact GELU counts as the 20 fp32 operations
of its arithmetic and one special-function instruction. For K3 and K4 the
time the SMs need to dispatch the 32 instructions of the compiled GELU is
printed beside the bound and is no part of it.
Phase 2 runs the port's eval step (forward, MGNLL, scale_by rescale, image
metrics) of the paper recipe in bf16 on 3 synthetic batches of B=4, T=3,
256x256 with seeded random weights, and checks that every forward went
through the kernels (1 K1, 12 K3, 6 K4, 1 K6 and no K7 launches, and the
encoder's group chain's statistics, pooled-sum and apply passes once each;
no backward kernel) and that the outputs are finite. One more step runs
under ``torch.profiler``: device time by kind, the idle share, the kernels
by name (12 wgmma K3, 6 K4, the decoder's 5 pooled-sum passes, the group
chain's statistics and pooled-sum passes, in_conv's one-pass K6, the gn3
apply, no K7 and no ATen reflection_pad), and the five fused decoder blocks
alone with recorded shapes, where no GELU, mean or sum over a whole
[B,256,256,C] map may run outside the kernels.
Phase 3 holds the fused eval path against the standard one on the card
(``fused_gate``: at fp32 compute within the fused-vs-standard gate
``gap_ok``, at bf16 within its RMSE, no farther in RMSE from the fp32
evaluation than the standard path and at the worst pixel within 1.25 times
the standard path's gap to it), and the card with the CPU (the kernels' plain
versions) on a small input,
for the paper recipe's architecture and for the residual + ``use_v`` +
``separate_out`` variant.
The scene phase runs ``predict_scene`` of the paper recipe on a synthetic
T=3, 1024x1024 scene (tile 256, overlap 64, batches of 4: 25 windows in 7
forwards), checks shapes, finiteness, a positive variance and the launches
(7 K1, 84 K3, 42 K4, 7 K6, the group chain's three passes 7 times each,
no K7, no train kernel), holds a single-window scene against
the eval step and the tiled result as phase 3 holds the eval step,
and prints windows/s.
Phase 4 runs the port's train step (forward, MGNLL, backward, Adam, the
rescale) of the paper recipe in bf16: 4 steps of B=4, T=3, 256x256 over the
3 batches with an explicit dropout generator. It checks the launches per
step (K1 1, K1-bwd 1, K5 12, K2 6, K6 25, K6-bwd 25, no K3 or K4), finite
losses, a finite non-zero
gradient for every parameter on the first step, and that the parameters
moved; it prints the step time and the peak device memory. One more step
runs under ``torch.profiler``: no ``reflection_pad`` or K7 kernel may appear
(the reflect border lives in K5 and K2), and the device time is printed by kind.
Phase 5 compares one fp32 train step on the card with the same step on
the CPU on a small input.
The remat phase runs the paper recipe's train step at B=4 and B=8 without
and with ``remat`` (each block recomputed in the backward under
``torch.utils.checkpoint``), from the same weights on the same batch: peak
memory, step time, device-busy time and launches a step (remat: 18 K5, 6
K2, 1 K1, 1 K1-bwd, 49 K6, 25 K6-bwd); remat's peak must be below the plain
one, its first
loss bit-equal and its gradients within 1e-3 RMSE of each largest element
or twice the plain step's own run-to-run gap.
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
+ 6 K2 + 25 K6 + 25 K6-bwd) + (eval forwards) x (1 K1 + 12 K3 + 6 K4 + 1
K6). After the counters are
read it holds what only a card runs: a checkpoint saved from the card and
loaded into a fresh model gives the same eval step to the bit; the batches
the side-stream prefetch hands out equal the host's; a val epoch with the
prefetch equals one without it to the bit, and so do a one-step and an
8-step train epoch (a train step repeats to the bit: none of its sums
uses atomics); and it prints the epochs'
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
--use_custom`` on the 768x768 mosaic (1 K1 + 12 K3 + 6 K4 + 1 K6), and
``cli.train`` with the default s2cloudless detector and no weights, which
must stop with its error.
Phase 8 runs U-TAE at its published widths (encoder [64,64,64,128], decoder
[32,32,64,128], 16 heads, d_model 256; the MSE loss ``derive`` sets) through
``cli.train`` (one epoch, 8 samples a split) and ``cli.test`` at B=4, T=3,
256x256, bf16 (files, no variance export, bit-equal test metrics, launches
exactly 3 K1, 22 K6 and 15 K7 a forward and 3 K1 + 3 K1-bwd + 22 K6 + 22
K6-bwd + 15 K7 + 15 K7 adjoints a train step and nothing else; no ATen
reflection_pad kernel in its profile),
then its bare steps (launches per step, step times, peak memory, a finite
gradient for every parameter, non-zero but for those zero in exact
arithmetic, one train step under ``torch.profiler`` by kind) and the card
against the CPU at 32x32 (fp32: eval RMSE and one train step's loss). Every
other family (U-Net pretrain, UNet3D at T=4, the two recurrent U-Nets,
ConvLSTM, ConvGRU, FPN + ConvLSTM, at the JAX package's default widths and
the MSE loss) runs three eval forwards and train steps at 256x256 (finite
outputs and gradients, no kernel launch but their norms' K6 and their reflect
pads' K7, ``K6_FAMILIES``, ``K7_FAMILIES``)
and is held card against CPU at
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
trace must name the kernels' ``uncrtaints::`` operators and the FLOP count must
equal the one the forward gives, and the card's count the CPU's at 32x32.
Then it holds one exported call at B=4 against the live eval forward
(exactly 1 K1, 12 K3, 6 K4 and 1 K6 launches), times both, runs ``predict_scene``
through the artifact against the live model, holds the NCCL run's train
loss equal to this process's to the bit and its test metrics against this
process's ``cli.test`` of its checkpoint within 1e-6, and prints the loader
rates of phases 6 and 7 with and without the native writers.
Phase 1 also holds the halo modes of K5 (forward and folded adjoint), K2
and K4 (a map that is one band of rows of a scene split over ranks, with
its neighbours' edge rows) at the paper shapes split into 2 and 4 bands:
each band against its plain version, the bands stitched against the
whole-tensor kernel (K5's forward and K4 bit-equal, the adjoint with the
halo gradients added back, K2's and K4's summed partials), and times each
halo mode at 2 bands beside the whole-mode kernel on the same rows, its
bound and the library composition (the halo rows, F.pad, cuDNN; for the
adjoint, autograd of that composition).
Phase 10 runs the 2-D data x spatial mesh: ``torchrun --nproc_per_node 2``
starts this script as two ranks of a 1 x 2 mesh (``--spatial-rank``; gloo,
since the two ranks share the card and NCCL refuses that), each holding one
band of 128 rows of the paper recipe's B=4, 256x256 batch. Their eval step
(loss, pred, var, metrics), one train step (loss, a finite non-zero
gradient for every parameter but those zero in exact arithmetic) and
``predict_scene(mesh=)`` on a 512x512 scene are held against this process,
and each rank's launches (1 K1 + 12 K3 + 6 K4 + 1 K6 a forward, K4 in halo
mode, the group chain's sums and K6's summed over the ranks, no K7; 1 K1 +
1 K1-bwd + 12 K5 + 6 K2 + 25 K6 + 25 K6-bwd a train step, K5 and K2 in halo
mode, K6 summing its statistics over the ranks), its
train-step peak memory and its collectives' host time are printed.
The ranks and this process also run UNet3D (T=4), FPN + ConvLSTM and U-TAE
at its published widths (MSE, attention dropout off) on the same layout:
eval step, ``predict_scene(mesh=)`` and one train step, held against one
process with the same gates, each rank's launches equal to one process's
but K7's (a band pads at the scene's edge, ``layers.band_pad``: no K7).
Meanwhile this process runs ``cli.train --ckpt_backend orbax`` (asynchronous
``.dcp`` checkpoints) for one epoch, resumed to two, and ``cli.test``, whose
metrics must equal to the bit a ``cli.test`` of the same weights written
as ``.pth.tar``; its train losses must equal phase 6's to the bit.
Phase 11 writes the JAX package's single-file checkpoint (flax msgpack
``.ckpt`` + ``.meta.json``) with ``save_jax_checkpoint`` after two train
steps of the paper recipe, and the same state as ``.pth.tar``: a fresh model
loads the ``.ckpt`` bit-equal (model, Adam's state, lr, step, epoch; the
eval step's pred and var; 1 K1 + 12 K3 + 6 K4), trains one step (1 K1 + 1
K1-bwd + 12 K5 + 6 K2, every gradient finite and non-zero but those zero in
exact arithmetic), and ``cli.test`` (bit-equal metrics), ``cli.train
--resume_from`` (first loss within 5e-4 relative) and
``load_pretrained_partial`` (equal values and mask) give what the
``.pth.tar`` gives; the file's bytes and the host ms of both routes' save
and load are printed beside the card.
Any failed check raises. The last line of stdout is the JSON result; the
line before it lists the kernels. Without a CUDA device the script exits
with an error and prints no result.
"""

import collections
import contextlib
import importlib.util
import io
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
from typing import Callable, Dict

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
# the paper shape's band of a 1 x 2 spatial mesh (timed too), then K1's
# other variants, checked only: T of 1, 2, 5 and 8; 16 and 32 channels a
# head; an H*W (33*35) that is not a multiple of the forward's tile; and, as
# a seventh field, x as a contiguous view one element off 16 bytes
K1_BAND = (B, T, PATCH // 2, PATCH, 128, 16)
K1_CHECK_SHAPES = [(2, t, 64, 64, 128, 16) for t in (1, 2, 5, 8)] + [
    (2, 3, 32, 32, 128, 8), (2, 3, 32, 32, 128, 4), (2, 3, 33, 35, 128, 16), K1_BAND,
    (2, 3, 32, 32, 128, 16, 1)]
# the design of K1's forward in csrc/aggregate.cu (tools/tune_aggregate_h100.py
# times it beside design b, every frame's loads in flight in registers)
K1_DESIGN = "design a: bulk copies of each frame's run of a pixel tile into shared memory"
# U-TAE's 64^2 and 128^2 levels fit in the 50 MB L2: timed also with their
# inputs rotated over copies of more than this many bytes in all
ROTATE_BYTES = 100e6
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


# K6 (ops/norm.py, csrc/norm.cu: the norms with their activation) at the
# path's shapes, bf16: the paper encoder's group norms over B*T frames (fn[1]
# and fn[4] at 256 channels + GELU, in_conv's 128 + ReLU), the decoder's
# batch norms over B maps (256 + GELU, fn[8]'s 128 alone), and U-TAE's
# narrowest width (its decoder's 32 channels at 256^2, batch norm + ReLU, in
# train and, as the folded affine, in eval). name: (kind, [N,H,W,C], groups,
# activation); kind "affine" is the eval batch norm (norm_affine_act)
K6_CASES = {
    "group enc [12,256,256,256] gelu": ("group", (B * T, PATCH, PATCH, HIDDEN), 4, "gelu"),
    "group enc [12,256,256,128] relu": ("group", (B * T, PATCH, PATCH, 128), 4, "relu"),
    "batch dec [4,256,256,256] gelu": ("batch", (B, PATCH, PATCH, HIDDEN), 4, "gelu"),
    "batch dec [4,256,256,128] none": ("batch", (B, PATCH, PATCH, 128), 4, "none"),
    "batch U-TAE [4,256,256,32] relu": ("batch", (B, PATCH, PATCH, 32), 4, "relu"),
    "eval batch U-TAE [4,256,256,32] relu": ("affine", (B, PATCH, PATCH, 32), 4, "relu"),
    # UNet3D's first batch norm (the affine in fp32) and LeakyReLU, T=4
    "batch_f32 UNet3D [4,4,256,256,32] leaky": ("batch_f32", (B, 4, PATCH, PATCH, 32), 4,
                                                "leaky_relu"),
    # the benchmark's cells' group norms over B*T frames (paper B=16: in_conv
    # and the MBConv's; U-TAE B=64: its 64-channel level; the FPN B=16: its
    # inconv's 32 and mid_conv's 160 channels), one pass and two timed
    "group paper B=16 [48,256,256,256] gelu": ("group", (48, PATCH, PATCH, HIDDEN), 4, "gelu"),
    "group paper B=16 [48,256,256,128] relu": ("group", (48, PATCH, PATCH, 128), 4, "relu"),
    "group U-TAE B=64 [192,256,256,64] relu": ("group", (192, PATCH, PATCH, 64), 4, "relu"),
    "group FPN B=16 [48,256,256,32] relu": ("group", (48, PATCH, PATCH, 32), 4, "relu"),
    "group FPN B=16 [48,256,256,160] relu": ("group", (48, PATCH, PATCH, 160), 4, "relu"),
}
K6_LINE_CASE = "group enc [12,256,256,256] gelu"  # the case of the JSON line
# The paper recipe's eval forward: the five decoder blocks (batch norms) run
# K3 -> K4 -> K3 each, and so does the encoder's group-norm block (the group
# chain, models/blocks.py:MBConv._fused_group_body), with K6's statistics
# pass ahead of it, the pooled-sum pass between K4 and the second K3 and
# K6's apply after it (each counted in its own wrapper, GN_PASSES_EVAL
# each a forward), under a spatial split too (K4 in halo mode)
K3_EVAL, K4_EVAL, GN_PASSES_EVAL = 12, 6, 1
GN_PASSES = ("GN-stats", "GN-pool", "GN-apply")  # their counters (kernel_wrappers)
# K6's launches (a forward each norm, a backward each norm in a train step):
# the paper recipe's eval forward runs in_conv's group norm (the MBConvs'
# norms are the chains'), a train step all 25 norms and their backward, a
# remat step 24 more forwards (each block's norms again); fused_eval off runs
# the encoder block's 4 and the decoder's 15 too
K6_EVAL, K6_TRAIN, K6_REMAT, K6_STANDARD_EVAL = 1, 25, 49, 20
# of those, the group norms' forwards (the encoder's 5 in a train step,
# in_conv's in an eval forward) take one pass (ops/norm.py:onchip_plan), each
# one kernel where the two passes run four; their backwards (one slab a wave)
# keep the two passes
K6_ONCHIP, K6_ONCHIP_EVAL = 5, 1
# U-TAE at its published widths: 10 group and 12 eval batch norms a forward,
# 22 norms a train step (the L-TAE's own norms are not K6's)
K6_UTAE = 22
# phase 8's other families: (K6 a forward, K6 a train step); UNet3D's 11
# batch norms take K6's batch_f32 form, ConvLSTM and ConvGRU have no norm
K6_FAMILIES = {"unet (pretrain)": (22, 22), "unet3d": (11, 11), "uconvlstm": (24, 24),
               "buconvlstm": (24, 24), "convlstm": (0, 0), "convgru": (0, 0), "fpn": (3, 3)}
# K7's launches (a reflect-padded conv that K4 / K5 do not fold: the pad, and
# in a train step its adjoint where the conv's input has a gradient): the
# paper recipe's eval forward never (K4 folds every depthwise conv's pad),
# nor its train step (K5 folds every reflect conv); fused_eval off pads the
# encoder's and the decoder's 5; U-TAE pads its 15 3x3 convs, and differentiates all 15;
# the other families (K7 a forward, K7's adjoint a train step), the
# recurrent U-Nets' and FPN's first padded conv reading the data
K7_EVAL, K7_STANDARD_EVAL, K7_UTAE = 0, 6, 15
K7_FAMILIES = {"unet (pretrain)": (15, 15), "unet3d": (0, 0), "uconvlstm": (17, 16),
               "buconvlstm": (17, 16), "convlstm": (0, 0), "convgru": (0, 0), "fpn": (7, 6)}
# K7 at the paths' largest padded maps, bf16: the paper eval encoder's
# depthwise input over B*T frames (the benchmark's B=16 is four of these)
# and U-TAE's widest level at the benchmark's B=64 over T frames; then
# checked only: fp32, p = 2, odd H != W, and channels of 3, 12 and 15 (the
# 2-, 4- and 8-byte vector paths). name: ([N,H,W,C], pad, dtype, timed)
K7_CASES = {
    "paper eval enc [48,256,256,256]": ((4 * B * T, PATCH, PATCH, HIDDEN), 1, BF16, True),
    "U-TAE [192,256,256,64]": ((64 * T, PATCH, PATCH, 64), 1, BF16, True),
    "fp32 [2,64,64,128]": ((2, 64, 64, 128), 1, FP32, False),
    "p=2 odd [3,5,7,64]": ((3, 5, 7, 64), 2, BF16, False),
    "C=15 [2,33,20,15]": ((2, 33, 20, 15), 1, BF16, False),
    "C=3 p=2 fp32 [2,9,11,3]": ((2, 9, 11, 3), 2, FP32, False),
    "C=12 p=3 [2,4,9,12]": ((2, 4, 9, 12), 3, BF16, False),
}
# what an element of K6 computes, in fp32 operations (bound): forward the
# statistics' add and multiply-add (3), the affine's multiply and add (2),
# the activation (an exact GELU: GELU_OPS and an erf; ReLU one compare);
# backward the recomputed affine (2), act' (GELU: GELU_OPS, the pdf's 5
# operations and an exponential), g' (1), the sums (3) and dx (4)
K6_FWD_OPS, K6_BWD_OPS = 5, 10

# device kernels of an eval step by kind: the first fragment found in a
# kernel's name decides (the hand-written kernels first)
EVAL_KINDS = (
    ("K1", ("att_group_",)),
    ("K7 reflect pad", ("reflect_pad_nhwc_kernel",)),
    ("K3", ("ngm_",)),
    ("K4 (with its pooled-sum pass)", ("ngd_", "channel_sum_kernel")),
    ("K6 norm + activation (with its statistics passes; the group chain's pooled sum)",
     ("norm_part_", "norm_finalize_", "norm_apply_", "group_stats_kernel", "gelu_pool_")),
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
    pad and its adjoint; GN_PASSES the eval group-norm MBConv chain's
    statistics, pooled-sum and apply passes)."""
    from uncrtaints_tpu_torch.ops import aggregate, dwconv, dwgrad, mbconv, norm, pad
    return {"K1": aggregate.att_group_aggregate, "K1-bwd": aggregate.att_group_aggregate_bwd,
            "K5": dwconv.dw_stencil, "K2": dwgrad.dw_kernel_grad,
            "K3": mbconv.norm_gelu_matmul, "K4": mbconv.norm_gelu_dwconv3x3,
            "K6": norm.norm_act, "K6-bwd": norm.norm_act_bwd,
            "K7": pad.reflect_pad, "K7-adj": pad.reflect_pad_adjoint,
            "GN-stats": norm.norm_stats, "GN-pool": norm.norm_gelu_pool,
            "GN-apply": norm.norm_apply}


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


def gap_ok(got: torch.Tensor, ref: torch.Tensor) -> Dict:
    """The fused-vs-standard gate of chip_smoke.py phase 3: max |gap| within
    0.02 and its RMSE within 5e-3 of max |ref|."""
    d = (got.float() - ref.float()).abs()
    top = float(ref.abs().max())
    mx, rmse = float(d.max()), float(d.square().mean().sqrt())
    return {"max": mx, "rmse": rmse, "max_ref": top,
            "ok": finite(got) and mx <= 0.02 * top and rmse <= 5e-3 * top}


# the bf16 fused path's largest gap to the fp32 evaluation, at most this
# many times the bf16 standard path's (on an H100 at phase 2's batches and
# the scene: 0.66-1.14 times; the parent's fused path, batch-norm blocks
# only, 0.91-1.04)
FUSED_MAX_OVER_STANDARD = 1.25


def fused_gate(label, fused, std, fused32, std32):
    """Phase 3's and the scene's gates of the fused eval path against the
    standard one on the same weights: at fp32 compute the fused path within
    :func:`gap_ok` of the standard path (the same function); at the
    recipe's bf16 within its RMSE, no farther in RMSE from the fp32
    standard evaluation than the standard bf16 path is, and at its worst
    pixel within FUSED_MAX_OVER_STANDARD times the standard bf16 path's
    largest gap to that evaluation (a fault of the bf16 kernels confined to
    a few pixels shows there). (The two bf16 paths
    round apart in all six MBConvs, the encoder's group chain keeping its
    norms' affines and its SE in fp32 where the standard body rounds to
    bf16, and the L-TAE's attention over T carries a pixel's difference to
    the output: at bf16 each path's largest gap to the fp32 evaluation, and
    so theirs to each other, passes the gate's 2%: on an H100 at phase 2's
    batches the standard path 3.6-3.9%, the fused one 2.9-3.7%.)"""
    for k in ("pred", "var"):
        g32, g16 = gap_ok(fused32[k], std32[k]), gap_ok(fused[k], std[k])
        ef, es = gap_ok(fused[k], std32[k]), gap_ok(std[k], std32[k])
        print(f"{label}, {k}: fp32 fused vs standard max {g32['max']:.4g} (<= "
              f"{0.02 * g32['max_ref']:.4g}), RMSE {g32['rmse']:.4g} (<= "
              f"{5e-3 * g32['max_ref']:.4g}); bf16 fused vs standard max {g16['max']:.4g}, RMSE "
              f"{g16['rmse']:.4g} (<= {5e-3 * g16['max_ref']:.4g}); against the fp32 standard "
              f"evaluation, bf16 fused max {ef['max']:.4g} (<= "
              f"{FUSED_MAX_OVER_STANDARD * es['max']:.4g}) RMSE {ef['rmse']:.4g}, bf16 standard "
              f"max {es['max']:.4g} RMSE {es['rmse']:.4g}")
        check(g32["ok"], f"{label}: the fp32 fused/standard gap in {k}")
        check(finite(fused[k]) and g16["rmse"] <= 5e-3 * g16["max_ref"],
              f"{label}: the bf16 fused/standard RMSE gap in {k}")
        check(ef["rmse"] <= es["rmse"],
              f"{label}: the bf16 fused path is farther from the fp32 evaluation than the "
              f"standard path in {k}")
        check(ef["max"] <= FUSED_MAX_OVER_STANDARD * es["max"],
              f"{label}: the bf16 fused path's largest gap to the fp32 evaluation in {k} is more "
              f"than {FUSED_MAX_OVER_STANDARD} times the standard path's")


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


def time_rotated(make, n_bytes):
    """:func:`time_kernel` of ``make()``'s call on fresh input sets in turn,
    as many as exceed ``ROTATE_BYTES`` together (``n_bytes`` each), so that
    no call finds its inputs in L2. ``make`` returns one set's call."""
    calls = [make() for _ in range(math.ceil(ROTATE_BYTES / n_bytes) + 1)]
    turn = [0]

    def call():
        calls[turn[0] % len(calls)]()
        turn[0] += 1

    return time_kernel(call)


def bound(n_bytes, *ops):
    """(bound_ms, bound_by): the least time the card could take to move
    ``n_bytes`` (each input read once, each output written once) or to do
    the operations, given as (count, peak rate) pairs per type, whichever
    is larger."""
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    t_ops = max(n / peak for n, peak in ops) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def rel_to(diff, scale):
    """The largest |diff| relative to its scale. Where a scale is 0 (a sum of
    |terms| that are all 0, e.g. a channel whose every GELU underflows to 0)
    the difference must be 0 too: it is divided by the smallest normal float
    instead of 0, so that 0 stays 0 and anything else fails."""
    return float((diff.abs() / scale.clamp_min(torch.finfo(torch.float32).tiny)).max())


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def phase1_kernels(dev):
    """Returns {kernel name: dict(max_abs_err, ms, plain_ms, bound_ms,
    bound_by, library_ms)} at the main path's shape of each kernel."""
    from uncrtaints_tpu_torch import _build
    from uncrtaints_tpu_torch.ops import aggregate, dwconv, dwgrad, mbconv
    from uncrtaints_tpu_torch.ops.pad import reflect_pad_plain

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

    def k1_inputs(shape, dtype):
        """x (a contiguous view one element into its buffer where the shape
        has a seventh field), softmax attention and an output gradient"""
        B, T, H, W, C, heads, *offset = shape
        x = randn(B, T, H, W, C).to(dtype)
        if offset:
            x = torch.empty(x.numel() + 1, device=dev, dtype=dtype)[1:].view(x.shape).copy_(x)
            check(x.is_contiguous() and x.data_ptr() % 16, "K1: x is not off 16 bytes")
        a = torch.softmax(randn(B, T, H, W, heads), dim=1).to(dtype)
        return x, a, randn(B, H, W, C).to(dtype)

    # ---- K1: main path [4,3,256,256,128] heads 16, a ragged shape, U-TAE's
    # three skip levels and the 1 x 2 band (timed too), and the variants
    print(f"K1 forward: {K1_DESIGN}")
    k1_err, k1_ms = 0.0, {}
    for shape in K1_SHAPES + UTAE_K1_SHAPES + K1_CHECK_SHAPES:
        B, T, H, W, C, heads = shape[:6]
        for dtype in (torch.bfloat16, torch.float32):
            x, a, _ = k1_inputs(shape, dtype)
            got = aggregate.att_group_aggregate(x, a)
            torch.cuda.synchronize()
            ref = aggregate.att_group_aggregate_plain(x, a)
            err = float((got.float() - ref.float()).abs().max())
            top = max(1.0, float(ref.float().abs().max()))
            # fp32: the same fp32 products summed in the same order; bf16:
            # the final rounding may differ by one ulp at the top of range
            tol = (1e-5 if dtype == torch.float32 else 2 ** -7) * top
            line = (f"K1 att_group_aggregate {str(dtype)[6:]} {list(shape[:5])} "
                    f"heads={heads}{' x off 16 bytes' if len(shape) > 6 else ''}: "
                    f"max_abs_err={err:.3g} (tol {tol:.3g})")
            if shape == K1_SHAPES[0] or (shape in UTAE_K1_SHAPES + [K1_BAND] and dtype == BF16):
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
                line += (f", kernel ({K1_DESIGN[:8]}) {kms:.4f} ms, plain {pms:.4f} ms, bound "
                         f"{bms:.4f} ms ({nbytes(x, a, got) / 1e6:.1f} MB; kernel at "
                         f"{bms / kms:.0%} of it), torch.einsum {lms:.4f} ms "
                         f"(max_abs_err {lerr:.3g})")
                if shape in UTAE_K1_SHAPES[:2]:
                    def fresh():
                        x_, a_, _ = k1_inputs(shape, dtype)
                        return lambda: aggregate.att_group_aggregate(x_, a_)

                    rms = time_rotated(fresh, nbytes(x, a, got))
                    line += (f"; inputs rotated past L2 {rms:.4f} ms ({bms / rms:.0%} of the "
                             f"bound; the first reading is partly L2's)")
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
            # the same function composed from PyTorch calls in bf16: the norm
            # applied as one affine (folded outside the timing), GELU, the SE
            # scale, torch.matmul, the output affine (the path's forms have
            # no output GELU and no statistics)
            check(not kw["out_gelu"] and not kw["do_stats"], f"K3 {name}: not a path form")
            xn, mean, coef, sc, bi = args[:5]
            rep = xn.shape[2] // mean.shape[1]  # channels a group
            fa = coef.repeat_interleave(rep, -1)[:, None, :] * sc
            fb = bi - mean.repeat_interleave(rep, -1)[:, None, :] * fa
            fa, fb = fa.to(xn.dtype), fb.to(xn.dtype)
            se_b = kw["se"].to(xn.dtype)[:, None, :] if kw["se"] is not None else None
            oa = [t.to(xn.dtype) for t in kw["out_affine"]] if kw["out_affine"] else None

            def composition():
                h = xn * fa + fb
                if kw["do_gelu"]:
                    h = torch.nn.functional.gelu(h)
                if se_b is not None:
                    h = h * se_b
                o = torch.matmul(h, w2)
                return o * oa[0] + oa[1] if oa is not None else o

            cerr = float((composition().float() - ref[0].float()).abs().max())
            # bf16 rounds between the calls: within 5% of the largest output
            check(cerr <= 0.05 * float(ref[0].float().abs().max()),
                  f"K3 {name}: the composition computes another function ({cerr:.3g})")
            cms = time_kernel(composition)
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
                     f"torch.matmul alone {lms:.4f} ms, the function composed of PyTorch calls "
                     f"in bf16 {cms:.4f} ms (max_abs_err {cerr:.3g})")
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
            ep = rel_to(got[3] - act.sum(dim=(1, 2)), act.abs().sum(dim=(1, 2)))
            # and against the plain version's, whose outputs may differ by an ulp
            ep_plain = rel_to(got[3] - ref[3], act.abs().sum(dim=(1, 2)))
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

    # ---- K1-bwd: the aggregator's backward at K1's shapes
    kb_err, kb_ms = 0.0, {}
    for shape in K1_SHAPES + UTAE_K1_SHAPES + K1_CHECK_SHAPES:
        B_, T_, H, W, C, heads = shape[:6]
        for dtype in (torch.bfloat16, torch.float32):
            x, a, gy = k1_inputs(shape, dtype)
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
                    f"heads={heads}{' x off 16 bytes' if len(shape) > 6 else ''}: "
                    f"max_abs_err={err:.3g} (tol {tol:.3g}), dx equal "
                    f"{bool(torch.equal(dx, rdx))}")
            if (shape in K1_SHAPES[:1] + UTAE_K1_SHAPES + [K1_BAND]) and dtype == BF16:
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
                if shape in UTAE_K1_SHAPES[:2]:
                    def fresh():
                        x_, a_, g_ = k1_inputs(shape, dtype)
                        return lambda: aggregate.att_group_aggregate_bwd(x_, a_, g_)

                    rms = time_rotated(fresh, nbytes(x, a, gy, dx, da))
                    line += (f"; inputs rotated past L2 {rms:.4f} ms ({bms / rms:.0%} of the "
                             f"bound; the first reading is partly L2's)")
            print(line)
            check(err <= tol, f"K1-bwd {dtype} {shape} disagrees with its plain version")
            check(torch.equal(dx, rdx), f"K1-bwd {dtype} {shape}: dx is not the plain product")
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
            y = Fn.conv2d(reflect_pad_plain(leaf, 1).permute(0, 3, 1, 2), w, groups=C)
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
                library = lambda: Fn.conv2d(reflect_pad_plain(x, 1).permute(0, 3, 1, 2), w,
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
                    reflect_pad_plain(x, 1).permute(0, 3, 1, 2), (C, 1, kh, kw), gc, groups=C)
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
    out.update(phase1_norms(dev, randn, result))
    out.update(phase1_pad(dev, randn, result))
    halo = phase1_halo_modes(dev, randn)
    for name, err in halo.items():
        out[name]["max_abs_err"] = max(out[name]["max_abs_err"], err)
    return out


def phase1_pad(dev, randn, result):
    """K7 at ``K7_CASES``: the forward bit-equal to ``F.pad`` (the plain
    version), the adjoint bit-equal to its plain version (the same fp32 sums
    in the same order, rounded once), the same bits twice, and within
    rounding of autograd's ``reflection_pad3d_backward``; at the two path
    shapes each timed against its byte bound and ATen's (``F.pad`` and its
    autograd backward)."""
    from uncrtaints_tpu_torch.ops import pad

    out = {}
    for name, (shape, p, dtype, timed) in K7_CASES.items():
        N, H, W, C = shape
        x = randn(*shape).to(dtype)
        y = pad.reflect_pad(x, p)
        g = randn(*y.shape).to(dtype)
        gx = pad.reflect_pad_adjoint(g, p)
        again = pad.reflect_pad_adjoint(g, p)
        torch.cuda.synchronize()
        fwd_ok = torch.equal(y, pad.reflect_pad_plain(x, p))
        twin = pad.reflect_pad_adjoint_plain(g, p)
        adj_ok, same = torch.equal(gx, twin), torch.equal(gx, again)
        del twin, again
        # ATen's backward sums in x's dtype with atomics: within 2 bf16 ulps
        # (1e-6 in fp32) of the largest |gx|
        leaf = torch.zeros_like(x).requires_grad_()
        ref = pad.reflect_pad_plain(leaf, p)
        aten = lambda: torch.autograd.grad(ref, leaf, g, retain_graph=True)[0]
        top = float(gx.float().abs().max())
        gap = float((aten().float() - gx.float()).abs().max())
        tol = (1e-6 if dtype == FP32 else 2 ** -6) * top
        line = (f"K7 reflect pad {name}, p={p}, {dtype}: forward bit-equal to F.pad {fwd_ok}; "
                f"adjoint bit-equal to its plain version {adj_ok}, deterministic {same}, "
                f"against ATen's backward max_abs_err={gap:.3g} (tol {tol:.3g})")
        if timed:
            fb = bound(nbytes(x, y), (0, PEAK_FP32))[0]  # a copy: no operations
            fms, flib = time_kernel(lambda: pad.reflect_pad(x, p)), time_kernel(
                lambda: pad.reflect_pad_plain(x, p))
            ams, alib = time_kernel(lambda: pad.reflect_pad_adjoint(g, p)), time_kernel(aten)
            apl = time_ms(lambda: pad.reflect_pad_adjoint_plain(g, p), runs=7)
            line += (f"; forward {fms:.4f} ms, bound {fb:.4f} ms ({fb / fms:.0%}), F.pad "
                     f"(the plain version and ATen's) {flib:.4f} ms; adjoint {ams:.4f} ms, "
                     f"bound {fb:.4f} ms ({fb / ams:.0%}), plain {apl:.4f} ms, ATen's backward "
                     f"{alib:.4f} ms")
            if "reflect_pad" not in out:  # the first timed case is the line's
                out["reflect_pad"] = result(0.0, fms, flib, fb, "bytes", flib)
                out["reflect_pad_adjoint"] = result(0.0, ams, apl, fb, "bytes", alib)
        print(line)
        check(fwd_ok, f"K7 {name}: the forward is not F.pad's tensor")
        check(adj_ok and same, f"K7 {name}: the adjoint is not its plain version's, or not "
                               "deterministic")
        check(gap <= tol, f"K7 {name}: the adjoint disagrees with ATen's backward")
        del x, y, g, gx, leaf, ref
        torch.cuda.empty_cache()
    return out


def phase1_norms(dev, randn, result):
    """K6 at ``K6_CASES``: the forward's statistics within 1e-5 of the
    twins' (fp32 sums in another order, relative to max x^2), its apply
    bit-equal to the twin's on the kernel's own coef / off (the same bf16
    roundings, torch's GELU and ReLU), y within 2^-6 of the largest output
    of the twins' whole forward (a coef or off one bf16 ulp apart where the
    statistics round the other way); the backward on the same inputs within
    1e-2 of the largest dx (fp32 inside, one bf16 rounding each side) and
    1e-4 of the largest dweight / dbias; two runs of each bit-equal. Timed
    at every case (CUDA events) beside the bound, the eager formula the port
    ran before (its autograd for the backward) and one library call: torch's
    batch or group norm on the channels_last view and the activation
    (autograd of it for the backward). Group and instance norms that take
    one pass (ops/norm.py:onchip_plan) are timed through the two-pass
    kernels too, and those held against the twins as well. Returns {kernel
    name: result} for the JSON line and the largest errors."""
    from uncrtaints_tpu_torch.ops import norm as tn
    U, Fn = torch.ops.uncrtaints, torch.nn.functional
    act_fn = {"gelu": Fn.gelu, "relu": Fn.relu, "none": lambda t: t,
              "leaky_relu": lambda t: Fn.leaky_relu(t, 0.01)}
    errs, line_out = {"fwd": 0.0, "bwd": 0.0}, {}
    for name, (kind, shape, G, act) in K6_CASES.items():
        C, A = shape[-1], tn.ACTS[act]
        x = (randn(*shape) * 2 + 1).bfloat16()
        gy = randn(*shape).bfloat16()
        w, b = randn(C) * 0.5 + 1, randn(C)
        if kind != "affine":  # the train step hands the parameters in bf16
            w, b = w.bfloat16(), b.bfloat16()
        nd = x.dim()  # the channels_last NC... view, and back
        to_nc, to_nhwc = (0, nd - 1, *range(1, nd - 1)), (0, *range(2, nd), 1)
        xc = x.permute(*to_nc)
        if kind == "affine":
            rm, rv = randn(C), randn(C).abs() + 0.5
            r = torch.rsqrt(rv + 1e-5)
            coef, off = (r * w).bfloat16(), (b - rm * r * w).bfloat16()
            fwd = lambda: U.norm_affine_act(x, coef, off, None, None, A)
            bwd = lambda: U.norm_affine_act_bwd(gy, x, coef, off, None, None, A)
            y, got_b = fwd(), bwd()
            torch.cuda.synchronize()
            ry = tn.affine_act_plain(x, coef, off, act)
            check(torch.equal(y, ry), f"K6 {name}: the apply is not the eager formula's bits")
            ref_b = tn.affine_act_bwd_twin(gy, x, coef, off, None, None, A)
            plain_f = lambda: tn.affine_act_plain(x, coef, off, act)
            leaves = [x.detach().requires_grad_(), coef.detach().requires_grad_(),
                      off.detach().requires_grad_()]
            yl = tn.affine_act_plain(*leaves, act)
            lib_f = lambda: act_fn[act](Fn.batch_norm(xc, rm, rv, w, b, training=False))
            stat = 0.0
        else:
            K = tn.KINDS[kind]
            fwd = lambda: U.norm_act(x, w, b, K, G, A, 0)
            n1 = (tn.norm_act.onchip, tn.norm_act_bwd.onchip)
            y, mvn, coef, off = fwd()
            bwd = lambda: U.norm_act_bwd(gy, x, w, b, mvn, coef, off, K, G, A, 0)
            got_b = bwd()
            torch.cuda.synchronize()
            onchip = (tn.norm_act.onchip - n1[0], tn.norm_act_bwd.onchip - n1[1])
            ry, rmvn, _, _ = tn.norm_act_twin(x, w, b, K, G, A)
            stat = float(((mvn - rmvn).abs()[:-1]).max()) / float(x.float().square().max())
            check(stat <= 1e-5 and float(mvn[-1]) == float(rmvn[-1]),
                  f"K6 {name}: statistics off the twins' by {stat:.3g}")
            Fr = coef.shape[0]
            twin_y = tn.apply_twin(x.view(Fr, -1, C), coef, off, tn.FORMS[K], A, w, b)
            check(torch.equal(y, twin_y.view(shape)),
                  f"K6 {name}: the apply is not the twin's bits on the kernel's coef / off")
            ref_b = tn.norm_act_bwd_twin(gy, x, w, b, mvn, coef, off, K, G, A)
            plain_f = lambda: tn.norm_act_plain(x, kind, w, b, G, act)
            leaves = [x.detach().requires_grad_(), w.detach().requires_grad_(),
                      b.detach().requires_grad_()]
            yl = tn.norm_act_plain(leaves[0], kind, leaves[1], leaves[2], G, act)[0]
            if kind in ("batch", "batch_f32"):
                lib_f = lambda: act_fn[act](Fn.batch_norm(xc, None, None, w.float(), b.float(),
                                                          training=True))
            else:
                wb, bb = w.bfloat16(), b.bfloat16()
                lib_f = lambda: act_fn[act](Fn.group_norm(xc, G, wb, bb, 1e-5))
        ferr = float((y.float() - ry.float()).abs().max())
        top = float(ry.float().abs().max())
        check(ferr <= 2 ** -6 * top, f"K6 {name}: y off the twins' by {ferr:.3g}")
        (dx, *dp), (rdx, *rdp) = got_b, ref_b
        berr = float((dx.float() - rdx.float()).abs().max())
        check(berr <= 1e-2 * float(rdx.float().abs().max()),
              f"K6-bwd {name}: dx off the twins' by {berr:.3g}")
        for d, r_ in zip(dp, rdp):
            if not r_.numel():  # the affine form's dweight / dbias: none
                continue
            top_d = max(float(r_.float().abs().max()), 1.0)
            tol = (1e-2 if d.dtype == torch.bfloat16 else 1e-4) * top_d
            check(float((d.float() - r_.float()).abs().max()) <= tol,
                  f"K6-bwd {name}: dweight / dbias off the twins'")
        again_f, again_b = fwd(), bwd()
        same = all(torch.equal(p, q) for p, q in zip(
            (y, *got_b) if kind == "affine" else (y, mvn, coef, off, *got_b),
            (again_f, *again_b) if kind == "affine" else (*again_f, *again_b)))
        check(same, f"K6 {name}: two runs differ")
        # the library call computes the same function (bf16 inside: 2^-5 of
        # max), its NCHW view taken back to NHWC
        lerr = float((lib_f().permute(*to_nhwc).float() - ry.float()).abs().max())
        check(lerr <= 2 ** -5 * top, f"K6 {name}: the library call computes another function "
                                     f"({lerr:.3g})")
        lib_leaf = xc.detach().requires_grad_()
        if kind == "affine":
            lib_y = act_fn[act](Fn.batch_norm(lib_leaf, rm, rv, w, b, training=False))
        elif kind in ("batch", "batch_f32"):
            lib_y = act_fn[act](Fn.batch_norm(lib_leaf, None, None, w.float(), b.float(),
                                              training=True))
        else:
            lib_y = act_fn[act](Fn.group_norm(lib_leaf, G, wb, bb, 1e-5))
        gyc = gy.permute(*to_nc)
        kf, kb = time_kernel(fwd), time_kernel(bwd)
        two = ""
        if kind != "affine" and any(onchip):  # the same call through the two passes
            Gk, form = (C if kind == "instance" else G), tn.FORMS[K]
            x3, g3 = x.view(coef.shape[0], -1, C), gy.view(coef.shape[0], -1, C)
            cnt = x3.shape[1] * (C // Gk)
            two_f = lambda: tn.forward_two_pass(x3, w, b, K, Gk, A, form, cnt)
            two_b = lambda: tn.backward_two_pass(g3, x3, w, b, mvn, coef, off, K, Gk, A, form)
            y2, dx2 = two_f()[0].view(shape), two_b()[0]
            e2 = float((y2.float() - ry.float()).abs().max())
            check(e2 <= 2 ** -6 * float(ry.float().abs().max()),
                  f"K6 {name}: the two passes' y off the twins' by {e2:.3g}")
            d2 = float((dx2.float() - ref_b[0].float().view(dx2.shape)).abs().max())
            check(d2 <= 1e-2 * float(ref_b[0].float().abs().max()),
                  f"K6-bwd {name}: the two passes' dx off the twins' by {d2:.3g}")
            tf2, tb2 = time_kernel(two_f), time_kernel(two_b)
            del y2, dx2
            two = (f"; one pass forward / backward {onchip}, two passes {tf2:.4f} / {tb2:.4f} "
                   f"ms ({{bf}} / {{bb}} of bound)")
        pf = time_ms(plain_f, runs=7)
        pb = time_ms(lambda: torch.autograd.grad(yl, leaves, gy, retain_graph=True), runs=7)
        lf = time_kernel(lib_f)
        lb = time_kernel(lambda: torch.autograd.grad(lib_y, lib_leaf, gyc, retain_graph=True))
        n = x.numel()
        gelu = act == "gelu"
        f_ops = n * (K6_FWD_OPS + (GELU_OPS if gelu else 1) + (0 if kind != "affine" else -3))
        b_ops = n * (K6_BWD_OPS + (GELU_OPS + 5 if gelu else 1))
        bf, byf = bound(2 * nbytes(x), (f_ops, PEAK_FP32), (n * GELU_SFU * gelu, PEAK_SFU))
        bb_ms, byb = bound(3 * nbytes(x), (b_ops, PEAK_FP32), (2 * n * gelu, PEAK_SFU))
        print(f"K6 {name}: forward max_abs_err {ferr:.3g} (tol {2 ** -6 * top:.3g}; statistics "
              f"{stat:.3g} of max x^2; apply bit-equal), kernel {kf:.4f} ms ({bf / kf:.0%} of "
              f"bound {bf:.4f} ms, {byf}), plain {pf:.4f} ms, library {lf:.4f} ms; backward "
              f"max_abs_err {berr:.3g}, kernel {kb:.4f} ms ({bb_ms / kb:.0%} of bound "
              f"{bb_ms:.4f} ms, {byb}), plain (autograd of the eager formula) {pb:.4f} ms, "
              f"library (autograd) {lb:.4f} ms; two runs bit-equal"
              + (two.format(bf=f"{bf / tf2:.0%}", bb=f"{bb_ms / tb2:.0%}") if two else ""))
        errs["fwd"], errs["bwd"] = max(errs["fwd"], ferr), max(errs["bwd"], berr)
        if name == K6_LINE_CASE:
            line_out["norm_act"] = result(0.0, kf, pf, bf, byf, lf)
            line_out["norm_act_bwd"] = result(0.0, kb, pb, bb_ms, byb, lb)
        del x, gy, y, yl, lib_y, leaves, lib_leaf, got_b, ref_b, again_f, again_b
    line_out["norm_act"]["max_abs_err"] = errs["fwd"]
    line_out["norm_act_bwd"]["max_abs_err"] = errs["bwd"]
    return line_out

def phase1_norms_alone(dev):
    """Phase 1's K6 alone (``--k6``): the build, then :func:`phase1_norms`."""
    from uncrtaints_tpu_torch import _build
    t0 = time.perf_counter()
    _build.lib()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s")
    g = torch.Generator(device=dev).manual_seed(SEED)
    result = lambda *a: dict(zip(("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                  "library_ms"), a))
    return phase1_norms(dev, lambda *s: torch.randn(*s, generator=g, device=dev), result)


# the group chain at the benchmark's eval batch: the paper encoder's block
# over B=16 x T=3 frames of 256x256x128, bf16
GN_FRAMES = 16 * T


def phase1_group_chain(dev):
    """The encoder's group-norm MBConv in eval as the group chain
    (``MBConv._fused_group_body``) at GN_FRAMES frames: the block against
    its standard body (the fused-vs-standard gate) and both timed; each
    pass of the chain on the block's own intermediates, timed beside its
    bound; the statistics pass and the pooled-sum pass against their twins
    (1e-5 of the sum of |terms|), the apply bit-equal to its twin, two calls
    of the pooled sum bit-equal, and the eager SE sum it replaces. Returns
    {wrapper name: the :func:`phase1_kernels` fields} of the three passes."""
    from uncrtaints_tpu_torch.models.blocks import MBConv
    from uncrtaints_tpu_torch.models.layers import Norm2d, init_weights
    from uncrtaints_tpu_torch.ops import mbconv, norm

    gen = torch.Generator().manual_seed(SEED)
    blk = MBConv(128, 128, expansion=2, norm="group")
    init_weights(blk, gen)
    with torch.no_grad():
        for m in blk.modules():  # the group norms' affines off 1 and 0
            if isinstance(m, Norm2d):
                m.weight.copy_(1.0 + 0.3 * torch.randn(m.weight.shape, generator=gen))
                m.bias.copy_(0.3 * torch.randn(m.bias.shape, generator=gen))
    blk = blk.to(dev).eval()
    for p in blk.parameters():
        p.data = p.data.bfloat16()
    g = torch.Generator(device=dev).manual_seed(SEED)
    a = (torch.randn(GN_FRAMES, PATCH, PATCH, 128, generator=g, device=dev) * 1.5
         + 0.5).bfloat16()
    NF, H, W, C = a.shape
    P, hid, G = H * W, blk.hidden, blk.n_groups
    fn, shape = blk.conv.fn, f"[{NF},{H},{W},{C}]"
    with torch.inference_mode():
        std = blk(a)
        blk.fused_eval = True
        n0 = {f.__name__: f.launches for f in (mbconv.norm_gelu_matmul,
                                                mbconv.norm_gelu_dwconv3x3, norm.norm_stats,
                                                norm.norm_gelu_pool, norm.norm_apply)}
        got = blk(a)
        torch.cuda.synchronize()
        n1 = {f.__name__: f.launches - n0[f.__name__]
              for f in (mbconv.norm_gelu_matmul, mbconv.norm_gelu_dwconv3x3, norm.norm_stats,
                        norm.norm_gelu_pool, norm.norm_apply)}
        check(n1 == {"norm_gelu_matmul": 2, "norm_gelu_dwconv3x3": 1, "norm_stats": 1,
                     "norm_gelu_pool": 1, "norm_apply": 1}, f"the group chain launched {n1}")
        gap = gap_ok(got, std)
        print(f"group chain: the encoder block {shape} bf16 against its standard body: max "
              f"{gap['max']:.4g} (<= {0.02 * gap['max_ref']:.4g}), RMSE {gap['rmse']:.4g} (<= "
              f"{5e-3 * gap['max_ref']:.4g}); two calls bit-equal {torch.equal(blk(a), got)}")
        check(gap["ok"], "the group chain is off its standard body")
        check(torch.equal(blk(a), got), "two calls of the group chain differ")
        del std, got
        t_chain = time_kernel(lambda: blk(a))
        blk.fused_eval = False
        t_std = time_kernel(lambda: blk(a))
        blk.fused_eval = True
        print(f"  the block: standard body {t_std:.3f} ms, group chain {t_chain:.3f} ms "
              f"({t_std / t_chain:.2f}x)")

        # each pass on the block's own intermediates
        a3 = a.view(NF, P, C)
        m0, r0 = norm.group_moments(norm.norm_stats(a3, G), P * C // G)
        w1 = fn[0].weight[:, :, 0, 0].t().to(torch.bfloat16).contiguous()
        k3a = (a3, m0, r0, blk.conv.norm.weight, blk.conv.norm.bias, w1)
        k3a_kw = dict(groups_in=G, groups_out=G, do_gelu=False, do_stats=True)
        h1, s1, q1 = mbconv.norm_gelu_matmul(*k3a, **k3a_kw)
        m1, r1 = norm.group_moments(torch.stack([s1, q1]), P * hid // G)
        wd = fn[3].weight[:, 0].permute(1, 2, 0)
        k4a = (h1.view(NF, H, W, hid), m1, r1, fn[1].weight, fn[1].bias, wd)
        k4_kw = dict(groups_in=G, groups_out=G, do_stats=True)
        h2, s2, q2 = mbconv.norm_gelu_dwconv3x3(*k4a, **k4_kw)
        m2, r2 = norm.group_moments(torch.stack([s2, q2]), P * hid // G)
        pa = (h2, m2, r2, fn[4].weight, fn[4].bias)
        pool = norm.norm_gelu_pool(*pa)
        se = fn[6](h2, mean=pool / P, scale_only=True)
        w2 = fn[7].weight[:, :, 0, 0].t().to(torch.bfloat16).contiguous()
        k3b = (h2.view(NF, P, hid), m2, r2, fn[4].weight, fn[4].bias, w2)
        k3b_kw = dict(se=se, groups_in=G, groups_out=G, do_gelu=True, do_stats=True)
        y, s3, q3 = mbconv.norm_gelu_matmul(*k3b, **k3b_kw)
        coef, off = norm.group_affine(*norm.group_moments(torch.stack([s3, q3]), P * C // G),
                                      fn[8].weight, fn[8].bias, y.dtype)
        z = norm.norm_apply(y, coef, off)

        # the statistics pass and the apply against their twins
        sums, stwin = norm.norm_stats(a3, G), norm.stats_twin(a3, G)
        es = rel_to(sums - stwin, norm.stats_twin(a3.abs(), G))  # [sum |x|, sum x^2]
        same_apply = torch.equal(z, norm.apply_twin(y, coef, off, 0, norm.ACTS["none"]))
        print(f"  K6 statistics pass {list(a3.shape)} bf16: rel_err against its twin {es:.3g} "
              f"(tol 1e-5); K6 apply (gn3) bit-equal to its twin {same_apply}")
        check(es <= 1e-5, "the statistics pass disagrees with its twin")
        check(same_apply, "the apply differs from its twin")

        # the pooled sum against its twin, and repeated
        twin = norm.gelu_pool_twin(h2.view(NF, P, hid), m2, r2, fn[4].weight, fn[4].bias)
        terms = torch.zeros_like(twin)
        for f0 in range(0, NF, 8):  # the sum of |terms|, a few frames at a time
            hf = h2[f0:f0 + 8].view(-1, P, hid).float()
            mf = m2[f0:f0 + 8].repeat_interleave(hid // G, -1)[:, None, :]
            rf = r2[f0:f0 + 8].repeat_interleave(hid // G, -1)[:, None, :]
            terms[f0:f0 + 8] = torch.nn.functional.gelu(
                (hf - mf) * rf * fn[4].weight.float() + fn[4].bias.float()).abs().sum(dim=1)
            del hf
        ep = rel_to(pool - twin, terms)
        same = torch.equal(norm.norm_gelu_pool(*pa), pool)
        print(f"  pooled-sum pass {list(h2.shape)} bf16: rel_err against its twin {ep:.3g} "
              f"(tol 1e-5), two calls bit-equal {same}")
        check(ep <= 1e-5, "the pooled-sum pass disagrees with its twin")
        check(same, "two calls of the pooled-sum pass differ")

        nel, nh = a.numel(), h2.numel()
        cases = [  # (name, call, bytes, fp32 operations, special-function operations)
            ("K6 statistics pass", lambda: norm.norm_stats(a3, G), nbytes(a), 3 * nel, 0),
            ("K3 pw1, gn0 prologue, gn1 statistics", lambda: mbconv.norm_gelu_matmul(
                *k3a, **k3a_kw), nbytes(a, h1), 4 * nel, 0),
            ("K4, gn1 + GELU, gn2 statistics", lambda: mbconv.norm_gelu_dwconv3x3(
                *k4a, **k4_kw), nbytes(h1, h2), (4 + GELU_OPS + 18 + 3) * nh, GELU_SFU * nh),
            ("pooled-sum pass", lambda: norm.norm_gelu_pool(*pa), nbytes(h2),
             (4 + GELU_OPS + 1) * nh, GELU_SFU * nh),
            ("K3 pw2, gn2 + GELU + SE prologue, gn3 statistics", lambda: mbconv.norm_gelu_matmul(
                *k3b, **k3b_kw), nbytes(h2, y), (5 + GELU_OPS) * nh, GELU_SFU * nh),
            ("K6 apply (gn3)", lambda: norm.norm_apply(y, coef, off), nbytes(y, z), 2 * nel, 0),
            ("residual add (eager)", lambda: a + z.view(a.shape), 3 * nbytes(a), nel, 0),
        ]
        total, total_bound, timed = 0.0, 0.0, {}
        for name, call, n_byte, ops, sfu in cases:
            kms = time_kernel(call)
            bms, by = bound(n_byte, (ops, PEAK_FP32), (sfu, PEAK_SFU))
            total, total_bound, timed[name] = total + kms, total_bound + bms, (kms, bms, by)
            print(f"  {name}: {kms:.4f} ms, bound {bms:.4f} ms ({by}: {n_byte / 1e6:.1f} MB; "
                  f"{bms / kms:.0%} of it)")
        pms = time_ms(lambda: norm.gelu_pool_twin(h2.view(NF, P, hid), m2, r2, fn[4].weight,
                                                  fn[4].bias), runs=3)
        sms = time_ms(lambda: norm.stats_twin(a3, G), runs=3)
        ams = time_ms(lambda: norm.apply_twin(y, coef, off, 0, norm.ACTS["none"]), runs=3)
        gelu_map = fn[4](h2, act="gelu")  # the standard body's gelu(gn2(h2)), the eager SE's input
        lms = time_kernel(lambda: gelu_map.sum(dim=(1, 2), dtype=torch.float32))
        gms = time_kernel(lambda: gelu_map * (se.to(gelu_map.dtype)[:, None, None, :]))
        print(f"  the passes {total:.3f} ms (bounds {total_bound:.3f} ms); the twins: statistics "
              f"{sms:.3f} ms, pooled sum {pms:.3f} ms, apply {ams:.3f} ms; the standard body's "
              f"eager SE on gelu(gn2(h2)): the pooled sum {lms:.4f} ms and the gate x * y "
              f"{gms:.4f} ms")
    fields = lambda err, case, plain_ms: dict(zip(
        ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"),
        (err, timed[case][0], plain_ms, *timed[case][1:], None)))
    return {"norm_stats": fields(float((sums - stwin).abs().max()), "K6 statistics pass", sms),
            "norm_gelu_pool": fields(float((pool - twin).abs().max()), "pooled-sum pass", pms),
            "norm_apply": fields(0.0, "K6 apply (gn3)", ams)}


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
            # the library's adjoint: autograd of the halo rows, the reflect
            # pad and cuDNN's conv (its input gradient, then the pad's and the
            # concatenation's backward), as K5's whole-map adjoint row
            leaf = torch.zeros_like(b).requires_grad_()
            hleaf = torch.zeros_like(h[1]).requires_grad_()
            xe = torch.cat([leaf[:, 1:2], leaf, hleaf], 1)
            y = Fn.conv2d(Fn.pad(xe.unsqueeze(1), (0, 0, 1, 1, 0, 0), mode="reflect").squeeze(1)
                          .permute(0, 3, 1, 2), wc, groups=C)
            gcb = g.permute(0, 3, 1, 2)

            def lib_adj():
                return torch.autograd.grad(y, (leaf, hleaf), gcb, retain_graph=True)

            t_adj_lib = time_kernel(lib_adj)
            for got, want in zip(lib_adj(), (adj[0][0], adj[0][2])):
                check(float((got.float() - want.float()).abs().max())
                      <= 4 * ulp * float(want.float().abs().max()),
                      f"K5 halo adjoint {case}: the library composition computes another function")
            del y
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
                  f"bound {abms:.4f}, autograd of halo concat + reflect F.pad + cuDNN "
                  f"{t_adj_lib:.4f}); K2 {t_gw:.4f} (whole-mode {t_gw_whole:.4f}, plain "
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
        ep = rel_to(sum(p[3] for p in parts) - whole[3], act)
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
    from uncrtaints_tpu_torch.ops import aggregate, dwconv, dwgrad, mbconv, norm, pad
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
                     dwgrad.dw_kernel_grad, norm.norm_act_bwd, pad.reflect_pad_adjoint)
    gn_passes = {k: f for k, f in kernel_wrappers().items() if k in GN_PASSES}
    for f in (aggregate.att_group_aggregate, mbconv.norm_gelu_matmul,
              mbconv.norm_gelu_dwconv3x3, norm.norm_act, pad.reflect_pad, *gn_passes.values(),
              *train_kernels):
        f.launches = 0
    mbconv.norm_gelu_matmul.wgmma_launches = 0
    norm.norm_act.onchip = 0
    times, results = [], []
    for _ in range(2):
        for b in batches:
            t0 = time.perf_counter()
            aux = step(model, b)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            results.append(aux)
    k1, k3 = aggregate.att_group_aggregate.launches, mbconv.norm_gelu_matmul.launches
    k4, k6 = mbconv.norm_gelu_dwconv3x3.launches, norm.norm_act.launches
    k7 = pad.reflect_pad.launches
    n_fwd = len(times)
    print(f"phase 2: paper recipe (bf16, {n_params} parameters), {n_fwd} eval "
          f"steps of B={B}, T={T}, {P}x{P}: K1 launches {k1}, K3 launches {k3}, "
          f"K4 launches {k4}, K6 launches {k6}, K7 launches {k7}")
    check(k1 == n_fwd, f"K1 launched {k1} times in {n_fwd} forwards (1 each expected)")
    check(k3 == K3_EVAL * n_fwd,
          f"K3 launched {k3} times in {n_fwd} forwards ({K3_EVAL} each expected)")
    check(k4 == K4_EVAL * n_fwd,
          f"K4 launched {k4} times in {n_fwd} forwards ({K4_EVAL} each expected)")
    gn = {k: f.launches for k, f in gn_passes.items()}
    print(f"  the group chain's passes: {gn}")
    check(all(n == GN_PASSES_EVAL * n_fwd for n in gn.values()),
          f"the group chain's passes launched {gn} in {n_fwd} forwards ({GN_PASSES_EVAL} each "
          "expected: the encoder's block)")
    check(k6 == K6_EVAL * n_fwd,
          f"K6 launched {k6} times in {n_fwd} forwards ({K6_EVAL} each expected)")
    print(f"  K6 in one pass: {norm.norm_act.onchip} of the {k6} forwards")
    check(norm.norm_act.onchip == K6_ONCHIP_EVAL * n_fwd,
          f"{norm.norm_act.onchip} K6 forwards took one pass in {n_fwd} forwards "
          f"({K6_ONCHIP_EVAL} each expected: in_conv's group norm)")
    check(k7 == K7_EVAL * n_fwd,
          f"K7 launched {k7} times in {n_fwd} forwards ({K7_EVAL} each expected)")
    check(mbconv.norm_gelu_matmul.wgmma_launches == k3,
          f"only {mbconv.norm_gelu_matmul.wgmma_launches} of the {k3} K3 launches ran the "
          "wgmma kernel")
    check(all(f.launches == 0 for f in train_kernels),
          "the eval step launched a backward or train-only kernel (K1-bwd, K5, K2, K6-bwd, "
          "K7's adjoint)")
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
    return cfg, model, batches, {"K1": k1, "K3": k3, "K4": k4, "K6": k6, "K7": k7, **gn}, ms


def profile_eval_step(step, model, batch, step_ms):
    """One more eval step under ``torch.profiler``, reported by
    :func:`eval_step_report`: the step must run 1 K1, 12 K3 through the
    wgmma kernel (three with statistics, each its two channel sums and its
    group sum), 6 K4 (the decoder's 5 each with its pooled-sum pass, the
    encoder's with statistics), the group chain's statistics pass (one
    partial pass, one group sum), pooled-sum pass (with its channel sum)
    and apply, in_conv's one-pass K6 (no statistics pass, no per-slot math
    of its own), no K7 and no ATen reflection_pad kernel, and the five
    fused decoder blocks no GELU, mean or sum over a whole map outside the
    kernels."""
    found, eager = eval_step_report(step, model, batch, step_ms)
    want = {"att_group_": 1, "ngm_wg_kernel": K3_EVAL, "ngm_kernel": 0,
            "ngd_tile_kernel": K4_EVAL, "channel_sum_kernel": 5 + 3 * 2 + 1,
            "group_stats_kernel": 3 + 1, "norm_part_kernel": 1, "norm_finalize_kernel": 0,
            "norm_apply_kernel": K6_EVAL + 1, "norm_apply_kernel_onchip": K6_ONCHIP_EVAL,
            "gelu_pool_part_kernel": 1, "reflect_pad_nhwc_kernel": K7_EVAL,
            "reflection_pad": 0}
    check(found == want,
          f"the eval step's kernels {found}, expected {want} (1 K1, 12 K3 through "
          "the wgmma kernel, 6 K4, the decoder's 5 with their pooled-sum passes, the group "
          "chain's statistics, pooled-sum and apply passes, in_conv's one-pass norm, no pad)")
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
                                   "channel_sum_kernel", "group_stats_kernel", "norm_part_kernel",
                                   "norm_finalize_kernel", "norm_apply_kernel",
                                   "norm_apply_kernel_onchip", "gelu_pool_part_kernel",
                                   "reflect_pad_nhwc_kernel", "reflection_pad")}
    print(f"    kernels by name: {found}")
    # the hand-written kernels one by one (template arguments tell the two K3 shapes apart)
    for key, (n, ms) in sorted(names.items()):
        if any(f in key for f in ("ngm_", "ngd_", "channel_sum_kernel", "att_group_", "norm_",
                                  "gelu_pool_")):
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
    step32 = make_eval_step(cfg.replace(compute_dtype="float32"))
    fused_gate("phase 3: eval on the card", fused, std, step32(model, batch), step32(off, batch))

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
    from uncrtaints_tpu_torch.ops import mbconv
    from uncrtaints_tpu_torch.train import batch_to_device, make_eval_step

    S, tile, overlap, bs = 1024, PATCH, 64, B
    nb = collate_multi([SyntheticSEN12MSCRTS(n_samples=1, n_input_t=T, patch_size=S,
                                             seed=SEED + 6)[0]], use_sar=True)
    scene, dates = nb["x"][0], nb["dates"][0]
    kernels = kernel_wrappers()
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
    want = chain_launches(0, n_fwd)
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
    cfg32 = cfg.replace(compute_dtype="float32")
    as_t = lambda r: {k: torch.from_numpy(v) for k, v in r.items() if k in ("pred", "var")}
    fused_gate("  the scene", as_t(out), as_t(std),
               as_t(predict_scene(model, cfg32, scene, dates, **kw)),
               as_t(predict_scene(off, cfg32, scene, dates, **kw)))
    return counts


def phase4_train(dev, batches):
    from uncrtaints_tpu_torch.config import Config, derive
    from uncrtaints_tpu_torch.ops import norm
    from uncrtaints_tpu_torch.train import create_train_state, make_train_step

    cfg = derive(Config(use_sar=True, scale_by=10.0))  # the paper recipe, bf16
    model = seeded_model(cfg, dev)
    state = create_train_state(cfg, model)
    step = make_train_step(cfg)
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    step(state, batches[0], gen)  # warm-up (cuDNN plans, allocator)
    torch.cuda.synchronize()
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    kernels = kernel_wrappers()
    torch.cuda.reset_peak_memory_stats(dev)
    for f in kernels.values():
        f.launches = 0
    norm.norm_act.onchip = norm.norm_act_bwd.onchip = 0
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
    per_step = chain_launches(1, 0)
    for k, n in per_step.items():
        check(counts[k] == n * TRAIN_STEPS,
              f"{k} launched {counts[k]} times in {TRAIN_STEPS} train steps ({n} each expected)")
    onchip = (norm.norm_act.onchip, norm.norm_act_bwd.onchip)
    print(f"  K6 / K6-bwd in one pass: {onchip} of {counts['K6']} / {counts['K6-bwd']}")
    check(onchip == (K6_ONCHIP * TRAIN_STEPS, 0),
          f"{onchip} K6 / K6-bwd calls took one pass in {TRAIN_STEPS} train steps "
          f"({K6_ONCHIP} + 0 each expected: the encoder's group norms' forwards)")
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
    # two runs of one step from the same weights, batch and dropout seed give
    # the same gradients bit for bit (the attention upsample's backward sums
    # in a fixed order, ops/resize.py), so two chains of the CLIs agree
    runs = []
    for _ in range(2):
        _, aux = step(create_train_state(cfg, seeded_model(cfg, dev)), batches[0],
                      torch.Generator(device=dev).manual_seed(SEED + 5))
        runs.append({n: g.clone() for n, g in aux["grads"].items()})
    differ = [n for n in runs[0] if not torch.equal(runs[0][n], runs[1][n])]
    print(f"  two runs of one step from the same state: {len(differ)} of {len(runs[0])} "
          f"parameter gradients differ")
    check(not differ, f"two runs of one train step gave other gradients for {differ[:8]}")
    return counts, ms


# the remat phase: the paper recipe's train step with and without --remat
REMAT_BATCHES, REMAT_STEPS = (4, 8), 3


def phase_remat(dev):
    """The paper recipe's train step (bf16) at B=4 and B=8, without and
    with ``remat`` (each UnCRtainTS block recomputed in the backward), from
    the same seeded weights on the same batch: peak device memory, median
    step ms of ``REMAT_STEPS``, one more step's device time under the
    profiler, the launches a step (remat: K5 18 = 6 forwards + 6 recomputed
    forwards + 6 folded adjoints; K2 6, K1 1, K1-bwd 1). Gates: remat's
    peak below the plain one at each batch, the first step's loss
    bit-equal, every gradient within RMSE max(1e-3, twice the plain step's
    own run-to-run gap) of its largest element from the plain one (not
    those zero in exact arithmetic, whose rounding noise is not
    comparable), every gradient finite and non-zero but those zero in exact
    arithmetic. Returns the launches."""
    from torch.profiler import ProfilerActivity, profile
    from uncrtaints_tpu_torch.config import Config, derive
    from uncrtaints_tpu_torch.data import SyntheticSEN12MSCRTS, collate_multi
    from uncrtaints_tpu_torch.train import batch_to_device, create_train_state, make_train_step
    kernels = kernel_wrappers()
    total = dict.fromkeys(kernels, 0)
    ds = SyntheticSEN12MSCRTS(n_samples=max(REMAT_BATCHES), n_input_t=T, patch_size=PATCH,
                              seed=SEED + 15)
    for nb in REMAT_BATCHES:
        batch = batch_to_device(collate_multi([ds[i] for i in range(nb)], use_sar=True), dev)
        res = {}
        for remat in (False, True):
            cfg = derive(Config(use_sar=True, scale_by=10.0, remat=remat))
            model = seeded_model(cfg, dev)
            state, step = create_train_state(cfg, model), make_train_step(cfg)
            gen = torch.Generator(device=dev).manual_seed(SEED + 4)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            for f in kernels.values():
                f.launches = 0
            times, first = [], None
            for _ in range(REMAT_STEPS):
                t0 = time.perf_counter()
                state, aux = step(state, batch, gen)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
                if first is None:
                    first = (aux["loss"].clone(), {n: g.clone() for n, g in aux["grads"].items()})
            counts = {k: f.launches for k, f in kernels.items()}
            peak = torch.cuda.max_memory_allocated(dev)
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                step(state, batch, gen)
                torch.cuda.synchronize()
            kinds, _, _ = device_time_by_kind(prof, KERNEL_KINDS)
            for k, n in counts.items():
                total[k] += n
            res[remat] = dict(peak=peak, ms=statistics.median(times), counts=counts,
                              busy=sum(t for t, _ in kinds.values()), first=first,
                              zero=exact_zero_gradients(model))
            if not remat:  # the plain first step once more: the run-to-run noise
                _, aux = step(create_train_state(cfg, seeded_model(cfg, dev)), batch,
                              torch.Generator(device=dev).manual_seed(SEED + 4))
                again = {n: g.clone() for n, g in aux["grads"].items()}
            del model, state, aux
            torch.cuda.empty_cache()
        plain, rem = res[False], res[True]
        for remat, r in res.items():
            per = {k: r["counts"][k] // REMAT_STEPS
                   for k in ("K5", "K2", "K1", "K1-bwd", "K6", "K6-bwd")}
            print(f"remat phase: paper recipe train step, bf16, B={nb}, T={T}, {PATCH}x{PATCH}, "
                  f"remat {remat}: peak device memory {r['peak'] / 2**30:.3f} GiB ({r['peak']} "
                  f"bytes), step {r['ms']:.2f} ms (median of {REMAT_STEPS}), device busy "
                  f"{r['busy']:.2f} ms (one step under the profiler), launches a step {per}")
            want = {**chain_launches(1, 0), "K5": 18 if remat else 12,
                    "K6": K6_REMAT if remat else K6_TRAIN}
            check(r["counts"] == {k: n * REMAT_STEPS for k, n in want.items()},
                  f"B={nb} remat {remat}: launches {r['counts']} in {REMAT_STEPS} steps, "
                  f"expected {want} a step")
        (lp, gp), (lr, gr) = plain["first"], rem["first"]
        # held: every gradient but those zero in exact arithmetic (noise),
        # against twice the plain step's own run-to-run gap (0: no sum of
        # the step uses atomics) or 1e-3, whichever is larger
        held = [n for n in gp if n not in plain["zero"]]
        rel = lambda a, n: float((a[n] - gp[n]).float().square().mean().sqrt()) / float(
            gp[n].abs().max())
        gaps = {n: rel(gr, n) for n in held}
        worst = max(gaps, key=gaps.get)
        floor = max(rel(again, n) for n in held)
        bound = max(1e-3, 2 * floor)
        bad = [n for n, g in gr.items()
               if not bool(torch.isfinite(g).all()) or (float(g.abs().max()) == 0
                                                        and n not in rem["zero"])]
        print(f"  B={nb}: remat / plain peak {rem['peak'] / plain['peak']:.3f}, step time "
              f"{rem['ms'] / plain['ms']:.3f}, device busy {rem['busy'] / plain['busy']:.3f}; "
              f"first loss {float(lr)!r} vs {float(lp)!r} (bit-equal {bool(torch.equal(lr, lp))});"
              f" largest gradient RMSE over max {gaps[worst]:.3g} ({worst}; {len(held)} of "
              f"{len(gp)} gradients held), plain against plain {floor:.3g} (bound "
              f"{bound:.3g})")
        check(rem["peak"] < plain["peak"], f"B={nb}: remat peak {rem['peak']} not below "
                                           f"{plain['peak']}")
        check(torch.equal(lr, lp), f"B={nb}: remat's first loss {float(lr)} != {float(lp)}")
        check(gaps[worst] <= bound, f"B={nb}: remat gradient of {worst} off by {gaps[worst]}")
        check(not bad, f"B={nb}: remat gradients zero or not finite: {bad[:8]}")
    return total


def profile_train_step(step, state, batch, gen, paper_recipe=True, step_ms=None):
    """One more train step under ``torch.profiler``; prints the device time
    by kind (and, given the unprofiled ``step_ms``, the device's idle share
    and the largest kernels). It fails if ATen's reflect pad runs (U-TAE pads
    its 3x3 convolutions for cuDNN through K7), and for the paper recipe if
    K7 runs or K5 or K2 is missing."""
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
    check("reflect pad" not in kinds, "the train step ran ATen's reflection_pad kernel, not K7")
    if not paper_recipe:
        top = sorted(names.items(), key=lambda kv: -kv[1][1])[:6]
        print("    the largest kernels: " + "; ".join(f"{k[:64]} x{n} {ms:.3f} ms"
                                                     for k, (n, ms) in top))
        return
    check("K7 reflect pad and its adjoint" not in kinds, "the paper train step padded: the "
          "differentiated reflect depthwise conv must not pad")
    check(kinds.get("K5 depthwise stencil", (0, 0))[1] >= 12
          and kinds.get("K2 depthwise weight gradient", (0, 0))[1] >= 12,
          f"the profile misses K5 or K2 kernels: {kinds}")
    # every norm through K6: four kernels a forward and four a backward, the
    # group norms' forwards one
    k6 = kinds.get("K6 and K6-bwd norm + activation", (0, 0))[1]
    want = 8 * K6_TRAIN - 3 * K6_ONCHIP
    check(k6 == want, f"the train step ran {k6} K6 kernels, {want} expected")


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
            "K2": 6 * train_steps, "K3": K3_EVAL * eval_forwards,
            "K4": K4_EVAL * eval_forwards,
            "K6": K6_TRAIN * train_steps + K6_EVAL * eval_forwards,
            "K6-bwd": K6_TRAIN * train_steps, "K7": K7_EVAL * eval_forwards, "K7-adj": 0,
            **dict.fromkeys(GN_PASSES, GN_PASSES_EVAL * eval_forwards)}


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
    # a train step repeats to the bit (no sum of its forward or backward uses
    # atomics), so one-step and 8-step train epochs agree to the bit with
    # the prefetch and without it
    first = [epoch("train", p, train_step=train_step, samples=B)[0]["train_loss"]
             for p in (True, False)]
    check(first[0] == first[1], f"one-step train epoch with the prefetch and without {first}")
    losses = [m["train_loss"] for m, _, _ in train]
    check(len(set(losses)) == 1, f"train epoch losses with and without the prefetch {losses}")
    print(f"  prefetch on, off, off, on, {len(ds)} samples: val epoch loss and every metric "
          f"equal to the bit; a one-step and the 8-step train epochs' losses equal to the bit "
          f"({losses[0]!r})")
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
    want = {"K1": 3 * (steps + evals), "K1-bwd": 3 * steps, "K5": 0, "K2": 0, "K3": 0, "K4": 0,
            "K6": K6_UTAE * (steps + evals), "K6-bwd": K6_UTAE * steps,
            "K7": K7_UTAE * (steps + evals), "K7-adj": K7_UTAE * steps,
            **dict.fromkeys(GN_PASSES, 0)}
    print(f"phase 8: U-TAE (encoder [64,64,64,128], decoder [32,32,64,128], 16 heads, d_model "
          f"256; bf16, B={B}, T={T}, {PATCH}x{PATCH}): cli.train 1 epoch and cli.test, "
          f"{chain_s:.1f} s, {steps} train steps and {evals} eval forwards, launches {counts}")
    check(counts == want, f"the U-TAE chain launched {counts}, expected {want} (3 K1, "
                          f"{K6_UTAE} K6 and {K7_UTAE} K7 a forward, 3 K1-bwd, {K6_UTAE} K6-bwd "
                          f"and {K7_UTAE} K7 adjoints a train step, nothing else)")
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
    check(ev_counts == {"K1": 18, "K1-bwd": 0, "K5": 0, "K2": 0, "K3": 0, "K4": 0,
                        "K6": 6 * K6_UTAE, "K6-bwd": 0, "K7": 6 * K7_UTAE, "K7-adj": 0,
                        **dict.fromkeys(GN_PASSES, 0)}
          and tr_counts == {"K1": 12, "K1-bwd": 12, "K5": 0, "K2": 0, "K3": 0, "K4": 0,
                            "K6": 4 * K6_UTAE, "K6-bwd": 4 * K6_UTAE, "K7": 4 * K7_UTAE,
                            "K7-adj": 4 * K7_UTAE, **dict.fromkeys(GN_PASSES, 0)},
          f"U-TAE bare steps launched {ev_counts} in 6 eval forwards and {tr_counts} in 4 train "
          f"steps (3 K1, {K6_UTAE} K6 and {K7_UTAE} K7 a forward, 3 K1-bwd, {K6_UTAE} K6-bwd "
          f"and {K7_UTAE} K7 adjoints a train step)")
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
    (bf16), finite outputs and no kernel launch but K6's (their norms,
    ``K6_FAMILIES``); card vs CPU at 32x32."""
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
    # each family: 3 eval forwards and 3 train steps here, 1 and 1 card vs CPU
    want = dict.fromkeys(kernels, 0)
    want["K6"] = sum(4 * (e + t) for e, t in K6_FAMILIES.values())
    want["K6-bwd"] = sum(4 * t for _, t in K6_FAMILIES.values())
    want["K7"] = sum(8 * e for e, _ in K7_FAMILIES.values())  # a train step pads as a forward
    want["K7-adj"] = sum(4 * a for _, a in K7_FAMILIES.values())
    check(counts == want, f"the baseline families launched {counts}, expected {want} (their "
                          "norms through K6, their reflect pads through K7, nothing else)")
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
    trace must name the kernels' operators, the FLOP count equal the forward's and,
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
               "dw_kernel_grad", "norm_gelu_matmul", "norm_gelu_dwconv3x3", "norm_act",
               "norm_act_bwd")
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
    want = chain_launches(0, 1)
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

    # ---- (e) the NCCL run against this process: its train loss (a train
    # epoch repeats to the bit, and one rank's all-reduces change no bit),
    # and its test split evaluated here on its own checkpoint
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
          f"{out['trainlog'][1]['train_loss']:.6f} (relative gap {train_gap:.3g}, must be 0); "
          f"its test metrics against one process's cli.test of its checkpoint: largest "
          f"relative gap {test_gap:.3g} (<= 1e-6)")
    check(train_gap == 0, f"the NCCL train loss differs from one process's by {train_gap}")
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


# the other families phase 10 holds on the mesh (MSE, bf16, B=4, 256x256):
# UNet3D at T=4, FPN + ConvLSTM, and U-TAE at its published widths (K1 at its
# skip levels); the attention dropout off (each band would draw its own)
SPATIAL_FAMILIES = {"unet3d": dict(model="unet3d", input_t=4), "fpn": dict(model="fpn"),
                    "utae": dict(model="utae", encoder_widths=[64, 64, 64, 128],
                                 decoder_widths=[32, 32, 64, 128], out_conv=[13], n_head=16,
                                 d_model=256, d_k=4)}


def _phase10_family(dev, name, mesh=None):
    """A family's eval step, ``predict_scene`` on a 512x512 scene and one
    train step (seeded weights) on B=4 synthetic samples, this rank's band
    of them under ``mesh``: losses, outputs, gradients and launches."""
    from uncrtaints_tpu_torch.config import Config, derive
    from uncrtaints_tpu_torch.data import SyntheticSEN12MSCRTS, collate_multi
    from uncrtaints_tpu_torch.infer import predict_scene
    from uncrtaints_tpu_torch.parallel import shard_batch
    from uncrtaints_tpu_torch.train import (batch_to_device, create_train_state,
                                            make_eval_step, make_train_step)
    cfg = derive(Config(use_sar=True, loss="l2", **SPATIAL_FAMILIES[name]))
    model = seeded_model(cfg, dev)
    te = getattr(model, "temporal_encoder", None)
    if te is not None and hasattr(te, "use_dropout"):
        te.use_dropout, te.dropout = False, 0.0
    kernels = kernel_wrappers()
    ds = SyntheticSEN12MSCRTS(n_samples=B, n_input_t=cfg.input_t, patch_size=PATCH, seed=SEED + 13)
    batch = collate_multi([ds[j] for j in range(B)], use_sar=True)
    sc = collate_multi([SyntheticSEN12MSCRTS(n_samples=1, n_input_t=cfg.input_t,
                                             patch_size=SCENE_2D, seed=SEED + 14)[0]])
    b = batch_to_device(batch if mesh is None else shard_batch(batch, mesh), dev)

    def counted(fn):
        for f in kernels.values():
            f.launches = 0
        r = fn()
        torch.cuda.synchronize()
        return r, {k: f.launches for k, f in kernels.items()}

    step = make_eval_step(cfg, with_metrics=True)
    step(model, b)  # warm-up
    res = {"top": float(batch["y"].max())}
    ev, res["eval counts"] = counted(lambda: step(model, b))
    res["eval"] = {"loss": float(ev["loss"]), "pred": ev["pred"].float().cpu()}
    out, res["scene counts"] = counted(lambda: predict_scene(
        model, cfg, sc["x"][0], sc["dates"][0], mesh=mesh, tile=PATCH, overlap=64, batch_size=B))
    res["scene"] = out["pred"]
    tstep = make_train_step(cfg)
    (_, aux), res["train counts"] = counted(
        lambda: tstep(create_train_state(cfg, model), b, torch.Generator(device=dev)))
    res["train loss"] = float(aux["loss"])
    res["grads"] = {n: (bool(torch.isfinite(g).all()), float(g.abs().max()))
                    for n, g in aux["grads"].items()}
    res["zero ok"] = sorted(exact_zero_gradients(model))
    return res


def family_report(one, got, n_data, n_spatial, label):
    """Hold each family's results on the mesh (``got``: the ranks' results,
    each with its ``families``) against one process's ``one`` with phase
    10's gates; returns the launches of all of them."""
    ns, total = n_spatial, collections.Counter()
    for name, o in one.items():
        fam = [g["families"][name] for g in got]
        groups = [fam[d * ns:(d + 1) * ns] for d in range(n_data)]
        lgap = _relgap(statistics.mean(g[0]["eval"]["loss"] for g in groups), o["eval"]["loss"])
        whole = torch.cat([torch.cat([v["eval"]["pred"] for v in g], dim=2) for g in groups])
        check(tuple(whole.shape) == tuple(o["eval"]["pred"].shape),
              f"{name}: stitched pred {tuple(whole.shape)}")
        rmse = float((whole - o["eval"]["pred"]).square().mean().sqrt()) / o["top"]
        d = fam[0]["scene"] - o["scene"]
        srmse = float(np.sqrt(np.mean(np.square(d)))) / float(np.abs(o["scene"]).max())
        tgap = max(_relgap(f["train loss"], o["train loss"]) for f in fam)
        bad = [n for f in fam for n, (fin, mx) in f["grads"].items()
               if not fin or (mx == 0 and n not in f["zero ok"])]
        print(f"{label}: {name} on the {n_data} x {ns} mesh (MSE, bf16, B={B}, "
              f"{PATCH // ns}-row bands) against one process: eval loss relative gap {lgap:.3g} "
              f"(<= 1e-3), pred RMSE over max|y| {rmse:.3g} (<= 5e-3); predict_scene RMSE over "
              f"max {srmse:.3g} (<= 5e-3); train loss largest relative gap {tgap:.3g} (<= 5e-3); "
              f"launches a rank: eval {fam[0]['eval counts']}, train {fam[0]['train counts']}")
        check(lgap <= 1e-3 and rmse <= 5e-3, f"{name} on the mesh: eval {lgap}, {rmse}")
        check(srmse <= 5e-3, f"{name} on the mesh: predict_scene {srmse}")
        check(tgap <= 5e-3, f"{name} on the mesh: train loss {tgap}")
        check(not bad, f"{name} on the mesh: gradients zero or not finite: {bad[:8]}")
        # a band pads at the scene's edge only (layers.band_pad), not through K7
        band = (lambda c: {**c, "K7": 0, "K7-adj": 0}) if ns > 1 else (lambda c: c)
        for f in fam:
            check(f["eval counts"] == band(o["eval counts"])
                  and f["train counts"] == band(o["train counts"]),
                  f"{name}: a rank launched {f['eval counts']} / {f['train counts']}, one "
                  f"process {o['eval counts']} / {o['train counts']}")
        for r in (o, *fam):
            for part in ("eval counts", "scene counts", "train counts"):
                total.update(r[part])
    return dict(total)


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
        res["families"] = {name: _phase10_family(dev, name, m) for name in SPATIAL_FAMILIES}
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
          f"against phase 6's .pth.tar run, relative gaps {gaps} (must be 0); test metrics "
          f".dcp vs .pth.tar bit-equal {dcp_test == pth_test}")
    check(counts == want, f"the orbax chain launched {counts}, expected {want}")
    check(all(g == 0 for g in gaps.values()), f"orbax run's train losses {gaps}")
    check(dcp_test == pth_test, f"cli.test of model.dcp {dcp_test} and of the same weights "
                                f"as .pth.tar {pth_test} differ")
    check(dcp_test == {k: v for k, v in second["test"].items()},
          "cli.test of model.dcp differs from the train run's final test")
    return counts


# phase 11: the JAX package's single-file checkpoint (flax msgpack .ckpt +
# .meta.json), written by the port's save_jax_checkpoint (this machine has no
# JAX to write one) and read back through every path that reads a checkpoint

def _host_ms(fn, runs=3):
    """The median host-clock ms of ``fn()`` over ``runs`` calls, with the
    device idle before each, and the last call's result."""
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), out


def phase11_jax_checkpoint(dev, tmp, card):
    """The paper recipe at full width (bf16, B=4, T=3, 256x256, seeded):
    two train steps, then ``save_jax_checkpoint`` into a run directory with
    its conf.json, and the same state as ``.pth.tar`` in a twin directory; a
    fresh model of another seed loads the ``.ckpt`` (model, Adam's moments
    and count, lr, step and epoch bit-equal to the source; its eval step
    bit-equal to the source model's), one train step after the load (every
    gradient finite and non-zero but those zero in exact arithmetic),
    ``cli.test`` on both directories (bit-equal metrics), ``cli.train
    --resume_from`` from each for one short epoch (the first losses within
    5e-4 relative) and ``load_pretrained_partial`` from each (equal values
    and masks). Returns the launches of the phase."""
    from uncrtaints_tpu_torch.cli import test as cli_test, train as cli_train
    from uncrtaints_tpu_torch.config import Config, apply_resume, derive
    from uncrtaints_tpu_torch.models import get_generator
    from uncrtaints_tpu_torch.train import (create_train_state, epoch_lr, make_eval_step,
                                            make_train_step, set_learning_rate)
    from uncrtaints_tpu_torch.train.checkpoint import (load_checkpoint, load_pretrained_partial,
                                                       save_checkpoint, save_jax_checkpoint)
    kernels = kernel_wrappers()
    res = os.path.join(tmp, "phase11")

    def recipe(name, **kw):  # the paper recipe, one batch a split
        return derive(Config(
            use_sar=True, scale_by=10.0, gamma=0.8, synthetic_data=True, synthetic_patch=PATCH,
            batch_size=B, input_t=T, max_samples_count=B, num_workers=4, plot_every=-1,
            export_every=-1, res_dir=res, experiment_name=name, **kw))

    cfg = recipe("jax", epochs=1)
    check(cfg.device == "cuda" and cfg.compute_dtype == "bfloat16"
          and cfg.encoder_widths == [128] and cfg.decoder_widths == [128] * 5
          and cfg.n_head == 16 and cfg.d_model == 256,
          "phase 11 runs the paper recipe at full width on the card")
    batches = _synthetic_batches(cfg, 3, PATCH, SEED + 11, dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    step = make_train_step(cfg)
    eval_step = make_eval_step(cfg, with_metrics=True)
    for f in kernels.values():
        f.launches = 0
    t0 = time.perf_counter()
    src = create_train_state(cfg, seeded_model(cfg, dev))
    for b in batches[:2]:
        src, _ = step(src, b, gen)
    src = set_learning_rate(src, epoch_lr(cfg, 1))
    lr = src.tx.lr
    twin = cfg.replace(experiment_name="pth")
    for c in (cfg, twin):
        os.makedirs(os.path.join(res, c.experiment_name), exist_ok=True)
        c.save_json(os.path.join(res, c.experiment_name, "conf.json"))
    save_jax_ms, jpath = _host_ms(lambda: save_jax_checkpoint(cfg, 1, src, "model_epoch_1", lr))
    save_pth_ms, ppath = _host_ms(lambda: save_checkpoint(twin, 1, src, "model_epoch_1", lr))
    fresh = lambda seed: create_train_state(cfg, get_generator(cfg.replace(rdm_seed=seed)))
    quiet = lambda: contextlib.redirect_stdout(io.StringIO())
    dst, dst_pth = fresh(7), fresh(8)
    with quiet():  # each load into the same fresh state: the last one is kept
        load_jax_ms, (got, meta) = _host_ms(
            lambda: load_checkpoint(cfg, res, dst, "model_epoch_1"))
        load_pth_ms, _ = _host_ms(lambda: load_checkpoint(twin, res, dst_pth, "model_epoch_1"))
    a, b = src.model.state_dict(), got.model.state_dict()
    same_model = list(a) == list(b) and all(torch.equal(a[k], b[k]) for k in a)
    same_adam = got.opt_state.count == src.opt_state.count == 2 and all(
        torch.equal(getattr(got.opt_state, m)[k], v)
        for m in ("mu", "nu") for k, v in getattr(src.opt_state, m).items())
    check(same_model and same_adam and got.tx.lr == lr and got.step == src.step == 2
          and meta == {"epoch": 1, "lr": lr, "step": 2},
          f"the .ckpt round trip: model {same_model}, Adam {same_adam}, lr {got.tx.lr} vs "
          f"{lr}, step {got.step}, meta {meta}")
    ref = eval_step(src.model, batches[2])
    before = launch_counts()
    out = eval_step(got.model, batches[2])
    one_eval = launches_since(before)
    check(torch.equal(out["pred"], ref["pred"]) and torch.equal(out["var"], ref["var"]),
          "the eval step of the model loaded from the .ckpt differs from the source's")
    check(one_eval == chain_launches(0, 1), f"the eval step after the load launched {one_eval}")
    before = launch_counts()
    got, aux = step(got, batches[2], gen)
    one_train = launches_since(before)
    check(one_train == chain_launches(1, 0), f"the train step after the load launched "
                                             f"{one_train}")
    zero_ok = exact_zero_gradients(got.model)
    bad = [n for n, g in aux["grads"].items()
           if not finite(g) or (n not in zero_ok and float(g.abs().max()) == 0.0)]
    check(not bad, f"gradients after the .ckpt load zero or not finite: {bad[:8]}")

    argv = lambda name: ["--experiment_name", name, "--weight_folder", res, "--res_dir",
                         os.path.join(tmp, f"phase11_{name}_test"), "--resume_at", "1",
                         "--max_samples_count", str(B), "--batch_size", str(B), "--input_t",
                         str(T), "--num_workers", "4", "--export_every", "-1"]
    first = {}
    with quiet():
        tests = {n: cli_test.main(cli_test.load_test_config(argv(n))) for n in ("jax", "pth")}
        for name, ckpt in (("jax", jpath), ("pth", ppath)):
            run = cli_train.main(apply_resume(recipe(
                name, epochs=2, resume_from=True, trained_checkp=ckpt, resume_at=1)))
            first[name] = run["trainlog"][2]["train_loss"]
    chain_s = time.perf_counter() - t0
    counts = {k: f.launches for k, f in kernels.items()}
    # 2 + 1 train steps here and 1 in each resumed run; 1 + 1 eval forwards
    # here, 1 in each cli.test, a val and a test forward in each resumed run
    want = chain_launches(2 + 1 + 2, 2 + 2 + 2 * 2)
    check(counts == want, f"phase 11 launched {counts}, expected {want}")
    check(tests["jax"] == tests["pth"], f"cli.test of the .ckpt {tests['jax']} and of the "
                                        f".pth.tar {tests['pth']} differ")
    rel = _relgap(first["jax"], first["pth"])
    check(rel <= 5e-4, f"the first loss resumed from the .ckpt {first['jax']} and from the "
                       f".pth.tar {first['pth']}: {rel:.3g} relative (> 5e-4)")

    part = {}
    for name, path in (("jax", jpath), ("pth", ppath)):
        st, mask = load_pretrained_partial(cfg, fresh(9), path)
        part[name] = (st.model.state_dict(), mask)
    (pa, ma), (pb, mb) = part["jax"], part["pth"]
    check(ma == mb and 0.0 in ma.values() and all(torch.equal(pa[k], pb[k]) for k in pa),
          "load_pretrained_partial from the .ckpt and from the .pth.tar differ")
    with open(jpath.replace(".ckpt", ".meta.json")) as f:
        side = json.load(f)
    print(f"phase 11: the JAX package's checkpoint, paper recipe (bf16, {len(a)} tensors): "
          f"save_jax_checkpoint -> fresh model -> load_checkpoint: model, Adam's moments and "
          f"count, lr, step and epoch equal to the bit (sidecar {side}); eval step bit-equal, "
          f"launches {one_eval}; a train step after the load launches {one_train}, every "
          f"gradient finite and non-zero but {len(zero_ok & set(aux['grads']))} zero in exact "
          f"arithmetic; cli.test .ckpt vs .pth.tar bit-equal; cli.train --resume_from first "
          f"loss .ckpt {first['jax']} vs .pth.tar {first['pth']} ({rel:.3g} relative, <= 5e-4); "
          f"load_pretrained_partial equal in values and mask ({sum(m == 0.0 for m in ma.values())} "
          f"of {len(ma)} frozen); {chain_s:.1f} s, launches {counts}")
    print(f"  files: model_epoch_1.ckpt {os.path.getsize(jpath)} bytes, model_epoch_1.pth.tar "
          f"{os.path.getsize(ppath)} bytes; host ms (median of 3): save_jax_checkpoint "
          f"{save_jax_ms:.1f}, save_checkpoint (.pth.tar) {save_pth_ms:.1f}, load_checkpoint "
          f".ckpt {load_jax_ms:.1f}, .pth.tar {load_pth_ms:.1f}; card {card}")
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

    # launches: every rank runs the whole forward on its band, through the
    # halo modes; a band pads at the scene's edge only (layers.band_pad), not
    # through K7
    fwd, trn = chain_launches(0, 1), chain_launches(1, 0)
    n_scene = -(-one["scene counts"]["K1"] // n_data)  # rounds of one batch a data rank
    for r, g in enumerate(got):
        print(f"  rank {r}: eval launches {g['eval counts']} (halo mode {g['eval halo']}), "
              f"train step {g['train counts']} (halo mode {g['train halo']}), scene "
              f"{g['scene counts']}")
        check(g["eval counts"] == fwd and g["eval halo"] == {"K5": 0, "K2": 0, "K4": K4_EVAL},
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
        one_families = {name: _phase10_family(dev, name) for name in SPATIAL_FAMILIES}
        orbax = _phase10_orbax(tmp)
    finally:
        got = finish_spatial_ranks(ranks, out, 1, SPATIAL)
    counts = spatial_report(one, got, batch, 1, SPATIAL, "phase 10")
    fams = family_report(one_families, got, 1, SPATIAL, "phase 10")
    return {k: orbax[k] + n + fams.get(k, 0) for k, n in counts.items()}


def main():
    if len(sys.argv) == 5 and sys.argv[1] == "--spatial-rank":
        return spatial_rank(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]))
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 1

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}")
    dev = torch.device("cuda", 0)
    if sys.argv[1:] == ["--k6"]:
        phase1_norms_alone(dev)
        return 0

    clock = [time.perf_counter()]

    def took(what):
        clock.append(time.perf_counter())
        print(f"[{what} took {clock[-1] - clock[-2]:.1f} s]")

    kern = {**phase1_kernels(dev), **phase1_group_chain(dev)}
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
    remat = phase_remat(dev)
    took("the remat phase")
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
        jaxck = phase11_jax_checkpoint(dev, work, card)
        took("phase 11")
    print(f"launches by path: eval {evalc}; scene {scene}; train {train}; remat {remat}; "
          f"CLIs {cli}; "
          f"real data {real}; U-TAE {utae}; other families {families}; ensemble members "
          f"{members}; export and the traced run {modules}; spatial mesh and orbax {spatial}; "
          f"the JAX checkpoint {jaxck}")

    # launches: the sum over the paths' runs (eval, scene, train, remat, the
    # CLI chain, the real-data CLIs, U-TAE's CLIs and bare steps, the other
    # families, the ensemble's members, one exported call and the traced
    # run, the spatial ranks and the orbax chain, the JAX checkpoint's), each
    # counted from 0 just before the path to just after it
    paths = (evalc, scene, train, remat, cli, real, utae, families, members, modules, spatial,
             jaxck)
    meta = {  # name: (source, the TPU kernel it replaces, its counter)
        "att_group_aggregate": ("aggregate.cu", "ops/pallas_aggregate.py:268", "K1"),
        "att_group_aggregate_bwd": ("aggregate.cu", "ops/pallas_aggregate.py:164", "K1-bwd"),
        "norm_gelu_matmul": ("norm_gelu_matmul.cu", "ops/pallas_mbconv.py:136", "K3"),
        "norm_gelu_dwconv3x3": ("norm_gelu_dwconv.cu", "ops/pallas_mbconv.py:254", "K4"),
        "dw_stencil": ("dwconv.cu", "ops/pallas_dwconv.py:92", "K5"),
        "dw_kernel_grad": ("dwgrad.cu", "ops/pallas_dwgrad.py:80", "K2"),
        # no Pallas kernel: the XLA-fused norms of the JAX package's Norm2d
        "norm_act": ("norm.cu", "models/layers.py:734", "K6"),
        "norm_act_bwd": ("norm.cu", "models/layers.py:734", "K6-bwd"),
        # no Pallas kernel: jnp.pad, fused by XLA into the convolution
        "reflect_pad": ("pad.cu", "models/layers.py:Conv2d", "K7"),
        "reflect_pad_adjoint": ("pad.cu", "models/layers.py:Conv2d", "K7-adj"),
        # the eval group-norm MBConv's passes around K3 -> K4 -> K3: K6's
        # statistics and apply kernels, and the SE's pooled sum
        "norm_stats": ("norm.cu", "models/layers.py:734", "GN-stats"),
        "norm_gelu_pool": ("norm.cu", "models/blocks.py:SE", "GN-pool"),
        "norm_apply": ("norm.cu", "models/layers.py:734", "GN-apply"),
    }
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": f"uncrtaints_tpu_torch/csrc/{src}",
         "replaces": f"uncrtaints_tpu/{rep}",
         "launches": sum(p.get(key, 0) for p in paths), **kern[name]}
        for name, (src, rep, key) in meta.items()]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
