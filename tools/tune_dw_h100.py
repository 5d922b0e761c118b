"""Build and time variants of the tiled depthwise kernels (K5, K2) on a GPU.

    python3 tools/tune_dw_h100.py          (from the root of a checkout, one card)

The tile sizes of ``uncrtaints_tpu_torch/csrc/dwtile.cuh`` (threads a block,
rows a band, columns and rows an item, the bands copied ahead, the resident
blocks the register count must allow, the bf16 channels a thread) can be set on nvcc's command line.
This script compiles ``dwconv.cu`` and ``dwgrad.cu`` once per variant (all
variants in parallel, each into its own library under ``build/tune_dw/``),
runs the reflect forward, the folded adjoint and the reflect weight gradient
of each at the train step's encoder and decoder shapes ([12|4,256,256,256]
bf16), holds every variant against the first one (the shipped sizes), and
prints the median device time of each (CUDA events, 15 runs) beside cuDNN's
depthwise conv and weight gradient. The port never loads these libraries.
"""

import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from uncrtaints_tpu_torch import _build  # noqa: E402

# (threads, rows a band, columns an item, rows an item, bands copied ahead,
# resident blocks the register count must allow, bf16 channels a thread);
# the first is shipped
VARIANTS = [(128, 4, 32, 16, 1, 1, 4), (128, 4, 32, 16, 1, 1, 8), (128, 4, 32, 32, 1, 1, 8),
            (256, 4, 32, 16, 1, 1, 8), (256, 4, 32, 32, 1, 2, 8), (128, 2, 32, 16, 1, 1, 8),
            (128, 4, 32, 16, 1, 1, 2), (256, 4, 32, 16, 1, 1, 2),
            (128, 4, 32, 32, 1, 1, 4), (128, 4, 32, 16, 2, 1, 4), (128, 4, 32, 16, 1, 4, 4),
            (128, 4, 32, 16, 1, 5, 4), (256, 4, 32, 32, 2, 2, 4), (128, 4, 32, 64, 1, 1, 4),
            (64, 4, 32, 16, 1, 1, 4), (128, 8, 32, 16, 1, 1, 4), (128, 4, 64, 16, 1, 1, 4),
            (128, 4, 16, 16, 1, 1, 4)]
NAMES = ("THREADS", "R", "WT", "ROWS", "AHEAD", "MINB", "CV")
SHAPES = {"enc": (12, 256, 256, 256), "dec": (4, 256, 256, 256)}
RUNS = 15


def build_all(out_dir: Path):
    nvcc, csrc = _build._nvcc(), _build._CSRC
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = []
    for v in VARIANTS:
        so = out_dir / ("dw_" + "_".join(map(str, v)) + ".so")
        defs = [f"-DUNCR_DW_{k}={n}" for k, n in zip(NAMES, v)]
        cmd = [nvcc, *_build.NVCC_FLAGS, *defs, "-shared", "-o", str(so),
               str(csrc / "dwconv.cu"), str(csrc / "dwgrad.cu"), str(csrc / "errors.cu")]
        jobs.append((v, so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for v, so, proc in jobs:
        out = proc.communicate()[0]
        if proc.returncode != 0:
            print(f"variant {v}: does not build\n{out[-2000:]}")
            continue
        libs[v] = ctypes.CDLL(str(so))
    return libs


def time_ms(fn):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(RUNS):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def entry_points(lib):
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.uncr_dw_stencil.argtypes = [vp, vp, vp] + [ci] * 12 + [vp]
    lib.uncr_dw_kernel_grad_blocks.argtypes = [ci] * 8
    lib.uncr_dw_kernel_grad.argtypes = [vp, vp, vp, vp] + [ci] * 12 + [vp]
    return lib


def main():
    if not torch.cuda.is_available():
        print("tune_dw_h100: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"card: {card}")
    libs = {v: entry_points(lib) for v, lib in build_all(ROOT / "build" / "tune_dw").items()}
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    rows = []
    for sname, (N, H, W, C) in SHAPES.items():
        x = torch.randn(N, H, W, C, generator=gen, device=dev).bfloat16()
        g = torch.randn(N, H, W, C, generator=gen, device=dev).bfloat16()
        w = (torch.randn(C, 1, 3, 3, generator=gen, device=dev) * 0.3).bfloat16()
        out, gw = torch.empty_like(x), torch.empty(C, 9, device=dev)
        xc, gc = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)
        conv = time_ms(lambda: torch.nn.functional.conv2d(xc, w, padding=1, groups=C))
        wgrad = time_ms(lambda: torch.nn.grad.conv2d_weight(xc, (C, 1, 3, 3), gc, padding=1,
                                                            groups=C))
        print(f"{sname} [{N},{H},{W},{C}] bf16: cuDNN depthwise conv {conv:.4f} ms, weight "
              f"gradient {wgrad:.4f} ms")
        first = None
        for v, lib in libs.items():
            def stencil(src, mode):
                err = lib.uncr_dw_stencil(src.data_ptr(), w.data_ptr(), out.data_ptr(), N, H, W,
                                          C, 3, 3, 1, 1, 1, 1, mode, 1, stream)
                assert err == 0, (v, err)

            nb = lib.uncr_dw_kernel_grad_blocks(N, H, W, C, 3, 3, 1, 1)
            part = torch.empty(nb, 9, C, device=dev)

            def grad():
                err = lib.uncr_dw_kernel_grad(x.data_ptr(), g.data_ptr(), part.data_ptr(),
                                              gw.data_ptr(), N, H, W, C, 3, 3, 1, 1, 1, 1, 1, 1,
                                              stream)
                assert err == 0, (v, err)

            res = {}
            stencil(x, 1)
            res["fwd"] = out.clone()
            stencil(g, 2)
            res["adj"] = out.clone()
            grad()
            res["gw"] = gw.clone()
            torch.cuda.synchronize()
            if first is None:
                first = res
            same = (torch.equal(res["fwd"], first["fwd"]) and torch.equal(res["adj"], first["adj"])
                    and float((res["gw"] - first["gw"]).abs().max()
                              / first["gw"].abs().max()) < 1e-4)
            t = {"fwd": time_ms(lambda: stencil(x, 1)), "adj": time_ms(lambda: stencil(g, 2)),
                 "gw": time_ms(grad)}
            print(f"  threads {v[0]:3d} band {v[1]} cols {v[2]:2d} rows {v[3]:2d} ahead {v[4]} "
                  f"blocks {v[5]} channels {v[6]}: reflect forward "
                  f"{t['fwd']:.4f} ms, adjoint {t['adj']:.4f} ms, weight gradient {t['gw']:.4f} ms"
                  f" ({nb} partials), agrees with the first {same}", flush=True)
            rows.append({"shape": sname, "variant": v, **t, "agrees": same})
    with open(ROOT / "build" / "tune_dw" / "results.json", "w") as f:
        json.dump({"card": card, "rows": rows}, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
