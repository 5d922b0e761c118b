"""Time K1 (the att_group aggregation, forward and backward) on a GPU beside
an older tree's kernels and beside the other design of its forward.

    python3 tools/tune_aggregate_h100.py [--older DIR] [--sweep]
                                            (from the root of a checkout, one card)

Builds, in parallel into ``build/tune_aggregate/``:

- ``uncrtaints_tpu_torch/csrc/aggregate.cu`` as it stands: the port's
  kernels, design (a): bulk asynchronous copies of each frame's run of a
  pixel tile into a ring of shared-memory stages;
- ``tools/aggregate_regs_h100.cu``: design (b), every frame's 16-byte loads
  in flight in registers, the head width a template parameter (the port
  never builds it);
- with ``--older DIR``, ``aggregate.cu`` of an older tree unpacked at DIR
  (``git archive <commit> --prefix=DIR/ | tar -x``);
- with ``--sweep``, ``aggregate.cu`` once for each ring depth (2, 3, 4
  stages) and stage size (16 to 64 KB, at most 192 KB a CTA) through its
  ``UNCR_K1_STAGES`` and ``UNCR_K1_STAGE_KB``, each timed at every shape.

The C entry points are called directly on preallocated outputs at every K1
shape on a path: the paper recipe's [4,3,256,256,128] with 16 heads in bf16
and fp32, U-TAE's three skip levels [4,3,s,s,64] with 16 heads of 4 channels
(s = 64, 128, 256) and the paper shape's band of a 1 x 2 spatial mesh
[4,3,128,256,128], forward and backward. Each build is first held against
the plain PyTorch versions (forward: 1e-6 of the largest in fp32, one bf16
ulp of it in bf16; backward: dx equal, dattn 1e-6 of the largest in fp32
and one bf16 ulp of it in bf16, as ``chip_smoke.py`` holds them). A time is the median of 7 samples,
each the mean of 8 calls queued behind a 3 ms spin on the device (the
method of ``chip_smoke.py:time_kernel``); the older tree's kernels are
timed before and after the current ones, design (b) between. Beside
each: the byte bound (each input read once, each output written once, over
3.35 TB/s), the share of it, ``torch.einsum``'s time for the same
function, and a device copy of the same bytes (half read, half written) as
the rate the memory system gives a plain stream. U-TAE's 64^2 and 128^2 levels fit in the card's 50 MB L2, so they
are also timed with the inputs rotated over copies of more than 100 MB in
all; a share above 100% of the byte bound is an L2 reading.
"""

import ctypes
import math
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from uncrtaints_tpu_torch import _build  # noqa: E402
from uncrtaints_tpu_torch.ops import aggregate  # noqa: E402

RUNS, QUEUE = 7, 8
PEAK_BYTES = 3.35e12
ROTATE_BYTES = 100e6
OUT = ROOT / "build" / "tune_aggregate"
SHAPES = {  # name: (B, T, H, W, C, heads, dtype, rotate over copies too)
    "paper bf16": (4, 3, 256, 256, 128, 16, torch.bfloat16, False),
    "paper fp32": (4, 3, 256, 256, 128, 16, torch.float32, False),
    "U-TAE 64^2": (4, 3, 64, 64, 64, 16, torch.bfloat16, True),
    "U-TAE 128^2": (4, 3, 128, 128, 64, 16, torch.bfloat16, True),
    "U-TAE 256^2": (4, 3, 256, 256, 64, 16, torch.bfloat16, False),
    "1x2 band": (4, 3, 128, 256, 128, 16, torch.bfloat16, False),
}


def start_build(name, sources, defs=()):
    so = OUT / f"{name}.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *defs, f"-I{_build._CSRC}", "-Xptxas", "-v",
           "-shared", "-o", str(so), *(str(s) for s in sources), str(_build._CSRC / "errors.cu")]
    return name, so, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True)


def load(job):
    name, so, proc = job
    out = proc.communicate()[0]
    if proc.returncode != 0:
        raise RuntimeError(f"{name}: the sources do not build\n{out[-6000:]}")
    # registers, spills and shared memory of each kernel, as ptxas reports them
    for line in out.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  [{name}] {line.strip()}")
    lib = ctypes.CDLL(str(so))
    vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.uncr_att_group_aggregate.argtypes = [vp, vp, vp, ci, ci, cl, ci, ci, ci, vp]
    if hasattr(lib, "uncr_att_group_aggregate_bwd"):
        lib.uncr_att_group_aggregate_bwd.argtypes = [vp, vp, vp, vp, vp, ci, ci, cl, ci, ci, ci,
                                                     vp]
    return name, lib


def time_ms(fn):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(RUNS):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(5_000_000)  # ~3 ms: the launches below queue up behind it
        a.record()
        for _ in range(QUEUE):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / QUEUE)
    return statistics.median(times)


def rotating(fns):
    """One call of the next function of ``fns`` per call, in turn."""
    state = [0]

    def call():
        fns[state[0] % len(fns)]()
        state[0] += 1

    return call


def main():
    if not torch.cuda.is_available():
        print("tune_aggregate_h100: no CUDA device", file=sys.stderr)
        return 1
    args = sys.argv[1:]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    OUT.mkdir(parents=True, exist_ok=True)
    jobs = [start_build("current", [_build._CSRC / "aggregate.cu"]),
            start_build("registers", [ROOT / "tools" / "aggregate_regs_h100.cu"])]
    if "--older" in args:
        older_dir = Path(args[args.index("--older") + 1])
        jobs.append(start_build("older", [older_dir / "uncrtaints_tpu_torch" / "csrc" /
                                          "aggregate.cu"]))
    sweep = []
    if "--sweep" in args:  # the ring's depth x the stage's size, at most 192 KB a CTA
        sweep = [(st, kb) for st in (2, 3, 4) for kb in (16, 32, 48, 64) if st * kb <= 192]
        jobs += [start_build(f"stages {st} x {kb} KB", [_build._CSRC / "aggregate.cu"],
                             [f"-DUNCR_K1_STAGES={st}", f"-DUNCR_K1_STAGE_KB={kb}"])
                 for st, kb in sweep]
    libs = dict(load(j) for j in jobs)
    swept = [name for name in libs if name.startswith("stages")]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    randn = lambda *s: torch.randn(*s, generator=gen, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    code = _build.DTYPE_CODES

    for name, (B, T, H, W, C, heads, dtype, rotate) in SHAPES.items():
        def inputs():
            x = randn(B, T, H, W, C).to(dtype)
            a = torch.softmax(randn(B, T, H, W, heads), dim=1).to(dtype)
            g = randn(B, H, W, C).to(dtype)
            return (x, a, g, torch.empty(B, H, W, C, device=dev, dtype=dtype),
                    torch.empty_like(x), torch.empty_like(a))

        sets = [inputs()]
        size = lambda *ts: sum(t.numel() * t.element_size() for t in ts)
        x, a, g, out, dx, da = sets[0]
        fwd_bytes, bwd_bytes = size(x, a, out), size(x, a, g, dx, da)
        if rotate:
            sets += [inputs() for _ in range(math.ceil(ROTATE_BYTES / fwd_bytes))]
        ref = aggregate.att_group_aggregate_plain(x, a)
        rdx, rda = aggregate.att_group_aggregate_bwd_plain(x, a, g)
        top = float(ref.float().abs().max())
        fp32 = dtype == torch.float32

        def fwd(lib, s):
            x_, a_, _, o_, _, _ = s
            return lambda: lib.uncr_att_group_aggregate(
                x_.data_ptr(), a_.data_ptr(), o_.data_ptr(), B, T, H * W, C, heads, code[dtype],
                stream)

        def bwd(lib, s):
            x_, a_, g_, _, dx_, da_ = s
            return lambda: lib.uncr_att_group_aggregate_bwd(
                x_.data_ptr(), a_.data_ptr(), g_.data_ptr(), dx_.data_ptr(), da_.data_ptr(), B, T,
                H * W, C, heads, code[dtype], stream)

        for build, lib in libs.items():
            err = fwd(lib, sets[0])()
            assert err == 0, (build, name, "forward", err)
            torch.cuda.synchronize()
            e = float((out.float() - ref.float()).abs().max())
            tol = (1e-6 if fp32 else 2 ** -7) * top
            assert e <= tol, (build, name, "forward", e, tol)
            line = f"{name} {build}: forward max_abs_err {e:.3g} (tol {tol:.3g})"
            if hasattr(lib, "uncr_att_group_aggregate_bwd"):
                err = bwd(lib, sets[0])()
                assert err == 0, (build, name, "backward", err)
                torch.cuda.synchronize()
                assert torch.equal(dx, rdx), (build, name, "dx")
                ea = (da.float() - rda.float()).abs()
                assert ea.max() <= (1e-6 if fp32 else 2 ** -7) * rda.float().abs().max(), \
                    (build, name, "dattn", float(ea.max()))
                line += f"; backward dx equal, dattn max_abs_err {float(ea.max()):.3g}"
            print(line, flush=True)

        fb, bb = fwd_bytes / PEAK_BYTES * 1e3, bwd_bytes / PEAK_BYTES * 1e3
        order = (["older"] if "older" in libs else []) + ["current", "registers"] + swept + \
            (["older"] if "older" in libs else [])
        for label, nbytes, bound, make in (("forward", fwd_bytes, fb, fwd),
                                           ("backward", bwd_bytes, bb, bwd)):
            runs = {}
            for build in order:
                t = time_ms(make(libs[build], sets[0]))
                runs.setdefault(build, []).append(t)
                if rotate:
                    tr = time_ms(rotating([make(libs[build], s) for s in sets]))
                    runs.setdefault(build + " rotated", []).append(tr)
            xv = x.view(B, T, H, W, heads, C // heads)
            gv = g.view(B, H, W, heads, C // heads)
            # a device copy of half the bytes (as many read as written): what
            # the memory system gives a plain stream of this size
            src = torch.empty(nbytes // 2, dtype=torch.uint8, device=dev)
            dst = torch.empty_like(src)
            copy_ms = time_ms(lambda: dst.copy_(src))
            del src, dst
            if make is fwd:
                lib_ms = time_ms(lambda: torch.einsum("bthwn,bthwnc->bhwnc", a, xv))
            else:
                lib_ms = time_ms(lambda: (torch.einsum("bthwn,bhwnc->bthwnc", a, gv),
                                          torch.einsum("bthwnc,bhwnc->bthwn", xv, gv)))
            if swept:
                best = min(swept, key=lambda b: runs[b][0])
                print(f"{name} {label}, the sweep: " + "; ".join(
                    f"{b[7:]} {runs.pop(b)[0]:.4f}" for b in swept) + f" (best: {best})")
                for b in swept:
                    runs.pop(b + " rotated", None)
            parts = []
            for build, ts in runs.items():
                shares = " / ".join(f"{t:.4f} ms ({bound / t:.0%})" for t in ts)
                parts.append(f"{build} {shares}")
            line = (f"{name} {label}: bound {bound:.4f} ms ({nbytes / 1e6:.1f} MB); "
                    + "; ".join(parts) + f"; torch.einsum {lib_ms:.4f} ms; a device copy of "
                    f"the same bytes {copy_ms:.4f} ms ({bound / copy_ms:.0%})")
            if "older" in runs:
                old = statistics.mean(runs["older"])
                line += f"; current / older {runs['current'][0] / old:.3f}"
            line += f"; registers / current {runs['registers'][0] / runs['current'][0]:.3f}"
            print(line, flush=True)
        del sets, x, a, g, out, dx, da, ref, rdx, rda
        torch.cuda.empty_cache()
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
