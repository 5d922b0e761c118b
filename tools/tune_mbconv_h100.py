"""Time the fused MBConv eval kernels (K3, K4) on a GPU beside an older tree's.

    python3 tools/tune_mbconv_h100.py [--older DIR]
                                            (from the root of a checkout, one card)

Builds ``uncrtaints_tpu_torch/csrc/norm_gelu_dwconv.cu`` and
``norm_gelu_matmul.cu`` as they stand, once more with ``-DUNCR_NGD_FMA=0`` (a
tap of K4 as a product and a sum rounded apart instead of one fused
multiply-add), and with ``--older DIR`` the same two sources of an older tree
unpacked at DIR (``git archive``; the kernels as they were before their
redesign: K4 always with its statistics pass, K3 with 128-row partial rows).
All builds run in parallel into ``build/tune_mbconv/``. The C entry points are
called directly on preallocated outputs and held against the plain PyTorch
versions at the eval path's shapes: K4 on [4,256,256,256] bf16 in the forms
(no statistics, pooled sum), (neither), (statistics) and (both); K3 on
[4,65536,128] -> 256 in the form the fused block calls (no epilogue) and with
an affine + GELU epilogue, and on [4,65536,256] -> 128 (GELU prologue, SE,
affine epilogue) and without the prologue's GELU. The older tree's kernels are
timed before and after the current ones. A time is the median of 7 samples,
each the mean of 8 launches queued behind a 3 ms spin on the device.

It also lists the SASS of the exact GELU (``gelu_exact`` of common.cuh) from
``cuobjdump`` of a one-line kernel, by class: the arithmetic (fused
multiply-adds, multiplies, adds), the special-function instruction, and the
selects, compares and moves the compiler adds around them.
The port never loads these libraries.
"""

import ctypes
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from uncrtaints_tpu_torch import _build  # noqa: E402
from uncrtaints_tpu_torch.ops import mbconv  # noqa: E402

RUNS, QUEUE = 7, 8
OUT = ROOT / "build" / "tune_mbconv"
SOURCES = ("norm_gelu_dwconv.cu", "norm_gelu_matmul.cu", "errors.cu")

GELU_CU = """
#include "common.cuh"
extern "C" __global__ void k_gelu(float* x) { x[threadIdx.x] = gelu_exact(x[threadIdx.x]); }
"""


def gelu_sass_count():
    """The instructions of ``gelu_exact`` between the load and the store of
    a kernel that applies it to one float, by opcode."""
    nvcc = Path(_build._nvcc())
    src, cubin = OUT / "gelu.cu", OUT / "gelu.cubin"
    src.write_text(GELU_CU)
    subprocess.run([str(nvcc), *_build.NVCC_FLAGS[:4], f"-I{_build._CSRC}", "-cubin",
                    "-o", str(cubin), str(src)], check=True, capture_output=True)
    sass = subprocess.run([str(nvcc.parent / "cuobjdump"), "-sass", str(cubin)],
                          capture_output=True, text=True).stdout
    (OUT / "gelu.sass").write_text(sass)
    ops = re.findall(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\d\s+)?([A-Z0-9_.]+)", sass)
    body = ops[ops.index("LDG.E") + 1:ops.index("STG.E")]
    counts = {}
    for op in body:
        op = op.split(".")[0]
        counts[op] = counts.get(op, 0) + 1
    flop = 2 * counts.get("FFMA", 0) + counts.get("FMUL", 0) + counts.get("FADD", 0)
    return {"instructions": len(body), "by_opcode": counts, "arithmetic_flop": flop,
            "mufu": counts.get("MUFU", 0)}


def start_build(name, csrc, defs=()):
    so = OUT / f"{name}.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *defs, "-shared", "-o", str(so),
           *(str(Path(csrc) / s) for s in SOURCES)]
    return name, so, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True)


def load(job, older=False):
    name, so, proc = job
    out = proc.communicate()[0]
    if proc.returncode != 0:
        raise RuntimeError(f"{name}: the sources do not build\n{out[-6000:]}")
    lib = ctypes.CDLL(str(so))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    k4 = [vp, ci, vp, vp, ci, vp, vp, vp, vp, ci, ci, ci, ci, vp, vp, vp, vp, ci]
    lib.uncr_ngd_blocks.argtypes = [ci, ci]
    lib.uncr_norm_gelu_dwconv3x3.argtypes = k4 + ([vp] if older else [vp] * 5)
    lib.uncr_norm_gelu_matmul.argtypes = [
        vp, ci, vp, vp, ci, vp, vp, vp, vp, vp, vp, ci, ci, vp, ci, ctypes.c_longlong, ci, ci,
        vp, vp, vp, vp, ci, vp]
    if not older:
        lib.uncr_ngm_tile_rows.argtypes = [ci, ci, ci, ci]
    return lib


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


def main():
    if not torch.cuda.is_available():
        print("tune_mbconv_h100: no CUDA device", file=sys.stderr)
        return 1
    args = sys.argv[1:]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"card: {card}")
    OUT.mkdir(parents=True, exist_ok=True)
    jobs = [start_build("current", _build._CSRC),
            start_build("taps_apart", _build._CSRC, ["-DUNCR_NGD_FMA=0"])]
    if "--older" in args:
        jobs.append(start_build(
            "older", Path(args[args.index("--older") + 1]) / "uncrtaints_tpu_torch" / "csrc"))
    gelu = gelu_sass_count()
    print(f"SASS of gelu_exact: {gelu}")
    cur, apart = load(jobs[0]), load(jobs[1])
    older = load(jobs[2], older=True) if len(jobs) > 2 else None
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    randn = lambda *s: torch.randn(*s, generator=gen, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    ptr = lambda t: t.data_ptr() if t is not None else None
    rows = []

    # ---- K4 at the path shape
    N, H, W, C = 4, 256, 256, 256
    x = randn(N, H, W, C).bfloat16()
    mean, coef = torch.zeros(N, 1, device=dev), torch.ones(N, 1, device=dev)
    sc, bi, w = randn(C), randn(C), (randn(3, 3, C) * 0.3).contiguous()
    psc, pbi = randn(C), randn(C)
    out = torch.empty_like(x)
    s1, s2, pool = (torch.zeros(N, 1, device=dev), torch.zeros(N, 1, device=dev),
                    torch.zeros(N, C, device=dev))
    ref = mbconv.norm_gelu_dwconv3x3_plain(x, mean, coef, sc, bi, w, groups_in=1, groups_out=1,
                                           pool_affine=(psc, pbi))
    top = float(ref[0].float().abs().max())
    gabs = torch.nn.functional.gelu(ref[0].float() * psc + pbi).abs().sum(dim=(1, 2))

    def older_k4():
        part = [torch.empty(N * older.uncr_ngd_blocks(H, W), C, device=dev) for _ in range(2)]

        def run():
            err = older.uncr_norm_gelu_dwconv3x3(
                x.data_ptr(), 1, mean.data_ptr(), coef.data_ptr(), 1, sc.data_ptr(),
                bi.data_ptr(), w.data_ptr(), out.data_ptr(), N, H, W, C, part[0].data_ptr(),
                part[1].data_ptr(), s1.data_ptr(), s2.data_ptr(), 1, stream)
            assert err == 0, err

        run()
        torch.cuda.synchronize()
        err = float((out.float() - ref[0].float()).abs().max())
        t = time_ms(run)
        print(f"K4 the older tree's kernel (statistics always on): max_abs_err {err:.3g}; "
              f"{t:.4f} ms", flush=True)
        rows.append({"kernel": "K4", "build": "older", "stats": t})

    if older:
        older_k4()
    for name, lib in (("current", cur), ("taps_apart", apart)):
        part = [torch.empty(N * lib.uncr_ngd_blocks(H, W) + N, C, device=dev) for _ in range(3)]

        def run(stats, pooled):
            err = lib.uncr_norm_gelu_dwconv3x3(
                x.data_ptr(), 1, mean.data_ptr(), coef.data_ptr(), 1, sc.data_ptr(),
                bi.data_ptr(), w.data_ptr(), out.data_ptr(), N, H, W, C,
                ptr(part[0] if stats else None), ptr(part[1] if stats else None),
                s1.data_ptr(), s2.data_ptr(), 1, ptr(psc if pooled else None),
                ptr(pbi if pooled else None), ptr(part[2] if pooled else None),
                pool.data_ptr(), stream)
            assert err == 0, (name, err)

        run(True, True)
        torch.cuda.synchronize()
        err = float((out.float() - ref[0].float()).abs().max())
        equal = bool(torch.equal(out, ref[0]))
        e1 = float(((s1 - ref[1]).abs() / ref[0].float().abs().sum(dim=(1, 2, 3))[:, None]).max())
        e2 = float(((s2 - ref[2]).abs() / ref[2]).max())
        ep = float(((pool - ref[3]).abs() / gabs).max())
        assert err <= top * 2 ** -7 and max(e1, e2, ep) <= 1e-3, (name, err, e1, e2, ep)
        assert equal or name == "current", "taps rounded apart must equal the plain version"
        t = {"pool": time_ms(lambda: run(False, True)), "none": time_ms(lambda: run(False, False)),
             "stats": time_ms(lambda: run(True, False)), "both": time_ms(lambda: run(True, True))}
        print(f"K4 {name}: max_abs_err {err:.3g} of {top:.3g} (bit-equal to the plain version "
              f"{equal}), rel err sum {e1:.2g} sumsq {e2:.2g} pool {ep:.2g}; ms pooled sum "
              f"{t['pool']:.4f}, neither {t['none']:.4f}, statistics {t['stats']:.4f}, both "
              f"{t['both']:.4f}", flush=True)
        rows.append({"kernel": "K4", "build": name, **t, "max_abs_err": err, "pool_rel": ep})
    if older:
        older_k4()

    # ---- K3 at the two path shapes
    P = 65536
    for (K, N2, se_on, gelu_on) in ((128, 256, False, False), (256, 128, True, True)):
        xa = randn(N, P, K).bfloat16()
        wa = (randn(K, N2) * 0.05).bfloat16()
        sca, bia = randn(K), randn(K)
        se = torch.sigmoid(randn(N, K)) if se_on else None
        osc, obi = randn(N2), randn(N2)
        oa = torch.empty(N, P, N2, device=dev, dtype=torch.bfloat16)
        epi = (osc, obi) if gelu_on else None  # the fused block's first GEMM has no epilogue
        ref = mbconv.norm_gelu_matmul_plain(xa, mean, coef, sca, bia, wa, se=se, groups_in=1,
                                            groups_out=1, do_gelu=gelu_on, out_affine=epi,
                                            do_stats=True)
        top = float(ref[0].float().abs().max())
        lms = time_ms(lambda: torch.matmul(xa.view(-1, K), wa))
        print(f"K3 [{N},{P},{K}]->{N2}: torch.matmul alone {lms:.4f} ms")
        todo = [("older", older)] if older else []
        todo += [("current", cur)] + todo
        for name, lib in todo:
            tr = 128 if name == "older" else lib.uncr_ngm_tile_rows(1, K, N2, 1)
            ps, pq = (torch.empty(N * P // tr + N, N2, device=dev) for _ in range(2))
            t1, t2 = torch.zeros(N, 1, device=dev), torch.zeros(N, 1, device=dev)

            def run(stats, gelu=gelu_on, affine=gelu_on, out_gelu=False):
                err = lib.uncr_norm_gelu_matmul(
                    xa.data_ptr(), 1, mean.data_ptr(), coef.data_ptr(), 1, sca.data_ptr(),
                    bia.data_ptr(), wa.data_ptr(), ptr(se), ptr(osc if affine else None),
                    ptr(obi if affine else None), int(gelu), int(out_gelu), oa.data_ptr(), N, P,
                    K, N2, ptr(ps if stats else None), ptr(pq if stats else None),
                    t1.data_ptr(), t2.data_ptr(), 1, stream)
                assert err == 0, (name, err)

            run(True)
            torch.cuda.synchronize()
            err = float((oa.float() - ref[0].float()).abs().max())
            e1 = float(((t1 - ref[1]).abs() / ref[0].float().abs().sum(dim=(1, 2))[:, None]).max())
            e2 = float(((t2 - ref[2]).abs() / ref[2]).max())
            assert err <= top * 2 ** -7 and max(e1, e2) <= 1e-4, (name, err, e1, e2)
            t = {"ms": time_ms(lambda: run(False)), "stats_ms": time_ms(lambda: run(True))}
            line = (f"  {name} (rows per partial {tr}): max_abs_err {err:.3g} of {top:.3g} "
                    f"(one bf16 ulp {top * 2 ** -7:.3g}), stats rel {e1:.2g} / {e2:.2g}; "
                    f"{t['ms']:.4f} ms, with statistics {t['stats_ms']:.4f} ms")
            if gelu_on:  # what the prologue's GELU costs: the same launch without it
                t["no_gelu_ms"] = time_ms(lambda: run(False, gelu=False))
                line += f", without the prologue's GELU {t['no_gelu_ms']:.4f} ms"
            else:  # what an epilogue the fused block does not ask for would cost
                t["epilogue_ms"] = time_ms(lambda: run(False, affine=True, out_gelu=True))
                line += f", with an affine + GELU epilogue {t['epilogue_ms']:.4f} ms"
            print(line, flush=True)
            rows.append({"kernel": "K3", "K": K, "N": N2, "build": name, **t,
                         "max_abs_err": err})
    with open(OUT / "results.json", "w") as f:
        json.dump({"card": card, "gelu_sass": gelu, "rows": rows}, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
