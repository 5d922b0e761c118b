"""The benchmark of the PyTorch port ``uncrtaints_tpu_torch`` on an NVIDIA H100.

    python3 bench_h100/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

runs one cell of ``BENCHMARK.json`` on this machine's card and prints one
JSON line: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics with ``--trace 0``, its per-layer metrics with
``--trace 1``), ``device``, with ``--trace 1`` ``breakdown``, and last
``compared``: each number the correctness check compared, with its limit
(also the last lines on standard error). Without a card, or with fewer
cards than the cell asks for, it exits with 2 and prints no result.

Build and kernel caches stay inside the checkout (``build/``): the port
builds its kernels into ``build/kernels/`` on the first run of a checkout
and every later run loads them.
"""

import os
import sys
import time
from pathlib import Path


def process_start() -> float:
    """``time.perf_counter()`` at this process's start (from /proc, to a
    clock tick), so set-up counts the interpreter's start too."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.perf_counter() - max(uptime - start_ticks / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return time.perf_counter()


T_START = process_start()
ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "build" / "bench_cache"
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                 ("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("CUDA_CACHE_PATH", "cuda")):
    os.environ[var] = str(CACHE / sub)
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    import argparse
    import json

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from bench_h100 import harness
    spec = harness.cell_spec(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < spec.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {spec.chips} CUDA device(s); this machine has {n}",
              file=sys.stderr)
        return 2
    out = harness.run_cell(spec, args.seed, args.seconds, bool(args.trace),
                           torch.device("cuda", 0), T_START)
    for k, c in out["compared"].items():
        print(f"{k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
