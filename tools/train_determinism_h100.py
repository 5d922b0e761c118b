"""Run the paper recipe's train step twice from the same weights, batch and
dropout seed on a GPU, and count the parameter gradients that differ in any
bit between the two runs.

    python3 tools/train_determinism_h100.py [--steps N]
                                            (from the root of a checkout, one card)

Three settings, each two runs of N steps (default 1 and 3): the port as it
is (the attention upsample's backward is the interpolation matmuls' adjoint,
``ops/resize.py:_Bilinear``); the upsample's backward left to
``F.interpolate`` (on CUDA it adds into the input gradient with atomics);
and the latter with ``torch.backends.cudnn.deterministic``. Prints, for each,
the losses of the two runs, the count of differing gradients, the largest
relative gaps and the step's median time over 7 steps (host clock, each
step synchronized), and the card's name and power limit.
"""

import argparse
import os
import statistics
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402
from uncrtaints_tpu_torch.config import Config, derive  # noqa: E402
from uncrtaints_tpu_torch.ops import resize  # noqa: E402
from uncrtaints_tpu_torch.train import create_train_state, make_train_step  # noqa: E402


def stock_bilinear(x, out_hw):
    """The upsample with ``F.interpolate``'s own backward."""
    lead, xc = resize._nchw(x)
    return resize._nhwc(resize._interpolate(xc, tuple(out_hw)), lead)


def run(cfg, step, batch, dev, steps):
    state = create_train_state(cfg, cs.seeded_model(cfg, dev))
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 5)
    for _ in range(steps):
        state, aux = step(state, batch, gen)
    return {n: g.clone() for n, g in aux["grads"].items()}, float(aux["loss"])


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, nargs="+", default=[1, 3])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cfg = derive(Config(use_sar=True, scale_by=10.0))  # the paper recipe, bf16
    batch = cs._synthetic_batches(cfg, 1, cs.PATCH, cs.SEED + 5, dev)[0]
    step = make_train_step(cfg)
    port = resize._bilinear
    for label, bilinear, cudnn_det in (("the port", port, False),
                                       ("F.interpolate's backward", stock_bilinear, False),
                                       ("F.interpolate's backward + cudnn.deterministic",
                                        stock_bilinear, True)):
        resize._bilinear = bilinear
        torch.backends.cudnn.deterministic = cudnn_det
        for n in args.steps:
            (a, la), (b, lb) = (run(cfg, step, batch, dev, n) for _ in range(2))
            gaps = sorted(((float((a[k] - b[k]).abs().max() / a[k].abs().max().clamp_min(1e-30)),
                            k) for k in a if not torch.equal(a[k], b[k])), reverse=True)
            print(f"{label}, {n} step(s): losses {la!r} {lb!r}; {len(gaps)} of {len(a)} "
                  f"gradients differ; largest relative gaps "
                  f"{[(k, f'{g:.3g}') for g, k in gaps[:3]]}", flush=True)
        state = create_train_state(cfg, cs.seeded_model(cfg, dev))
        gen = torch.Generator(device=dev).manual_seed(cs.SEED + 5)
        times = []
        for _ in range(8):  # the first warms up
            t0 = time.perf_counter()
            state, _ = step(state, batch, gen)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        print(f"{label}: train step {statistics.median(times[1:]):.3f} ms median of 7",
              flush=True)
    resize._bilinear = port
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
