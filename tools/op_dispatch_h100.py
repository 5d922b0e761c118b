"""Time the paper recipe's eval and train steps of any tree on a GPU, and the
host cost of calling a kernel through its dispatcher operator.

    python3 tools/op_dispatch_h100.py [--root DIR] [--calls]     (one card)

Builds the paper recipe (B=4, T=3, 256x256, bf16, seeded weights) from the
package ``uncrtaints_tpu_torch`` under ``--root`` (default: this checkout; a
tree unpacked with ``git archive`` works too) and prints, on lines starting
with ``steps:``: the eval step and the train step on the host clock (median
of 12 and of 8 steps, each ending in ``torch.cuda.synchronize()``) and each
step's device-busy time from one step under ``torch.profiler`` (the sum of
its CUDA kernels). With ``--calls`` (a tree whose kernels are operators) it
also prints the host time of one call of K1, K5 and K3 through
``torch.ops.uncrtaints`` and through the launch function the operator wraps,
each the mean of 100 calls queued behind a spin on the device (so the
host's path, not the kernel, is timed), with and without autograd for K1
and K5. Nothing is checked: it is the yardstick for comparing two trees in
one call on one card (parent, change, change, parent).
"""

import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent.parent


def _steps(dev):
    from uncrtaints_tpu_torch.config import Config, derive
    from uncrtaints_tpu_torch.data import SyntheticSEN12MSCRTS, collate_multi
    from uncrtaints_tpu_torch.models import get_generator
    from uncrtaints_tpu_torch.train import (batch_to_device, create_train_state,
                                            make_eval_step, make_train_step)
    cfg = derive(Config(use_sar=True, scale_by=10.0))
    ds = SyntheticSEN12MSCRTS(n_samples=4, n_input_t=3, patch_size=256, seed=1)
    batch = batch_to_device(collate_multi([ds[j] for j in range(4)]), dev)
    model = get_generator(cfg, device=dev, generator=torch.Generator().manual_seed(0))
    gen = torch.Generator(device=dev).manual_seed(0)
    state = create_train_state(cfg, model)
    ev, tr = make_eval_step(cfg, with_metrics=True), make_train_step(cfg)
    run = {"eval": lambda: ev(model, batch), "train": lambda: tr(state, batch, gen)}
    out = {}
    for name, n in (("eval", 12), ("train", 8)):
        for _ in range(2):
            run[name]()
        torch.cuda.synchronize()
        times = []
        for _ in range(n):
            t0 = time.perf_counter()
            run[name]()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            run[name]()
            torch.cuda.synchronize()
        busy = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
        out[name] = (statistics.median(times), min(times), max(times), busy)
        print(f"steps: {name} step {out[name][0]:.3f} ms median of {n} (min "
              f"{out[name][1]:.3f}, max {out[name][2]:.3f}), device busy {busy:.3f} ms")
    return out


def _host_us(fn, n=100):
    """Host microseconds a call, the calls queued behind a device spin."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(400_000_000)  # keep the device busy (~0.2 s) while the host queues
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


def _calls(dev):
    from uncrtaints_tpu_torch.ops import aggregate, dwconv, mbconv
    g = torch.Generator(device=dev).manual_seed(0)
    r = lambda *s, dt=torch.bfloat16: torch.randn(s, device=dev, generator=g).to(dt)
    x, attn = r(1, 3, 8, 8, 128), r(1, 3, 8, 8, 16)
    xd, wd = r(1, 8, 8, 256), r(256, 1, 3, 3)
    k3 = (r(1, 128, 128), torch.zeros(1, 1, device=dev), torch.ones(1, 1, device=dev),
          r(128, dt=torch.float32), r(128, dt=torch.float32), r(128, 256))
    u = torch.ops.uncrtaints
    rows = {
        "K1 operator, no grad": lambda: u.att_group_aggregate(x, attn),
        "K1 launch function": lambda: aggregate._launch_fwd(x, attn),
        "K5 operator, no grad": lambda: u.dw_stencil(xd, wd, [1, 1, 1, 1], 1),
        "K5 launch function": lambda: dwconv._launch(xd, wd, ((1, 1), (1, 1)), 1),
        "K3 operator": lambda: u.norm_gelu_matmul(*k3, None, None, None, 1, 4, False,
                                                  False, False),
        "K3 launch function": lambda: mbconv._k3_launch(*k3, None, None, None, 1, 4, False,
                                                        False, False),
    }
    xg, wg = x.clone().requires_grad_(), wd.clone().requires_grad_()
    rows["K1 operator, autograd"] = lambda: u.att_group_aggregate(xg, attn)
    rows["K5 operator, autograd"] = lambda: u.dw_stencil(xd, wg, [1, 1, 1, 1], 1)
    with torch.no_grad():
        got = {k: _host_us(f) for k, f in rows.items() if "autograd" not in k}
    got.update({k: _host_us(f) for k, f in rows.items() if "autograd" in k})
    for k, v in got.items():
        print(f"calls: {k}: {v:.2f} us a call (host)")


def main():
    if not torch.cuda.is_available():
        print("op_dispatch_h100: no CUDA device", file=sys.stderr)
        return 1
    args = sys.argv[1:]
    root = Path(args[args.index("--root") + 1]).resolve() if "--root" in args else HERE
    sys.path.insert(0, str(root))  # the package under test
    import uncrtaints_tpu_torch
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"card: {card}; package {Path(uncrtaints_tpu_torch.__file__).parent}")
    dev = torch.device("cuda", 0)
    _steps(dev)
    if "--calls" in args:
        _calls(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
