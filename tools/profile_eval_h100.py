"""Profile the port's eval step of the paper recipe on a GPU, for any tree.

    python3 tools/profile_eval_h100.py [--root DIR]      (one card)

Builds the paper recipe with seeded weights from the package
``uncrtaints_tpu_torch`` found under ``--root`` (default: this checkout; an
older tree unpacked with ``git archive`` works too), runs 6 eval steps of
B=4, T=3, 256x256 (median on the host clock around a synchronised step),
then one step under ``torch.profiler`` with the report of
``chip_smoke.py:eval_step_report``: device time by kind, the idle share,
the K3 and K4 kernels by name, and the five decoder blocks alone with any
eager GELU or reduction over a whole map they run. Nothing is checked: it is
the yardstick for comparing two trees in one call on one card.
"""

import importlib.util
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent.parent


def main():
    if not torch.cuda.is_available():
        print("profile_eval_h100: no CUDA device", file=sys.stderr)
        return 1
    args = sys.argv[1:]
    root = Path(args[args.index("--root") + 1]).resolve() if "--root" in args else HERE
    sys.path.insert(0, str(root))  # the package under test
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    from uncrtaints_tpu_torch.config import Config, derive
    from uncrtaints_tpu_torch.data import SyntheticSEN12MSCRTS, collate_multi
    from uncrtaints_tpu_torch.train import batch_to_device, make_eval_step
    import uncrtaints_tpu_torch
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"card: {card}; package {Path(uncrtaints_tpu_torch.__file__).parent}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cfg = derive(Config(use_sar=True, scale_by=10.0))
    B, T, P = smoke.B, smoke.T, smoke.PATCH
    ds = SyntheticSEN12MSCRTS(n_samples=B, n_input_t=T, patch_size=P, seed=smoke.SEED + 1)
    batch = batch_to_device(collate_multi([ds[j] for j in range(B)], use_sar=True), dev)
    model = smoke.seeded_model(cfg, dev)
    step = make_eval_step(cfg, with_metrics=True)
    step(model, batch)
    torch.cuda.synchronize()
    times = []
    for _ in range(6):
        t0 = time.perf_counter()
        step(model, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    ms = statistics.median(times)
    print(f"eval step: {ms:.3f} ms median of 6 (min {min(times):.3f}, max {max(times):.3f})")
    smoke.eval_step_report(step, model, batch, ms)
    return 0


if __name__ == "__main__":
    sys.exit(main())
