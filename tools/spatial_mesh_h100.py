"""The paper recipe on a 2-D data x spatial mesh of GPUs, against one process.

    python3 tools/spatial_mesh_h100.py [--data D] [--spatial S]     (D*S cards, or fewer)

Starts ``chip_smoke.py``'s spatial ranks (``--spatial-rank``) as a D x S mesh
under ``torchrun`` (default 2 x 2): NCCL with a card a rank, gloo where
ranks must share a card. Each rank holds its samples and its band of rows of
the paper recipe's B=4, T=3, 256x256 batch (bf16, seeded weights, synthetic
data) and runs an eval step, ``predict_scene(mesh=)`` on a 512x512 scene and
train steps. When the ranks are done, this process runs the same on card 0
alone, and ``chip_smoke.py:spatial_report`` holds the ranks against it
(losses, outputs, the launches through the halo modes, the gradients) and
prints each rank's train-step peak memory, its step times, its collectives'
host time and the device time of its host copies and NCCL kernels. Exits
non-zero when a check fails.
"""

import importlib.util
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent.parent


def main():
    if not torch.cuda.is_available():
        print("spatial_mesh_h100: no CUDA device", file=sys.stderr)
        return 1
    args = sys.argv[1:]
    n_data = int(args[args.index("--data") + 1]) if "--data" in args else 2
    n_spatial = int(args[args.index("--spatial") + 1]) if "--spatial" in args else 2
    sys.path.insert(0, str(HERE))
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cards = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True, check=True).stdout.strip().splitlines()
    print(f"cards: {cards}; {n_data} x {n_spatial} ranks on {torch.cuda.device_count()} card(s)")
    with tempfile.TemporaryDirectory() as out:
        # the ranks first, so that the reference has card 0 to itself
        got = smoke.finish_spatial_ranks(smoke.start_spatial_ranks(out, n_data, n_spatial), out,
                                         n_data, n_spatial)
    batch, scene = smoke._spatial_inputs()
    one = smoke._phase10_steps(torch.device("cuda", 0), batch, scene)
    smoke.spatial_report(one, got, batch, n_data, n_spatial, "spatial_mesh_h100")
    return 0


if __name__ == "__main__":
    sys.exit(main())
