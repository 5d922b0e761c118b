"""Readings for the correctness limits of a cell, on the card.

    python3 bench_h100/calibrate.py --workload paper_train_b16 --seeds 1,2,3 \\
        [--control 4,5,6] [--faults unchanged,half_batch,altered --fault-seeds 7,8,9] \\
        [--seconds 1]

runs the cell in one process once a seed with a short window (``--seconds``),
the program as it is (``program``), the plain reference in fp8 e4m3 in its
place (``control``, the precision step below the configurations' bf16) and
the program with each fault of faults.py underneath, and prints one JSON
line a run with the numbers the check compared. The lower reading of a
number is the largest the program gives, the upper the smallest the control
(and, for a train cell, a fault) gives; limits/<workload>.json holds the
limits set between them (PERF.md gives the readings).
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control", default="")
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args(argv)

    import torch

    from bench_h100 import faults, harness, systems
    if not torch.cuda.is_available():
        print("calibrate needs a CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    spec = harness.cell_spec(args.workload)
    ints = lambda s: [int(x) for x in s.split(",") if x]
    ref = systems.ReferenceEval if spec.traffic["step"] == "eval" else systems.ReferenceTrain
    control = lambda cf, b, w, d, s: ref(cf, w)
    runs = [("program", s, {}) for s in ints(args.seeds)]
    runs += [("control", s, {"system_factory": control}) for s in ints(args.control)]
    runs += [(f, s, {"wrap": faults.FAULTS[f]}) for f in args.faults.split(",") if f
             for s in ints(args.fault_seeds)]
    for mode, seed, kw in runs:
        t0 = time.perf_counter()
        out = harness.run_cell(spec, seed, args.seconds, False, device, time.perf_counter(), **kw)
        print(json.dumps({"workload": spec.name, "mode": mode, "seed": seed,
                          "numbers": {**out["readings"],
                                      **{k: c["value"] for k, c in out["compared"].items()}},
                          "correct": out["correct"], "metrics": out["metrics"],
                          "peak": out["device"]["memory_peak_bytes"],
                          "wall_s": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
