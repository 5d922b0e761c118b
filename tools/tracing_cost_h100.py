"""What the step spans (``uncrtaints_tpu_torch/tracing.py``) cost the host, on
a GPU.

    python3 tools/tracing_cost_h100.py [--batch N] [--rounds R] [--requests K]

Builds the paper recipe with seeded weights on the card (256x256, T=3) and,
for the eval step and the train step, runs ``R`` rounds, each of two
windows of ``K`` requests under a CUDA-only ``torch.profiler`` (the
benchmark's device window): one with the tracer on, one with it forced off
(``tracing.span`` / ``step`` / ``recording`` replaced by empty contexts),
in turns, the order swapped every round. An eval request is one step and a
synchronize, a train request one step, the window ending in one
synchronize. Prints, a step: the host's time from the call to its return
(the median of each window) and each window's idle share (1 - the union of
its device operations over its length on the host clock, as
``bench_h100/metrics/idle_share.py``), with the on - off differences (the
medians over the rounds), the spans and counters of a record, and the
device time of each section (the median over the tracer-on windows' steps,
self time as ``bench_h100/metrics/device_ms.py`` reads it). A span's own
host cost is also timed apart, over empty spans: a million with no
profiler (one check), ten thousand inside an open step record on the card
under the CUDA-only profiler (the profiler range, two timing events, the
record), each multiplied by the spans of a step. One JSON line at the end.
"""

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(HERE))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--requests", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("tracing_cost_h100: no CUDA device", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    from bench_h100 import trace
    from bench_h100.metrics.device_ms import self_ms
    from uncrtaints_tpu_torch import tracing
    from uncrtaints_tpu_torch.config import Config, derive
    from uncrtaints_tpu_torch.models.registry import get_generator
    from uncrtaints_tpu_torch.train.engine import (create_train_state, make_eval_step,
                                                   make_train_step)

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    dev = torch.device("cuda", 0)
    cfg = derive(Config(use_sar=True, scale_by=10.0, batch_size=args.batch, device="cuda"))
    gen = torch.Generator(device=dev).manual_seed(7)
    with torch.device(dev):
        model = get_generator(cfg, device=dev, generator=gen)
    B, T, S = args.batch, cfg.input_t, 256
    batch = {"x": torch.rand((B, T, S, S, 15), generator=gen, device=dev),
             "y": torch.rand((B, 1, S, S, 13), generator=gen, device=dev),
             "dates": torch.floor(1500.0 * torch.rand((B, T), generator=gen, device=dev))}
    ev, tr = make_eval_step(cfg), make_train_step(cfg)
    state = create_train_state(cfg, model)
    calls = {"eval": lambda: ev(model, batch), "train": lambda: tr(state, batch, gen)}

    real = (tracing.span, tracing.step, tracing.recording)
    null = (lambda name: tracing._NULL, lambda name, model: tracing._NULL, lambda: False)

    def window(kind, on):
        tracing.span, tracing.step, tracing.recording = real if on else null
        host = []
        try:
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                w0 = time.perf_counter()
                for _ in range(args.requests):
                    t0 = time.perf_counter()
                    calls[kind]()
                    host.append(time.perf_counter() - t0)
                    if kind == "eval":
                        torch.cuda.synchronize()
                torch.cuda.synchronize()
                w1 = time.perf_counter()
        finally:
            tracing.span, tracing.step, tracing.recording = real
        busy = sum(b - a for a, b in trace.merge([(a, b) for _, a, b in
                                                  trace._device_ops(prof.events())]))
        return 1e6 * statistics.median(host), 100.0 * (1.0 - busy / 1e6 / (w1 - w0))

    result = {"card": card, "batch": B}
    for kind in ("eval", "train"):
        for _ in range(3):  # warm-up, the profiler's start-up included
            calls[kind]()
        window(kind, True)
        tracing.take()
        on, off = [], []  # (host µs a call, idle %), by window
        for r in range(args.rounds):
            for mode in ((True, False) if r % 2 == 0 else (False, True)):
                (on if mode else off).append(window(kind, mode))
        recs = tracing.take()
        sections = [self_ms(rec) for rec in recs]
        names = sorted({n for s in sections for n in s})
        res = {
            "host_us_on": [h for h, _ in on], "host_us_off": [h for h, _ in off],
            "idle_on": [i for _, i in on], "idle_off": [i for _, i in off],
            "on_minus_off_us": statistics.median(a[0] - b[0] for a, b in zip(on, off)),
            "on_minus_off_idle_points": statistics.median(a[1] - b[1] for a, b in zip(on, off)),
            "steps_recorded": len(recs),
            "spans": [sp.name for sp in recs[-1].spans],
            "counters_mb": {k: v / 1e6 for k, v in recs[-1].counters.items()},
            "section_ms": {n: statistics.median(s.get(n, 0.0) for s in sections) for n in names},
            "step_ms": statistics.median(rec.spans[0].device_ms() for rec in recs),
        }
        result[kind] = res
        print(kind, json.dumps(res), flush=True)

    def per_span_us(n):
        t0 = time.perf_counter()
        for _ in range(n):
            with tracing.span("x"):
                pass
        return (time.perf_counter() - t0) / n * 1e6

    result["off_us_a_span"] = per_span_us(1_000_000)
    with profile(activities=[ProfilerActivity.CUDA]), tracing.step("eval_step", model):
        result["on_us_a_span"] = per_span_us(10_000)
    torch.cuda.synchronize()
    tracing.take()
    for mode in ("off", "on"):
        result[f"{mode}_us_a_step"] = {k: result[f"{mode}_us_a_span"] * len(result[k]["spans"])
                                       for k in ("eval", "train")}
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
