"""One run of one cell: set-up, the timed window, the traced window, the
check against the reference, and the result line.

Everything a cell is made of is found by name (``BENCHMARK.json`` beside the
benchmark's folder names the cells and metrics):

- ``configs/<config>.json``: the model as it is run (the port's Config
  fields, the explicit widths the reference reads, the optimizer, the
  reference family);
- ``traffic/<traffic>.json``: the step kind, batch, patch, the pool of
  distinct batches, how many requests the check keeps, the traced window;
- ``limits/<workload>.json``: the numbers the cell's check compares, each
  with its limit (a cell without one is never correct);
- ``metrics/<name>.py``, else ``metrics/<stem>.py`` for the name before its
  first dot and then for each tail of that after an underscore, longest
  first (``utae_train_seq_per_s`` -> ``seq_per_s.py``, ``k1_roofline.eval`` ->
  ``roofline.py``): a reader ``read(ctx)`` that returns the metric or None
  when it finds nothing;
- ``kernels/<name>.py``: a kernel family's accounting (accounting.py);
- ``reference/<family>.py``: the plain reference.

Eval traffic is a closed loop with one client: each request is one eval
step on the next batch of the pool, ended by a synchronize; its latency runs
from the call to the end of that synchronize. Train traffic is train steps
back to back on the pool's batches, the state threaded through, one
synchronize when the window's time is up. Either way the window's rate is
all the work it completed over all its time.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import math
import random
import sys
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Callable, Optional

import torch

from bench_h100 import accounting, check, systems, trace, weights

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "uncrtaints_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_spec(workload: str, root: Path = HERE) -> SimpleNamespace:
    """The cell ``workload`` of ``root``'s BENCHMARK.json (one directory up)
    with its configuration, traffic, limits and metric names."""
    spec = load_json(root.parent / "BENCHMARK.json")
    cell = next((w for w in spec["workloads"] if w["name"] == workload), None)
    if cell is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json "
                         f"({[w['name'] for w in spec['workloads']]})")
    entry = next(c for c in spec["configs"] if c["name"] == cell["config"])
    in_cell = lambda m: "workloads" not in m or workload in m["workloads"]
    limits_path = root / "limits" / f"{workload}.json"
    config = load_json(root.parent / entry["file"])
    config["reference_dir"] = str(root / "reference")
    return SimpleNamespace(
        name=workload, chips=cell["chips"], root=root, config=config,
        traffic=load_json(root / "traffic" / f"{cell['traffic']}.json"),
        limits=load_json(limits_path) if limits_path.exists() else {},
        end_to_end=[m for m in spec["end_to_end"] if in_cell(m)],
        per_layer=[m for m in spec["per_layer"] if in_cell(m)])


def reader(name: str, root: Path = HERE) -> Callable:
    """The ``read(ctx)`` function of metric ``name``."""
    d = root / "metrics"
    words = name.split(".")[0].split("_")
    for stem in [name] + ["_".join(words[i:]) for i in range(len(words))]:
        if (d / f"{stem}.py").exists():
            spec = importlib.util.spec_from_file_location(f"bench_h100.metrics.{stem}",
                                                          d / f"{stem}.py")
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod.read
    raise SystemExit(f"no reader for metric {name!r} under {d}")


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Reservoir:
    """A uniform sample of ``k`` of the requests seen, drawn from the seed."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng, self.seen, self.kept = k, random.Random(seed), 0, []

    def offer(self, item) -> None:
        self.seen += 1
        if len(self.kept) < self.k:
            self.kept.append(item)
        else:
            j = self.rng.randrange(self.seen)
            if j < self.k:
                self.kept[j] = item


def eval_window(system, pool, seconds: float, device, keep: Optional[Reservoir] = None,
                max_requests: Optional[int] = None, span: bool = False) -> dict:
    """Closed-loop eval requests until ``seconds`` have passed (or
    ``max_requests``): each request's latency and host time (call to
    return), and the window's start and end."""
    lat, host, n = [], [], 0
    sync(device)
    t0 = time.perf_counter()
    while True:
        j = n % len(pool)
        ts = time.perf_counter()
        with trace.span(trace.REQUEST) if span else contextlib.nullcontext():
            out = system(pool[j])
            th = time.perf_counter()
            sync(device)
        te = time.perf_counter()
        lat.append(te - ts)
        host.append(th - ts)
        if keep is not None:
            keep.offer({"pool": j, "out": out})
        del out
        n += 1
        if te - t0 >= seconds or (max_requests and n >= max_requests):
            break
    return {"t0": t0, "t1": te, "requests": n, "latency_s": lat, "host_s": host}


def train_window(system, pool, gen, seconds: float, device,
                 max_requests: Optional[int] = None, span: bool = False) -> dict:
    """Train steps back to back until ``seconds`` have passed (or
    ``max_requests``), one synchronize at the end."""
    host, n, loss = [], 0, None
    sync(device)
    t0 = time.perf_counter()
    while True:
        ts = time.perf_counter()
        with trace.span(trace.REQUEST) if span else contextlib.nullcontext():
            loss = system(pool[n % len(pool)], gen)["loss"]
        host.append(time.perf_counter() - ts)
        n += 1
        if time.perf_counter() - t0 >= seconds or (max_requests and n >= max_requests):
            break
    sync(device)
    t1 = time.perf_counter()
    return {"t0": t0, "t1": t1, "requests": n, "host_s": host,
            "last_loss": float(loss)}


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run_cell(spec: SimpleNamespace, seed: int, seconds: float, traced: bool,
             device: torch.device, t_start: float, system_factory: Optional[Callable] = None,
             wrap: Optional[Callable] = None) -> dict:
    """One run of the cell: the result line as a dict.

    ``system_factory(cfgfile, batch, weights, device, seed)`` replaces the
    program (the control); ``wrap(system)`` puts a fault under the timed
    path (the tests)."""
    cfgfile, traffic = spec.config, spec.traffic
    kind, B = traffic["step"], traffic["batch"]
    phases = {"start_to_call": time.perf_counter() - t_start}
    mark = lambda name, t0: phases.__setitem__(name, time.perf_counter() - t0)
    t0 = time.perf_counter()
    shapes = systems.state_shapes(cfgfile, B, device)  # the program's import
    mark("program_import", t0)
    t0 = time.perf_counter()
    torch.zeros(1, device=device)
    sync(device)
    mark("device_init", t0)
    t0 = time.perf_counter()
    w = weights.seeded_weights(shapes, seed, device)
    pool = weights.batch_pool(cfgfile["model"], traffic, seed, device)
    if system_factory is None:
        system_factory = systems.PortEval if kind == "eval" else systems.PortTrain
    sync(device)
    mark("weights_and_inputs", t0)
    t0 = time.perf_counter()
    system = system_factory(cfgfile, B, w, device, seed)
    if wrap is not None:
        system = wrap(system)
    mark("program_build", t0)
    t0 = time.perf_counter()

    record = gen = gen_state = None
    if kind == "eval":
        for batch in pool:  # every shape the window uses, built and warmed
            system(batch)
        keep = Reservoir(traffic["checked_requests"], seed)
    else:
        gen = weights.dropout_generator(seed, device)
        gen_state = gen.get_state()
        record = check.follow(system, pool, gen, traffic["compared_steps"],
                              cfgfile["optimizer"]["b1"])
        for i in range(traffic["warmup_steps"]):
            system(pool[i % len(pool)], gen)
    sync(device)
    setup_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t_window = time.perf_counter()
    mark("warm_up", t0)

    if kind == "eval":
        window = eval_window(system, pool, seconds, device, keep)
    else:
        window = train_window(system, pool, gen, seconds, device)
    window_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    tr = None
    kernels = accounting.load_kernels(spec.root)
    if traced:
        span = dict(seconds=traffic["trace_seconds"], max_requests=traffic["trace_max_requests"])
        run = ((lambda **kw: eval_window(system, pool, device=device, **{**span, **kw}))
               if kind == "eval" else
               (lambda **kw: train_window(system, pool, gen, device=device, **{**span, **kw})))
        tr = trace.Trace(run, {op for k in kernels.values() for op in k.OPS})
    peak = max(setup_peak, torch.cuda.max_memory_allocated(device)
               if device.type == "cuda" else 0)
    found = forbidden_modules()
    if found:
        raise RuntimeError(f"modules of JAX or of the JAX package are loaded: {found}")

    del system
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    if kind == "eval":
        numbers = check.eval_numbers(cfgfile, w, keep.kept, pool, traffic["reference_block"])
        checked = len(keep.kept)
    else:
        numbers = check.train_numbers(cfgfile, w, record, pool, gen_state)
        checked = traffic["compared_steps"]
    # the cell's limits file names the numbers it compares; the rest are
    # readings only (kept in the line for the next calibration)
    compared = {k: {"value": numbers.get(k, math.inf), "limit": lim}
                for k, lim in spec.limits.items()}
    failed_numbers = [k for k, c in compared.items() if not c["value"] <= c["limit"]]
    if kind == "train" and not math.isfinite(window["last_loss"]):
        failed_numbers.append("the window's last loss is not finite")
    correct = bool(compared) and not failed_numbers

    info = accounting.card(device) if device.type == "cuda" else {
        "name": "cpu", "power_limit_w": None, **next(iter(accounting.PEAKS.values()))}
    ctx = SimpleNamespace(kind=kind, spec=spec, traffic=traffic, config=cfgfile,
                          setup_s=t_window - t_start, window=window, window_peak=window_peak,
                          trace=tr, card=info, shapes=shapes, kernels=kernels)
    metrics = {}
    for m in (spec.per_layer if traced else spec.end_to_end):
        ctx.name = m["name"]
        v = reader(m["name"], spec.root)(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device_info = {"platform": "gpu" if device.type == "cuda" else "cpu",
                   "kind": info["name"], "count": 1, "memory_peak_bytes": peak}
    out = {"correct": correct, "attempted": window["requests"],
           "failed": checked if failed_numbers else 0, "metrics": metrics,
           "device": device_info}
    if tr is not None:
        device_info.update(busy_s=tr.busy_s, window_s=tr.window_s)
        out["breakdown"] = tr.breakdown({name: k.FRAGMENTS for name, k in kernels.items()})
    out["card"] = {"name": info["name"], "power_limit_w": info["power_limit_w"],
                   "peak_bf16_flops": info["bf16_flops"], "peak_hbm_bytes_per_s":
                   info["hbm_bytes"]}
    out["workload"], out["seed"], out["seconds"] = spec.name, seed, seconds
    out["setup_phases_s"] = phases
    out["readings"] = {k: v for k, v in numbers.items() if k not in compared}
    out["compared"] = compared
    return out
