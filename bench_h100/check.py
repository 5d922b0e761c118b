"""What decides ``correct``: the program's outputs against the plain fp32
reference, after the window has closed.

Eval cells compare the requests the window kept (a sample drawn from the
seed): for each, pred, var and the loss against the reference on the same
batch and weights, the reference computed in blocks of sequences. The
numbers (the worst request's):

- ``pred_rmse``: ||pred - ref|| / ||ref||;
- ``pred_max``: max |pred - ref| (data units; a reflectance in [0, 1]);
- ``var_rmse``: ||var - ref|| / ||ref||;
- ``loss_gap``: |loss - ref| / |ref|.

Train cells compare the first steps set-up drove through the window's own
step (the same state object the window then runs): the reference follows
them from the same weights, batches and dropout generator state. The
numbers:

- ``loss_gap``: the worst step's |loss - ref| / |ref|;
- ``pred_rmse``, ``pred_max``: as for eval, of the first step's pred (its
  forward in train mode, from the same weights on both sides; later steps
  start from parameters that Adam's sign-like first updates already set
  apart);
- ``grad_gap``: the first step's gradient, as the program's optimizer got
  it (Adam's first moment after one step over 1 - b1): the worst leaf's
  | ||g|| - ||g_ref|| |, over the larger of ||g_ref|| and the median
  leaf's ||g_ref||; ``grad_gap_median`` the median leaf's gap;
- ``update_gap``: the same of the parameters' change over the compared
  steps, leaving out the leaves whose first reference gradient is under a
  thousandth of the median leaf's (their change is Adam on round-off);
  ``update_gap_median`` the median leaf's.

A cell compares the numbers its limits file names (PERF.md gives the
readings each limit was set from); the others are reported as readings.

The reference runs with TF32 off, in fp32, on the program's device after
the program's state is freed.
"""

from __future__ import annotations

import contextlib
import math
import statistics
from typing import Dict, List

import torch

from bench_h100 import systems
from bench_h100.reference import common

TINY_GRAD = 1e-3  # a leaf under this share of the median leaf's gradient is round-off
TRAIN_NUMBERS = ("loss_gap", "pred_rmse", "pred_max", "grad_gap", "grad_gap_median",
                 "update_gap", "update_gap_median")


@contextlib.contextmanager
def fp32_exact():
    """TF32 off for matrix products and convolutions while the reference runs."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).norm() / b.double().norm().clamp(min=1e-300))


@torch.no_grad()
def eval_numbers(cfgfile: dict, weights, kept: List[dict], pool, block: int) -> Dict[str, float]:
    """The eval numbers over the kept requests ({"pool": index, "out":
    outputs}); non-finite outputs read as inf."""
    P = {k: v.float() for k, v in weights.items()}
    worst: Dict[str, float] = {}
    with fp32_exact():
        for req in kept:
            batch, out = pool[req["pool"]], req["out"]
            B = batch["x"].shape[0]
            losses, preds, vars_ = [], [], []
            for i in range(0, B, block):
                part = {k: v[i:i + block] for k, v in batch.items()}
                loss, pred, var = systems.reference_outputs(cfgfile, P, part, False)
                losses.append(loss * part["x"].shape[0])
                preds.append(pred)
                vars_.append(var)
            ref_loss, ref_pred = float(sum(losses) / B), torch.cat(preds)
            pred = out["pred"].float()
            nums = {"pred_rmse": math.inf, "pred_max": math.inf, "loss_gap": math.inf}
            if vars_[0] is not None:
                nums["var_rmse"] = math.inf
            if pred.shape == ref_pred.shape:
                nums.update(pred_rmse=_rel(pred, ref_pred),
                            pred_max=float((pred - ref_pred).abs().max()),
                            loss_gap=abs(float(out["loss"]) - ref_loss) / abs(ref_loss))
                if vars_[0] is not None and out["var"].shape == ref_pred.shape:
                    nums["var_rmse"] = _rel(out["var"].float(), torch.cat(vars_))
            for k, v in nums.items():
                worst[k] = max(worst.get(k, 0.0), v if math.isfinite(v) else math.inf)
    return worst


def leaf_gap(got: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor], names,
             over=max) -> float:
    """The worst leaf's (``over=statistics.median``: the median leaf's)
    | ||got|| - ||ref|| | over max(||ref||, the median leaf's ||ref||)."""
    gn = {n: float(got[n].double().norm()) for n in names}
    rn = {n: float(ref[n].double().norm()) for n in names}
    med = statistics.median(rn.values())
    gaps = [abs(gn[n] - rn[n]) / max(rn[n], med, 1e-300) for n in names]
    return over(gaps) if all(map(math.isfinite, gaps)) else math.inf


def first_gradient(system, b1: float) -> Dict[str, torch.Tensor]:
    """The first step's gradient as the system's Adam got it: its first
    moment after one step over 1 - b1."""
    return {n: m.float() / (1.0 - b1) for n, m in system.first_moment().items()}


def follow(system, pool, gen: torch.Generator, steps: int, b1: float) -> dict:
    """Drive ``system`` through ``steps`` train steps on pool[0], pool[1],
    ...: {"losses", "preds", "grad1", "params"} (copies where the state
    moves on)."""
    losses, preds, grad1 = [], [], None
    for i in range(steps):
        out = system(pool[i % len(pool)], gen)
        losses.append(out["loss"])
        preds.append(out["pred"].float())
        if grad1 is None:
            grad1 = {n: g.clone() for n, g in first_gradient(system, b1).items()}
    return {"losses": [float(l) for l in losses], "preds": preds, "grad1": grad1,
            "params": {n: p.detach().float().clone() for n, p in system.params().items()}}


def train_numbers(cfgfile: dict, weights, record: dict, pool, gen_state) -> Dict[str, float]:
    """The train numbers for the program's ``record`` (:func:`follow`), its
    steps having run on pool[0], pool[1], ... with the dropout generator
    from ``gen_state``: the reference follows the same steps."""
    device = pool[0]["x"].device
    gen = torch.Generator(device=device)
    gen.set_state(gen_state)
    ref_sys = systems.ReferenceTrain(cfgfile, weights, q=common.exact)
    with fp32_exact():
        ref = follow(ref_sys, pool, gen, len(record["losses"]), cfgfile["optimizer"]["b1"])
    del ref_sys
    got = record["losses"]
    names = list(ref["grad1"])
    if (not all(map(math.isfinite, got)) or set(record["grad1"]) != set(names)
            or any(p.shape != r.shape for p, r in zip(record["preds"], ref["preds"]))):
        return {k: math.inf for k in TRAIN_NUMBERS}
    med = statistics.median(float(g.norm()) for g in ref["grad1"].values())
    moving = [n for n in names if float(ref["grad1"][n].norm()) >= TINY_GRAD * med]
    change = {n: record["params"][n] - weights[n].float() for n in moving}
    ref_change = {n: ref["params"][n] - weights[n].float() for n in moving}
    return {"loss_gap": max(abs(g - r) / abs(r) for g, r in zip(got, ref["losses"])),
            "pred_rmse": _rel(record["preds"][0], ref["preds"][0]),
            "pred_max": float((record["preds"][0] - ref["preds"][0]).abs().max()),
            "grad_gap": leaf_gap(record["grad1"], ref["grad1"], names),
            "grad_gap_median": leaf_gap(record["grad1"], ref["grad1"], names, statistics.median),
            "update_gap": leaf_gap(change, ref_change, moving),
            "update_gap_median": leaf_gap(change, ref_change, moving, statistics.median)}
