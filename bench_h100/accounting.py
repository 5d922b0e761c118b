"""The benchmark's own accounting: the card's peaks, the FLOPs of a request
and the hand-written kernels' bytes and operations.

Peaks are NVIDIA's data-sheet figures for the H100 SXM at its 700 W limit:
989 TFLOP/s dense bf16 on the tensor cores, 3.35 TB/s of HBM3. A card not
in the table raises. Every run reports the card's power limit beside them
(``nvidia-smi``), since a card set below 700 W reaches less.

The FLOPs of a request are counted by ``torch.utils.flop_counter`` over the
benchmark's plain reference on the meta device at the cell's shapes (matrix
products and convolutions, forward and, for a train step, backward; no
elementwise work), so they do not move with the program.

Each file ``kernels/<name>.py`` describes one hand-written kernel family:
``OPS``, the operator names the program calls it by (the profiler records
them with their input shapes and dtypes); ``FRAGMENTS``, pieces of its
device kernels' names; ``cost(op, shapes, dtypes)``, the bytes it must move
(each input read once, each output written once) and the FLOPs it must
do. The roofline metrics read them all.
"""

from __future__ import annotations

import importlib.util
import math
import subprocess
from pathlib import Path
from typing import Dict

import torch

HERE = Path(__file__).resolve().parent
PEAKS = {"NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12, "hbm_bytes": 3.35e12}}
DTYPE_BYTES = {"float": 4, "float32": 4, "c10::BFloat16": 2, "bfloat16": 2, "c10::Half": 2,
               "double": 8, "long int": 8, "int": 4, "bool": 1}


def card(device: torch.device) -> dict:
    """The card's name, peaks and power limit; raises for a card that has
    no peaks in the table."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    name = torch.cuda.get_device_name(index)
    if name not in PEAKS:
        raise RuntimeError(f"no peaks known for {name!r} (known: {sorted(PEAKS)})")
    out = subprocess.run(["nvidia-smi", f"--id={index}", "--query-gpu=power.limit",
                          "--format=csv,noheader,nounits"], capture_output=True, text=True,
                         check=True).stdout.strip()
    return {"name": name, "power_limit_w": float(out), **PEAKS[name]}


def bound_seconds(peaks: dict, nbytes: float, flops: float) -> float:
    """The least time the card needs: the larger of bytes over bandwidth and
    FLOPs over the bf16 peak."""
    return max(nbytes / peaks["hbm_bytes"], flops / peaks["bf16_flops"])


def load_kernels(root: Path = HERE) -> Dict[str, object]:
    """Every kernel family's accounting module under ``root/kernels``, by
    file name."""
    out = {}
    for path in sorted((root / "kernels").glob("*.py")):
        if path.stem.startswith("_"):
            continue
        spec = importlib.util.spec_from_file_location(f"bench_h100.kernels.{path.stem}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        out[path.stem] = mod
    return out


def nbytes(shape, dtype: str) -> int:
    return math.prod(shape) * DTYPE_BYTES[dtype]


def conv_backward_flops(grad_out_shape, x_shape, w_shape, *args, transposed=None,
                        output_mask=None, **kwargs) -> int:
    """The convolution's backward as two convolutions of the forward's cost
    (2 per multiply-add, the groups honoured): the input gradient and the
    weight gradient, each where asked for. (torch's own formula counts a
    depthwise weight gradient as a dense one, C times too many.)"""
    if transposed is None:  # positional: bias, stride, padding, dilation, transposed, ...
        transposed, output_mask = args[4], args[7]
    fwd = 2 * math.prod(x_shape if transposed else grad_out_shape) * math.prod(w_shape[1:])
    return fwd * (int(bool(output_mask[0])) + int(bool(output_mask[1])))


def request_flops(cfgfile: dict, traffic: dict, shapes: Dict[str, torch.Size]) -> float:
    """FLOPs of one request of this cell, by the reference on the meta device."""
    from torch.utils.flop_counter import FlopCounterMode

    from bench_h100 import systems
    meta = torch.device("meta")
    m = cfgfile["model"]
    train = traffic["step"] == "train"
    P = {k: torch.empty(s, device=meta, requires_grad=train and not k.endswith(
        ("running_mean", "running_var"))) for k, s in shapes.items()}
    B, T, S = traffic["batch"], m["input_t"], traffic["patch"]
    batch = {"x": torch.empty((B, T, S, S, m["input_dim"]), device=meta),
             "y": torch.empty((B, 1, S, S, 13), device=meta),
             "dates": torch.empty((B, T), device=meta)}
    mapping = {torch.ops.aten.convolution_backward: conv_backward_flops}
    with FlopCounterMode(display=False, custom_mapping=mapping) as counter:
        loss, _, _ = systems.reference_outputs(cfgfile, P, batch, train)
        if train:
            torch.autograd.grad(loss, [p for p in P.values() if p.requires_grad])
    return float(counter.get_total_flops())
