"""The cell's weights and inputs, drawn from ``--seed`` on the device.

Weights: one N(0,1) draw on the device for every parameter and statistic
together, then each leaf its law (by its name and shape):

- a weight of two or more axes (convolution, linear, the L-TAE's queries):
  xavier-normal, std sqrt(2 / (fan_in + fan_out));
- a norm's scale: 1 + 0.1 z; any bias: 0.1 z;
- a batch norm's running mean 0.1 z and running variance exp(0.25 z).

The names and shapes are those of the port's ``state_dict``, so the same
dict loads into the program and into the reference by name.

Inputs: a pool of batches, x and y ~ U[0,1) and the dates floor(U[0,1500))
days, each batch drawn anew (no two rows alike). Each stream has its own
generator: weights from ``seed``, batches from ``seed + 1``, the train
step's dropout from ``seed + 2``.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

S2_BANDS = 13


def _leaf(name: str, z: torch.Tensor) -> torch.Tensor:
    if name.endswith("running_mean"):
        return 0.1 * z
    if name.endswith("running_var"):
        return torch.exp(0.25 * z)
    if z.dim() >= 2:
        rf = math.prod(z.shape[2:])
        return z * math.sqrt(2.0 / ((z.shape[0] + z.shape[1]) * rf))
    if name.endswith("weight"):
        return 1.0 + 0.1 * z
    return 0.1 * z


def seeded_weights(shapes: Dict[str, torch.Size], seed: int,
                   device: torch.device) -> Dict[str, torch.Tensor]:
    """{name: fp32 tensor on ``device``} for every entry of ``shapes``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    sizes = [math.prod(s) for s in shapes.values()]
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    return {n: _leaf(n, z.view(s)) for (n, s), z in zip(shapes.items(), flat.split(sizes))}


def batch_pool(model: dict, traffic: dict, seed: int,
               device: torch.device) -> List[Dict[str, torch.Tensor]]:
    """``traffic["pool"]`` batches of ``traffic["batch"]`` sequences of
    ``model["input_t"]`` frames at ``traffic["patch"]`` squared."""
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    B, T, S = traffic["batch"], model["input_t"], traffic["patch"]
    pool = []
    for _ in range(traffic["pool"]):
        pool.append({
            "x": torch.rand((B, T, S, S, model["input_dim"]), generator=gen, device=device),
            "y": torch.rand((B, 1, S, S, S2_BANDS), generator=gen, device=device),
            "dates": torch.floor(1500.0 * torch.rand((B, T), generator=gen, device=device)),
        })
    return pool


def dropout_generator(seed: int, device: torch.device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed + 2)
