"""Radiometric preprocessing on tensors: S2 multispectral and S1 SAR
rescaling (port of the on-device half of uncrtaints_tpu/data/preprocess.py).

- MS 'default': clip to [0, 10000], rescale to [0, 1]
- MS 'resnet' : clip to [0, 10000], divide by 2000
- SAR 'default': clip dB to [-25, 0], rescale to [0, 1]
- SAR 'resnet' : per-polarisation clip ([-25,0] / [-32.5,0]) -> [0, 2]
- NaNs zeroed afterwards
"""

from __future__ import annotations

import torch


def rescale(img, old_min, old_max):
    return (img - old_min) / (old_max - old_min)


def process_MS_device(img: torch.Tensor, method: str = "default") -> torch.Tensor:
    if method == "default":
        img = rescale(torch.clamp(img, 0.0, 10000.0), 0.0, 10000.0)
    elif method == "resnet":
        img = torch.clamp(img, 0.0, 10000.0) / 2000.0
    return torch.nan_to_num(img)


def process_SAR_device(img: torch.Tensor, method: str = "default",
                       pol_axis: int = -1) -> torch.Tensor:
    """Polarisations (VV, VH) on ``pol_axis`` (NHWC default: last)."""
    if method == "default":
        img = rescale(torch.clamp(img, -25.0, 0.0), -25.0, 0.0)
    elif method == "resnet":
        vv, vh = img.narrow(pol_axis, 0, 1), img.narrow(pol_axis, 1, 1)
        vv = 2 * (torch.clamp(vv, -25.0, 0.0) + 25.0) / 25.0
        vh = 2 * (torch.clamp(vh, -32.5, 0.0) + 32.5) / 32.5
        img = torch.cat([vv, vh], dim=pol_axis)
    return torch.nan_to_num(img)
