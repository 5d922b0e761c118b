"""Whole-batch image metrics: RMSE, MAE, PSNR, SAM, SSIM, and the error and
uncertainty statistics (port of img_metrics_batch in
uncrtaints_tpu/metrics/image.py; values per sample, as the reference's
per-item metrics give them).
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from uncrtaints_tpu_torch.ops.ssim import ssim


def img_metrics_batch(target: torch.Tensor, pred: torch.Tensor,
                      var: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """target, pred (and var) [B,1,H,W,C] -> {metric: [B]} on their device.
    The spectral angle reduces over the channel axis, in degrees."""
    dims = tuple(range(1, target.dim()))
    err = target - pred
    rmse = err.square().mean(dim=dims).sqrt()
    dot = (target * pred).sum(dim=-1)
    denom = target.square().sum(dim=-1).sqrt() * pred.square().sum(dim=-1).sqrt()
    sam = (torch.arccos(torch.clamp(dot / denom, -1.0, 1.0)) * 180.0 / math.pi
           ).mean(dim=dims[:-1])
    B = target.shape[0]
    out = {
        "RMSE": rmse,
        "MAE": err.abs().mean(dim=dims),
        "PSNR": 20.0 * torch.log10(1.0 / rmse),
        "SAM": sam,
        "SSIM": ssim(target.reshape(-1, *target.shape[-3:]),
                     pred.reshape(-1, *pred.shape[-3:]),
                     size_average=False).reshape(B, -1).mean(dim=1),
    }
    if var is not None:
        out.update({
            "error": err.reshape(B, -1).nanmean(dim=1),
            "mean ae": err.abs().reshape(B, -1).nanmean(dim=1),
            "mean se": err.square().reshape(B, -1).nanmean(dim=1),
            "mean var": var.reshape(B, -1).nanmean(dim=1),
        })
    return out
