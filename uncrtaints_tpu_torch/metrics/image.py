"""Image metrics: RMSE, MAE, PSNR, SAM, SSIM, and the error and uncertainty
statistics (port of uncrtaints_tpu/metrics/image.py): ``img_metrics`` for one
sample with its pixelwise vectors, ``img_metrics_batch`` for a whole batch on
its device (values per sample, as the per-item metrics give them) and the
NaN-skipping running mean ``AvgImgMetrics``.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch

from uncrtaints_tpu_torch.ops.ssim import ssim
from uncrtaints_tpu_torch.parallel import mesh


def img_metrics(target: torch.Tensor, pred: torch.Tensor,
                var: Optional[torch.Tensor] = None,
                pixelwise: bool = True) -> Dict:
    """Metric dict of one sample. target, pred (and var): [1, H, W, C] (T=1
    collapsed). Scalars are Python floats; with ``var`` and ``pixelwise``
    the per-pixel error statistics, averaged over the leading axis and the
    channels, come as flat numpy vectors [H*W]."""
    error = target - pred
    rmse = torch.sqrt(torch.mean(torch.square(error)))
    dot = torch.sum(target * pred, dim=-1)
    denom = torch.sqrt(torch.sum(target * target, dim=-1)) * \
        torch.sqrt(torch.sum(pred * pred, dim=-1))
    sam = torch.mean(torch.arccos(torch.clamp(dot / denom, -1.0, 1.0)) * 180.0 / math.pi)
    out = {
        "RMSE": float(rmse), "MAE": float(torch.mean(torch.abs(error))),
        "PSNR": float(20.0 * torch.log10(1.0 / rmse)),
        "SAM": float(sam), "SSIM": float(ssim(target, pred)),
    }
    if var is not None:
        se, ae = torch.square(error), torch.abs(error)
        out.update({
            "error": float(error.nanmean()), "mean ae": float(ae.nanmean()),
            "mean se": float(se.nanmean()), "mean var": float(var.nanmean()),
        })
        if pixelwise:
            flat = lambda t: t.nanmean(dim=(0, -1)).reshape(-1).cpu().numpy()
            out.update({
                "pixelwise error": flat(error), "pixelwise ae": flat(ae),
                "pixelwise se": flat(se), "pixelwise var": flat(var),
            })
    return out


def _band_mean(t: torch.Tensor, dims, sp) -> torch.Tensor:
    """The mean over ``dims`` of the scene whose band t is: the band's sums
    summed over the spatial group, over the scene's count."""
    n = sp.n_spatial
    for d in dims:
        n *= t.shape[d]
    return mesh.spatial_sum(t.sum(dim=dims), sp) / n


def _band_nanmean(t: torch.Tensor, sp) -> torch.Tensor:
    """t [B, ...] -> the scene's nanmean per sample (sums and counts of the
    non-NaN elements summed over the spatial group)."""
    flat = t.reshape(t.shape[0], -1)
    tot = mesh.spatial_sum(torch.stack([flat.nansum(dim=1),
                                        (~flat.isnan()).sum(dim=1).to(flat.dtype)]), sp)
    return tot[0] / tot[1]


def img_metrics_batch(target: torch.Tensor, pred: torch.Tensor,
                      var: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """target, pred (and var) [B,1,H,W,C] -> {metric: [B]} on their device.
    The spectral angle reduces over the channel axis, in degrees. Under a
    spatial split the arrays are bands of the scenes (axis 2) and every
    metric is the scene's, the same on each rank of a spatial group."""
    sp = mesh.spatial()
    if sp is not None:
        return _img_metrics_bands(target, pred, var, sp)
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


def _img_metrics_bands(target, pred, var, sp) -> Dict[str, torch.Tensor]:
    """:func:`img_metrics_batch` of the scenes whose bands the arrays are."""
    dims = tuple(range(1, target.dim()))
    err = target - pred
    rmse = _band_mean(err.square(), dims, sp).sqrt()
    dot = (target * pred).sum(dim=-1)
    denom = target.square().sum(dim=-1).sqrt() * pred.square().sum(dim=-1).sqrt()
    sam = _band_mean(torch.arccos(torch.clamp(dot / denom, -1.0, 1.0)) * 180.0 / math.pi,
                     dims[:-1], sp)
    B = target.shape[0]
    out = {
        "RMSE": rmse,
        "MAE": _band_mean(err.abs(), dims, sp),
        "PSNR": 20.0 * torch.log10(1.0 / rmse),
        "SAM": sam,
        "SSIM": ssim(target.reshape(-1, *target.shape[-3:]),
                     pred.reshape(-1, *pred.shape[-3:]),
                     size_average=False).reshape(B, -1).mean(dim=1),
    }
    if var is not None:
        out.update({
            "error": _band_nanmean(err, sp),
            "mean ae": _band_nanmean(err.abs(), sp),
            "mean se": _band_nanmean(err.square(), sp),
            "mean var": _band_nanmean(var, sp),
        })
    return out


class AvgImgMetrics:
    """NaN-skipping running mean of scalar metrics."""

    def __init__(self):
        self.metrics = ["RMSE", "MAE", "PSNR", "SAM", "SSIM",
                        "error", "mean se", "mean ae", "mean var"]
        self.reset()

    def reset(self):
        self.running = {m: float("nan") for m in self.metrics}
        self.counts = {m: 0 for m in self.metrics}
        self.extras = {}

    def add(self, d: Dict):
        for k, v in d.items():
            if k not in self.metrics:
                continue
            if isinstance(v, (np.ndarray, torch.Tensor)) and v.ndim > 0:
                continue
            v = float(v)
            if np.isnan(v):
                continue
            c = self.counts[k]
            if c == 0:
                self.running[k] = v
            else:
                self.running[k] = c / (c + 1) * self.running[k] + v / (c + 1)
            self.counts[k] = c + 1

    def value(self) -> Dict:
        return {**self.running, **self.extras}

    def __setitem__(self, key, val):
        # values set after the epoch (UCE SE, AUCE SE) ride along in value()
        self.extras[key] = val
