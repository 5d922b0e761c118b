"""Reconstruction losses: l1, l2, GNLL and the closed-form diagonal MGNLL.

Port of uncrtaints_tpu/losses/losses.py. For a diagonal covariance the
multivariate Gaussian NLL per pixel is

    k/2*log(2*pi) + 1/2*sum_c log(var_c) + 1/2*sum_c err_c^2/var_c

The reference's quirks are kept: iso mode broadcasts its one variance over
the 13 bands; the Mahalanobis term is nan_to_num'ed and clamped to 1e-9;
only the first 13 variance channels are clamped to eps. The clamps act as
torch's in-place clamp under no_grad: gradients flow as if they were not
there.

Layout: mean, target and var are [B,1,H,W,C]. The NLL losses return
(scalar loss, clamped variance).
"""

from __future__ import annotations

import math
from typing import Callable

import torch

S2_BANDS = 13


def l1_loss(pred, target):
    return (pred - target).abs().mean()


def l2_loss(pred, target):
    return (pred - target).square().mean()


def _clamp_nograd(var: torch.Tensor, eps: float) -> torch.Tensor:
    return var + (torch.clamp(var, min=eps) - var).detach()


def _reduce(loss, var, reduction: str):
    if reduction == "mean":
        return loss.mean(), var
    if reduction == "sum":
        return loss.sum(), var
    return loss, var


def gaussian_nll_loss(pred, target, var, full: bool = True, eps: float = 1e-8,
                      reduction: str = "mean"):
    """Univariate heteroscedastic Gaussian NLL."""
    var = _clamp_nograd(var, eps)
    loss = 0.5 * (torch.log(var) + (pred - target).square() / var)
    if full:
        loss = loss + 0.5 * math.log(2 * math.pi)
    return _reduce(loss, var, reduction)


def multi_gaussian_nll_loss(pred, target, var, full: bool = True,
                            eps: float = 1e-8, reduction: str = "mean",
                            mode: str = "diag", chunk=None):
    """Diagonal or isotropic multivariate Gaussian NLL over the spectral
    axis (one k=13 Gaussian per pixel). ``chunk`` is accepted for flag
    parity; the closed form needs no chunking."""
    del chunk
    if mode == "iso":
        var = var.expand(*var.shape[:-1], S2_BANDS)
    k = pred.shape[-1]
    if var.shape[-1] > S2_BANDS:
        var = torch.cat([_clamp_nograd(var[..., :S2_BANDS], eps),
                         var[..., S2_BANDS:]], dim=-1)
    else:
        var = _clamp_nograd(var, eps)
    logdet = torch.log(var).sum(dim=-1)
    maha = ((pred - target).square() / var).sum(dim=-1)
    maha = torch.clamp(torch.nan_to_num(maha), min=1e-9)
    loss = 0.5 * k * math.log(2 * math.pi) + 0.5 * logdet + 0.5 * maha
    return _reduce(loss, var, reduction)


def get_loss(config) -> Callable:
    """criterion(pred, target, var=None) -> (loss, variance or None)."""
    if config.loss == "GNLL":
        return lambda pred, targ, var: gaussian_nll_loss(
            pred, targ, var, full=True, eps=1e-8, reduction="mean")
    if config.loss == "MGNLL":
        return lambda pred, targ, var: multi_gaussian_nll_loss(
            pred, targ, var, full=True, eps=1e-8, reduction="mean",
            mode=config.covmode, chunk=config.chunk_size)
    if config.loss == "l1":
        return lambda pred, targ, var=None: (l1_loss(pred, targ), None)
    if config.loss == "l2":
        return lambda pred, targ, var=None: (l2_loss(pred, targ), None)
    raise NotImplementedError(config.loss)


def calc_loss(criterion, config, out, y, var=None):
    if config.loss in ("GNLL", "MGNLL"):
        return criterion(out, y, var)
    return criterion(out, y)
