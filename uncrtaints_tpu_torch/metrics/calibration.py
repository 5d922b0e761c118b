"""Uncertainty calibration metrics: ECE discard curves and UCE/AUCE.

The port's own copy of uncrtaints_tpu/metrics/calibration.py (numpy only;
the tests hold the two equal on seeded inputs):

- compute_ece: rank per-sample squared errors by ascending uncertainty and
  report cumulative means at 5% bins (the discard curve).
- compute_uce_auce: bin variances into 100//percent bins between min and max,
  per-bin |RMV - RMSE| (l2) or |MSD - MAE| (l1); UCE weights bins by their
  occupancy, AUCE is the unweighted mean over non-empty bins.

These run on small per-split vectors at the end of an epoch.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def binarize(arg, n_bins, floor=0.0, ceil=1.0):
    """np.digitize over a linspace grid."""
    return np.digitize(arg, bins=np.linspace(floor, ceil, num=n_bins)[1:])


def compute_ece(variances: Sequence[float], errors: Sequence[float],
                n_samples: int, percent: int = 5) -> np.ndarray:
    """Uncertainty-sorted cumulative mean errors at `percent`%% bins."""
    variances = np.asarray(variances, dtype=np.float64)
    errors = np.asarray(errors, dtype=np.float64)
    order = np.argsort(variances, kind="stable")
    errs_sort = errors[order]
    bins = np.linspace(0, n_samples, 100 // percent + 1).astype(int)[1:]
    sorted_errors = np.array([
        np.nanmean(errs_sort[:r]) if r > 0 else np.nan for r in bins])
    return sorted_errors


def compute_uce_auce(variances: Sequence[float], errors: Sequence[float],
                     n_samples: int, percent: int = 5,
                     l2: bool = True) -> Tuple[float, float, dict]:
    """Returns (UCE, AUCE, per-bin detail dict for plotting)."""
    n_bins = 100 // percent
    var = np.asarray(variances, dtype=np.float64)
    err = np.asarray(errors, dtype=np.float64)

    metric = (lambda a: np.sqrt(np.mean(a ** 2))) if l2 else \
        (lambda a: np.mean(np.abs(a)))

    var_idx = binarize(var, n_bins, floor=var.min(), ceil=var.max())

    bk_var = np.full(n_bins, np.nan)
    bk_err = np.full(n_bins, np.nan)
    for b in range(n_bins):
        sel = var_idx == b
        if sel.any():
            bk_var[b] = metric(np.sqrt(var[sel]))
            bk_err[b] = metric(err[sel])

    calib_err = np.abs(bk_err - bk_var)
    counts = np.histogram(var_idx, bins=n_bins,
                          range=(var_idx.min(), var_idx.max()))[0]
    bk_weight = counts / n_samples
    uce = float(np.nansum(bk_weight * calib_err))
    auce = float(np.nanmean(calib_err))
    detail = {"bk_var": bk_var, "bk_err": bk_err, "calib_err": calib_err,
              "weights": bk_weight}
    return uce, auce, detail
