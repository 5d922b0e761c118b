"""Time-point samplers: choose input frames + cloud-free target from a
coverage vector.

The port's own copy of uncrtaints_tpu/data/samplers.py (the tests hold the
two equal): pure functions, as the reference's data/dataLoader.py:308-360:

- fixed: target = least-cloudy frame (argsort ties -> earliest); inputs =
  first n frames with coverage in [min_cov, max_cov], falling back to the
  first n non-target frames; coverage_match flags fallback or a target
  above clear_tresh
- fixedsubset: fixed over a [earliest, latest) window, shifted back, with
  full-series fallback (NOTE: the reference's implementation at
  dataLoader.py:326,330 passes `self` as the coverage argument -- a latent
  bug unreachable from the CLI; we implement the documented intent)
- random: uniform-random clear target (coverage < clear_tresh, else global
  argmin); inputs = the centered sliding window of width n+1 around it
  (dataLoader.py:333-344)
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def fixed_sampler(coverage: Sequence[float], n_input_t: int,
                  min_cov: float = 0.0, max_cov: float = 1.0,
                  clear_tresh: float = 1e-3) -> Tuple[List[int], int, bool]:
    coverage = list(coverage)
    cloudless_idx = int(np.argsort(coverage)[0])
    inputs_idx = [i for i, c in enumerate(coverage)
                  if min_cov <= c <= max_cov][:n_input_t]
    if len(inputs_idx) < n_input_t:
        inputs_idx = [i for i in range(len(coverage))
                      if i != cloudless_idx][:n_input_t]
        coverage_match = False
    else:
        coverage_match = True
    if coverage[cloudless_idx] > clear_tresh:
        coverage_match = False
    return inputs_idx, cloudless_idx, coverage_match


def fixedsubset_sampler(coverage: Sequence[float], n_input_t: int,
                        earliest_idx: int = 0, latest_idx: int = 30,
                        min_cov: float = 0.0, max_cov: float = 1.0,
                        clear_tresh: float = 1e-3) -> Tuple[List[int], int, bool]:
    sub = list(coverage)[earliest_idx:latest_idx]
    inputs_idx, cloudless_idx, match = fixed_sampler(
        sub, n_input_t, min_cov, max_cov, clear_tresh)
    inputs_idx = [i + earliest_idx for i in inputs_idx]
    cloudless_idx += earliest_idx
    if not match:
        inputs_idx, cloudless_idx, match = fixed_sampler(
            coverage, n_input_t, min_cov, max_cov, clear_tresh)
    return inputs_idx, cloudless_idx, match


def sliding_windows(n_time_points: int, width: int) -> np.ndarray:
    """All contiguous index windows of the given width (dataLoader.py:214)."""
    base = np.arange(n_time_points)
    return np.lib.stride_tricks.sliding_window_view(base, window_shape=width)


def random_sampler(coverage: Sequence[float], n_input_t: int,
                   rng: np.random.Generator,
                   clear_tresh: float = 1e-3) -> Tuple[List[int], int, bool]:
    coverage = np.asarray(coverage)
    is_clear = np.argwhere(coverage < clear_tresh).flatten()
    if len(is_clear) > 0:
        cloudless_idx = int(is_clear[rng.integers(0, len(is_clear))])
    else:
        cloudless_idx = int(coverage.argmin())
    windows = sliding_windows(len(coverage), n_input_t + 1)
    containing = [w for w in windows if cloudless_idx in w]
    chosen = containing[len(containing) // 2]
    inputs_idx = [int(t) for t in chosen if t != cloudless_idx]
    return inputs_idx, cloudless_idx, True
