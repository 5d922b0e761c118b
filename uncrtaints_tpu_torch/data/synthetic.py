"""Synthetic SEN12MS-CR(-TS)-like data source.

The port's own copy of uncrtaints_tpu/data/synthetic.py (numpy only; the
tests hold the two bit-identical for the same seed). Samples have the
nested structure of the real datasets, drawn from a seeded generator:
smooth random fields for S2 reflectance, speckled fields for S1
backscatter, thresholded blobs for cloud masks. The tests and the GPU smoke
run use it, so the full dataset is not needed to exercise the port.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

S1_BANDS = 2
S2_BANDS = 13


def _smooth_field(rng: np.random.Generator, shape, smooth: int = 4):
    """Cheap smooth random field: low-res noise, bilinear-ish upsample."""
    H, W = shape[-2], shape[-1]
    low = rng.random((*shape[:-2], max(2, H // smooth), max(2, W // smooth)),
                     dtype=np.float32)
    reps_h = int(np.ceil(H / low.shape[-2]))
    reps_w = int(np.ceil(W / low.shape[-1]))
    up = np.repeat(np.repeat(low, reps_h, axis=-2), reps_w, axis=-1)
    return up[..., :H, :W]


class SyntheticSEN12MSCRTS:
    """Multi-temporal synthetic dataset (cloudy_cloudfree samples)."""

    def __init__(self, n_samples: int = 64, n_input_t: int = 3,
                 patch_size: int = 256, seed: int = 1,
                 sample_type: str = "cloudy_cloudfree"):
        self.n_samples = n_samples
        self.n_input_t = n_input_t
        self.patch_size = patch_size
        self.seed = seed
        self.sample_type = sample_type

    def __len__(self):
        return self.n_samples

    def __getitem__(self, pdx: int) -> Dict:
        rng = np.random.default_rng(self.seed * 1_000_003 + pdx)
        T, P = self.n_input_t, self.patch_size
        base_s2 = _smooth_field(rng, (S2_BANDS, P, P))  # static scene

        in_s1, in_s2, in_masks, in_td = [], [], [], []
        for t in range(T):
            cloud = (_smooth_field(rng, (P, P), smooth=8) > 0.6).astype(np.float32)
            s2 = np.clip(base_s2 * (1 - cloud) + cloud *
                         (0.8 + 0.2 * rng.random((P, P), dtype=np.float32)), 0, 1)
            s1 = np.clip(_smooth_field(rng, (S1_BANDS, P, P)) +
                         0.05 * rng.standard_normal((S1_BANDS, P, P)).astype(np.float32),
                         0, 1)
            in_s1.append(s1)
            in_s2.append(s2.astype(np.float32))
            in_masks.append(cloud)
            in_td.append(float(rng.integers(0, 1500)))

        sample = {
            "input": {
                "S1": in_s1,
                "S2": in_s2,
                "masks": in_masks,
                "coverage": [float(m.mean()) for m in in_masks],
                "S1 TD": in_td,
                "S2 TD": in_td,
                "S1 path": [], "S2 path": [], "idx": list(range(T)),
                "coord": [[0.0, 0.0, 1.0, 1.0]] * T,
            },
            "target": {
                "S1": [np.clip(_smooth_field(rng, (S1_BANDS, P, P)), 0, 1)],
                "S2": [base_s2.astype(np.float32)],
                "masks": [np.zeros((P, P), np.float32)],
                "coverage": [0.0],
                "S1 TD": [float(rng.integers(0, 1500))],
                "S2 TD": [float(rng.integers(0, 1500))],
                "S1 path": [], "S2 path": [], "idx": T,
                "coord": [[0.0, 0.0, 1.0, 1.0]],
            },
            "coverage bin": True,
        }
        return sample


class SyntheticSEN12MSCR:
    """Mono-temporal synthetic triplets (pretrain samples)."""

    def __init__(self, n_samples: int = 64, patch_size: int = 256, seed: int = 1):
        self.n_samples = n_samples
        self.patch_size = patch_size
        self.seed = seed

    def __len__(self):
        return self.n_samples

    def __getitem__(self, pdx: int) -> Dict:
        rng = np.random.default_rng(self.seed * 7_000_003 + pdx)
        P = self.patch_size
        s2 = _smooth_field(rng, (S2_BANDS, P, P)).astype(np.float32)
        cloud = (_smooth_field(rng, (P, P), smooth=8) > 0.55).astype(np.float32)
        s2_cloudy = np.clip(s2 * (1 - cloud) + cloud * 0.9, 0, 1).astype(np.float32)
        s1 = np.clip(_smooth_field(rng, (S1_BANDS, P, P)), 0, 1).astype(np.float32)
        return {
            "input": {"S1": s1, "S2": s2_cloudy, "masks": cloud,
                      "coverage": float(cloud.mean()),
                      "S1 path": "", "S2 path": "", "coord": [0, 0, 1, 1]},
            "target": {"S2": s2, "S2 path": "", "coord": [0, 0, 1, 1]},
        }
