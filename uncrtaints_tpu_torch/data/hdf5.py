"""HDF5 dataset source and converter (port of uncrtaints_tpu/data/hdf5.py).

Replaces the reference's tif->HDF5 export (its
util/hdf5converter/sen12mscrts_to_hdf5.py:27-211): the converter walks a
generic-mode SEN12MSCRTS once, storing each patch's full 30-frame series,
day offsets and cloud masks/coverage; ``HDF5SEN12MSCRTS`` then serves
samples from sequential chunked reads instead of 60 small tif opens per
sample. h5py is optional; both raise without it.

Layout per patch group ``p{pdx}``:
  S1        [30, 2, H, W]  float32 (preprocessed SAR)
  S2        [30, 13, H, W] uint16  (raw reflectance; rescale at read time)
  masks     [30, H, W]     float32
  coverage  [30]           float32
  s1_td/s2_td [30]         int32
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from uncrtaints_tpu_torch.data.preprocess import process_MS
from uncrtaints_tpu_torch.data.samplers import (
    fixed_sampler, fixedsubset_sampler, random_sampler,
)

try:
    import h5py
except ImportError:  # optional: the HDF5 source and converter raise without it
    h5py = None


def convert_to_hdf5(dataset, out_path: str, max_patches: Optional[int] = None,
                    compression: Optional[str] = "lzf") -> str:
    """Export a generic-mode SEN12MSCRTS (or synthetic) dataset to HDF5."""
    if h5py is None:
        raise ImportError("h5py is required for HDF5 conversion")
    n = len(dataset) if max_patches is None else min(max_patches, len(dataset))
    with h5py.File(out_path, "w") as f:
        for pdx in range(n):
            s = dataset[pdx]
            g = f.create_group(f"p{pdx}")
            s1 = np.stack(s["S1"]).astype(np.float32)
            # store S2 raw as uint16 to halve disk/IO; reference stores raw too
            s2 = np.stack(s["S2"])
            if s2.max() <= 1.5:  # already rescaled -> bring back to DN
                s2 = s2 * 10000.0
            g.create_dataset("S1", data=s1, compression=compression)
            g.create_dataset("S2", data=np.clip(s2, 0, 65535).astype(np.uint16),
                             compression=compression)
            g.create_dataset("masks", data=np.stack(s["masks"]).astype(np.float32),
                             compression=compression)
            g.create_dataset("coverage",
                             data=np.asarray(s["coverage"], np.float32))
            g.create_dataset("s1_td", data=np.asarray(s["S1 TD"], np.int32))
            g.create_dataset("s2_td", data=np.asarray(s["S2 TD"], np.int32))
    return out_path


class HDF5SEN12MSCRTS:
    """cloudy_cloudfree sampling over a converted HDF5 store; sample dicts
    are interchangeable with SEN12MSCRTS's."""

    def __init__(self, path: str, n_input_samples: int = 3,
                 sampler: str = "fixed", min_cov: float = 0.0,
                 max_cov: float = 1.0, rescale_method: str = "default",
                 seed: int = 1, raw_s2: bool = False):
        if h5py is None:
            raise ImportError("h5py is required for the HDF5 data source")
        self.path = path
        self.n_input_t = n_input_samples
        self.sampling = sampler
        self.min_cov, self.max_cov = min_cov, max_cov
        self.method = rescale_method
        # raw_s2: skip host radiometry and return uint16 DN S2 frames for
        # the single-pass collate (data/pipeline.py make_fast_collate);
        # plain collate_multi cannot consume raw frames
        self.raw_s2 = raw_s2
        self.seed = seed
        self.epoch_count = 0
        self._file = None
        with h5py.File(path, "r") as f:
            self.keys = sorted(f.keys(), key=lambda k: int(k[1:]))

    def __len__(self):
        return len(self.keys)

    def incr_epoch_count(self):
        self.set_epoch_count(self.epoch_count + 1)

    def set_epoch_count(self, epoch_count: int):
        """Sampler rng is a pure function of (seed, epoch_count) so resumed
        runs reproduce the same 'random' sample choices per epoch."""
        self.epoch_count = epoch_count

    @property
    def file(self):
        if self._file is None:  # lazy per-process handle
            self._file = h5py.File(self.path, "r")
        return self._file

    def _sample_indices(self, coverage, pdx: int):
        if self.sampling == "random":
            # per-item generator keyed on (seed, epoch, item): the same draw
            # under concurrent loader threads (see sen12mscrts.py)
            rng = np.random.default_rng((self.seed, self.epoch_count, pdx))
            return random_sampler(coverage, self.n_input_t, rng)
        if self.sampling == "fixedsubset":
            return fixedsubset_sampler(coverage, self.n_input_t,
                                       min_cov=self.min_cov,
                                       max_cov=self.max_cov)
        return fixed_sampler(coverage, self.n_input_t,
                             min_cov=self.min_cov, max_cov=self.max_cov)

    def __getitem__(self, pdx: int) -> Dict:
        g = self.file[self.keys[pdx]]
        coverage = [float(c) for c in g["coverage"][:]]
        inputs_idx, cloudless_idx, match = self._sample_indices(coverage, pdx)
        sel = sorted(inputs_idx)

        s1 = g["S1"][sel].astype(np.float32)
        if self.raw_s2:
            s2 = g["S2"][sel]                      # uint16 DN, single-pass collate
            tg_s2 = g["S2"][cloudless_idx]
            # the collate applies the radiometry; it must be built with the
            # SAME method (make_fast_collate validates this marker)
            raw_method = self.method
        else:
            s2 = process_MS(g["S2"][sel].astype(np.float32), self.method)
            tg_s2 = process_MS(g["S2"][cloudless_idx].astype(np.float32),
                               self.method)
            raw_method = None
        masks = g["masks"][sel].astype(np.float32)
        tg_s1 = g["S1"][cloudless_idx].astype(np.float32)
        tg_mask = g["masks"][cloudless_idx].astype(np.float32)
        s1_td = g["s1_td"][:]
        s2_td = g["s2_td"][:]

        return {
            "input": {"S1": list(s1), "S2": list(s2), "masks": list(masks),
                      "coverage": [coverage[i] for i in sel],
                      "S1 TD": [int(s1_td[i]) for i in sel],
                      "S2 TD": [int(s2_td[i]) for i in sel],
                      "S1 path": [], "S2 path": [], "idx": sel, "coord": [],
                      **({"rescale_method": raw_method}
                         if raw_method is not None else {})},
            "target": {"S1": [tg_s1], "S2": [tg_s2], "masks": [tg_mask],
                       "coverage": [coverage[cloudless_idx]],
                       "S1 TD": [int(s1_td[cloudless_idx])],
                       "S2 TD": [int(s2_td[cloudless_idx])],
                       "S1 path": [], "S2 path": [],
                       "idx": cloudless_idx, "coord": []},
            "coverage bin": match,
        }
