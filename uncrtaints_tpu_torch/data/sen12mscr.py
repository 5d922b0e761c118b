"""SEN12MS-CR: mono-temporal (S1, S2 cloud-free, S2 cloudy) triplets
(port of uncrtaints_tpu/data/sen12mscr.py).

The reference's data/dataLoader.py:548-700: path indexing by s1 -> s2 /
s2_cloudy substitution, hard-coded ROI-string splits, pretrain sample dicts.
The cloud mask runs on ``device`` ("cuda" by default; data/masks.py).
"""

from __future__ import annotations

import os
import warnings
from typing import Dict, List

import numpy as np

from uncrtaints_tpu_torch.data.masks import get_cloud_map, resolve_device
from uncrtaints_tpu_torch.data.preprocess import process_MS, process_SAR
from uncrtaints_tpu_torch.data.rois import splits_cr
from uncrtaints_tpu_torch.data.sen12mscrts import natsorted, read_tif_bounds, read_tif_img


def iterdict(dictionary: Dict, fct):
    """Recursively apply fct to dict leaves (dataLoader.py:76-82)."""
    for k, v in dictionary.items():
        if isinstance(v, dict):
            dictionary[k] = iterdict(v, fct)
        else:
            dictionary[k] = fct(v)
    return dictionary


class SEN12MSCR:
    def __init__(self, root: str, split: str = "all", region: str = "all",
                 cloud_masks: str = "s2cloudless_mask",
                 sample_type: str = "pretrain",
                 rescale_method: str = "default", device="cuda"):
        assert split in ("all", "train", "val", "test")
        assert sample_type in ("pretrain",), "SEN12MSCR samples are pretrain"
        assert cloud_masks in (None, "cloud_cloudshadow_mask",
                               "s2cloudless_map", "s2cloudless_mask")
        if region != "all":
            raise NotImplementedError("SEN12MSCR only supports region='all'")

        self.device = resolve_device(device)
        self.root_dir = root
        self.region = region
        self.split = split
        self.splits = splits_cr()
        self.cloud_masks = cloud_masks
        self.sample_type = sample_type
        self.method = rescale_method
        self.n_input_t = 1

        self.paths = self.get_paths()
        self.n_samples = len(self.paths)
        if not self.n_samples:
            self.throw_warn()

    def throw_warn(self):
        warnings.warn(
            "No data samples found! Expected layout: "
            "<root>/ROIsXXXX_season_s1/s1_<n>/*.tif with sibling _s2 and "
            "_s2_cloudy directories (as produced by dl_data.sh).")

    def get_paths(self) -> List[Dict]:
        paths = []
        if not os.path.isdir(self.root_dir):
            return paths
        seeds_s1 = natsorted(d for d in os.listdir(self.root_dir) if "_s1" in d)
        for seed in seeds_s1:
            for roi in natsorted(os.listdir(os.path.join(self.root_dir, seed))):
                roi_dir = os.path.join(self.root_dir, seed, roi)
                s1 = natsorted(os.path.join(roi_dir, p)
                               for p in os.listdir(roi_dir))
                s2 = [p.replace("/s1", "/s2").replace("_s1", "_s2") for p in s1]
                s2c = [p.replace("/s1", "/s2_cloudy").replace("_s1", "_s2_cloudy")
                       for p in s1]
                for pdx in range(len(s1)):
                    if not all(map(os.path.isfile, (s1[pdx], s2[pdx], s2c[pdx]))):
                        continue
                    if not any(r in s1[pdx] for r in self.splits[self.split]):
                        continue
                    paths.append({"S1": s1[pdx], "S2": s2[pdx],
                                  "S2_cloudy": s2c[pdx]})
        return paths

    def __len__(self):
        return self.n_samples

    def __getitem__(self, pdx: int) -> Dict:
        p = self.paths[pdx]
        s1 = process_SAR(read_tif_img(p["S1"]), self.method)
        s2 = read_tif_img(p["S2"])
        s2_cloudy = read_tif_img(p["S2_cloudy"])
        coord = read_tif_bounds(p["S2"])
        mask = None if not self.cloud_masks else get_cloud_map(
            np.moveaxis(s2_cloudy, 0, -1), self.cloud_masks, device=self.device)

        return {
            "input": {"S1": s1,
                      "S2": process_MS(s2_cloudy, self.method),
                      "masks": mask,
                      "coverage": float(np.mean(mask)) if mask is not None else 0.0,
                      "S1 path": p["S1"], "S2 path": p["S2_cloudy"],
                      "coord": coord},
            "target": {"S2": process_MS(s2, self.method),
                       "S2 path": p["S2"], "coord": coord},
        }
