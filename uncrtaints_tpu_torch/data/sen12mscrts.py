"""SEN12MS-CR-TS: multi-temporal cloudy/cloud-free Sentinel time series
(port of uncrtaints_tpu/data/sen12mscrts.py).

The reference's data/dataLoader.py:144-529, with the same public surface
and sample structure. Four acquisition modes, as in the reference:

  a) custom_samples: user-specified patch lists with spatial mosaicing
  b.i) import_data_path with precomputed date indices
  b.ii) import_data_path with precomputed coverage stats + online sampling
  c) fully online: read all 30 frames, mask everything, sample

- GeoTIFF decode stays on the host: rasterio when installed, else the
  port's own codec (data/tiff.py).
- The cloud masks of all frames one ``get_imgs`` call reads run as one call
  on ``device`` ("cuda" by default; data/masks.py), each frame with its own
  blank guard. The sample's arrays come back as numpy.
- Returned arrays are CHW float32 per frame, exactly as the reference's,
  so the collates take real and synthetic samples alike.
"""

from __future__ import annotations

import copy
import glob
import os
import re
import warnings
from datetime import datetime
from typing import Dict, Iterable, List, Optional

import numpy as np

from uncrtaints_tpu_torch.data.masks import get_cloud_map, resolve_device
from uncrtaints_tpu_torch.data.preprocess import process_MS, process_SAR
from uncrtaints_tpu_torch.data.rois import ROI_TS, splits_ts
from uncrtaints_tpu_torch.data.samplers import (
    fixed_sampler, fixedsubset_sampler, random_sampler)

S1_LAUNCH = datetime.strptime("2014-04-03", "%Y-%m-%d")

try:
    import rasterio
    from rasterio.merge import merge as rasterio_merge
except ImportError:  # a machine without GDAL: the port's codec reads the tiles
    rasterio = None
    rasterio_merge = None


def natsorted(seq):
    """Natural sort (the reference uses the natsort package)."""
    def key(s):
        return [int(t) if t.isdigit() else t.lower()
                for t in re.split(r"(\d+)", str(s))]
    return sorted(seq, key=key)


def read_tif_img(path: str) -> np.ndarray:
    """GeoTIFF -> float32 [bands, H, W] (dataLoader.py:24-28 semantics):
    rasterio when installed, else the port's codec (data/tiff.py)."""
    if rasterio is None:
        from uncrtaints_tpu_torch.data.tiff import read_tiff
        return read_tiff(path).astype(np.float32)
    with rasterio.open(path) as tif:
        return tif.read().astype(np.float32)


def read_tif_bounds(path: str) -> List[float]:
    if rasterio is None:
        from uncrtaints_tpu_torch.data.tiff import read_tiff_bounds
        return read_tiff_bounds(path)
    with rasterio.open(path) as tif:
        return list(tif.bounds)


def date_from_patch_path(path: str) -> datetime:
    """Acquisition date is the 6th '_'-separated token of the file name
    (dataLoader.py:375-376)."""
    return datetime.strptime(os.path.basename(path).split("_")[5], "%Y-%m-%d")


def days_since_launch(date: datetime) -> int:
    return (date - S1_LAUNCH).days


def cloud_maps(frames: List[np.ndarray], detector: Optional[str], device) -> Optional[List[np.ndarray]]:
    """The masks of same-sized raw CHW S2 frames, in one call."""
    if not detector:
        return None
    return list(get_cloud_map(np.moveaxis(np.stack(frames), 1, -1), detector, device=device))


class SEN12MSCRTS:
    def __init__(self, root: str, split: str = "all", region: str = "all",
                 cloud_masks: str = "s2cloudless_mask",
                 sample_type: str = "cloudy_cloudfree", sampler: str = "fixed",
                 n_input_samples: int = 3, rescale_method: str = "default",
                 min_cov: float = 0.0, max_cov: float = 1.0,
                 import_data_path: Optional[str] = None,
                 custom_samples=None, seed: int = 1, device="cuda",
                 time_points: Iterable[int] = range(30), raw_s2: bool = False):
        """``time_points``: the time-point folders of every patch (the
        archives' 30; a smaller tree names its own). ``raw_s2``: the
        cloudy_cloudfree samples carry S2 as the tree's uint16 DN, marked
        with ``rescale_method``, for the raw or the single-pass collate
        (data/pipeline.py), as ``HDF5SEN12MSCRTS(raw_s2=True)`` does."""
        assert split in ("all", "train", "val", "test"), \
            "split must be all|train|val|test"
        assert sample_type in ("generic", "cloudy_cloudfree"), \
            "sample_type must be generic|cloudy_cloudfree"
        assert cloud_masks in (None, "cloud_cloudshadow_mask",
                               "s2cloudless_map", "s2cloudless_mask"), \
            "unknown cloud mask type"

        self.device = resolve_device(device)
        self.root_dir = root
        self.region = region
        self.split = split
        self.splits = splits_ts(region)
        self.modalities = ("S1", "S2")
        self.time_points = time_points
        self.cloud_masks = cloud_masks
        self.sample_type = sample_type if cloud_masks is not None else "generic"
        self.sampling = sampler
        self.n_input_t = n_input_samples
        if raw_s2 and (self.sample_type != "cloudy_cloudfree"
                       or isinstance(custom_samples, list)):
            raise ValueError("raw_s2 serves the cloudy_cloudfree samples of a tree "
                             "(masks on, no custom samples)")
        self.raw_s2 = raw_s2
        self.vary_samples = (self.sampling == "random"
                             and self.sample_type == "cloudy_cloudfree")
        self.method = rescale_method
        self.min_cov, self.max_cov = min_cov, max_cov
        self.epoch_count = 0
        # 'random' sampling is a pure function of (seed, epoch_count) so
        # vary_samples epochs reproduce across resumed runs
        self.seed = seed

        if self.vary_samples and split in ("val", "test"):
            warnings.warn(f"Loading {split} split, but sampled time points "
                          "will differ each epoch!")

        self.import_data_path = import_data_path
        self.data_pairs = None
        if self.import_data_path:
            path = self.import_data_path
            if os.path.isdir(path):
                path = os.path.join(
                    path, f"generic_{self.n_input_t}_{self.split}_"
                          f"{self.region}_{self.cloud_masks}.npy")
            self.data_pairs = np.load(path, allow_pickle=True).item()
            self.n_data_pairs = len(self.data_pairs)

        self.custom_samples = custom_samples
        if isinstance(self.custom_samples, list):
            self.paths = self.custom_samples
            self.import_data_path = None
            self.data_pairs = None
        else:
            self.paths = self.get_paths()
        self.n_samples = len(self.paths)
        if not self.n_samples:
            self.throw_warn()

    # ------------------------------------------------------------------ #

    def throw_warn(self):
        warnings.warn(
            "No data samples found! Expected layout: "
            "<root>/<ROIsXXXX>/<roi>/<S1|S2>/<0..29>/*.tif "
            "(merge the downloaded archives' subdirectories so each ROI "
            "holds S1/ and S2/ time-point folders).")

    def get_paths(self) -> List[Dict]:
        """Index all patches of the split: per patch, 30 S1 + 30 S2 paths."""
        paths = []
        for roi_dir, rois in ROI_TS.items():
            for roi in rois:
                roi_path = os.path.join(self.root_dir, roi_dir, roi)
                if (not os.path.isdir(roi_path)
                        or f"{roi_dir}/{roi}" not in self.splits[self.split]):
                    continue
                s1_t, s2_t = [], []
                for tdx in self.time_points:
                    rel1 = os.path.join(roi_dir, roi, "S1", str(tdx))
                    rel2 = os.path.join(roi_dir, roi, "S2", str(tdx))
                    d1 = os.path.join(self.root_dir, rel1)
                    d2 = os.path.join(self.root_dir, rel2)
                    f1 = natsorted(os.path.join(rel1, f) for f in os.listdir(d1)
                                   if f.endswith(".tif"))
                    f2 = natsorted(os.path.join(rel2, f) for f in os.listdir(d2)
                                   if f.endswith(".tif"))
                    assert len(f1) == len(f2), "unpaired S1/S2 patches"
                    s1_t.append(f1)
                    s2_t.append(f2)
                for pdx in range(len(s1_t[0])):
                    paths.append({
                        "S1": [s1_t[t][pdx] for t in self.time_points],
                        "S2": [s2_t[t][pdx] for t in self.time_points]})
        return paths

    # ------------------------------------------------------------------ #

    def get_imgs(self, pdx: int, tdx=None):
        """Load images + masks + meta for patch pdx at time indices tdx."""
        if tdx is None:
            tdx = list(self.time_points)
        tdx = list(tdx)
        s1_paths = [self.paths[pdx]["S1"][t] for t in tdx]
        s2_paths = [self.paths[pdx]["S2"][t] for t in tdx]
        s1 = [process_SAR(read_tif_img(os.path.join(self.root_dir, p)),
                          self.method) for p in s1_paths]
        s2_raw = [read_tif_img(os.path.join(self.root_dir, p))
                  for p in s2_paths]  # masks run pre-rescale
        coord = [read_tif_bounds(os.path.join(self.root_dir, p))
                 for p in s2_paths]
        masks = cloud_maps(s2_raw, self.cloud_masks, self.device)
        coverage = [float(np.mean(m)) for m in masks] if masks else []
        s1_td = [days_since_launch(date_from_patch_path(p)) for p in s1_paths]
        s2_td = [days_since_launch(date_from_patch_path(p)) for p in s2_paths]
        return s1, s2_raw, masks, coverage, coord, s1_td, s2_td

    def _sample_indices(self, coverage, pdx: int):
        if self.sampling == "random":
            # a fresh generator keyed on (seed, epoch, item): the same draw
            # whichever loader thread calls __getitem__, and in whatever order
            rng = np.random.default_rng((self.seed, self.epoch_count, pdx))
            return random_sampler(coverage, self.n_input_t, rng)
        if self.sampling == "fixedsubset":
            return fixedsubset_sampler(coverage, self.n_input_t,
                                       earliest_idx=0, latest_idx=30,
                                       min_cov=self.min_cov,
                                       max_cov=self.max_cov)
        return fixed_sampler(coverage, self.n_input_t,
                             min_cov=self.min_cov, max_cov=self.max_cov)

    def mosaic_patches(self, paths_nested):
        """Merge spatial patch lists into mosaics (dataLoader.py:383-393):
        rasterio.merge when GDAL is installed, else the port's bounds-based
        merge (method='first', data/tiff.py)."""
        if rasterio_merge is None:
            from uncrtaints_tpu_torch.data.tiff import merge_arrays
            out = []
            for tp in paths_nested:
                full = [os.path.join(self.root_dir, sp) for sp in tp]
                out.append(merge_arrays(
                    [read_tif_img(p) for p in full],
                    [read_tif_bounds(p) for p in full]).astype(np.float32))
            return out
        out = []
        for tp in paths_nested:
            srcs = [rasterio.open(os.path.join(self.root_dir, sp)) for sp in tp]
            mosaic, _ = rasterio_merge(srcs)
            for s in srcs:
                s.close()
            out.append(mosaic.astype(np.float32))
        return out

    def _s2(self, img: np.ndarray) -> np.ndarray:
        """An S2 frame as a cloudy_cloudfree sample carries it: processed,
        or with ``raw_s2`` the tree's uint16 DN."""
        return img.astype(np.uint16) if self.raw_s2 else process_MS(img, self.method)

    def getsample(self, pdx: int) -> Dict:
        return self[pdx]

    def __len__(self):
        return self.n_samples

    def incr_epoch_count(self):
        self.set_epoch_count(self.epoch_count + 1)

    def set_epoch_count(self, epoch_count: int):
        """Jump to an epoch (resume path): the sampler rng state depends only
        on (seed, epoch_count), never on how many epochs actually ran here."""
        self.epoch_count = epoch_count

    # ------------------------------------------------------------------ #

    def _getitem_custom(self, pdx):
        from uncrtaints_tpu_torch.data.sen12mscr import iterdict
        entry = self.custom_samples[pdx]

        # parse the acquisition dates before mosaicing, and hand iterdict a
        # deep copy: iterdict rewrites the nested dict's leaves in place, so
        # a shallow copy would replace the caller's path lists on first access
        in_s1_td = [days_since_launch(
            datetime.strptime(t[0].split("/")[-1].split("_")[-3], "%Y-%m-%d"))
            for t in entry["input"]["S1"]]
        in_s2_td = [days_since_launch(
            datetime.strptime(t[0].split("/")[-1].split("_")[-3], "%Y-%m-%d"))
            for t in entry["input"]["S2"]]
        custom = iterdict(copy.deepcopy(entry), self.mosaic_patches)

        input_s1 = [process_SAR(img, self.method) for img in custom["input"]["S1"]]
        input_s2_raw = custom["input"]["S2"]
        input_masks = cloud_maps(input_s2_raw, self.cloud_masks, self.device) or []
        input_s2 = [process_MS(img, self.method) for img in input_s2_raw]

        # the reference feeds the 1-element target list through the numpy
        # ufuncs directly (dataLoader.py:419-420); stacked explicitly here
        target_s1 = process_SAR(np.asarray(custom["target"]["S1"]),
                                self.method)[0]
        target_s2 = [process_MS(np.asarray(custom["target"]["S2"]),
                                self.method)[0]]
        # the reference's target masks are those of the input rasters
        # (dataLoader.py:421): the same maps, not computed twice
        target_mask = list(input_masks)

        return {
            "input": {"S1": list(input_s1), "S2": input_s2,
                      "masks": list(input_masks),
                      "coverage": [float(np.mean(m)) for m in input_masks],
                      "S1 TD": in_s1_td, "S2 TD": in_s2_td,
                      "S1 path": [], "S2 path": [], "idx": [],
                      "coord": []},
            "target": {"S1": [target_s1], "S2": target_s2,
                       "masks": [target_mask], "coverage": [],
                       "S1 TD": [], "S2 TD": [],
                       "S1 path": [], "S2 path": [], "idx": [],
                       "coord": []},
            "coverage bin": True,
        }

    def __getitem__(self, pdx: int) -> Dict:
        if self.sample_type == "generic":
            if self.custom_samples:
                raise NotImplementedError
            s1, s2_raw, masks, coverage, coord, s1_td, s2_td = self.get_imgs(pdx)
            return {
                "S1": s1,
                "S2": [process_MS(img, self.method) for img in s2_raw],
                "masks": masks, "coverage": coverage,
                "S1 TD": s1_td, "S2 TD": s2_td,
                "S1 path": [os.path.join(self.root_dir, self.paths[pdx]["S1"][t])
                            for t in self.time_points],
                "S2 path": [os.path.join(self.root_dir, self.paths[pdx]["S2"][t])
                            for t in self.time_points],
                "coord": coord,
            }

        if self.custom_samples:
            return self._getitem_custom(pdx)

        if self.data_pairs is not None:
            # epoch-wrapped index into the imported pairings (dataLoader.py:425)
            adj_pdx = (self.epoch_count * len(self) + pdx) % self.n_data_pairs
            pair = self.data_pairs[adj_pdx]
            if "input" in pair and "target" in pair:
                inputs_idx, cloudless_idx = list(pair["input"]), int(pair["target"])
                coverage_match = True
            else:
                coverage = [float(c) for c in pair["coverage"]]
                inputs_idx, cloudless_idx, coverage_match = \
                    self._sample_indices(coverage, pdx)
            # inputs and target in one read (one mask call), then split
            n = len(inputs_idx)
            s1, s2_raw, masks, _, coord, s1_td, s2_td = \
                self.get_imgs(pdx, inputs_idx + [cloudless_idx])
            input_s1, target_s1 = s1[:n], s1[n]
            input_masks, target_mask = masks[:n], masks[n]
            input_s2 = [self._s2(img) for img in s2_raw[:n]]
            target_s2 = [self._s2(s2_raw[n])]
            in_s1_td, in_s2_td, in_coord = s1_td[:n], s2_td[:n], coord[:n]
            tg_s1_td, tg_s2_td, tg_coord = s1_td[n:], s2_td[n:], coord[n:]
        else:
            # fully online (dataLoader.py:458-463)
            s1, s2_raw, masks, coverage, coord, s1_td, s2_td = self.get_imgs(pdx)
            inputs_idx, cloudless_idx, coverage_match = \
                self._sample_indices(coverage, pdx)
            input_s1 = [s1[i] for i in inputs_idx]
            input_masks = [masks[i] for i in inputs_idx]
            target_s1, target_mask = s1[cloudless_idx], masks[cloudless_idx]
            input_s2 = [self._s2(s2_raw[i]) for i in inputs_idx]
            target_s2 = [self._s2(s2_raw[cloudless_idx])]
            in_s1_td = [s1_td[i] for i in inputs_idx]
            in_s2_td = [s2_td[i] for i in inputs_idx]
            tg_s1_td, tg_s2_td = [s1_td[cloudless_idx]], [s2_td[cloudless_idx]]
            in_coord = [coord[i] for i in inputs_idx]
            tg_coord = [coord[cloudless_idx]]

        root = self.root_dir
        marker = {"rescale_method": self.method} if self.raw_s2 else {}
        return {
            **marker,
            "input": {
                "S1": list(input_s1), "S2": input_s2,
                "masks": list(input_masks),
                "coverage": [float(np.mean(m)) for m in input_masks],
                "S1 TD": in_s1_td, "S2 TD": in_s2_td,
                "S1 path": [os.path.join(root, self.paths[pdx]["S1"][i])
                            for i in inputs_idx],
                "S2 path": [os.path.join(root, self.paths[pdx]["S2"][i])
                            for i in inputs_idx],
                "idx": inputs_idx, "coord": in_coord,
            },
            "target": {
                "S1": [target_s1], "S2": target_s2, "masks": [target_mask],
                "coverage": [float(np.mean(target_mask))],
                "S1 TD": tg_s1_td, "S2 TD": tg_s2_td,
                "S1 path": [os.path.join(root, self.paths[pdx]["S1"][cloudless_idx])],
                "S2 path": [os.path.join(root, self.paths[pdx]["S2"][cloudless_idx])],
                "idx": cloudless_idx, "coord": tg_coord,
            },
            "coverage bin": coverage_match,
        }


def get_pairedS1(patch_list, root_dir, mod=None, time=None):
    """Fetch paired patches differing in modality/date (dataLoader.py:110-120)."""
    paired = []
    for patch in patch_list:
        seed, roi, modality, time_number, fname = patch.split("/")
        t = time_number if time is None else time
        m = modality if mod is None else mod
        n_patch = fname.split("patch_")[-1].split(".tif")[0]
        paired_dir = "/".join([seed, roi, m.upper(), str(t)])
        cand = os.path.join(root_dir, paired_dir,
                            f"{m}_{seed}_{roi}_ImgNo_{t}_*_patch_{n_patch}.tif")
        paired.append("/".join([paired_dir, os.path.basename(glob.glob(cand)[0])]))
    return paired
