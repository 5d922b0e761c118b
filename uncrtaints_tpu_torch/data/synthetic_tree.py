"""Write a SEN12MS-CR-TS file tree of synthetic GeoTIFFs.

The real archives are about 600 GB; the tests and the card's smoke run
write their own tree with the port's TIFF writer instead, in the dataset's
layout, names and sample types:

    <root>/<ROIsXXXX>/<roi>/<S1|S2>/<t>/<s1|s2>_<ROIsXXXX>_<roi>_ImgNo_<t>_<date>_patch_<p>.tif

S2 frames are uint16 13-band DN, S1 frames float32 2-band dB, with GeoTIFF
bounds that lay the patches of a ROI out on a grid of 16 columns (patch p at
row p // 16, column p % 16), so the 3x3 custom sample of ``cli.test
--use_custom`` (patches 171-173, 187-189, 203-205) mosaics to one square.
The content is a pure function of (seed, ROI, modality, time point, patch):
a vegetation-like ground with 1% noise, and on about three frames in four,
one to three bright cloud blobs with a dark shadow patch beside each, so the
masks, the coverage and the samplers have real work to do.

    from uncrtaints_tpu_torch.data.synthetic_tree import write_sen12mscrts_tree
    write_sen12mscrts_tree("/tmp/tree", {"ROIs1868/114": range(2)}, hw=64)
"""

from __future__ import annotations

import os
import zlib
from concurrent.futures import ThreadPoolExecutor
from datetime import datetime, timedelta
from typing import Dict, Iterable, Mapping, Optional

import numpy as np

from uncrtaints_tpu_torch.data.tiff import write_tiff

# vegetation-like reflectance of B01..B12 (B10 the cirrus band), in DN
GROUND = np.array([600, 500, 700, 500, 1000, 2000, 2500, 3000, 3000, 1000, 100, 2000, 1000],
                  np.float32)
GRID_COLUMNS = 16
PIXEL_M = 10.0


def default_date(t: int) -> str:
    return (datetime(2018, 1, 1) + timedelta(days=5 * t)).strftime("%Y-%m-%d")


def patch_name(mod: str, roi: str, t: int, date: str, p: int) -> str:
    roi_dir, roi_id = roi.split("/")
    return f"{mod.lower()}_{roi_dir}_{roi_id}_ImgNo_{t}_{date}_patch_{p}.tif"


def patch_bounds(p: int, hw: int):
    left = 500000.0 + (p % GRID_COLUMNS) * hw * PIXEL_M
    top = 4100000.0 - (p // GRID_COLUMNS) * hw * PIXEL_M
    return [left, top - hw * PIXEL_M, left + hw * PIXEL_M, top]


def _rng(*key) -> np.random.Generator:
    return np.random.default_rng(zlib.crc32("/".join(map(str, key)).encode()))


def s2_frame(seed: int, roi: str, t: int, p: int, hw: int) -> np.ndarray:
    """uint16 [13, hw, hw] DN."""
    rng = _rng(seed, roi, "S2", t, p)
    img = GROUND[:, None, None] * (1.0 + 0.01 * rng.standard_normal((13, hw, hw), np.float32))
    yy, xx = np.ogrid[:hw, :hw]
    for _ in range(int(rng.integers(0, 4))):
        cy, cx = rng.integers(0, hw, 2)
        r = int(rng.integers(max(1, hw // 10), max(2, hw // 4)))
        blob = (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r
        img[:, blob] = 5000.0 + 4000.0 * rng.random((13, 1), np.float32)
        y0, x0 = min(hw - 1, cy + r), min(hw - 1, cx + r)
        img[:, y0:y0 + r, x0:x0 + r] *= 0.15  # the blob's shadow
    return img.astype(np.uint16)


def s1_frame(seed: int, roi: str, t: int, p: int, hw: int) -> np.ndarray:
    """float32 [2, hw, hw] dB."""
    return (-25.0 + 25.0 * _rng(seed, roi, "S1", t, p).random((2, hw, hw), np.float32))


def write_sen12mscrts_tree(root: str, patches: Mapping[str, Iterable[int]], hw: int = 256,
                           time_points: Iterable[int] = range(30),
                           dates: Optional[Dict[int, str]] = None,
                           deflate: Iterable[str] = (), seed: int = 0,
                           workers: int = 8) -> int:
    """Write every (ROI, modality, time point, patch) file; ``patches`` maps
    "ROIsXXXX/<roi>" to its patch numbers, ROIs named in ``deflate`` are
    written deflate-compressed (the integer S2 with the horizontal
    predictor). Returns the bytes written."""
    deflate = set(deflate)
    jobs = []
    for roi, ids in patches.items():
        for t in time_points:
            date = (dates or {}).get(t) or default_date(t)
            for mod in ("S1", "S2"):
                d = os.path.join(root, roi, mod, str(t))
                os.makedirs(d, exist_ok=True)
                jobs += [(roi, mod, t, p, os.path.join(d, patch_name(mod, roi, t, date, p)))
                         for p in ids]

    def write(job):
        roi, mod, t, p, path = job
        arr = (s2_frame if mod == "S2" else s1_frame)(seed, roi, t, p, hw)
        packed = roi in deflate
        write_tiff(path, arr, compression="deflate" if packed else "none",
                   predictor=2 if packed and mod == "S2" else 1, bounds=patch_bounds(p, hw))
        return os.path.getsize(path)

    with ThreadPoolExecutor(max_workers=max(1, workers)) as pool:
        return sum(pool.map(write, jobs))
