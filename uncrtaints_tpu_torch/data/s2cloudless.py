"""s2cloudless cloud detector, self-contained.

The port's own copy of uncrtaints_tpu/data/s2cloudless.py (numpy, on the
host; the tests hold the two equal). The reference's default cloud mask for
both datasets is `s2cloudless_mask` (its data/dataLoader.py:145, 549),
computed by the `s2cloudless`
package's `S2PixelCloudDetector(threshold=0.4, all_bands=True, average_over=4,
dilation_size=2)` (dataLoader.py:216-218) -- a LightGBM pixel classifier over
10 Sentinel-2 bands plus disk-filter post-processing. This module
re-implements that stack without `s2cloudless` or `lightgbm`:

- :class:`LightGBMModel`: parser + vectorized numpy inference for LightGBM's
  text model format (the standard `pixel_s2_cloud_detector_lightGBM_v0.1.txt`
  shipped with s2cloudless releases parses directly).
- :class:`S2CloudlessDetector`: band selection, per-pixel probability,
  disk-average smoothing, thresholding and disk dilation matching
  s2cloudless's `get_cloud_probability_maps` / `get_cloud_masks`.

The trained tree weights are not in the repository; point
`S2CLOUDLESS_MODEL_PATH` (or the `model_path` argument) at the standard model
file, or fetch it into the port's cache with `python -m
uncrtaints_tpu_torch.cli.download --s2cloudless-weights --run`. Tree
inference and post-processing are tested against hand-built models and
scipy in tests/test_torch_s2cloudless.py.
"""

from __future__ import annotations

import os
import warnings
from typing import List, Optional, Sequence

import numpy as np

try:  # scipy is optional: only the post-processing needs it
    from scipy import ndimage as _ndi
except ImportError:  # pragma: no cover
    _ndi = None

# Band order of a full 13-band L1C stack, and the 10 bands the s2cloudless
# model consumes (its `MODEL_BAND_IDS`): B01,B02,B04,B05,B08,B8A,B09,B10,B11,B12
MODEL_BAND_IDS = (0, 1, 3, 4, 7, 8, 9, 10, 11, 12)

_MODEL_PATH_ENV = "S2CLOUDLESS_MODEL_PATH"
_MODEL_FILENAME = "pixel_s2_cloud_detector_lightGBM_v0.1.txt"


class _Tree:
    """One decision tree in LightGBM's array encoding.

    Child index >= 0 -> internal node; child < 0 -> leaf ``-child - 1``.
    decision_type bit 2 (value 2) marks a default-left split (NaN goes left).
    """

    __slots__ = ("split_feature", "threshold", "left", "right",
                 "leaf_value", "default_left")

    def __init__(self, fields: dict):
        self.split_feature = np.asarray(fields.get("split_feature", []), np.int32)
        self.threshold = np.asarray(fields.get("threshold", []), np.float64)
        self.left = np.asarray(fields.get("left_child", []), np.int32)
        self.right = np.asarray(fields.get("right_child", []), np.int32)
        self.leaf_value = np.asarray(fields.get("leaf_value", [0.0]), np.float64)
        dt = np.asarray(fields.get("decision_type",
                                   [0] * len(self.split_feature)), np.int32)
        self.default_left = (dt & 2) != 0

    def predict(self, x: np.ndarray) -> np.ndarray:
        """Vectorized walk: x [P, F] -> leaf values [P]."""
        P = x.shape[0]
        if self.split_feature.size == 0:  # single-leaf (constant) tree
            return np.full(P, self.leaf_value[0])
        cur = np.zeros(P, np.int32)          # node index; negatives = leaves
        active = np.ones(P, bool)
        # a binary tree with L leaves has depth < L; bound the walk
        for _ in range(len(self.leaf_value)):
            if not active.any():
                break
            idx = cur[active]
            feat = self.split_feature[idx]
            val = x[active, feat]
            thr = self.threshold[idx]
            nan = np.isnan(val)
            go_left = (val <= thr) | (nan & self.default_left[idx])
            nxt = np.where(go_left, self.left[idx], self.right[idx])
            cur[active] = nxt
            active = cur >= 0
        leaf = -cur - 1
        return self.leaf_value[leaf]


class LightGBMModel:
    """Minimal LightGBM model-file reader + ensemble inference.

    Supports the subset the s2cloudless classifier uses: numerical splits,
    binary objective (sigmoid link), no categorical features.
    """

    def __init__(self, trees: List[_Tree], objective: str = "binary",
                 sigmoid: float = 1.0, max_feature_idx: int = 0):
        self.trees = trees
        self.objective = objective
        self.sigmoid = sigmoid
        self.num_features = max_feature_idx + 1

    # ----------------------------------------------------------------- #

    @classmethod
    def from_text(cls, text: str) -> "LightGBMModel":
        objective, sigmoid, max_feat = "binary", 1.0, 0
        trees: List[_Tree] = []
        fields: Optional[dict] = None

        def flush():
            if fields is not None and "leaf_value" in fields:
                trees.append(_Tree(fields))

        for raw in text.splitlines():
            line = raw.strip()
            if line.startswith("Tree="):
                flush()
                fields = {}
                continue
            if "=" not in line:
                if line == "end of trees":
                    flush()
                    fields = None
                continue
            key, _, val = line.partition("=")
            if fields is None:  # header section
                if key == "objective":
                    # e.g. "binary sigmoid:1"
                    parts = val.split()
                    objective = parts[0]
                    for p in parts[1:]:
                        if p.startswith("sigmoid:"):
                            sigmoid = float(p.split(":", 1)[1])
                elif key == "max_feature_idx":
                    max_feat = int(val)
                continue
            if key in ("split_feature", "left_child", "right_child",
                       "decision_type"):
                fields[key] = [int(v) for v in val.split()] if val else []
            elif key in ("threshold", "leaf_value"):
                fields[key] = [float(v) for v in val.split()] if val else []
        flush()
        if not trees:
            raise ValueError("no trees found in LightGBM model text")
        return cls(trees, objective, sigmoid, max_feat)

    @classmethod
    def from_file(cls, path: str) -> "LightGBMModel":
        with open(path) as f:
            return cls.from_text(f.read())

    # ----------------------------------------------------------------- #

    def raw_score(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, np.float64)
        out = np.zeros(x.shape[0])
        for t in self.trees:
            out += t.predict(x)
        return out

    def predict_proba(self, x: np.ndarray) -> np.ndarray:
        """P(class 1) per row of x [P, F]."""
        s = self.raw_score(x)
        if self.objective.startswith("binary"):
            return 1.0 / (1.0 + np.exp(-self.sigmoid * s))
        return s


# --------------------------------------------------------------------- #
# post-processing (s2cloudless get_mask_from_prob semantics)
# --------------------------------------------------------------------- #

def disk(radius: int) -> np.ndarray:
    """skimage.morphology.disk parity: x^2 + y^2 <= r^2 footprint."""
    y, x = np.ogrid[-radius:radius + 1, -radius:radius + 1]
    return (x * x + y * y <= radius * radius).astype(np.uint8)


def average_disk(prob: np.ndarray, radius: int) -> np.ndarray:
    """Normalized disk-mean smoothing (scipy convolve, reflect boundary)."""
    if _ndi is None:
        raise ImportError("scipy is required for s2cloudless post-processing")
    k = disk(radius).astype(np.float64)
    return _ndi.convolve(prob.astype(np.float64), k / k.sum(), mode="reflect")


def dilate_disk(mask: np.ndarray, radius: int) -> np.ndarray:
    """Binary dilation with a disk footprint (skimage dilation parity)."""
    if _ndi is None:
        raise ImportError("scipy is required for s2cloudless post-processing")
    return _ndi.binary_dilation(mask.astype(bool), structure=disk(radius))


class S2CloudlessDetector:
    """Drop-in S2PixelCloudDetector for the modes the reference uses.

    Input arrays are [N, H, W, 13] reflectances in [0, 1] (DN/10000) with
    `all_bands=True` band order; the model consumes MODEL_BAND_IDS.
    """

    def __init__(self, threshold: float = 0.4, all_bands: bool = True,
                 average_over: int = 4, dilation_size: int = 2,
                 model_path: Optional[str] = None,
                 model: Optional[LightGBMModel] = None):
        self.threshold = threshold
        self.all_bands = all_bands
        self.average_over = average_over
        self.dilation_size = dilation_size
        if model is None:
            model = LightGBMModel.from_file(find_model_file(model_path))
        self.model = model

    def _features(self, data: np.ndarray) -> np.ndarray:
        if self.all_bands:
            data = data[..., list(MODEL_BAND_IDS)]
        return data

    def get_cloud_probability_maps(self, data: np.ndarray) -> np.ndarray:
        data = np.asarray(data, np.float64)
        n, h, w, _ = data.shape
        feats = self._features(data).reshape(n * h * w, -1)
        return self.model.predict_proba(feats).reshape(n, h, w)

    def get_mask_from_prob(self, probs: np.ndarray,
                           threshold: Optional[float] = None) -> np.ndarray:
        thr = self.threshold if threshold is None else threshold
        if self.average_over:
            masks = np.asarray([average_disk(p, self.average_over) > thr
                                for p in probs], np.int8)
        else:
            masks = (probs > thr).astype(np.int8)
        if self.dilation_size:
            masks = np.asarray([dilate_disk(m, self.dilation_size)
                                for m in masks], np.int8)
        return masks

    def get_cloud_masks(self, data: np.ndarray) -> np.ndarray:
        return self.get_mask_from_prob(self.get_cloud_probability_maps(data))


def find_model_file(model_path: Optional[str] = None) -> str:
    """Locate the standard s2cloudless LightGBM model file.

    Search order: explicit argument -> $S2CLOUDLESS_MODEL_PATH -> the
    cli.download weights cache -> the installed s2cloudless package's
    models/ dir -> CWD."""
    candidates = []
    if model_path:
        candidates.append(model_path)
    env = os.environ.get(_MODEL_PATH_ENV)
    if env:
        candidates.append(env)
    from uncrtaints_tpu_torch.cli.download import s2cloudless_cache_dir
    candidates.append(os.path.join(s2cloudless_cache_dir(), _MODEL_FILENAME))
    try:
        import s2cloudless as _pkg  # reuse the official weights if present
        candidates.append(os.path.join(os.path.dirname(_pkg.__file__),
                                       "models", _MODEL_FILENAME))
    except ImportError:
        pass
    candidates.append(os.path.join(os.getcwd(), _MODEL_FILENAME))
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    raise FileNotFoundError(
        f"s2cloudless model weights not found; fetch with `python -m "
        f"uncrtaints_tpu_torch.cli.download --s2cloudless-weights --run` or set "
        f"${_MODEL_PATH_ENV} to a copy of {_MODEL_FILENAME} (ships with "
        f"s2cloudless releases)")


def make_detector(model_path: Optional[str] = None) -> Optional[S2CloudlessDetector]:
    """Reference-configured detector (dataLoader.py:216-218), or None when
    no weights are reachable."""
    try:
        return S2CloudlessDetector(threshold=0.4, all_bands=True,
                                   average_over=4, dilation_size=2,
                                   model_path=model_path)
    except (FileNotFoundError, ImportError, ValueError) as e:
        warnings.warn(f"s2cloudless detector unavailable: {e}")
        return None
