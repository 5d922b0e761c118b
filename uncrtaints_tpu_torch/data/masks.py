"""Cloud and shadow detection on the card (port of uncrtaints_tpu/data/masks.py).

The threshold detector of the reference (its util/detect_cloudshadow.py:17-93)
and the mask dispatch (its data/dataLoader.py:61-106) run as torch ops over
batched [..., H, W, 13] band stacks on the device the caller names, so the
frames of one sample are masked in one call:

- cloud score: min over rescaled brightness tests of bands
  B01/B02/B04/B03/B10/B11, minus the NDSI snow test, grey_closing(5, 5),
  7x7 box filter, clip to [1e-5, 1], threshold binarize
- shadow: CSI = (B08 + B11) / 2 against adaptive thresholds on CSI and the
  blue band (per frame), 5x5 median filter
- merged mask: shadows -> -1, clouds -> +1, binarized to {0, 1}
- s2cloudless modes (the reference's default): the optional `s2cloudless`
  package if installed, else the port's LightGBM reader and detector
  (data/s2cloudless.py, on the host; its probability map is blurred on the
  device). Without weights the dispatch raises: a silent fallback to the
  threshold detector would change coverage, sampled frames and metrics.

Input convention: ``img`` is the raw (unrescaled) S2 stack, bands last,
in [0, 10000]. ``get_cloud_map`` takes and returns numpy, so a sample dict
has the JAX package's structure; it runs on ``device`` ("cuda" by default,
raising without a card, never moving to the CPU).

The datasets call ``get_cloud_map`` from the loader's worker threads while
the step runs on the default stream. Each call therefore runs on a stream of
its own (from a pool, one per concurrent caller) and waits on that stream
only, when its mask comes back to the host.
"""

from __future__ import annotations

import contextlib
import threading
import warnings

import numpy as np
import torch

from uncrtaints_tpu_torch.ops.filters import (
    box_filter2d, gaussian_filter2d, grey_closing, median_filter2d)

S2CLOUDLESS_MODES = ("s2cloudless_map", "s2cloudless_mask")


def resolve_device(device) -> torch.device:
    """The device a mask runs on; a CUDA device without a card raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={device!r}: no CUDA device is available (pass device='cpu' to "
            "mask on the CPU)")
    return dev


def _rescale(data, lo, hi):
    return (data - lo) / (hi - lo)


def _normalized_difference(c1, c2):
    s = c1 + c2
    s = torch.where(s == 0, 0.001, s)
    return (c1 - c2) / s


def get_cloud_mask(img: torch.Tensor, cloud_threshold: float = 0.2,
                   binarize: bool = False, use_moist_check: bool = False) -> torch.Tensor:
    """Hand-crafted cloud score (detect_cloudshadow.py:43-78).
    img: [..., H, W, 13] raw S2. Returns the [..., H, W] score or binary mask."""
    d = img / 10000.0
    b = lambda i: d[..., i]

    score = torch.ones(d.shape[:-1], dtype=d.dtype, device=d.device)
    # clouds are reasonably bright in blue and aerosol/cirrus bands
    score = torch.minimum(score, _rescale(b(1), 0.1, 0.5))
    score = torch.minimum(score, _rescale(b(0), 0.1, 0.3))
    score = torch.minimum(score, _rescale(b(0) + b(10), 0.4, 0.9))
    score = torch.minimum(score, _rescale(b(3) + b(2) + b(1), 0.2, 0.8))
    if use_moist_check:
        ndmi = _normalized_difference(b(7), b(11))
        score = torch.minimum(score, _rescale(ndmi, -0.1, 0.1))
    # ... but clouds are not snow
    ndsi = _normalized_difference(b(2), b(11))
    score = torch.minimum(score, _rescale(ndsi, 0.8, 0.6))

    score = grey_closing(score, 5)
    score = box_filter2d(score, 7)
    score = torch.clamp(score, 0.00001, 1.0)
    if binarize:
        score = (score >= cloud_threshold).to(score.dtype)
    return score


def get_shadow_mask(img: torch.Tensor) -> torch.Tensor:
    """Cloud-shadow index thresholding (detect_cloudshadow.py:17-40).
    Returns [..., H, W] in {-1, 0}."""
    d = img / 10000.0
    bb, bnir, bswir1 = d[..., 1], d[..., 7], d[..., 11]
    csi = (bnir + bswir1) / 2.0

    # adaptive thresholds over the spatial dims only (per frame)
    lo = lambda a: torch.amin(a, dim=(-2, -1), keepdim=True)
    mean = lambda a: torch.mean(a, dim=(-2, -1), keepdim=True)
    t3 = lo(csi) + 0.75 * (mean(csi) - lo(csi))
    t4 = lo(bb) + (5.0 / 6.0) * (mean(bb) - lo(bb))

    shadow = torch.where((csi < t3) & (bb < t4), -1.0, 0.0)
    return median_filter2d(shadow, 5)


def get_cloud_cloudshadow_mask(img: torch.Tensor, cloud_threshold: float = 0.2) -> torch.Tensor:
    """Merged binary cloud+shadow mask (dataLoader.py:61-72): shadows and
    clouds both labelled 1."""
    cloud = get_cloud_mask(img, cloud_threshold, binarize=True)
    shadow = get_shadow_mask(img)
    merged = torch.zeros_like(cloud)
    merged = torch.where(shadow < 0, -1.0, merged)
    merged = torch.where(cloud > 0, 1.0, merged)
    return (merged != 0).float()


_S2C_CACHE = {"detector": None, "tried": False}


def _try_s2cloudless():
    if _S2C_CACHE["tried"]:
        return _S2C_CACHE["detector"]
    _S2C_CACHE["tried"] = True
    _S2C_CACHE["detector"] = _build_s2cloudless()
    return _S2C_CACHE["detector"]


def _build_s2cloudless():
    try:
        from s2cloudless import S2PixelCloudDetector  # optional dependency
        return S2PixelCloudDetector(threshold=0.4, all_bands=True,
                                    average_over=4, dilation_size=2)
    except ImportError:
        # the port's LightGBM inference (data/s2cloudless.py); needs the
        # standard weights file on disk ($S2CLOUDLESS_MODEL_PATH or the cache)
        from uncrtaints_tpu_torch.data.s2cloudless import make_detector
        return make_detector()


_STREAMS: dict = {}
_STREAMS_LOCK = threading.Lock()


@contextlib.contextmanager
def _own_stream(dev: torch.device):
    """Run the block on a CUDA stream that no other thread uses meanwhile
    (a no-op on the CPU). The streams are pooled per device, so the
    allocator's per-stream caches stay as few as the concurrent callers."""
    if dev.type != "cuda":
        yield
        return
    key = dev.index if dev.index is not None else torch.cuda.current_device()
    with _STREAMS_LOCK:
        free = _STREAMS.setdefault(key, [])
        stream = free.pop() if free else torch.cuda.Stream(device=key)
    try:
        with torch.cuda.stream(stream):
            yield
    finally:
        with _STREAMS_LOCK:
            free.append(stream)


def _blank_warning():
    warnings.warn("Encountered a blank sample, defaulting to cloudy mask.")


def _threshold_map(img: np.ndarray, dev: torch.device) -> np.ndarray:
    """The merged threshold mask of every frame in one call on ``dev``, with
    the blank-image guard per frame."""
    lead, hw = img.shape[:-3], img.shape[-3:-1]
    # upload contiguous bytes: a bands-last view of a bands-first stack (as
    # the datasets hand over) goes up as it lies and is viewed back on the card
    first = np.moveaxis(img, -1, -3)
    bands_first = first.flags.c_contiguous
    with _own_stream(dev):
        x = torch.from_numpy(first if bands_first else np.ascontiguousarray(img)).to(dev)
        x = torch.clamp(x.float(), 0, 10000).reshape(-1, *x.shape[-3:])
        flat = x.reshape(len(x), -1)
        blank = (flat.mean(1) < 1e-5) & (flat.std(1, correction=0) < 1e-5)
        m = get_cloud_cloudshadow_mask(x.movedim(1, -1) if bands_first else x)
        m = torch.where(blank[:, None, None], 1.0, m)
        # one copy back (the mask and the blank flags), one wait on this stream
        host = torch.cat([m.reshape(-1), blank.float()]).cpu().numpy()
    n = m.numel()
    if host[n:].any():
        _blank_warning()
    return host[:n].reshape(*lead, *hw)


def _s2cloudless_map(img: np.ndarray, detector: str, instance, dev: torch.device) -> np.ndarray:
    """The s2cloudless modes: the detector on the host, the probability
    map's blur on ``dev``; the blank guard per frame."""
    lead, hw = img.shape[:-3], img.shape[-3:-1]
    frames = np.clip(img, 0, 10000).reshape(-1, *img.shape[-3:])
    blank = np.array([f.mean() < 1e-5 and f.std() < 1e-5 for f in frames])
    if blank.any():
        _blank_warning()
    if blank.all():
        return np.ones((*lead, *hw), np.float32)
    inst = instance if instance is not None else _try_s2cloudless()
    if inst is None:
        # no silent fallback: s2cloudless is the reference's default
        # detector, and the threshold detector in its place changes coverage
        # -> sampled frames -> metrics; it must be an explicit choice
        raise RuntimeError(
            "cloud_masks='%s' needs the s2cloudless LightGBM weights, which were not "
            "found. Fetch the standard model file with `python -m "
            "uncrtaints_tpu_torch.cli.download --s2cloudless-weights --run` (or set "
            "$S2CLOUDLESS_MODEL_PATH to a copy of "
            "pixel_s2_cloud_detector_lightGBM_v0.1.txt). To use the threshold "
            "detector instead, pass --cloud_masks cloud_cloudshadow_mask explicitly."
            % detector)
    x = frames / 10000.0
    if detector == "s2cloudless_map":
        m = inst.get_cloud_probability_maps(x)
        m[m < 0.5] = 0
        with _own_stream(dev):
            t = torch.from_numpy(np.ascontiguousarray(m, np.float32)).to(dev)
            m = gaussian_filter2d(t, sigma=2.0).cpu().numpy()
    else:
        m = inst.get_cloud_masks(x)
    m = m.astype(np.float32)
    m[blank] = 1.0
    return m.reshape(*lead, *hw)


def get_cloud_map(img: np.ndarray, detector: str = "cloud_cloudshadow_mask",
                  instance=None, device="cuda") -> np.ndarray:
    """Mask dispatch with the blank-image guard (dataLoader.py:84-106).

    img: [..., H, W, 13] raw S2 (bands last), one frame or a stack, each
    frame guarded on its own. Returns the float32 [..., H, W] mask."""
    dev = resolve_device(device)
    img = np.asarray(img)
    if detector in S2CLOUDLESS_MODES:
        return _s2cloudless_map(img, detector, instance, dev)
    if detector == "cloud_cloudshadow_mask":
        return _threshold_map(img, dev)
    warnings.warn(f"Method {detector} not yet implemented!")
    return np.ones(img.shape[:-3] + img.shape[-3:-1], np.float32)
