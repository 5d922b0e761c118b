"""2-D filters of the cloud/shadow detector, as torch ops on the input's
device (port of uncrtaints_tpu/ops/filters.py).

The reference runs scipy's C kernels on the host (its
util/detect_cloudshadow.py:38, 69-70 and data/dataLoader.py:99); here they
are tensor ops, so the masks of a whole frame stack run on the card:

- median_filter2d: zero-padded k x k median (scipy.signal.medfilt2d)
- grey_closing:    max then min over k x k, symmetric padding
  (scipy.ndimage.grey_closing, whose 'reflect' repeats the edge sample)
- box_filter2d:    zero-padded 'same' box mean
  (scipy.signal.convolve2d(box, mode='same') for odd k)
- gaussian_filter2d: separable gaussian, symmetric padding
  (scipy.ndimage.gaussian_filter, truncate=4.0)

All work on the last two axes and keep leading batch axes. The sums run
tap by tap in the JAX version's order, so the results on the CPU equal its
to the bit or within a rounding step.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def _shifted_views(xp: torch.Tensor, k: int, H: int, W: int):
    """The k*k shifted H x W views of a padded map, row-major over the window."""
    return [xp[..., dy:dy + H, dx:dx + W] for dy in range(k) for dx in range(k)]


def _pad_symmetric(x: torch.Tensor, r: int, dim: int) -> torch.Tensor:
    """numpy's 'symmetric' pad of ``r`` on both sides of ``dim``: the map
    continues as its mirror image, the edge sample repeated."""
    n = x.shape[dim]
    if r <= n:
        return torch.cat([x.narrow(dim, 0, r).flip(dim), x,
                          x.narrow(dim, n - r, r).flip(dim)], dim)
    # wider than the map: the mirrored map repeats with period 2n
    m = -(-r // (2 * n))
    period = torch.cat([x, x.flip(dim)], dim)
    return torch.cat([period] * (2 * m + 1), dim).narrow(dim, 2 * n * m - r, n + 2 * r)


def _window_reduce(x: torch.Tensor, k: int, sign: float) -> torch.Tensor:
    """Max (sign 1) or min (sign -1) over k x k of the symmetric-padded map."""
    r = k // 2
    xp = _pad_symmetric(_pad_symmetric(x, r, -2), r, -1)
    lead, (H, W) = x.shape[:-2], x.shape[-2:]
    out = F.max_pool2d(sign * xp.reshape(-1, 1, H + 2 * r, W + 2 * r), k, stride=1)
    return sign * out.reshape(*lead, H, W)


def median_filter2d(x: torch.Tensor, k: int = 5) -> torch.Tensor:
    """k x k median filter, zero padding (scipy.signal.medfilt2d)."""
    r = k // 2
    H, W = x.shape[-2:]
    stack = torch.stack(_shifted_views(F.pad(x, (r, r, r, r)), k, H, W))
    # torch.median returns the lower of the two middle values; k*k is odd,
    # so there is one middle value and it is the median
    return torch.median(stack, dim=0).values


def grey_closing(x: torch.Tensor, k: int = 5) -> torch.Tensor:
    """Greyscale closing = erosion(dilation(x)) with a flat k x k structuring
    element, symmetric boundary (scipy.ndimage.grey_closing's default)."""
    return _window_reduce(_window_reduce(x, k, 1.0), k, -1.0)


def box_filter2d(x: torch.Tensor, k: int = 7) -> torch.Tensor:
    """'same' convolution with a normalised k x k box, zero padding."""
    r = k // 2
    H, W = x.shape[-2:]
    views = _shifted_views(F.pad(x.float(), (r, r, r, r)), k, H, W)
    summed = torch.zeros_like(views[0])
    for v in views:
        summed = summed + v
    return summed / float(k * k)


@functools.lru_cache(maxsize=None)
def _gaussian_taps(device: torch.device, sigma: float, truncate: float) -> torch.Tensor:
    """The sampled, normalised gaussian (scipy's), made in fp64, rounded once
    to fp32 and kept on the device: one host copy per device and sigma."""
    radius = int(truncate * sigma + 0.5)
    t = np.arange(-radius, radius + 1)
    taps = np.exp(-0.5 * (t / sigma) ** 2)
    return torch.tensor((taps / taps.sum()).astype(np.float32), device=device)


def gaussian_filter2d(x: torch.Tensor, sigma: float = 2.0, truncate: float = 4.0) -> torch.Tensor:
    """Separable gaussian blur, symmetric boundary
    (scipy.ndimage.gaussian_filter)."""
    taps = _gaussian_taps(x.device, float(sigma), float(truncate))
    radius = (taps.numel() - 1) // 2

    def along(arr, dim):
        ap = _pad_symmetric(arr, radius, dim)
        n = arr.shape[dim]
        out = torch.zeros_like(arr)
        for i in range(2 * radius + 1):
            out = out + taps[i] * ap.narrow(dim, i, n)
        return out

    return along(along(x.float(), -2), -1)
