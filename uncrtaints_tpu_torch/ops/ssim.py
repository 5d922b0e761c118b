"""Gaussian-window SSIM on NHWC images.

Port of uncrtaints_tpu/ops/ssim.py: an 11x11 gaussian window (sigma 1.5)
applied per channel with zero 'same' padding, C1 = 0.01^2, C2 = 0.03^2. The
window is an outer product, so the blur runs separably (a [k,1] pass, then
a [1,k] pass), with the same 1-D factor as the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _gaussian_window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    g = np.exp(-((np.arange(size) - size // 2) ** 2) / (2.0 * sigma ** 2))
    g = g / g.sum()
    return np.outer(g, g).astype(np.float32)


def _depthwise_blur(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Separable zero-padded 'same' depthwise correlation of x [B,H,W,C]."""
    C, k = x.shape[-1], g.shape[0]
    xc = x.permute(0, 3, 1, 2)
    kcol = g.view(1, 1, k, 1).expand(C, 1, k, 1)
    krow = g.view(1, 1, 1, k).expand(C, 1, 1, k)
    y = F.conv2d(xc, kcol, padding=(k // 2, 0), groups=C)
    y = F.conv2d(y, krow, padding=(0, k // 2), groups=C)
    return y.permute(0, 2, 3, 1)


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
         size_average: bool = True) -> torch.Tensor:
    """SSIM between two NHWC image batches in [0, 1]; a scalar, or one value
    per image when ``size_average`` is False."""
    window = _gaussian_window(window_size)
    c = window_size // 2
    g = torch.from_numpy(window[:, c] / np.sqrt(window[c, c])).to(img1.device)
    img1 = img1.to(torch.float32)
    img2 = img2.to(torch.float32)
    C = img1.shape[-1]
    # one blur pass over the five stacked moment images
    b = _depthwise_blur(torch.cat(
        [img1, img2, img1 * img1, img2 * img2, img1 * img2], dim=-1), g)
    mu1, mu2 = b[..., :C], b[..., C:2 * C]
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = b[..., 2 * C:3 * C] - mu1_sq
    sigma2_sq = b[..., 3 * C:4 * C] - mu2_sq
    sigma12 = b[..., 4 * C:] - mu1_mu2
    C1, C2 = 0.01 ** 2, 0.03 ** 2
    ssim_map = ((2 * mu1_mu2 + C1) * (2 * sigma12 + C2)) / (
        (mu1_sq + mu2_sq + C1) * (sigma1_sq + sigma2_sq + C2))
    if size_average:
        return ssim_map.mean()
    return ssim_map.mean(dim=(1, 2, 3))
