"""Gaussian-window SSIM on NHWC images.

Port of uncrtaints_tpu/ops/ssim.py: an 11x11 gaussian window (sigma 1.5)
applied per channel with zero 'same' padding, C1 = 0.01^2, C2 = 0.03^2. The
window is an outer product, so the blur runs separably (a [k,1] pass, then
a [1,k] pass), with the same 1-D factor as the JAX package. Under a spatial
split (parallel/mesh.py) the images are bands of the scenes: the blur takes
the neighbours' rows and the means are the scenes'.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from uncrtaints_tpu_torch.parallel import mesh


def _depthwise_blur(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Separable zero-padded 'same' depthwise correlation of x [B,H,W,C].
    Under a spatial split x is a band of the scene: the column pass reads
    ``k // 2`` rows of each neighbour and zero-pads only at the scene's
    edge (a band needs at least that many rows)."""
    C, k = x.shape[-1], g.shape[0]
    r = k // 2
    sp = mesh.spatial()
    if sp is not None:
        top, bot = mesh.halo_exchange(x, r, 1, sp)
        zeros = lambda: x.new_zeros((x.shape[0], r, *x.shape[2:]))
        x = torch.cat([zeros() if top is None else top, x, zeros() if bot is None else bot], 1)
    xc = x.permute(0, 3, 1, 2)
    kcol = g.view(1, 1, k, 1).expand(C, 1, k, 1)
    krow = g.view(1, 1, 1, k).expand(C, 1, 1, k)
    y = F.conv2d(xc, kcol, padding=(0 if sp is not None else r, 0), groups=C)
    y = F.conv2d(y, krow, padding=(0, k // 2), groups=C)
    return y.permute(0, 2, 3, 1)


def _gaussian_1d(size: int, device, sigma: float = 1.5) -> torch.Tensor:
    """The normalized 1-D gaussian whose outer product is the window, made
    on ``device`` in fp64 and rounded once (a copy of a host array would
    make the host wait for the device in every call)."""
    r = torch.arange(size, device=device, dtype=torch.float64) - size // 2
    g = torch.exp(-(r * r) / (2.0 * sigma ** 2))
    return (g / g.sum()).float()


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
         size_average: bool = True) -> torch.Tensor:
    """SSIM between two NHWC image batches in [0, 1]; a scalar, or one value
    per image when ``size_average`` is False."""
    g = _gaussian_1d(window_size, img1.device)
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
    sp = mesh.spatial()
    if sp is not None:  # the scene's mean: the bands' sums over the spatial group
        if size_average:
            return mesh.spatial_sum(ssim_map.sum(), sp) / (ssim_map.numel() * sp.n_spatial)
        return mesh.spatial_sum(ssim_map.sum(dim=(1, 2, 3)), sp) / (
            ssim_map[0].numel() * sp.n_spatial)
    if size_average:
        return ssim_map.mean()
    return ssim_map.mean(dim=(1, 2, 3))
