"""Whole-scene inference: cloud removal over scenes far larger than the
256x256 training crops.

Port of uncrtaints_tpu/infer.py. :func:`predict_scene` tiles a [T,H,W,C]
scene into overlapping ``tile x tile`` windows, runs the eval forward over
batches of windows, and blends the overlaps with a separable linear
crossfade whose weights sum to 1 everywhere in the scene, so there are no
visible seams and each pixel's prediction is dominated by the window that
sees it most centrally.

The forward is the eval step's (train/engine.py:eval_forward): the input is
multiplied by ``scale_by`` and cast to the compute dtype with the
parameters, the model runs in eval mode under ``torch.inference_mode()`` (on a CUDA device the
fused MBConv chain, kernels K1, K3 and K4), and the mean is divided by
``scale_by``, the variance by ``scale_by**2``.

Variance handling: the predicted aleatoric variances are blended with the
same weights as the means. This is the convex combination of the windows'
variances without the spread of their means, so a mild under-estimate
wherever overlapping windows disagree about the mean.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from uncrtaints_tpu_torch.config import Config
from uncrtaints_tpu_torch.train.engine import eval_forward


def _axis_ramp(tile: int, overlap: int, n_windows: int) -> np.ndarray:
    """1-D crossfade weight: linear 0->1 over the first ``overlap`` pixels,
    plateau 1, linear 1->0 over the last ``overlap``. Adjacent windows at
    stride ``tile - overlap`` then sum to exactly 1 in the crossfade zone.
    A single window (or overlap=0) gets a flat weight of 1."""
    w = np.ones(tile, np.float32)
    if n_windows == 1 or overlap == 0:
        return w
    ramp = (np.arange(overlap, dtype=np.float32) + 1.0) / (overlap + 1.0)
    w[:overlap] = ramp
    w[-overlap:] = ramp[::-1]
    return w


def _window_origins(size: int, tile: int, stride: int) -> list:
    """Window start offsets covering [0, size), the final window clamped
    flush to the far edge."""
    if size <= tile:
        return [0]
    starts = list(range(0, size - tile, stride))
    starts.append(size - tile)
    return starts


def _live_forward(model: torch.nn.Module, cfg: Config) -> Callable:
    """``fn(x [B,T,t,t,C], dates [B,T] or None) -> {'pred', 'var'?}`` in
    data units, fp32, on the model's device: the eval step's forward."""
    s = float(cfg.scale_by)

    @torch.inference_mode()
    def fwd(xb: torch.Tensor, d_batch: Optional[torch.Tensor]) -> Dict:
        model.eval()
        mean, var = eval_forward(cfg, model, s * xb.to(torch.float32), d_batch)
        res = {"pred": mean / s}
        if var is not None:
            res["var"] = var / (s * s)
        return res

    return fwd


def predict_scene(model: Optional[torch.nn.Module], cfg: Optional[Config],
                  scene_x, dates=None, *, tile: int = 256, overlap: int = 64,
                  batch_size: int = 8, device=None,
                  forward_fn: Optional[Callable] = None) -> Dict[str, np.ndarray]:
    """Run the model over an arbitrarily large scene.

    scene_x: [T,H,W,C] preprocessed inputs (numpy or a tensor; the band
    layout the model was trained with, value-scaled like the dataset
    pipeline, not yet multiplied by scale_by). dates: [T] day offsets or
    None. ``device`` is where the window batches go; None means the model's
    device.

    ``forward_fn`` serves scenes from another forward than the live model's
    (an exported artifact): a callable ``fn(x [B,T,t,t,C], dates [B,T]) ->
    {'pred', 'var'?}`` taking tensors on ``device``; ``model`` and ``cfg``
    may then be None, ``device`` must be given, and ``dates`` are required.

    Returns {"pred": [1,H,W,13], "var": [1,H,W,13]} numpy fp32 arrays in
    data units (no "var" for a mean-only head).
    """
    scene_np = np.asarray(scene_x.cpu() if isinstance(scene_x, torch.Tensor) else scene_x)
    T, H0, W0, C = scene_np.shape
    if tile % 2:
        raise ValueError(f"tile must be even, got {tile}")
    if forward_fn is None:
        # shrink the window to a small scene (rounded down to even). Only
        # for the live model: another forward may have fixed spatial dims,
        # and small scenes then go through the pad-up-to-tile branch below
        tile = min(tile, max(2, max(H0, W0) // 2 * 2))
        run = _live_forward(model, cfg)
        if device is None:
            device = next(model.parameters()).device
    else:
        # the artifact takes day offsets as a real input, so there is no
        # "no dates" mode (zeros would apply the position-0 encoding, where
        # the live model skips the encoding when dates is None)
        if dates is None:
            raise ValueError(
                "predict_scene(forward_fn=...) requires `dates`: the forward "
                "takes day offsets as a real input. Pass the [T] day offsets "
                "(or serve from the live model, which supports dates=None).")
        if device is None:
            raise ValueError("predict_scene(forward_fn=...) requires `device`")
        run = forward_fn
    device = torch.device(device)
    overlap = min(overlap, tile // 2)
    stride = tile - overlap

    # scenes narrower than the tile in one axis: edge-pad up to the tile
    # (windows are square; the pad is cropped from the output)
    H, W = max(H0, tile), max(W0, tile)
    if (H, W) != (H0, W0):
        scene_np = np.pad(scene_np, ((0, 0), (0, H - H0), (0, W - W0), (0, 0)),
                          mode="edge")

    ys = _window_origins(H, tile, stride)
    xs = _window_origins(W, tile, stride)
    origins = [(y, x) for y in ys for x in xs]
    w2d = np.outer(_axis_ramp(tile, overlap, len(ys)),
                   _axis_ramp(tile, overlap, len(xs))).astype(np.float32)[..., None]

    d_batch = None
    if dates is not None:
        d_batch = torch.as_tensor(np.asarray(dates), dtype=torch.float32,
                                  device=device)[None].expand(batch_size, T)

    def dispatch(b0: int):
        chunk = origins[b0:b0 + batch_size]
        xb = np.stack([scene_np[:, y:y + tile, x:x + tile] for y, x in chunk])
        if len(chunk) < batch_size:  # one batch shape: repeat the last window
            xb = np.concatenate([xb, np.repeat(xb[-1:], batch_size - len(chunk), axis=0)])
        out = run(torch.from_numpy(xb).to(device, non_blocking=True), d_batch)
        return chunk, out["pred"], out.get("var")  # not yet waited for

    # one-deep pipeline: batch i+1 is launched before the blocking copy of
    # batch i to the host, so the device computes while the host blends
    num = vnum = den = None
    starts = list(range(0, len(origins), batch_size))
    pending = dispatch(starts[0])
    for b0 in starts[1:] + [None]:
        nxt = dispatch(b0) if b0 is not None else None
        chunk, mean, var = pending
        if num is None:  # sized off the first output (the head split)
            num = np.zeros((H, W, mean.shape[-1]), np.float32)
            vnum = np.zeros_like(num) if var is not None else None
            den = np.zeros((H, W, 1), np.float32)
        mean = mean.float().cpu().numpy()  # [B,1,tile,tile,13]
        var = var.float().cpu().numpy() if var is not None else None
        for i, (y, x) in enumerate(chunk):
            num[y:y + tile, x:x + tile] += w2d * mean[i, 0]
            if var is not None:
                vnum[y:y + tile, x:x + tile] += w2d * var[i, 0]
            den[y:y + tile, x:x + tile] += w2d
        pending = nxt

    out = {"pred": (num / den)[None, :H0, :W0]}
    if vnum is not None:
        out["var"] = (vnum / den)[None, :H0, :W0]
    return out
