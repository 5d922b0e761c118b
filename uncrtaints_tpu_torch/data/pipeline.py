"""Host-side batch assembly.

The port's own copy of ``collate_multi`` from uncrtaints_tpu/data/
pipeline.py (numpy only; the tests hold the two bit-identical). Batch
semantics follow the reference's prepare_data_multi:

- x = concat(S1, S2) on channels per frame -> [B, T, H, W, 2+13];
- dates = mean(S1 TD, S2 TD) when SAR is used, else S2 TD -> [B, T];
- y = target S2 -> [B, 1, H, W, 13]; masks -> [B, T, H, W].

The prefetching loader of that module is not ported yet.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def _hwc(frame) -> np.ndarray:
    """CHW -> contiguous fp32 HWC."""
    return np.ascontiguousarray(
        np.transpose(np.asarray(frame, dtype=np.float32), (1, 2, 0)))


def collate_multi(samples, use_sar: bool = True,
                  x_dtype=np.float32) -> Dict[str, np.ndarray]:
    """Stack sample dicts into one NHWC multi-temporal batch.

    ``x_dtype`` other than fp32 rounds the input once at collation, before
    the step's fp32 scale_by multiply; targets and dates stay fp32."""
    xs, ys, dates, masks = [], [], [], []
    for s in samples:
        s1 = np.stack([_hwc(f) for f in s["input"]["S1"]])  # [T,H,W,2]
        s2 = np.stack([_hwc(f) for f in s["input"]["S2"]])  # [T,H,W,13]
        xs.append(np.concatenate([s1, s2], axis=-1) if use_sar else s2)
        ys.append(_hwc(np.asarray(s["target"]["S2"][0]))[None])
        s1_td = np.asarray(s["input"]["S1 TD"], np.float32)
        s2_td = np.asarray(s["input"]["S2 TD"], np.float32)
        dates.append((s1_td + s2_td) / 2.0 if use_sar else s2_td)
        masks.append(np.stack(s["input"]["masks"]).astype(np.float32))
    return {
        "x": np.stack(xs).astype(x_dtype),
        "y": np.stack(ys).astype(np.float32),
        "dates": np.stack(dates).astype(np.float32),
        "masks": np.stack(masks),
    }
