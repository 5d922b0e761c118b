"""Host-side input pipeline: collation, shuffling, prefetch, host sharding.

The port's own copy of uncrtaints_tpu/data/pipeline.py (numpy only; the
tests hold every collate bit-identical to the original's and the loader's
sample order equal). A thread-pooled, double-buffered numpy pipeline that
yields NHWC batches. Batch semantics follow the reference's
prepare_data_multi / prepare_data_mono:

- multi: x = concat(S1, S2) on channels per frame -> [B, T, H, W, 2+13];
  dates = mean(S1 TD, S2 TD) when SAR is used, else S2 TD -> [B, T];
  y = target S2 -> [B, 1, H, W, 13]; masks -> [B, T, H, W]
- mono:  x -> [B, 1, H, W, C], no dates

The train iterator is re-seeded each epoch with (seed + epoch) when
vary_samples is on, so the sample order reproduces across resumed runs.

The frames go CHW -> HWC through the port's compiled writers
(``uncrtaints_tpu_torch/native``, built at first use; a failed build
raises): the single-pass and the raw-DN collate write each frame into its
preallocated batch slab in one pass, the uint16 radiometry through a lookup
table, with the interpreter lock released.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, Optional

import numpy as np

from uncrtaints_tpu_torch import native
from uncrtaints_tpu_torch.data.preprocess import process_MS


def _hwc(frame) -> np.ndarray:
    """CHW -> contiguous fp32 HWC (the native transpose)."""
    return native.chw_to_hwc(np.ascontiguousarray(frame, dtype=np.float32))


def _dates(inp, use_sar: bool) -> np.ndarray:
    s1_td = np.asarray(inp["S1 TD"], np.float32)
    s2_td = np.asarray(inp["S2 TD"], np.float32)
    return (s1_td + s2_td) / 2.0 if use_sar else s2_td


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
        dates.append(_dates(s["input"], use_sar))
        masks.append(np.stack(s["input"]["masks"]).astype(np.float32))
    return {
        "x": np.stack(xs).astype(x_dtype),
        "y": np.stack(ys).astype(np.float32),
        "dates": np.stack(dates).astype(np.float32),
        "masks": np.stack(masks),
    }


def _decode_raw_s2(samples, method: str):
    """Apply process_MS to raw-uint16 S2 samples so the generic collate can
    take them."""
    out = []
    for s in samples:
        if np.asarray(s["input"]["S2"][0]).dtype != np.uint16:
            out.append(s)
            continue
        inp = dict(s["input"])
        inp["S2"] = [process_MS(np.asarray(f, np.float32), method)
                     for f in s["input"]["S2"]]
        tgt = dict(s["target"])
        tgt["S2"] = [process_MS(np.asarray(s["target"]["S2"][0], np.float32),
                                method)]
        out.append({**s, "input": inp, "target": tgt})
    return out


def _check_marker(sample, method: str):
    """Raw-DN samples carry the radiometry method they expect; a mismatched
    collate would apply the wrong rescale with no other symptom."""
    marker = sample.get("rescale_method")
    if marker is not None and marker != method:
        raise ValueError(
            f"raw samples expect rescale_method={marker!r} but this "
            f"collate was built with method={method!r}")


def _into_slab(slab, c0: int, frame, method: str = "default"):
    """CHW frame -> channels [c0, c0+C) of an HWC slab in one native pass
    (uint16 into a float32 slab: the radiometry of ``method``); a pair of
    dtypes the writers do not take is written by numpy, cast on the write."""
    frame = np.ascontiguousarray(frame)
    if native.supported(frame.dtype, slab.dtype):
        native.frame_into_slab(slab, c0, frame, method)
    else:
        slab[..., c0:c0 + frame.shape[0]] = np.moveaxis(frame, 0, -1)


def make_fast_collate(method: str = "default", x_dtype=np.float32):
    """Single-pass batch assembly: each frame goes CHW -> the preallocated
    [B,T,H,W,C] slab in one native write, with no stack / concatenate
    passes. Takes processed fp32 S2 frames (a layout copy) and raw uint16 DN
    frames (``process_MS`` as an exact lookup table in the write); same values
    as :func:`collate_multi`. Variable-T batches, an ``x_dtype`` other than
    float32 and S2 frames of another dtype go through the generic collate."""
    def collate(samples, use_sar: bool = True) -> Dict[str, np.ndarray]:
        B = len(samples)
        s0 = samples[0]["input"]
        T = len(s0["S2"])
        s2_dtype = np.asarray(s0["S2"][0]).dtype
        if (any(len(s["input"]["S2"]) != T for s in samples)
                or np.dtype(x_dtype) != np.float32
                or s2_dtype not in (np.uint16, np.float32)):
            return collate_multi(_decode_raw_s2(samples, method),
                                 use_sar=use_sar, x_dtype=x_dtype)
        _check_marker(samples[0], method)
        C2, H, W = np.asarray(s0["S2"][0]).shape
        c1 = 2 if use_sar else 0
        x = np.empty((B, T, H, W, c1 + C2), dtype=np.float32)
        y = np.empty((B, 1, H, W, C2), dtype=np.float32)
        dates, masks = [], []
        for b, s in enumerate(samples):
            inp = s["input"]
            for t in range(T):
                if use_sar:
                    _into_slab(x[b, t], 0, np.asarray(inp["S1"][t], np.float32))
                _into_slab(x[b, t], c1, inp["S2"][t], method)
            _into_slab(y[b, 0], 0, s["target"]["S2"][0], method)
            dates.append(_dates(inp, use_sar))
            masks.append(np.stack(inp["masks"]).astype(np.float32))
        return {"x": x, "y": y, "dates": np.stack(dates).astype(np.float32),
                "masks": np.stack(masks)}
    return collate


def make_raw_collate(method: str = "default", s1_dtype=np.float32):
    """Raw-DN batch assembly: ship Sentinel-2 uint16 digital numbers to the
    device untouched and let the step do the radiometry.

    Collates raw samples into {'x_s1' [B,T,H,W,2] s1_dtype, 'x_s2dn'
    [B,T,H,W,13] uint16, 'y_dn' [B,1,H,W,13] uint16, 'dates', 'masks'}, the
    batch form ``train/engine.py:_prepare_xy`` consumes: process_MS runs on
    the device, ahead of the step's scale_by multiply. The host's cost per
    S2 / target element is a transpose copy, and the S2 + target bytes that
    go to the device halve against fp32.

    ``method`` must match the rescale_method the train / eval step was built
    with; raw samples carry a marker that is validated here. S1 is stored
    already processed (fp32)."""
    def collate(samples, use_sar: bool = True) -> Dict[str, np.ndarray]:
        B = len(samples)
        s0 = samples[0]["input"]
        T = len(s0["S2"])
        if any(len(s["input"]["S2"]) != T for s in samples):
            raise ValueError("make_raw_collate requires uniform-T batches "
                             "(use pad_collate_multi for variable T)")
        if np.asarray(s0["S2"][0]).dtype != np.uint16:
            raise ValueError("make_raw_collate needs raw uint16 DN samples")
        _check_marker(samples[0], method)
        C2, H, W = np.asarray(s0["S2"][0]).shape
        x_s2 = np.empty((B, T, H, W, C2), dtype=np.uint16)
        y = np.empty((B, 1, H, W, C2), dtype=np.uint16)
        x_s1 = (np.empty((B, T, H, W, 2), dtype=s1_dtype)
                if use_sar else None)
        dates, masks = [], []
        for b, s in enumerate(samples):
            inp = s["input"]
            for t in range(T):
                if use_sar:
                    _into_slab(x_s1[b, t], 0, np.asarray(inp["S1"][t], np.float32))
                _into_slab(x_s2[b, t], 0, np.asarray(inp["S2"][t]))
            _into_slab(y[b, 0], 0, np.asarray(s["target"]["S2"][0]))
            dates.append(_dates(inp, use_sar))
            masks.append(np.stack(inp["masks"]).astype(np.float32))
        out = {"x_s2dn": x_s2, "y_dn": y,
               "dates": np.stack(dates).astype(np.float32),
               "masks": np.stack(masks)}
        if use_sar:
            out["x_s1"] = x_s1
        return out
    return collate


def select_collate(cfg):
    """The CLIs' collate policy in one place: mono for pretrain, the
    single-pass collate by default (exact numerics), the generic numpy
    collate with --no_fast_collate."""
    if cfg.pretrain:
        return collate_mono
    if getattr(cfg, "fast_collate", False):
        return make_fast_collate()
    return collate_multi


def collate_mono(samples, use_sar: bool = True) -> Dict[str, np.ndarray]:
    """Stack mono-temporal (pretrain) samples: [B, 1, H, W, C]."""
    xs, ys, masks = [], [], []
    for s in samples:
        s2 = np.moveaxis(np.asarray(s["input"]["S2"]), 0, -1)
        if use_sar:
            s1 = np.moveaxis(np.asarray(s["input"]["S1"]), 0, -1)
            x = np.concatenate([s1, s2], axis=-1)
        else:
            x = s2
        xs.append(x[None])
        ys.append(np.moveaxis(np.asarray(s["target"]["S2"]), 0, -1)[None])
        masks.append(np.asarray(s["input"]["masks"], np.float32)[None])
    return {
        "x": np.stack(xs).astype(np.float32),
        "y": np.stack(ys).astype(np.float32),
        "dates": None,
        "masks": np.stack(masks),
    }


def pad_collate_multi(samples, use_sar: bool = True, pad_value: float = 0.0):
    """Variable-T collation: right-pad each sample's temporal axis to the
    batch max. Padded frames are all ``pad_value`` so models recover the pad
    mask; padded dates are 0."""
    max_t = max(len(s["input"]["S2"]) for s in samples)

    def pad_t(arr, t):  # [T, ...] -> [max_t, ...]
        if arr.shape[0] == t == max_t:
            return arr
        pad = [(0, max_t - arr.shape[0])] + [(0, 0)] * (arr.ndim - 1)
        return np.pad(arr, pad, constant_values=pad_value)

    xs, ys, dates, masks = [], [], [], []
    for s in samples:
        t = len(s["input"]["S2"])
        s2 = np.stack([np.moveaxis(f, 0, -1) for f in s["input"]["S2"]])
        if use_sar:
            s1 = np.stack([np.moveaxis(f, 0, -1) for f in s["input"]["S1"]])
            x = np.concatenate([s1, s2], axis=-1)
        else:
            x = s2
        xs.append(pad_t(x, t))
        ys.append(np.moveaxis(np.asarray(s["target"]["S2"][0]), 0, -1)[None])
        dates.append(pad_t(_dates(s["input"], use_sar), t))
        masks.append(pad_t(np.stack(s["input"]["masks"]).astype(np.float32), t))
    return {"x": np.stack(xs).astype(np.float32),
            "y": np.stack(ys).astype(np.float32),
            "dates": np.stack(dates).astype(np.float32),
            "masks": np.stack(masks)}


class Subset:
    """Index-range view over a dataset (the --max_samples_count and
    --max_samples_frac caps)."""

    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, i):
        return self.dataset[self.indices[i]]

    def __getattr__(self, name):
        # pass through dataset attributes (epoch_count etc.)
        return getattr(self.dataset, name)


class BatchLoader:
    """Shuffling, thread-prefetching batch iterator over an indexable dataset.

    Per-process sharding for data-parallel runs: with ``shard=(rank,
    world)`` each process iterates a disjoint strided subset of the index
    space. The global sample order is agreed on by every process (same
    seed+epoch rng) and striding happens AFTER the shuffle, so with
    ``drop_last=False`` the non-divisible GLOBAL tail is well defined and
    every process yields the SAME tail batch last, marked with
    ``"_replicated_tail": True``.

    An iterator that is closed early (a ``break``, an error in the
    consumer) stops its producer thread and its pool before it returns; an
    error in the dataset or the collate is raised in the consumer.
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 seed: int = 1, collate=collate_multi, use_sar: bool = True,
                 num_workers: int = 4, drop_last: bool = True,
                 shard: Optional[tuple] = None, prefetch: int = 2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.collate = collate
        self.use_sar = use_sar
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.shard = shard
        self.prefetch = prefetch
        self.epoch = 0

    def set_epoch(self, epoch: int):
        """Epoch-seeded reshuffle."""
        self.epoch = epoch

    def _global_order(self) -> np.ndarray:
        """The epoch's sample order, identical on every process (a pure
        function of seed+epoch)."""
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            rng.shuffle(idx)
        return idx

    def _plan(self):
        """(this process's body batches, replicated global tail indices or
        None)."""
        idx = self._global_order()
        B = self.batch_size
        if self.shard is None:
            n_full = len(idx) // B
            batches = [idx[i * B:(i + 1) * B] for i in range(n_full)]
            tail = idx[n_full * B:]
            if tail.size and not self.drop_last:
                batches.append(tail)  # one process: just a smaller batch
            return batches, None
        host, n_hosts = self.shard
        gbs = B * n_hosts
        body_len = len(idx) // gbs * gbs
        mine = idx[:body_len][host::n_hosts]
        batches = [mine[i * B:(i + 1) * B] for i in range(body_len // gbs)]
        tail = idx[body_len:]
        if self.drop_last or tail.size == 0:
            return batches, None
        return batches, tail

    def __len__(self):
        batches, tail = self._plan()
        return len(batches) + (1 if tail is not None else 0)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        batches, tail = self._plan()

        pool = ThreadPoolExecutor(max_workers=self.num_workers)
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        failure = []

        def put(item):
            """Blocks while the queue is full, gives up once stopped."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.05)
                    return
                except queue.Full:
                    pass

        def produce():
            try:
                for b in batches:
                    if stop.is_set():
                        return
                    samples = list(pool.map(self.dataset.__getitem__, b))
                    put(self.collate(samples, use_sar=self.use_sar))
                if tail is not None and not stop.is_set():
                    samples = list(pool.map(self.dataset.__getitem__, tail))
                    out = self.collate(samples, use_sar=self.use_sar)
                    out["_replicated_tail"] = True
                    put(out)
            except Exception as e:  # handed to the consumer, raised there
                failure.append(e)
            finally:
                put(None)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                yield item
            if failure:
                raise failure[0]
        finally:
            stop.set()
            t.join()
            pool.shutdown(wait=True)
