"""ctypes bindings of the host slab writers (``preprocess.cpp``).

Port of uncrtaints_tpu/native: the source is compiled with ``g++ -O3
-shared -fPIC`` at first use into ``build/native/<hash>/`` at the root of
the checkout, keyed by a hash of the source and the flags (an edited source
is rebuilt, a stale library never loaded), and loaded with ctypes, which
releases the interpreter lock for each call, so the loader's threads write
frames in parallel (no OpenMP, unlike the JAX package's build, so a
toolchain without libgomp builds it too). A failed build raises with the
compiler's output: the collates that write through these functions have no
silent numpy fallback.

The uint16 radiometry is a 65536-entry lookup table made here with the
numpy path's own fp32 arithmetic; its bf16 form is rounded to nearest even by
torch (``.to(torch.bfloat16)``), the rounding ``ml_dtypes`` gives the JAX
package's table. A bf16 slab is a uint16 array of the bf16 bits
(``torch.from_numpy(slab).view(torch.bfloat16)`` reads it).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np
import torch

_SRC = Path(__file__).resolve().parent / "preprocess.cpp"
_BUILD_ROOT = Path(__file__).resolve().parent.parent.parent / "build" / "native"
CXX_FLAGS = ("-O3", "-shared", "-fPIC")

_lib: Optional[ctypes.CDLL] = None
_LUTS: dict = {}


def build() -> Path:
    """Compile ``preprocess.cpp`` into a shared library (cached by content)."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(_SRC.read_bytes())
    out_dir = _BUILD_ROOT / h.hexdigest()[:16]
    so = out_dir / "libuncr_native.so"
    if so.exists():
        return so
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"libuncr_native.so.{os.getpid()}.tmp"
    cmd = [os.environ.get("CXX", "g++"), *CXX_FLAGS, str(_SRC), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError(f"native slab writers: no C++ compiler ({' '.join(cmd)}): "
                           f"{e}; pass --no_fast_collate to collate without them") from e
    if proc.returncode != 0:
        raise RuntimeError(f"native slab writers: build failed (rc={proc.returncode}): "
                           f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, so)  # atomic: a concurrent loader never sees half a file
    return so


def lib() -> ctypes.CDLL:
    """The loaded library, built on first call (a failed build raises)."""
    global _lib
    if _lib is None:
        loaded = ctypes.CDLL(str(build()))
        vp, i64 = ctypes.c_void_p, ctypes.c_int64
        loaded.f32_chw_to_hwc.argtypes = [vp, vp, i64, i64, i64]
        for name in ("u16_lut_chw_to_hwc_slab_f32", "u16_lut_chw_to_hwc_slab_u16"):
            getattr(loaded, name).argtypes = [vp, vp, vp, i64, i64, i64, i64]
        for name in ("f32_chw_to_hwc_slab_f32", "u16_chw_to_hwc_slab_u16",
                     "f32_chw_to_hwc_slab_bf16"):
            getattr(loaded, name).argtypes = [vp, vp, i64, i64, i64, i64]
        for fn in ("f32_chw_to_hwc", "u16_lut_chw_to_hwc_slab_f32",
                   "u16_lut_chw_to_hwc_slab_u16", "f32_chw_to_hwc_slab_f32",
                   "u16_chw_to_hwc_slab_u16", "f32_chw_to_hwc_slab_bf16"):
            getattr(loaded, fn).restype = None
        _lib = loaded
    return _lib


def bf16_bits(a: np.ndarray) -> np.ndarray:
    """fp32 -> the uint16 bits of bf16, rounded to nearest even (torch)."""
    t = torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))
    return t.to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)


def ms_lut(method: str = "default", bf16: bool = False) -> np.ndarray:
    """``process_MS`` as a table over the uint16 range: the numpy path's fp32
    clip and divide; fp32, or with ``bf16`` the uint16 bits of bf16."""
    key = (method, bf16)
    lut = _LUTS.get(key)
    if lut is None:
        v = np.clip(np.arange(65536, dtype=np.float32), 0.0, 10000.0)
        v = v / 2000.0 if method == "resnet" else v / 10000.0
        lut = bf16_bits(v) if bf16 else np.ascontiguousarray(v, dtype=np.float32)
        _LUTS[key] = lut
    return lut


def chw_to_hwc(chw: np.ndarray) -> np.ndarray:
    """Layout-only CHW -> HWC of a contiguous fp32 frame."""
    if chw.dtype != np.float32 or chw.ndim != 3 or not chw.flags.c_contiguous:
        raise ValueError(f"chw_to_hwc: a contiguous float32 [C,H,W] frame expected, "
                         f"got {chw.dtype} {chw.shape}")
    C, H, W = chw.shape
    out = np.empty((H, W, C), np.float32)
    lib().f32_chw_to_hwc(chw.ctypes.data, out.ctypes.data, C, H, W)
    return out


_PAIRS = {False: {("uint16", "uint16"), ("uint16", "float32"), ("float32", "float32")},
          True: {("uint16", "uint16"), ("float32", "uint16")}}


def supported(frame_dtype, slab_dtype, bf16: bool = False) -> bool:
    """Whether :func:`frame_into_slab` writes a frame of this dtype into a
    slab of that one (with ``bf16`` a uint16 slab holds bf16 bits)."""
    return (np.dtype(frame_dtype).name, np.dtype(slab_dtype).name) in _PAIRS[bool(bf16)]


def frame_into_slab(slab_hwc: np.ndarray, c0: int, chw: np.ndarray,
                    method: str = "default", bf16: bool = False) -> None:
    """Write a [C,H,W] frame into ``slab_hwc[:, :, c0:c0+C]`` in one pass.

    - uint16 frame -> uint16 slab: the raw codes, a layout copy (the
      radiometry runs on the device);
    - uint16 frame -> float32 slab, or -> uint16 slab with ``bf16``: the
      radiometry of ``method`` through :func:`ms_lut`;
    - float32 frame -> float32 slab: a layout copy;
    - float32 frame -> uint16 slab with ``bf16``: rounded to bf16 (nearest
      even).

    Raises on a frame or slab that is not contiguous, shapes that differ,
    channels beyond the slab, or another pair of dtypes."""
    if chw.ndim != 3 or slab_hwc.ndim != 3:
        raise ValueError(f"frame_into_slab: [C,H,W] frame and [H,W,dstC] slab expected, "
                         f"got {chw.shape} and {slab_hwc.shape}")
    if not (chw.flags.c_contiguous and slab_hwc.flags.c_contiguous):
        raise ValueError("frame_into_slab: frame and slab must be contiguous")
    C, H, W = chw.shape
    dstC = slab_hwc.shape[-1]
    # raises, not asserts: they guard a raw native write and survive python -O
    if slab_hwc.shape[:2] != (H, W):
        raise ValueError(f"frame_into_slab: slab {slab_hwc.shape} vs frame {chw.shape}")
    if c0 < 0 or c0 + C > dstC:
        raise ValueError(f"frame_into_slab: channels [{c0}, {c0 + C}) exceed the "
                         f"slab's {dstC}")
    if not supported(chw.dtype, slab_hwc.dtype, bf16):
        raise TypeError(f"frame_into_slab: no writer from {chw.dtype} into a "
                        f"{slab_hwc.dtype} slab (bf16={bf16})")
    n = lib()
    src, dst = chw.ctypes.data, slab_hwc.ctypes.data + c0 * slab_hwc.itemsize
    if chw.dtype == np.uint16:
        if slab_hwc.dtype == np.float32:
            n.u16_lut_chw_to_hwc_slab_f32(src, ms_lut(method).ctypes.data, dst, C, H, W, dstC)
        elif bf16:
            n.u16_lut_chw_to_hwc_slab_u16(src, ms_lut(method, True).ctypes.data, dst,
                                          C, H, W, dstC)
        else:
            n.u16_chw_to_hwc_slab_u16(src, dst, C, H, W, dstC)
    elif slab_hwc.dtype == np.float32:
        n.f32_chw_to_hwc_slab_f32(src, dst, C, H, W, dstC)
    else:
        n.f32_chw_to_hwc_slab_bf16(src, dst, C, H, W, dstC)
