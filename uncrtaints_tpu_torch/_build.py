"""Build and load the port's hand-written CUDA kernels.

The sources under ``csrc/`` have a plain C interface and include no PyTorch
header. Each ``.cu`` file is compiled by its own ``nvcc`` process, all of
them started together, and one more ``nvcc`` call links the objects into a
shared library; the build takes about as long as the slowest source. The
library is built at first use into ``build/kernels/<hash>/`` at the root of
the checkout, keyed by a hash of the sources and the flags (an edited source
is rebuilt, a stale library is never loaded), and loaded with ``ctypes``.

Every C entry point returns ``cudaGetLastError()`` after its launches;
:func:`check` raises when that is not ``cudaSuccess``. A launch the CUDA
runtime refuses (too many threads, too much shared memory) never runs and would
otherwise go unnoticed.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional, Sequence

import torch

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD_ROOT = Path(__file__).resolve().parent.parent / "build" / "kernels"
_LIB_NAME = "libuncr_kernels.so"

# sm_90a: the Hopper target; the trailing "a" admits wgmma/setmaxnreg for
# the later PRs that use them
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

# the dtype codes of csrc/common.cuh (UncrDtype)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    """CUDA_HOME's nvcc, else the one on PATH, else the toolkit's
    conventional install location."""
    candidates = []
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home:
        candidates.append(os.path.join(home, "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA "
        "kernels of uncrtaints_tpu_torch are built from csrc/ at first use")


def _sources():
    return sorted(p for p in _CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def build() -> Path:
    """Compile ``csrc/*.cu`` into one shared library (cached by content)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    out_dir = _BUILD_ROOT / h.hexdigest()[:16]
    so = out_dir / _LIB_NAME
    if so.exists():
        return so
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc, pid = _nvcc(), os.getpid()
    jobs = []
    for src in (p for p in _sources() if p.suffix == ".cu"):
        obj = out_dir / f"{src.stem}.{pid}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failed = []
    for cmd, _, proc in jobs:  # wait for every job, so none outlives us
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed (rc={proc.returncode}): "
                          f"{' '.join(cmd)}\n{out}\n{err}")
    if failed:
        raise RuntimeError("\n".join(failed))
    tmp = out_dir / f"{_LIB_NAME}.{pid}.tmp"
    cmd = [nvcc, "-shared", "-o", str(tmp), *(str(obj) for _, obj, _ in jobs)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed (rc={proc.returncode}): "
                           f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, so)  # atomic: a concurrent loader never sees half a file
    return so


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    if _lib is None:
        loaded = ctypes.CDLL(str(build()))
        loaded.uncr_error_string.argtypes = [ctypes.c_int]
        loaded.uncr_error_string.restype = ctypes.c_char_p
        _lib = loaded
    return _lib


def kernel(name: str, argtypes: Sequence) -> ctypes._CFuncPtr:
    """C entry point ``name`` with its argument types declared (every
    pointer and the stream as ``c_void_p``, so none is cut to 32 bits)."""
    fn = getattr(lib(), name)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def check(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        msg = lib().uncr_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err}: {msg}")
