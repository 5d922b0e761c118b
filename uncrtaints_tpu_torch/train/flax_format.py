"""The JAX package's single-file checkpoint format: flax's msgpack.

A self-contained codec of the subset ``flax.serialization.msgpack_serialize``
writes and ``msgpack_restore`` reads (flax/serialization.py), in Python and
numpy, so that this package reads and writes ``{name}.ckpt`` files without
flax or msgpack:

- msgpack's nil, bool, int and uint of every width, float32 / float64, str,
  bin, array and map;
- three extension types: 1 an ndarray, 2 a Python complex, 3 a numpy scalar.
  An ndarray's payload is itself msgpack of ``(shape, dtype name, the C-order
  bytes)``; a numpy scalar is a 0-d ndarray's payload, read back as
  ``arr[()]``; a complex is msgpack of ``(real, imag)``;
- arrays over ``MAX_CHUNK_SIZE`` bytes, which flax splits into
  ``{"__msgpack_chunked_array__": True, "shape": {...}, "chunks": {...}}``
  maps of flat slices (``_chunk`` / ``_unchunk`` there).

numpy has no bfloat16: a ``bfloat16`` leaf decodes to a :class:`BFloat16`
array, its raw bits as uint16, which :func:`to_tensor` reads as
``torch.bfloat16``. Encoding makes msgpack-python's type choices (the
smallest int encoding, float64 for a Python float, an ndarray extension for
a 0-d array), so for a tree in the same key order the bytes equal
``msgpack_serialize``'s. Input outside the subset (an unknown extension, a
truncated buffer, bytes after the tree) raises ``ValueError`` naming the
offset.
"""

from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np
import torch

MAX_CHUNK_SIZE = 2 ** 30  # flax's: msgpack holds at most 2**31 - 1 bytes an object
EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"


class BFloat16(np.ndarray):
    """A bfloat16 array held as its raw bits (uint16): numpy has no
    bfloat16. Views (transposes, flips, reshapes) keep the class."""


def to_tensor(a: np.ndarray) -> torch.Tensor:
    """A decoded leaf -> a contiguous CPU tensor of its own memory (a
    :class:`BFloat16` as ``torch.bfloat16``)."""
    if isinstance(a, BFloat16) or a.dtype.name == "bfloat16":  # also ml_dtypes' bfloat16
        bits = np.array(a.view(np.ndarray), order="C").view(np.int16)
        return torch.from_numpy(bits).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, order="C"))


def from_tensor(t: torch.Tensor) -> np.ndarray:
    """A tensor -> a numpy leaf to encode (a :class:`BFloat16` for bf16)."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16).view(BFloat16)
    return t.numpy()


# ------------------------------------------------------------- decode --

class _Reader:
    def __init__(self, data):
        self.buf = memoryview(data).cast("B")
        self.pos = 0

    def take(self, n: int) -> memoryview:
        start = self.pos
        if start + n > len(self.buf):
            raise ValueError(f"msgpack: truncated at offset {start}: {n} bytes wanted, "
                             f"{len(self.buf) - start} left")
        self.pos = start + n
        return self.buf[start:start + n]

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


_FIXED = {  # first byte -> (struct format of the value or of the length, kind)
    0xc4: (">B", "bin"), 0xc5: (">H", "bin"), 0xc6: (">I", "bin"),
    0xc7: (">B", "ext"), 0xc8: (">H", "ext"), 0xc9: (">I", "ext"),
    0xca: (">f", "num"), 0xcb: (">d", "num"),
    0xcc: (">B", "num"), 0xcd: (">H", "num"), 0xce: (">I", "num"), 0xcf: (">Q", "num"),
    0xd0: (">b", "num"), 0xd1: (">h", "num"), 0xd2: (">i", "num"), 0xd3: (">q", "num"),
    0xd9: (">B", "str"), 0xda: (">H", "str"), 0xdb: (">I", "str"),
    0xdc: (">H", "array"), 0xdd: (">I", "array"), 0xde: (">H", "map"), 0xdf: (">I", "map"),
}
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}


def _decode(r: _Reader, raw: bool = False) -> Any:
    at = r.pos
    b = r.take(1)[0]
    if b <= 0x7f:
        return b
    if b >= 0xe0:
        return b - 0x100
    if 0x80 <= b <= 0x8f:
        return _map(r, b & 0x0f, raw)
    if 0x90 <= b <= 0x9f:
        return [_decode(r, raw) for _ in range(b & 0x0f)]
    if 0xa0 <= b <= 0xbf:
        return _str(r, b & 0x1f, raw, at)
    if b == 0xc0:
        return None
    if b in (0xc2, 0xc3):
        return b == 0xc3
    if b in _FIXEXT:
        return _ext(r, _FIXEXT[b], at)
    if b not in _FIXED:
        raise ValueError(f"msgpack: unknown type byte 0x{b:02x} at offset {at}")
    fmt, kind = _FIXED[b]
    n = r.unpack(fmt)
    if kind == "num":
        return n
    if kind == "bin":
        return bytes(r.take(n))
    if kind == "str":
        return _str(r, n, raw, at)
    if kind == "ext":
        return _ext(r, n, at)
    if kind == "array":
        return [_decode(r, raw) for _ in range(n)]
    return _map(r, n, raw)


def _str(r: _Reader, n: int, raw: bool, at: int):
    data = bytes(r.take(n))
    if raw:
        return data
    try:
        return data.decode("utf-8")
    except UnicodeDecodeError as e:
        raise ValueError(f"msgpack: a str that is not UTF-8 at offset {at}") from e


def _map(r: _Reader, n: int, raw: bool) -> dict:
    out = {}
    for _ in range(n):
        k = _decode(r, raw)
        out[k] = _decode(r, raw)
    return out


def _dtype(name: bytes, at: int):
    if name == b"bfloat16":
        return None
    try:
        dt = np.dtype(name.decode("ascii"))
    except (TypeError, UnicodeDecodeError) as e:
        raise ValueError(f"msgpack: unknown ndarray dtype {name!r} at offset {at}") from e
    if dt.hasobject or dt.fields is not None:
        raise ValueError(f"msgpack: ndarray dtype {name!r} at offset {at} is not a plain one")
    return dt


def _ndarray(payload: memoryview, at: int) -> np.ndarray:
    """flax's ``_ndarray_from_bytes``: msgpack of (shape, dtype name, bytes),
    read with raw strings."""
    r = _Reader(payload)
    tpl = _decode(r, raw=True)
    if r.pos != len(r.buf):
        raise ValueError(f"msgpack: {len(r.buf) - r.pos} bytes after the ndarray at offset {at}")
    if (not isinstance(tpl, list) or len(tpl) != 3 or not isinstance(tpl[1], bytes)
            or not isinstance(tpl[2], bytes) or not isinstance(tpl[0], list)
            or not all(isinstance(d, int) and d >= 0 for d in tpl[0])):
        raise ValueError(f"msgpack: a malformed ndarray at offset {at}")
    shape, name, data = tpl
    dt = _dtype(name, at)
    itemsize = 2 if dt is None else dt.itemsize
    if len(data) != int(np.prod(shape, dtype=np.int64)) * itemsize:
        raise ValueError(f"msgpack: ndarray at offset {at} holds {len(data)} bytes, not the "
                         f"{shape} {name.decode(errors='replace')} it declares")
    flat = np.frombuffer(data, np.uint16 if dt is None else dt).copy()
    arr = flat.reshape(shape)
    return arr.view(BFloat16) if dt is None else arr


def _ext(r: _Reader, n: int, at: int):
    code = r.unpack(">b")
    payload = r.take(n)
    if code == EXT_NDARRAY:
        return _ndarray(payload, at)
    if code == EXT_NPSCALAR:  # a bfloat16 scalar stays a 0-d BFloat16
        a = _ndarray(payload, at)
        return a if isinstance(a, BFloat16) else a[()]
    if code == EXT_COMPLEX:
        pr = _Reader(payload)
        pair = _decode(pr)
        if pr.pos != len(payload) or not isinstance(pair, list) or len(pair) != 2:
            raise ValueError(f"msgpack: a malformed complex at offset {at}")
        return complex(pair[0], pair[1])
    raise ValueError(f"msgpack: unknown extension type {code} at offset {at}")


def _unchunk(tree):
    """flax's ``_unchunk_array_leaves_in_place``, as a new tree."""
    if not isinstance(tree, dict):
        return tree
    if _CHUNKED in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        flat = np.concatenate(chunks)
        out = flat.reshape(shape)
        return out.view(BFloat16) if isinstance(chunks[0], BFloat16) else out
    return {k: _unchunk(v) for k, v in tree.items()}


def restore(data) -> Any:
    """``flax.serialization.msgpack_restore``: bytes -> a tree of dicts,
    lists, Python scalars and numpy arrays (chunked arrays rebuilt)."""
    r = _Reader(data)
    tree = _decode(r)
    if r.pos != len(r.buf):
        raise ValueError(f"msgpack: {len(r.buf) - r.pos} bytes after the tree at offset {r.pos}")
    return _unchunk(tree)


# ------------------------------------------------------------- encode --

def _pack_int(n: int, out: bytearray):
    if 0 <= n < 0x80:
        out.append(n)
    elif -0x20 <= n < 0:
        out.append(n & 0xff)
    elif 0 <= n <= 0xff:
        out += b"\xcc" + struct.pack(">B", n)
    elif -0x80 <= n < 0:
        out += b"\xd0" + struct.pack(">b", n)
    elif 0 <= n <= 0xffff:
        out += b"\xcd" + struct.pack(">H", n)
    elif -0x8000 <= n < 0:
        out += b"\xd1" + struct.pack(">h", n)
    elif 0 <= n <= 0xffffffff:
        out += b"\xce" + struct.pack(">I", n)
    elif -0x80000000 <= n < 0:
        out += b"\xd2" + struct.pack(">i", n)
    elif 0 <= n <= 0xffffffffffffffff:
        out += b"\xcf" + struct.pack(">Q", n)
    elif -0x8000000000000000 <= n < 0:
        out += b"\xd3" + struct.pack(">q", n)
    else:
        raise ValueError(f"msgpack: int {n} does not fit 64 bits")


def _pack_len(n: int, fix: int, fix_max: int, heads: Tuple[Tuple[int, str], ...],
              out: bytearray):
    if fix is not None and n <= fix_max:
        out.append(fix | n)
        return
    for head, fmt in heads:
        if n <= (1 << (8 * struct.calcsize(fmt))) - 1:
            out += bytes([head]) + struct.pack(fmt, n)
            return
    raise ValueError(f"msgpack: length {n} too large")


def _pack_str(s: str, out: bytearray):
    data = s.encode("utf-8")
    _pack_len(len(data), 0xa0, 0x1f, ((0xd9, ">B"), (0xda, ">H"), (0xdb, ">I")), out)
    out += data


def _pack_bin(data: bytes, out: bytearray):
    _pack_len(len(data), None, 0, ((0xc4, ">B"), (0xc5, ">H"), (0xc6, ">I")), out)
    out += data


def _pack_ext(code: int, data: bytes, out: bytearray):
    fix = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}.get(len(data))
    if fix is not None:
        out.append(fix)
    else:
        _pack_len(len(data), None, 0, ((0xc7, ">B"), (0xc8, ">H"), (0xc9, ">I")), out)
    out += struct.pack(">b", code) + data


def _ndarray_bytes(a: np.ndarray) -> bytes:
    """flax's ``_ndarray_to_bytes``: msgpack of (shape, dtype name, bytes)."""
    if a.dtype.hasobject or a.dtype.fields is not None:
        raise ValueError("msgpack: object and structured dtypes are not serialized")
    name = "bfloat16" if isinstance(a, BFloat16) else a.dtype.name
    tpl = bytearray(b"\x93")  # a fixarray of three
    _pack(list(a.shape), tpl)
    _pack_str(name, tpl)
    _pack_bin(a.view(np.ndarray).tobytes("C"), tpl)
    return bytes(tpl)


def _pack(obj, out: bytearray):
    if obj is None:
        out.append(0xc0)
    elif obj is True or obj is False:
        out.append(0xc3 if obj else 0xc2)
    elif type(obj) is int:
        _pack_int(obj, out)
    elif type(obj) is float:
        out += b"\xcb" + struct.pack(">d", obj)
    elif type(obj) is str:
        _pack_str(obj, out)
    elif type(obj) in (bytes, bytearray, memoryview):
        _pack_bin(bytes(obj), out)
    elif type(obj) is dict:
        _pack_len(len(obj), 0x80, 0x0f, ((0xde, ">H"), (0xdf, ">I")), out)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    elif type(obj) in (list, tuple):
        _pack_len(len(obj), 0x90, 0x0f, ((0xdc, ">H"), (0xdd, ">I")), out)
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, torch.Tensor):
        _pack(from_tensor(obj), out)
    elif isinstance(obj, np.ndarray):
        _pack_ext(EXT_NDARRAY, _ndarray_bytes(obj), out)
    elif isinstance(obj, np.generic):
        _pack_ext(EXT_NPSCALAR, _ndarray_bytes(np.asarray(obj)), out)
    elif type(obj) is complex:
        pair = bytearray()
        _pack([obj.real, obj.imag], pair)
        _pack_ext(EXT_COMPLEX, bytes(pair), out)
    else:
        raise ValueError(f"msgpack: cannot serialize {type(obj).__name__}")


def _chunk(a: np.ndarray, max_chunk: int) -> dict:
    """flax's ``_chunk``: a flat array's slices of at most ``max_chunk``
    bytes, with the shape."""
    size = max(1, int(max_chunk / a.dtype.itemsize))
    flat = a.reshape(-1)
    return {_CHUNKED: True, "shape": {str(i): int(d) for i, d in enumerate(a.shape)},
            "chunks": {str(j): flat[i:i + size]
                       for j, i in enumerate(range(0, flat.size, size))}}


def _chunk_leaves(tree, max_chunk: int):
    """flax's ``_chunk_array_leaves_in_place``, as a new tree: an array
    leaf (a tensor too) that is the root or a dict's value is split when it
    holds more than ``max_chunk`` bytes."""
    if isinstance(tree, torch.Tensor):
        tree = from_tensor(tree)
    if isinstance(tree, np.ndarray):
        return _chunk(tree, max_chunk) if tree.size * tree.dtype.itemsize > max_chunk else tree
    if isinstance(tree, dict):
        return {k: _chunk_leaves(v, max_chunk) for k, v in tree.items()}
    return tree


def serialize(tree, max_chunk: int = MAX_CHUNK_SIZE) -> bytes:
    """``flax.serialization.msgpack_serialize(tree, in_place=True)``: a tree
    of dicts (str keys), lists, Python scalars, numpy arrays and scalars
    and tensors -> bytes, arrays over ``max_chunk`` bytes chunked."""
    out = bytearray()
    _pack(_chunk_leaves(tree, max_chunk), out)
    return bytes(out)
