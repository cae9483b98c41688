"""A numpy-only codec of the ``.msgpack`` checkpoints the JAX package
writes and reads (``flax.serialization.to_bytes`` / ``from_bytes``,
``adaa_tpu/utils/checkpoints.py``).

The port reads and writes them without the ``msgpack`` module. ``unpackb`` decodes
the msgpack format (https://github.com/msgpack/msgpack/blob/master/spec.md):
maps, arrays (as lists), strings, bin, ints, floats, nil and bools, and
flax's extension types: an ndarray (type 1) is ``(shape, dtype name,
row-major bytes)`` packed inside the ext record, a numpy scalar (type 3)
the same with shape ``()``, a complex (type 2) ``(real, imag)``.
``restore`` also joins the arrays flax split into chunks of 2**30 bytes,
as ``flax.serialization.msgpack_restore`` does, and ``load`` reads a file:
the result is flax's variable tree, a nested dict of numpy arrays.

``packb`` encodes as ``msgpack.packb(obj, use_bin_type=True)`` does, each
value in its smallest format, with a numpy array as flax's ndarray
extension; ``serialize`` first splits arrays over 2**30 bytes into
flax's chunks (``flax.serialization.msgpack_serialize``), and ``save``
writes a variable tree to a file that ``flax.serialization.from_bytes``
reads.
"""
from __future__ import annotations

import struct
from pathlib import Path
from typing import Any, Union

import numpy as np

# flax.serialization._MsgpackExtType
EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3

_CONST = {0xC0: None, 0xC2: False, 0xC3: True}
_NUMBER = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
           0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
# first byte -> (kind, format of the length that follows)
_SIZED = {0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
          0xC7: ("ext", ">B"), 0xC8: ("ext", ">H"), 0xC9: ("ext", ">I"),
          0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
          0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
          0xDE: ("map", ">H"), 0xDF: ("map", ">I")}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.data):
            raise ValueError(f"truncated msgpack data: {n} bytes wanted at offset {self.pos}")
        out = self.data[self.pos:end]
        self.pos = end
        return out

    def number(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if b <= 0x8F:
            return self.sized("map", b & 0x0F)
        if b <= 0x9F:
            return self.sized("array", b & 0x0F)
        if b <= 0xBF:
            return self.sized("str", b & 0x1F)
        if b in _CONST:
            return _CONST[b]
        if b in _NUMBER:
            return self.number(_NUMBER[b])
        if b in _SIZED:
            kind, fmt = _SIZED[b]
            return self.sized(kind, self.number(fmt))
        if b in _FIXEXT:
            return self.sized("ext", _FIXEXT[b])
        raise ValueError(f"invalid msgpack byte 0x{b:02x} at offset {self.pos - 1}")

    def sized(self, kind: str, n: int) -> Any:
        if kind == "map":
            out = {}
            for _ in range(n):
                key = self.value()
                out[key] = self.value()
            return out
        if kind == "array":
            return [self.value() for _ in range(n)]
        if kind == "str":
            return str(self.take(n), "utf-8")
        if kind == "bin":
            return bytes(self.take(n))
        code = self.number(">b")
        return _ext(code, self.take(n))


def _dtype_array(buffer: memoryview, name: str) -> np.ndarray:
    """The row-major buffer as a numpy array of dtype ``name``; bfloat16,
    which numpy lacks, widens exactly to float32."""
    if name == "bfloat16":
        bits = np.frombuffer(buffer, np.dtype("<u2")).astype(np.uint32) << 16
        return bits.view(np.float32)
    return np.frombuffer(buffer, np.dtype(name))


def _ext(code: int, payload: memoryview) -> Any:
    if code in (EXT_NDARRAY, EXT_NPSCALAR):
        shape, name, buffer = _Reader(payload).value()
        name = name.decode() if isinstance(name, bytes) else name
        arr = _dtype_array(memoryview(buffer), name).reshape(shape)
        return arr if code == EXT_NDARRAY else arr[()]
    if code == EXT_COMPLEX:
        real, imag = _Reader(payload).value()
        return complex(real, imag)
    raise ValueError(f"unknown msgpack extension type {code}")


def unpackb(data: bytes) -> Any:
    """Decode one msgpack object (``msgpack.unpackb(data, raw=False)``,
    with flax's extension types decoded)."""
    reader = _Reader(data)
    out = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError(f"{len(reader.data) - reader.pos} bytes of extra data after the object")
    return out


def _unchunk(tree: Any) -> Any:
    """Join flax's chunked arrays (``{"__msgpack_chunked_array__": True,
    "shape": {"0": ...}, "chunks": {"0": ...}}``) back into arrays."""
    if not isinstance(tree, dict):
        return tree
    if "__msgpack_chunked_array__" in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def restore(data: bytes) -> Any:
    """``flax.serialization.msgpack_restore``: the state dict of the bytes."""
    return _unchunk(unpackb(data))


def load(path: Union[str, Path]) -> Any:
    """The variable tree of a ``.msgpack`` checkpoint."""
    return restore(Path(path).read_bytes())


MAX_CHUNK_SIZE = 2 ** 30  # flax.serialization.MAX_CHUNK_SIZE (bytes)


def _head(out: bytearray, n: int, fix: int, fix_max: int, codes) -> None:
    """A sized value's header: the fix format below ``fix_max``, else the
    smallest of ``codes`` = ((first byte, length format), ...)."""
    if fix is not None and n < fix_max:
        out.append(fix | n)
        return
    for code, fmt in codes:
        if n < 1 << (8 * struct.calcsize(fmt)):
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"msgpack value of {n} entries or bytes is too large")


def _int(out: bytearray, v: int) -> None:
    if 0 <= v < 0x80 or -32 <= v < 0:
        out += struct.pack(">b" if v < 0 else ">B", v)
        return
    codes = (((0xCC, ">B"), (0xCD, ">H"), (0xCE, ">I"), (0xCF, ">Q")) if v >= 0 else
             ((0xD0, ">b"), (0xD1, ">h"), (0xD2, ">i"), (0xD3, ">q")))
    for code, fmt in codes:
        try:
            packed = struct.pack(fmt, v)
        except struct.error:
            continue
        out.append(code)
        out += packed
        return
    raise ValueError(f"integer {v} does not fit msgpack's 64 bits")


def _ndarray_bytes(arr: np.ndarray) -> bytes:
    """flax's ``_ndarray_to_bytes``: (shape, dtype name, row-major bytes)."""
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes cannot be serialized")
    return packb((list(arr.shape), arr.dtype.name, arr.tobytes("C")))


def _pack(out: bytearray, obj: Any) -> None:
    if obj is None or isinstance(obj, bool):
        out.append({None: 0xC0, False: 0xC2, True: 0xC3}[obj])
    elif isinstance(obj, np.ndarray):
        _pack_ext(out, EXT_NDARRAY, _ndarray_bytes(obj))
    elif isinstance(obj, np.generic):
        _pack_ext(out, EXT_NPSCALAR, _ndarray_bytes(np.asarray(obj)))
    elif isinstance(obj, int):
        _int(out, obj)
    elif isinstance(obj, float):
        out.append(0xCB)
        out += struct.pack(">d", obj)
    elif isinstance(obj, complex):
        _pack_ext(out, EXT_COMPLEX, packb((obj.real, obj.imag)))
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _head(out, len(data), 0xA0, 32, ((0xD9, ">B"), (0xDA, ">H"), (0xDB, ">I")))
        out += data
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = bytes(obj)
        _head(out, len(data), None, 0, ((0xC4, ">B"), (0xC5, ">H"), (0xC6, ">I")))
        out += data
    elif isinstance(obj, (list, tuple)):
        _head(out, len(obj), 0x90, 16, ((0xDC, ">H"), (0xDD, ">I")))
        for v in obj:
            _pack(out, v)
    elif isinstance(obj, dict):
        _head(out, len(obj), 0x80, 16, ((0xDE, ">H"), (0xDF, ">I")))
        for k, v in obj.items():
            _pack(out, k)
            _pack(out, v)
    else:
        raise TypeError(f"cannot serialize {type(obj).__name__} to msgpack")


def _pack_ext(out: bytearray, code: int, data: bytes) -> None:
    fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if len(data) in fixext:
        out.append(fixext[len(data)])
    else:
        _head(out, len(data), None, 0, ((0xC7, ">B"), (0xC8, ">H"), (0xC9, ">I")))
    out += struct.pack(">b", code)
    out += data


def packb(obj: Any) -> bytes:
    """Encode one object (``msgpack.packb(obj, use_bin_type=True)`` with
    flax's extension types for numpy arrays, scalars and complex numbers)."""
    out = bytearray()
    _pack(out, obj)
    return bytes(out)


def _chunked(tree: Any) -> Any:
    """flax's copy of the tree (dict keys sorted, as a pytree's are) with
    ``_chunk_array_leaves_in_place`` applied: arrays over MAX_CHUNK_SIZE
    bytes become ``{"__msgpack_chunked_array__": True, "shape": {"0":
    ...}, "chunks": {"0": ...}}``."""
    if isinstance(tree, dict):
        return {k: _chunked(tree[k]) for k in sorted(tree)}
    if isinstance(tree, np.ndarray) and tree.size * tree.dtype.itemsize > MAX_CHUNK_SIZE:
        size = max(1, MAX_CHUNK_SIZE // tree.dtype.itemsize)
        flat = tree.reshape(-1)
        chunks = [flat[i:i + size] for i in range(0, flat.size, size)]
        return {"__msgpack_chunked_array__": True,
                "shape": {str(i): d for i, d in enumerate(tree.shape)},
                "chunks": {str(i): c for i, c in enumerate(chunks)}}
    return tree


def serialize(tree: Any) -> bytes:
    """``flax.serialization.msgpack_serialize`` of a nested dict of numpy arrays."""
    return packb(_chunked(tree))


def save(path: Union[str, Path], tree: Any) -> None:
    """Write a variable tree as a ``.msgpack`` checkpoint."""
    Path(path).write_bytes(serialize(tree))
