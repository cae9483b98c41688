"""A numpy-only decoder of the ``.msgpack`` checkpoints the JAX package
writes (``flax.serialization.to_bytes``, ``adaa_tpu/utils/checkpoints.py``).

The port reads them without the ``msgpack`` module. ``unpackb`` decodes
the msgpack format (https://github.com/msgpack/msgpack/blob/master/spec.md):
maps, arrays (as lists), strings, bin, ints, floats, nil and bools, and
flax's extension types: an ndarray (type 1) is ``(shape, dtype name,
row-major bytes)`` packed inside the ext record, a numpy scalar (type 3)
the same with shape ``()``, a complex (type 2) ``(real, imag)``.
``restore`` also joins the arrays flax split into chunks of 2**30 bytes,
as ``flax.serialization.msgpack_restore`` does, and ``load`` reads a file:
the result is flax's variable tree, a nested dict of numpy arrays.
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
