"""A msgpack reader for the JAX package's model snapshots, in numpy alone.

The JAX package writes a snapshot with flax's ``serialization.to_bytes``:
msgpack of the variable tree (nested maps with string keys), each array
an extension of type 1 whose payload is itself msgpack of (shape, dtype
name, C-order bytes); a numpy scalar is the same under type 3.
:func:`unpackb` decodes what flax writes: maps, arrays, strings, binary,
integers, floats, nil, booleans and those extensions, into dicts, lists,
numpy arrays and Python scalars, as ``flax.serialization.msgpack_restore``
does. A bfloat16 array (numpy has no such dtype) comes back as float32,
which holds every bfloat16 value exactly. Arrays past 2**30 bytes, which
flax splits into chunks, are left as flax's chunk maps: no model here
has one.
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np

_EXT_NDARRAY = 1
_EXT_COMPLEX = 2
_EXT_NPSCALAR = 3
# type byte -> value, struct format, (length format, reader), or length
_SIMPLE = {0xC0: None, 0xC2: False, 0xC3: True}
_SCALAR = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
           0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
_SIZED = {0xC4: (">B", "binary"), 0xC5: (">H", "binary"), 0xC6: (">I", "binary"),
          0xD9: (">B", "text"), 0xDA: (">H", "text"), 0xDB: (">I", "text"),
          0xDC: (">H", "array"), 0xDD: (">I", "array"), 0xDE: (">H", "map"), 0xDF: (">I", "map")}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
_EXT = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError(f"msgpack: truncated at byte {self.pos} (wanted {n} more)")
        out = self.data[self.pos: self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self) -> Any:
        b = self.unpack(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.text(b & 0x1F)
        if b in _SIMPLE:
            return _SIMPLE[b]
        if b in _SCALAR:
            return self.unpack(_SCALAR[b])
        if b in _SIZED:
            fmt, read = _SIZED[b]
            return getattr(self, read)(self.unpack(fmt))
        if b in _FIXEXT:
            return self.ext(_FIXEXT[b])
        if b in _EXT:
            return self.ext(self.unpack(_EXT[b]))
        raise ValueError(f"msgpack: type byte {b:#04x} at byte {self.pos - 1} is not used")

    def text(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def binary(self, n: int) -> bytes:
        return bytes(self.take(n))

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out

    def ext(self, n: int) -> Any:
        code = self.unpack(">b")
        payload = bytes(self.take(n))
        if code == _EXT_NDARRAY:
            return _ndarray(payload)
        if code == _EXT_NPSCALAR:
            return _ndarray(payload)[()]
        if code == _EXT_COMPLEX:
            real, imag = unpackb(payload)
            return complex(real, imag)
        raise ValueError(f"msgpack: extension type {code} is not one flax writes")


def _ndarray(payload: bytes) -> np.ndarray:
    shape, dtype, buf = unpackb(payload)
    dtype = dtype.decode() if isinstance(dtype, bytes) else dtype
    if dtype == "bfloat16":
        # the high half of a float32: exact
        bits = np.frombuffer(buf, dtype="<u2").astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape).copy()


def unpackb(data: bytes) -> Any:
    """Decode one msgpack value that spans all of ``data``."""
    r = _Reader(data)
    out = r.value()
    if r.pos != len(r.data):
        raise ValueError(f"msgpack: {len(r.data) - r.pos} bytes after the value")
    return out
