"""A reader of flax's msgpack parameter files, with no msgpack package.

`flax.serialization.to_bytes(params)` writes the parameter tree as
msgpack: maps of str keys, arrays as ext type 1 (a packed (shape, dtype
name, C-order bytes) triple), numpy scalars as ext type 3 (the same
triple). `load_flax` decodes that subset (nil, bool, int, float, str,
bin, array, map, ext 1 and ext 3) into nested dicts of CPU tensors; a
"bfloat16" dtype name becomes torch.bfloat16. Any other ext code raises,
as does a truncated or over-long buffer. Reading only: a writer comes
with training.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

EXT_NDARRAY = 1
EXT_NPSCALAR = 3


class _Reader:
    def __init__(self, data):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n):
        if self.pos + n > len(self.data):
            raise ValueError("msgpack: truncated buffer")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def uint(self, n):
        return int.from_bytes(self.take(n), "big")

    def sint(self, n):
        return int.from_bytes(self.take(n), "big", signed=True)

    def value(self):
        b = self.uint(1)
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F)
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if b in (0xC4, 0xC5, 0xC6):  # bin 8 / 16 / 32
            return bytes(self.take(self.uint(1 << (b - 0xC4))))
        if b in (0xC7, 0xC8, 0xC9):  # ext 8 / 16 / 32
            n = self.uint(1 << (b - 0xC7))
            return self.ext(self.sint(1), n)
        if b == 0xCA:
            return struct.unpack(">f", self.take(4))[0]
        if b == 0xCB:
            return struct.unpack(">d", self.take(8))[0]
        if 0xCC <= b <= 0xCF:  # uint 8 / 16 / 32 / 64
            return self.uint(1 << (b - 0xCC))
        if 0xD0 <= b <= 0xD3:  # int 8 / 16 / 32 / 64
            return self.sint(1 << (b - 0xD0))
        if 0xD4 <= b <= 0xD8:  # fixext 1 / 2 / 4 / 8 / 16
            return self.ext(self.sint(1), 1 << (b - 0xD4))
        if b in (0xD9, 0xDA, 0xDB):  # str 8 / 16 / 32
            return self.str(self.uint(1 << (b - 0xD9)))
        if b in (0xDC, 0xDD):  # array 16 / 32
            return self.array(self.uint(2 << (b - 0xDC)))
        if b in (0xDE, 0xDF):  # map 16 / 32
            return self.map(self.uint(2 << (b - 0xDE)))
        raise ValueError(f"msgpack: unknown type byte 0x{b:02x}")

    def str(self, n):
        return str(self.take(n), "utf-8")

    def array(self, n):
        return [self.value() for _ in range(n)]

    def map(self, n):
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out

    def ext(self, code, n):
        data = self.take(n)
        if code == EXT_NDARRAY:
            return _ndarray(data)
        if code == EXT_NPSCALAR:
            return _ndarray(data).reshape(())
        raise ValueError(f"msgpack: ext type {code} is not a flax array "
                         "(only 1, ndarray, and 3, numpy scalar, are read)")


def _unpack(data):
    reader = _Reader(data)
    out = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError(f"msgpack: {len(reader.data) - reader.pos} bytes "
                         "after the value")
    return out


def _ndarray(data):
    """flax's ndarray encoding: msgpack (shape, dtype name, C bytes)."""
    shape, name, buf = _unpack(data)
    if isinstance(name, bytes):
        name = name.decode()
    if name == "bfloat16":
        flat = torch.frombuffer(bytearray(buf), dtype=torch.bfloat16)
    else:
        flat = torch.from_numpy(np.frombuffer(buf, np.dtype(name)).copy())
    return flat.reshape(tuple(shape))


def load_flax(data):
    """flax msgpack bytes (`flax.serialization.to_bytes`) -> the tree as
    nested dicts with CPU tensor leaves."""
    return _unpack(data)
