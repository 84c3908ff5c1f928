"""A reader and a writer of flax's msgpack parameter files, with no msgpack
package.

`flax.serialization.to_bytes(params)` writes the parameter tree as
msgpack: maps of str keys, arrays as ext type 1 (a packed (shape, dtype
name, C-order bytes) triple), numpy scalars as ext type 3 (the same
triple). `load_flax` decodes that subset (nil, bool, int, float, str,
bin, array, map, ext 1 and ext 3) into nested dicts of CPU tensors; a
"bfloat16" dtype name becomes torch.bfloat16. Any other ext code raises,
as does a truncated or over-long buffer. `dump_flax` writes the same
subset (maps of str keys, arrays as ext 1), so `flax.serialization.
from_bytes` reads its bytes back bit for bit; its bytes need not equal
flax's own (msgpack lets a value take several encodings).
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


def _pack_uint(out, n, fix_max, codes):
    """Append the header of a sized msgpack item: a fix form below
    fix_max (`codes[0]` | n), else the smallest of the 8, 16 and 32-bit
    forms `codes[1:]` (None where msgpack has none)."""
    if n < fix_max:
        out.append(codes[0] | n)
        return
    for code, width in zip(codes[1:], (1, 2, 4)):
        if code is not None and n < 1 << (8 * width):
            out.append(code)
            out += n.to_bytes(width, "big")
            return
    raise ValueError(f"msgpack: size {n} is too large")


def _pack(out, value):
    if value is None:
        out.append(0xC0)
    elif isinstance(value, bool):
        out.append(0xC3 if value else 0xC2)
    elif isinstance(value, int):
        if 0 <= value <= 0x7F or -32 <= value < 0:
            out += value.to_bytes(1, "big", signed=value < 0)
        elif value >= 0:
            out.append(0xCF)
            out += value.to_bytes(8, "big")
        else:
            out.append(0xD3)
            out += value.to_bytes(8, "big", signed=True)
    elif isinstance(value, float):
        out.append(0xCB)
        out += struct.pack(">d", value)
    elif isinstance(value, str):
        data = value.encode("utf-8")
        _pack_uint(out, len(data), 32, (0xA0, 0xD9, 0xDA, 0xDB))
        out += data
    elif isinstance(value, (bytes, bytearray, memoryview)):
        data = bytes(value)
        _pack_uint(out, len(data), 0, (0, 0xC4, 0xC5, 0xC6))
        out += data
    elif isinstance(value, (list, tuple)):
        _pack_uint(out, len(value), 16, (0x90, None, 0xDC, 0xDD))
        for v in value:
            _pack(out, v)
    elif isinstance(value, dict):
        _pack_uint(out, len(value), 16, (0x80, None, 0xDE, 0xDF))
        for k, v in value.items():
            if not isinstance(k, str):
                raise TypeError(f"msgpack: flax keys are str, got {k!r}")
            _pack(out, k)
            _pack(out, v)
    elif torch.is_tensor(value) or isinstance(value, np.ndarray):
        _pack_ext(out, EXT_NDARRAY, _ndarray_bytes(value))
    elif isinstance(value, np.generic):
        _pack_ext(out, EXT_NPSCALAR, _ndarray_bytes(np.asarray(value)))
    else:
        raise TypeError(f"msgpack: cannot write {type(value).__name__}")


def _pack_ext(out, code, data):
    n = len(data)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        out.append(fixed[n])
    else:
        _pack_uint(out, n, 0, (0, 0xC7, 0xC8, 0xC9))
    out += code.to_bytes(1, "big", signed=True)
    out += data


def _ndarray_bytes(a):
    """flax's `_ndarray_to_bytes`: msgpack (shape, dtype name, C bytes).
    A bfloat16 tensor is written under the name "bfloat16"."""
    if torch.is_tensor(a):
        t = a.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            shape, name = tuple(t.shape), "bfloat16"
            buf = t.view(torch.int16).numpy().tobytes()
        else:
            a = t.numpy()
    if isinstance(a, np.ndarray):
        if a.dtype.hasobject or a.dtype.fields is not None:
            raise TypeError(f"msgpack: cannot write an array of {a.dtype}")
        shape, name, buf = a.shape, a.dtype.name, a.tobytes("C")
    out = bytearray()
    _pack(out, [list(shape), name, buf])
    return bytes(out)


def dump_flax(tree):
    """The tree (nested dicts of str keys with tensor, numpy array or
    scalar leaves) as flax msgpack bytes, which
    `flax.serialization.from_bytes` and `load_flax` read."""
    out = bytearray()
    _pack(out, tree)
    return bytes(out)
