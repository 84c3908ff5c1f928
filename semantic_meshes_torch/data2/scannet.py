"""ScanNet `.sens` RGB-D sensor-stream parser.

Own copy of the JAX package's `semantic_meshes/data2/scannet.py`. The
native reader (the port's host IO library, `native.py`) is the only path
of `SensFile(filename)`; a failed build raises. The pure-python reader
stays as the plain version, `SensFile.plain(filename)`, which the tests
compare against.

Reimplementation of the stream format consumed by the reference
(ref: python/semantic_meshes/data2/scannet.py:18-119; format origin:
github.com/ScanNet/ScanNet SensReader, sensor stream version 4).

Layout (little-endian):
  header: u32 version(==4) | u64 strlen | sensor_name bytes |
          4x (16 f32 row-major 4x4): intrinsic_color, extrinsic_color,
          intrinsic_depth, extrinsic_depth |
          i32 color_compression | i32 depth_compression |
          u32 color_width | u32 color_height | u32 depth_width |
          u32 depth_height | f32 depth_shift | u64 num_frames
  frame:  16 f32 camera_to_world | u64 timestamp_color | u64 timestamp_depth |
          u64 color_bytes | u64 depth_bytes | color blob | depth blob

Frames are sorted by color timestamp after load, matching the reference
(scannet.py:77).
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

COMPRESSION_TYPE_COLOR = {-1: "unknown", 0: "raw", 1: "png", 2: "jpeg"}
COMPRESSION_TYPE_DEPTH = {
    -1: "unknown",
    0: "raw_ushort",
    1: "zlib_ushort",
    2: "occi_ushort",
}


class SensError(ValueError):
    """Malformed/truncated .sens stream. Every parse failure raises this
    (mutation fuzzing found raw struct.error/KeyError/MemoryError leaking
    from the old reads — tests/test_io.py::TestSensFuzz)."""


def _compression_name(table, code, what):
    try:
        return table[code]
    except KeyError:
        raise SensError(
            f"invalid {what} compression code {code} in .sens header"
        ) from None


def _file_size(f):
    try:
        return os.fstat(f.fileno()).st_size
    except (OSError, AttributeError):
        return None


def _read_exact(f, n, what, size=None):
    """Read exactly n bytes or raise SensError. The size guard rejects
    absurd declared lengths BEFORE f.read tries to allocate them."""
    if n < 0 or (size is not None and n > size):
        raise SensError(f"implausible {what} length {n} in .sens stream")
    data = f.read(n)
    if len(data) != n:
        raise SensError(f"truncated .sens stream reading {what}")
    return data


def _read_mat4(f, size=None):
    return np.frombuffer(
        _read_exact(f, 64, "4x4 matrix", size), dtype="<f4"
    ).reshape(4, 4).copy()


class RGBDFrame:
    """One RGB-D frame: pose + compressed color/depth payloads."""

    __slots__ = (
        "camera_to_world",
        "timestamp_color",
        "timestamp_depth",
        "color_size_bytes",
        "depth_size_bytes",
        "color_data",
        "depth_data",
    )

    def __init__(self, f):
        size = _file_size(f)
        self.camera_to_world = _read_mat4(f, size)
        (
            self.timestamp_color,
            self.timestamp_depth,
            self.color_size_bytes,
            self.depth_size_bytes,
        ) = struct.unpack("<QQQQ", _read_exact(f, 32, "frame header", size))
        self.color_data = _read_exact(
            f, self.color_size_bytes, "color blob", size
        )
        self.depth_data = _read_exact(
            f, self.depth_size_bytes, "depth blob", size
        )

    def decompress_color(self, compression_type="jpeg"):
        if compression_type != "jpeg":
            raise NotImplementedError(
                f"color compression {compression_type!r} not supported"
            )
        return self.decompress_color_jpeg()

    def decompress_color_jpeg(self):
        from ..io.image import imread

        return imread(self.color_data)

    def decompress_depth(self, compression_type="zlib_ushort"):
        if compression_type != "zlib_ushort":
            raise NotImplementedError(
                f"depth compression {compression_type!r} not supported"
            )
        return self.decompress_depth_zlib()

    def decompress_depth_zlib(self):
        return zlib.decompress(self.depth_data)


class _IndexedFrame:
    """RGBDFrame view over the whole-file buffer (native fast path)."""

    __slots__ = (
        "camera_to_world",
        "timestamp_color",
        "timestamp_depth",
        "color_size_bytes",
        "depth_size_bytes",
        "_buf",
        "_color_off",
        "_depth_off",
    )

    def __init__(self, buf, rec):
        self.camera_to_world = (
            np.asarray(rec["camera_to_world"], np.float32).reshape(4, 4)
        )
        self.timestamp_color = int(rec["timestamp_color"])
        self.timestamp_depth = int(rec["timestamp_depth"])
        self.color_size_bytes = int(rec["color_size"])
        self.depth_size_bytes = int(rec["depth_size"])
        self._buf = buf
        self._color_off = int(rec["color_offset"])
        self._depth_off = int(rec["depth_offset"])

    @property
    def color_data(self):
        return self._buf[self._color_off:self._color_off + self.color_size_bytes]

    @property
    def depth_data(self):
        return self._buf[self._depth_off:self._depth_off + self.depth_size_bytes]

    decompress_color = RGBDFrame.decompress_color
    decompress_color_jpeg = RGBDFrame.decompress_color_jpeg
    decompress_depth = RGBDFrame.decompress_depth
    decompress_depth_zlib = RGBDFrame.decompress_depth_zlib


class SensFile:
    """Parsed .sens stream (version 4).

    `SensFile(filename)` reads through the native indexer (threaded C++,
    native.py): one pass over the file's buffer, frames as views into it
    that keep it alive. `SensFile.plain(filename)` is the pure-python
    reader. Both sort the frames by colour timestamp.
    """

    VERSION = 4

    def __init__(self, filename, max_frames=None):
        self.version = self.VERSION
        self._try_native(filename, max_frames)
        self.frames.sort(key=lambda fr: fr.timestamp_color)

    @classmethod
    def plain(cls, filename, max_frames=None):
        """The same stream through the pure-python reader (the plain
        version of the native one)."""
        self = cls.__new__(cls)
        self.version = cls.VERSION
        self._read_python(filename, max_frames)
        self.frames.sort(key=lambda fr: fr.timestamp_color)
        return self

    def _read_python(self, filename, max_frames):
        with open(filename, "rb") as f:
            size = _file_size(f)
            (version,) = struct.unpack(
                "<I", _read_exact(f, 4, "version", size)
            )
            if version != self.VERSION:
                raise SensError(
                    f"{filename}: unsupported .sens version {version}"
                )
            (strlen,) = struct.unpack(
                "<Q", _read_exact(f, 8, "name length", size)
            )
            self.sensor_name = _read_exact(
                f, strlen, "sensor name", size
            ).decode(errors="replace")
            self.intrinsic_color = _read_mat4(f, size)
            self.extrinsic_color = _read_mat4(f, size)
            self.intrinsic_depth = _read_mat4(f, size)
            self.extrinsic_depth = _read_mat4(f, size)
            (color_comp, depth_comp) = struct.unpack(
                "<ii", _read_exact(f, 8, "compression codes", size)
            )
            self.color_compression_type = _compression_name(
                COMPRESSION_TYPE_COLOR, color_comp, "color"
            )
            self.depth_compression_type = _compression_name(
                COMPRESSION_TYPE_DEPTH, depth_comp, "depth"
            )
            (
                self.color_width,
                self.color_height,
                self.depth_width,
                self.depth_height,
            ) = struct.unpack("<IIII", _read_exact(f, 16, "resolutions", size))
            (self.depth_shift,) = struct.unpack(
                "<f", _read_exact(f, 4, "depth shift", size)
            )
            (num_frames,) = struct.unpack(
                "<Q", _read_exact(f, 8, "frame count", size)
            )
            if max_frames is not None:
                num_frames = min(num_frames, max_frames)
            self.frames = [RGBDFrame(f) for _ in range(num_frames)]

    def _try_native(self, filename, max_frames):
        """The native reader (JAX scannet.py:228-268); a failed build of
        the host library raises, a malformed stream raises SensError."""
        from .. import native

        with open(filename, "rb") as f:
            data = f.read()
        try:
            hdr = native.parse_header(data)
            records = native.index_frames(
                data, hdr.frames_start,
                hdr.num_frames if max_frames is None
                else min(hdr.num_frames, max_frames),
            )
        except SensError:
            raise
        except ValueError as e:  # typed-error contract: SensError
            raise SensError(f"{filename}: {e}") from None
        self.sensor_name = hdr.sensor_name.decode(errors="replace")
        for attr in ("intrinsic_color", "extrinsic_color", "intrinsic_depth",
                     "extrinsic_depth"):
            setattr(
                self, attr,
                np.asarray(getattr(hdr, attr), np.float32).reshape(4, 4),
            )
        self.color_compression_type = _compression_name(
            COMPRESSION_TYPE_COLOR, hdr.color_compression, "color"
        )
        self.depth_compression_type = _compression_name(
            COMPRESSION_TYPE_DEPTH, hdr.depth_compression, "depth"
        )
        self.color_width = hdr.color_width
        self.color_height = hdr.color_height
        self.depth_width = hdr.depth_width
        self.depth_height = hdr.depth_height
        self.depth_shift = hdr.depth_shift
        self._buf = data
        self._records = records
        self.frames = [_IndexedFrame(data, r) for r in records]

    def decode_all_depths(self):
        """All depth frames as one (N, depth_height, depth_width) uint16
        array, in frame order: zlib on every hardware thread on the native
        path, one zlib.decompress a frame on the plain one."""
        from .. import native

        pixels = self.depth_height * self.depth_width
        if getattr(self, "_records", None) is not None:
            order = np.argsort(self._records["timestamp_color"], kind="stable")
            recs = self._records[order]
            try:
                out = native.decode_depth_batch(
                    self._buf, recs["depth_offset"], recs["depth_size"],
                    pixels)
            except ValueError as e:  # typed-error contract: SensError
                raise SensError(str(e)) from None
            return out.reshape(-1, self.depth_height, self.depth_width)
        return np.stack(
            [
                np.frombuffer(
                    fr.decompress_depth(self.depth_compression_type), "<u2"
                ).reshape(self.depth_height, self.depth_width)
                for fr in self.frames
            ]
        )

    # -- exporters (parity with the reference utility methods) ---------------

    def depth_image(self, frame):
        raw = frame.decompress_depth(self.depth_compression_type)
        return np.frombuffer(raw, dtype="<u2").reshape(
            self.depth_height, self.depth_width
        )

    def export_depth_images(self, output_path, image_size=None, frame_skip=1):
        from ..io.image import imwrite

        os.makedirs(output_path, exist_ok=True)
        for i in range(0, len(self.frames), frame_skip):
            depth = self.depth_image(self.frames[i])
            if image_size is not None:
                depth = _resize_nearest(depth, image_size)
            imwrite(os.path.join(output_path, f"{i}.png"), depth)

    def export_color_images(self, output_path, image_size=None, frame_skip=1):
        from ..io.image import imwrite

        os.makedirs(output_path, exist_ok=True)
        for i in range(0, len(self.frames), frame_skip):
            color = self.frames[i].decompress_color(self.color_compression_type)
            if image_size is not None:
                color = _resize_nearest(color, image_size)
            imwrite(os.path.join(output_path, f"{i}.jpg"), color)

    def export_poses(self, output_path, frame_skip=1):
        os.makedirs(output_path, exist_ok=True)
        for i in range(0, len(self.frames), frame_skip):
            np.savetxt(
                os.path.join(output_path, f"{i}.txt"),
                self.frames[i].camera_to_world,
                fmt="%f",
            )

    def export_intrinsics(self, output_path):
        os.makedirs(output_path, exist_ok=True)
        for name, mat in (
            ("intrinsic_color", self.intrinsic_color),
            ("extrinsic_color", self.extrinsic_color),
            ("intrinsic_depth", self.intrinsic_depth),
            ("extrinsic_depth", self.extrinsic_depth),
        ):
            np.savetxt(os.path.join(output_path, f"{name}.txt"), mat, fmt="%f")


def _resize_nearest(img, hw):
    h, w = hw
    ys = (np.arange(h) * img.shape[0] / h).astype(np.int64)
    xs = (np.arange(w) * img.shape[1] / w).astype(np.int64)
    return img[ys][:, xs]


def write_sens(filename, sensor_name, intrinsic_color, extrinsic_color,
               intrinsic_depth, extrinsic_depth, color_hw, depth_hw,
               depth_shift, frames):
    """Write a .sens stream (v4) — used by tests to synthesize fixtures.

    frames: list of dicts with keys camera_to_world (4,4), timestamp_color,
    timestamp_depth, color_data (bytes), depth_data (bytes).
    """
    with open(filename, "wb") as f:
        f.write(struct.pack("<I", SensFile.VERSION))
        name = sensor_name.encode()
        f.write(struct.pack("<Q", len(name)))
        f.write(name)
        for mat in (intrinsic_color, extrinsic_color, intrinsic_depth,
                    extrinsic_depth):
            f.write(np.asarray(mat, "<f4").tobytes())
        f.write(struct.pack("<ii", 2, 1))  # jpeg color, zlib_ushort depth
        f.write(
            struct.pack(
                "<IIII", color_hw[1], color_hw[0], depth_hw[1], depth_hw[0]
            )
        )
        f.write(struct.pack("<f", depth_shift))
        f.write(struct.pack("<Q", len(frames)))
        for fr in frames:
            f.write(np.asarray(fr["camera_to_world"], "<f4").tobytes())
            f.write(
                struct.pack(
                    "<QQQQ",
                    fr["timestamp_color"],
                    fr["timestamp_depth"],
                    len(fr["color_data"]),
                    len(fr["depth_data"]),
                )
            )
            f.write(fr["color_data"])
            f.write(fr["depth_data"])
