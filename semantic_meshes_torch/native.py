"""ctypes bridge to the port's host IO library (csrc/sens_io.cpp).

Own copy of the JAX package's `semantic_meshes/native.py`: the same
structs, dtypes, clamps on untrusted counts and `ValueError` contract.
Two differences: the library is built by `_build.build_host` (g++ and
zlib) into `build/torch_kernels/` the first time it is needed, and
`load()` raises when that build or the layout check fails, as the CUDA
kernels do (nothing falls back to Python); the depth batch runs on
std::thread workers, not OpenMP. The pure-Python
readers stay as the plain versions (`io.colmap.read_images_bin_plain`,
`data2.scannet.SensFile.plain`), which the tests compare against.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from . import _build

_lock = threading.Lock()
_lib = None

# keep in sync with struct FrameRecord in csrc/sens_io.cpp
FRAME_RECORD_DTYPE = np.dtype(
    [
        ("camera_to_world", "<f4", (16,)),
        ("timestamp_color", "<u8"),
        ("timestamp_depth", "<u8"),
        ("color_offset", "<u8"),
        ("color_size", "<u8"),
        ("depth_offset", "<u8"),
        ("depth_size", "<u8"),
    ]
)


# keep in sync with struct SensHeader in csrc/sens_io.cpp (ctypes lays it
# out with the C compiler's natural alignment)
class SensHeaderC(ctypes.Structure):
    _fields_ = [
        ("version", ctypes.c_uint32),
        ("intrinsic_color", ctypes.c_float * 16),
        ("extrinsic_color", ctypes.c_float * 16),
        ("intrinsic_depth", ctypes.c_float * 16),
        ("extrinsic_depth", ctypes.c_float * 16),
        ("color_compression", ctypes.c_int32),
        ("depth_compression", ctypes.c_int32),
        ("color_width", ctypes.c_uint32),
        ("color_height", ctypes.c_uint32),
        ("depth_width", ctypes.c_uint32),
        ("depth_height", ctypes.c_uint32),
        ("depth_shift", ctypes.c_float),
        ("num_frames", ctypes.c_uint64),
        ("frames_start", ctypes.c_uint64),
        ("sensor_name", ctypes.c_char * 256),
    ]


# keep in sync with struct ColmapImageRecord in csrc/sens_io.cpp
COLMAP_IMAGE_DTYPE = np.dtype(
    [
        ("image_id", "<i4"),
        ("camera_id", "<i4"),
        ("qvec", "<f8", (4,)),
        ("tvec", "<f8", (3,)),
        ("name_offset", "<u8"),
        ("name_length", "<u8"),
    ]
)


def _declare(lib):
    lib.sens_parse_header.restype = ctypes.c_int
    lib.sens_parse_header.argtypes = [
        ctypes.c_char_p, ctypes.c_uint64, ctypes.POINTER(SensHeaderC),
    ]
    lib.sens_index.restype = ctypes.c_int64
    lib.sens_index.argtypes = [
        ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint64,
        ctypes.c_void_p, ctypes.c_uint64,
    ]
    lib.sens_decode_depth_batch.restype = ctypes.c_int64
    lib.sens_decode_depth_batch.argtypes = [
        ctypes.c_char_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_uint64, ctypes.c_void_p,
    ]
    lib.colmap_index_images.restype = ctypes.c_int64
    lib.colmap_index_images.argtypes = [
        ctypes.c_char_p, ctypes.c_uint64, ctypes.c_void_p, ctypes.c_uint64,
    ]
    for probe in ("sens_header_size", "sens_record_size",
                  "colmap_image_record_size"):
        getattr(lib, probe).restype = ctypes.c_int
        getattr(lib, probe).argtypes = []


def load():
    """The loaded ctypes library, built first if needed. Raises
    RuntimeError when the build fails or a record layout disagrees
    between C and Python."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = _build.load_host("sens_io")
        _declare(lib)
        sizes = {
            "SensHeader": (lib.sens_header_size(),
                           ctypes.sizeof(SensHeaderC)),
            "FrameRecord": (lib.sens_record_size(),
                            FRAME_RECORD_DTYPE.itemsize),
            "ColmapImageRecord": (lib.colmap_image_record_size(),
                                  COLMAP_IMAGE_DTYPE.itemsize),
        }
        bad = {k: v for k, v in sizes.items() if v[0] != v[1]}
        if bad:
            raise RuntimeError(
                "host IO library record sizes disagree with native.py "
                f"(C, Python): {bad}")
        _lib = lib
        return _lib


def index_colmap_images(data: bytes):
    """Parse images.bin into a structured array (names decoded separately
    via the offset/length spans)."""
    lib = load()
    if len(data) < 8:
        raise ValueError("images.bin truncated")
    count = int(np.frombuffer(data, "<u8", count=1)[0])
    # count is untrusted: clamp to the most records the file could hold
    # (min 73 bytes each: fixed fields + empty name + point count) so a
    # corrupt header can't trigger a multi-GB allocation
    max_possible = (len(data) - 8) // 73
    if count > max_possible:
        raise ValueError(
            f"images.bin corrupt: claims {count} images, file fits "
            f"at most {max_possible}"
        )
    recs = np.zeros(count, dtype=COLMAP_IMAGE_DTYPE)
    n = lib.colmap_index_images(
        data, len(data), recs.ctypes.data_as(ctypes.c_void_p), count
    )
    if n < 0:
        raise ValueError(f"images.bin parse failed at image {-n - 1}")
    return recs[:n]


def parse_header(data: bytes):
    """The .sens header of `data` as a SensHeaderC."""
    lib = load()
    hdr = SensHeaderC()
    rc = lib.sens_parse_header(data, len(data), ctypes.byref(hdr))
    if rc != 0:
        raise ValueError(f".sens header parse failed (code {rc})")
    return hdr


def index_frames(data: bytes, frames_start: int, max_frames: int):
    """FRAME_RECORD_DTYPE records of up to `max_frames` frames."""
    lib = load()
    # max_frames comes from the untrusted header: clamp to the most frames
    # the stream could physically hold (96-byte fixed part per frame)
    max_possible = max(len(data) - int(frames_start), 0) // 96
    if max_frames > max_possible:
        raise ValueError(
            f".sens corrupt: header claims {max_frames} frames, stream "
            f"fits at most {max_possible}"
        )
    records = np.zeros(max_frames, dtype=FRAME_RECORD_DTYPE)
    n = lib.sens_index(
        data, len(data), frames_start,
        records.ctypes.data_as(ctypes.c_void_p), max_frames,
    )
    if n < 0:
        raise ValueError(f".sens frame index failed at frame {-n - 1}")
    return records[:n]


def decode_depth_batch(data: bytes, offsets, sizes, pixels: int):
    """Inflate many zlib uint16 depth frames in parallel -> (N, pixels)."""
    lib = load()
    offsets = np.ascontiguousarray(offsets, np.uint64)
    sizes = np.ascontiguousarray(sizes, np.uint64)
    # defensive bounds check before handing raw offsets to the C decoder
    # (uncompress reads buf[offset : offset + size] unchecked); ordered so
    # no uint64 arithmetic can wrap
    n_bytes = np.uint64(len(data))
    if len(offsets) and (
        (sizes > n_bytes).any() or (offsets > n_bytes - sizes).any()
    ):
        raise ValueError(".sens depth payload spans exceed the stream")
    out = np.empty((len(offsets), pixels), np.uint16)
    failed = lib.sens_decode_depth_batch(
        data,
        offsets.ctypes.data_as(ctypes.c_void_p),
        sizes.ctypes.data_as(ctypes.c_void_p),
        len(offsets), pixels,
        out.ctypes.data_as(ctypes.c_void_p),
    )
    if failed:
        raise ValueError(f"zlib depth decode failed at frame {failed - 1}")
    return out
