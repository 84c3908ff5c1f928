"""The tile preparation on the card: CUDA wrapper of csrc/tile_prep.cu.

Everything of one view before the tile z-resolve (`tile_kernel.
resolve_inputs`) in two hand-written kernels, where the plain chain of
PyTorch ops (`tile_kernel.resolve_inputs_plain`: `tiles.setup_inputs`,
`tiles._bin_triangles` with its (tiles, rows) overlap and `topk`,
`tile_kernel.candidate_table`) takes ~197 launches and a host wait for
each camera array it uploads:

1. `tile_setup_kernel`, one thread a setup row: setup (with clip_near the
   near-plane clipper's piece; the face vertices read in place, or
   gathered from the vertices by the faces), the row's candidate-table
   row, and its tile rectangle packed into 8 bytes; the sentinel row T,
   and the overflow zeroed;
2. `tile_bins_kernel`, one block a (32, 128) tile: the rows whose
   rectangle holds the tile in ascending order, the first N = min(cap,
   rows) of them padded with the sentinel T, the count min(listed, N),
   and max(listed - N, 0) added to the overflow.

The camera goes to the kernels by value (`dense_prep.pack_camera`), so
nothing is uploaded and nothing syncs with the host; a camera array that
is a CUDA tensor already is read where it lies. The outputs are
bit-identical to the plain chain's on the card
(tests/test_torch_tile_prep_kernel.py); the plain chain stays the CPU
implementation. There is no fallback from one to the other. The kernels
build into the `raster_tile` library beside kernel A (`_build.SOURCES`).
"""

from __future__ import annotations

import ctypes

import torch

from . import tiles
from .dense_prep import pack_camera

# kernel launches of this module and views it prepared (a caller that
# counts sets them to 0 first); the plain chain counts neither
launches = 0
views = 0

# tiles a side at most: a rectangle's bounds are 16 bits each, and
# csrc/tile_prep.cu's kNotBinnedX, 65535, lies past every tile
MAX_TILES_A_SIDE = 0xFFFF


class _Params(ctypes.Structure):
    """csrc/tile_prep.cu's `Params`, field for field."""

    _fields_ = [
        ("cam", ctypes.c_float * 16),
        ("cam_ptr", ctypes.c_void_p * 4),
        ("face_vertices", ctypes.c_void_p),
        ("vertices", ctypes.c_void_p),
        ("faces", ctypes.c_void_p),
        ("table", ctypes.c_void_p),
        ("rects", ctypes.c_void_p),
        ("cand", ctypes.c_void_p),
        ("counts", ctypes.c_void_p),
        ("overflow", ctypes.c_void_p),
        ("rows", ctypes.c_int),
        ("faces64", ctypes.c_int),
        ("clip", ctypes.c_int),
        ("height", ctypes.c_int),
        ("width", ctypes.c_int),
        ("nbx", ctypes.c_int),
        ("nby", ctypes.c_int),
        ("n", ctypes.c_int),
        ("y_offset", ctypes.c_float),
    ]


_fns = None


def _kernels():
    """(the row multiple of the rectangles, (setup, bins) C entry points)
    of the raster_tile library (built at first use); each entry point
    returns cudaGetLastError() after its launch."""
    global _fns
    if _fns is None:
        from .. import _build

        lib = _build.load("raster_tile")
        fns = (lib.sm_tile_setup, lib.sm_tile_bins)
        for fn in fns:
            fn.argtypes = (ctypes.POINTER(_Params), ctypes.c_void_p)
            fn.restype = ctypes.c_int
        _fns = (lib.sm_tile_prep_row_align(), fns)
    return _fns


def _launch(fn, params, name):
    global launches
    err = fn(ctypes.byref(params), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    launches += 1


def _check(name, t, dtypes, shape):
    """Raises unless t is a contiguous CUDA tensor of one of `dtypes` whose
    shape matches `shape` (None: any length)."""
    if (not torch.is_tensor(t) or not t.is_cuda or t.dtype not in dtypes
            or not t.is_contiguous() or t.ndim != len(shape)
            or any(n is not None and n != m for n, m in zip(shape, t.shape))):
        want = " or ".join(str(d) for d in dtypes)
        dims = ", ".join("?" if n is None else str(n) for n in shape)
        got = (f"{tuple(t.shape)} {t.dtype} on {t.device} (contiguous="
               f"{t.is_contiguous()})" if torch.is_tensor(t) else type(t))
        raise ValueError(f"{name} must be a contiguous ({dims}) CUDA {want} "
                         f"tensor, got {got}")


def prepare(face_vertices, vertices, faces, camera, *, height, width,
            y_offset, max_tris_per_tile, clip_near):
    """The tile preparation of one view on the card.

    face_vertices: a contiguous (F, 3, 3) f32 CUDA tensor, or None: then
    vertices, a contiguous (V, 3) f32 CUDA tensor, and faces, a contiguous
    (F, 3) int32 or int64 one on the same card, whose entries index
    vertices; camera: the four arrays of pack_camera. Returns (table,
    cand, counts, overflow) as tile_kernel.resolve_inputs_plain builds
    them: (rows + 1, 16) f32, (tiles, N) int32, (tiles,) int32 and an int32
    scalar, N = min(max_tris_per_tile, rows)."""
    global views
    if face_vertices is not None:
        _check("face_vertices", face_vertices, (torch.float32,),
               (None, 3, 3))
        device, faces_count, faces64 = face_vertices.device, len(
            face_vertices), 0
    else:
        _check("vertices", vertices, (torch.float32,), (None, 3))
        _check("faces", faces, (torch.int32, torch.int64), (None, 3))
        if faces.device != vertices.device:
            raise ValueError(f"faces on {faces.device}, vertices on "
                             f"{vertices.device}")
        device, faces_count = vertices.device, len(faces)
        faces64 = int(faces.dtype == torch.int64)
    rows = 2 * faces_count if clip_near else faces_count
    nbx = tiles._cdiv(width, tiles.TILE_W)
    nby = tiles._cdiv(height, tiles.TILE_H)
    if rows >= 2**31 or max(nbx, nby) > MAX_TILES_A_SIDE:
        raise ValueError(f"{rows} rows or a {height}x{width} image past the "
                         "packed tile rectangles' range")
    values, on_device = pack_camera(*camera)
    if any(t is not None and t.device != device for t in on_device):
        raise ValueError(f"the camera's CUDA tensors must be on {device}")
    align, (setup_fn, bins_fn) = _kernels()
    num_tiles = nbx * nby
    n = min(int(max_tris_per_tile), rows)
    lists = num_tiles * n
    at = -(-lists // 4) * 4  # the rectangles start 16-byte aligned
    table = torch.empty((rows + 1, 16), dtype=torch.float32, device=device)
    work = torch.empty(at + 2 * (-(-rows // align) * align),
                       dtype=torch.int32, device=device)
    small = torch.empty(num_tiles + 1, dtype=torch.int32, device=device)
    cand, counts = work[:lists].view(num_tiles, n), small[:num_tiles]
    overflow = small[num_tiles:].view(())
    p = _Params()
    ctypes.memmove(p.cam, values.ctypes.data, 64)
    for i, t in enumerate(on_device):
        p.cam_ptr[i] = 0 if t is None else t.data_ptr()
    if face_vertices is not None:
        p.face_vertices = face_vertices.data_ptr()
    else:
        p.vertices, p.faces = vertices.data_ptr(), faces.data_ptr()
    p.table, p.rects = table.data_ptr(), work[at:].data_ptr()
    p.cand, p.counts = cand.data_ptr(), counts.data_ptr()
    p.overflow = overflow.data_ptr()
    p.rows, p.faces64, p.clip = rows, faces64, int(bool(clip_near))
    p.height, p.width, p.nbx, p.nby, p.n = height, width, nbx, nby, n
    p.y_offset = float(y_offset)
    with torch.cuda.device(device):
        _launch(setup_fn, p, "tile_setup")
        if num_tiles:
            _launch(bins_fn, p, "tile_bins")
    views += 1
    return table, cand, counts, overflow
