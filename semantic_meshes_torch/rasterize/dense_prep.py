"""The dense preparation on the card: CUDA wrapper of csrc/dense_prep.cu.

Everything of one view before the dense z-resolve (`dense.resolve_inputs`)
in three hand-written kernels and one `torch.sort`, where the plain chain
of PyTorch ops (`dense.resolve_inputs_plain`) takes ~550 small launches:

1. `dense_setup_kernel`, one thread a setup row: setup (with clip_near the
   near-plane clipper's piece), classification, the row's five tile ids,
   its candidate-table row, per block the counts of micro rows and pairs,
   and the micro image's background;
2. `torch.sort(stable=True)` of the tile ids, as the plain chain sorts
   them;
3. `dense_bins_kernel`: the sorted triangle ids, each tile's start (the
   plain chain's `searchsorted`), the e_cap clamp and the overflow of
   pairs past e_cap and of big rows past n_global;
4. `dense_micro_kernel`, one thread a setup row: the micro fragments,
   merged into the packed key image with a 64-bit atomicMin, and the micro
   rows a budget drops, added to the overflow.

With e_cap_rows == 0 only passes 1 and 4 run. The camera goes to the
kernels by value (`pack_camera`), so nothing is uploaded and nothing syncs
with the host; a camera array that is a CUDA tensor already (the lens
path's virtual focal, a batch moved to the device once) is read where it
lies. The outputs are bit-identical to the plain chain's on the card
(tests/test_torch_dense_prep_kernel.py); the plain chain stays the CPU
implementation. There is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

# kernel launches of this module and views it prepared (a caller that
# counts sets them to 0 first); the plain chain counts neither
launches = 0
views = 0

_CAMERA_SIZES = (9, 3, 2, 2)  # rotation, translation, focal, principal


class _Params(ctypes.Structure):
    """csrc/dense_prep.cu's `Params`, field for field."""

    _fields_ = [
        ("cam", ctypes.c_float * 16),
        ("cam_ptr", ctypes.c_void_p * 4),
        ("face_vertices", ctypes.c_void_p),
        ("tri_ids", ctypes.c_void_p),
        ("table", ctypes.c_void_p),
        ("tile_ids", ctypes.c_void_p),
        ("block_counts", ctypes.c_void_p),
        ("micro_key", ctypes.c_void_p),
        ("sorted_keys", ctypes.c_void_p),
        ("order", ctypes.c_void_p),
        ("sorted_ids", ctypes.c_void_p),
        ("starts", ctypes.c_void_p),
        ("overflow", ctypes.c_void_p),
        ("e_cap", ctypes.c_longlong),
        ("n_global", ctypes.c_longlong),
        ("rows", ctypes.c_int),
        ("clip", ctypes.c_int),
        ("height", ctypes.c_int),
        ("width", ctypes.c_int),
        ("nbx", ctypes.c_int),
        ("num_tiles", ctypes.c_int),
        ("y_offset", ctypes.c_float),
        ("y_band", ctypes.c_int),
        ("micro_max", ctypes.c_int),
        ("split", ctypes.c_int),
        ("cap", ctypes.c_int),
        ("zero_budget", ctypes.c_int),
    ]


_fns = None


def _kernels():
    """(rows a block of passes 1 and 4, (setup, bins, micro) C entry
    points) of the raster_dense library (built at first use); each entry
    point returns cudaGetLastError() after its launch."""
    global _fns
    if _fns is None:
        from .. import _build

        lib = _build.load("raster_dense")
        fns = []
        for name in ("sm_dense_setup", "sm_dense_bins", "sm_dense_micro"):
            fn = getattr(lib, name)
            fn.argtypes = (ctypes.POINTER(_Params), ctypes.c_void_p)
            fn.restype = ctypes.c_int
            fns.append(fn)
        _fns = (lib.sm_dense_prep_rows_per_block(), tuple(fns))
    return _fns


def pack_camera(rotation, translation, focal_lengths, principal_point):
    """The camera as the kernels take it: (values (16,) f32 numpy array of
    rotation (row-major), translation, focal lengths and principal point;
    device tensors (4,), None where the value is in `values`). An array
    that is a CUDA tensor stays on the device, as a contiguous f32 tensor,
    and its slots of `values` are 0; any other (numpy, list, CPU tensor)
    is rounded to f32 on the host, as `torch.as_tensor(x,
    dtype=torch.float32)` rounds it for the plain chain."""
    values = np.zeros(16, np.float32)
    on_device = [None] * 4
    at = 0
    for i, (x, n) in enumerate(zip((rotation, translation, focal_lengths,
                                    principal_point), _CAMERA_SIZES)):
        if torch.is_tensor(x) and x.is_cuda:
            t = x.to(torch.float32).contiguous()
            if t.numel() != n:
                raise ValueError(f"camera array {i} has {t.numel()} values, "
                                 f"not {n}")
            on_device[i] = t
        else:
            v = torch.as_tensor(x, dtype=torch.float32).reshape(-1).numpy()
            if v.size != n:
                raise ValueError(f"camera array {i} has {v.size} values, "
                                 f"not {n}")
            values[at:at + n] = v
        at += n
    return values, tuple(on_device)


def _launch(fn, params, name):
    global launches
    err = fn(ctypes.byref(params), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    launches += 1


def prepare(face_vertices, camera, *, height, width, y_offset, e_cap,
            n_global, micro_max, micro_split, micro_cap, tri_ids, clip_near,
            nbx, num_tiles):
    """The dense preparation of one view on face_vertices' card.

    face_vertices: contiguous (F, 3, 3) f32 CUDA tensor; camera: the four
    arrays of pack_camera; e_cap: the pair budget (a CHUNK multiple), or 0
    for the pure-micro path; micro_cap: the compaction cap in rows, or
    None; tri_ids: None or a (rows,) int32 CUDA tensor. Returns (table,
    sorted_ids, starts, micro_key, overflow) as dense.resolve_inputs_plain
    builds them (table, sorted_ids and starts None when e_cap is 0)."""
    global views
    device = face_vertices.device
    if (not face_vertices.is_cuda or face_vertices.dtype != torch.float32
            or not face_vertices.is_contiguous()
            or tuple(face_vertices.shape[1:]) != (3, 3)):
        raise ValueError("face_vertices must be a contiguous (F, 3, 3) CUDA "
                         f"float32 tensor, got {tuple(face_vertices.shape)} "
                         f"{face_vertices.dtype} on {device}")
    faces = face_vertices.shape[0]
    rows = 2 * faces if clip_near else faces
    if tri_ids is not None and (
            tri_ids.device != device or tri_ids.dtype != torch.int32
            or tri_ids.shape != (rows,) or not tri_ids.is_contiguous()):
        raise ValueError(f"tri_ids must be a contiguous ({rows},) int32 "
                         f"tensor on {device}")
    values, on_device = pack_camera(*camera)
    if any(t is not None and t.device != device for t in on_device):
        raise ValueError(f"the camera's CUDA tensors must be on {device}")
    rows_per_block, (setup_fn, bins_fn, micro_fn) = _kernels()
    p = _Params()
    ctypes.memmove(p.cam, values.ctypes.data, 64)
    for i, t in enumerate(on_device):
        p.cam_ptr[i] = 0 if t is None else t.data_ptr()
    p.face_vertices = face_vertices.data_ptr()
    p.tri_ids = 0 if tri_ids is None else tri_ids.data_ptr()
    blocks = max(-(-rows // rows_per_block), 1)
    counts = torch.empty(2 * blocks + 1, dtype=torch.int32, device=device)
    overflow = counts[2 * blocks:].view(())  # pass 3 or 4 writes it first
    key = torch.empty((height, width), dtype=torch.int64, device=device)
    p.block_counts = counts.data_ptr()
    p.overflow = overflow.data_ptr()
    p.micro_key = key.data_ptr()
    p.e_cap, p.n_global = int(e_cap), int(n_global)
    p.rows, p.clip = rows, int(bool(clip_near))
    p.height, p.width, p.nbx, p.num_tiles = height, width, nbx, num_tiles
    p.y_offset = float(y_offset)
    p.y_band = int(y_offset)  # truncates toward zero, as astype(int32)
    p.micro_max = int(micro_max)
    p.split = 0 if micro_split is None else int(micro_split)
    p.cap = -1 if micro_cap is None else int(micro_cap)
    p.zero_budget = int(e_cap == 0)
    table = sorted_ids = starts = None
    with torch.cuda.device(device):
        if e_cap:
            table = torch.empty((rows + 1, 16), dtype=torch.float32,
                                device=device)
            tile_ids = torch.empty(rows * 5, dtype=torch.int32,
                                   device=device)
            p.table, p.tile_ids = table.data_ptr(), tile_ids.data_ptr()
        _launch(setup_fn, p, "dense_setup")
        if e_cap:
            keys, order = torch.sort(tile_ids, stable=True)
            sorted_ids = torch.empty(min(int(e_cap), rows * 5),
                                     dtype=torch.int32, device=device)
            starts = torch.empty(num_tiles + 2, dtype=torch.int32,
                                 device=device)
            p.sorted_keys, p.order = keys.data_ptr(), order.data_ptr()
            p.sorted_ids, p.starts = sorted_ids.data_ptr(), starts.data_ptr()
            _launch(bins_fn, p, "dense_bins")
        _launch(micro_fn, p, "dense_micro")
    views += 1
    return table, sorted_ids, starts, key, overflow
