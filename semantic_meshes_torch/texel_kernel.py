"""The texel shader on the card: CUDA wrapper of csrc/texel_shader.cu.

One view's texel ids (render._texel_prim_image) in two hand-written
kernels, where the plain chain of PyTorch ops
(render._texel_prim_image_plain) takes ~175 launches and a host wait for
each camera array it uploads:

1. `texel_table_kernel`, one thread a face: the nine f32 coefficients of
   the affine forms A1, A2 and S (pinhole, or with clip_near the
   camera-space ray form), the resolution and the first texel index, one
   row of 12 int32 a face;
2. `texel_shade_kernel`, one thread a pixel: the triangle id read by its
   strides, its row, u = A1 / S and v = A2 / S at the pixel centre, the
   grid cell and `first + index`, or `none` for a pixel of no texel.

The camera goes to the kernels by value (dense_prep.pack_camera), so
nothing is uploaded and nothing syncs with the host; a camera array that
is a CUDA tensor already is read where it lies. The ids are bit-identical
to the plain chain's on the card (tests/test_torch_texel_shader_kernel.py);
the plain chain stays the CPU implementation. There is no fallback from
one to the other.
"""

from __future__ import annotations

import ctypes

import torch

from .rasterize.dense_prep import pack_camera

# kernel launches of this module and views it shaded (a caller that counts
# sets them to 0 first); the plain chain counts neither
launches = 0
views = 0

_ROW = 12  # int32 lanes of a table row


class _Params(ctypes.Structure):
    """csrc/texel_shader.cu's `Params`, field for field."""

    _fields_ = [
        ("cam", ctypes.c_float * 16),
        ("cam_ptr", ctypes.c_void_p * 4),
        ("vertices", ctypes.c_void_p),
        ("faces", ctypes.c_void_p),
        ("resolutions", ctypes.c_void_p),
        ("first", ctypes.c_void_p),
        ("table", ctypes.c_void_p),
        ("ids", ctypes.c_void_p),
        ("ids_s0", ctypes.c_longlong),
        ("ids_s1", ctypes.c_longlong),
        ("out", ctypes.c_void_p),
        ("faces_count", ctypes.c_int),
        ("faces64", ctypes.c_int),
        ("ids64", ctypes.c_int),
        ("clip", ctypes.c_int),
        ("height", ctypes.c_int),
        ("width", ctypes.c_int),
        ("y_offset", ctypes.c_float),
        ("none", ctypes.c_int),
    ]


_fns = None


def _kernels():
    """The (table, shade) C entry points of the texel_shader library
    (built at first use); each returns cudaGetLastError() after its
    launch."""
    global _fns
    if _fns is None:
        from . import _build

        lib = _build.load("texel_shader")
        fns = (lib.sm_texel_table, lib.sm_texel_shade)
        for fn in fns:
            fn.argtypes = (ctypes.POINTER(_Params), ctypes.c_void_p)
            fn.restype = ctypes.c_int
        _fns = fns
    return _fns


def _launch(fn, params, name):
    global launches
    err = fn(ctypes.byref(params), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    launches += 1


def _on(x, dtype, device):
    """x as a contiguous tensor of `dtype` on `device`: no copy for one that
    is so already."""
    return torch.as_tensor(x, dtype=dtype, device=device).contiguous()


def texel_ids(vertices, faces, camera, tri_index, resolutions,
              first_texel_index, none, *, y_offset=0, clip_near=False):
    """The texel ids (H, W) int32 of one view's triangle ids on the card.

    tri_index: (H, W) int32 or int64 CUDA tensor, any strides, -1 empty;
    vertices (V, 3), faces (T, 3) int32 or int64, resolutions and
    first_texel_index (T,): tensors on the same card, or arrays uploaded
    here; camera: the four arrays of dense_prep.pack_camera. A pixel of no
    texel (id < 0 or >= T, or a face of resolution 0) reads `none`."""
    global views
    device = tri_index.device
    if not tri_index.is_cuda or tri_index.ndim != 2:
        raise ValueError("tri_index must be an (H, W) CUDA tensor, got "
                         f"{tuple(tri_index.shape)} on {device}")
    if tri_index.dtype not in (torch.int32, torch.int64):
        tri_index = tri_index.to(torch.int32)
    vertices = _on(vertices, torch.float32, device)
    faces = torch.as_tensor(faces, device=device)
    if faces.dtype not in (torch.int32, torch.int64):
        faces = faces.long()
    faces = faces.contiguous()
    resolutions = _on(resolutions, torch.int32, device)
    first = _on(first_texel_index, torch.int32, device)
    T = faces.shape[0]
    if (vertices.ndim != 2 or vertices.shape[1] != 3
            or tuple(faces.shape) != (T, 3) or resolutions.shape != (T,)
            or first.shape != (T,) or T >= 2**31):
        raise ValueError(
            f"vertices {tuple(vertices.shape)}, faces {tuple(faces.shape)}, "
            f"resolutions {tuple(resolutions.shape)} and first texel "
            f"indices {tuple(first.shape)} must be (V, 3), (T, 3), (T,) "
            "and (T,)")
    values, on_device = pack_camera(*camera)
    if any(t is not None and t.device != device for t in on_device):
        raise ValueError(f"the camera's CUDA tensors must be on {device}")
    height, width = tri_index.shape
    out = torch.empty((height, width), dtype=torch.int32, device=device)
    if out.numel() == 0:
        return out
    table = torch.empty((T, _ROW), dtype=torch.int32, device=device)
    table_fn, shade_fn = _kernels()
    p = _Params()
    ctypes.memmove(p.cam, values.ctypes.data, 64)
    for i, t in enumerate(on_device):
        p.cam_ptr[i] = 0 if t is None else t.data_ptr()
    p.vertices, p.faces = vertices.data_ptr(), faces.data_ptr()
    p.resolutions, p.first = resolutions.data_ptr(), first.data_ptr()
    p.table = table.data_ptr()
    p.ids, (p.ids_s0, p.ids_s1) = tri_index.data_ptr(), tri_index.stride()
    p.out = out.data_ptr()
    p.faces_count = T
    p.faces64 = int(faces.dtype == torch.int64)
    p.ids64 = int(tri_index.dtype == torch.int64)
    p.clip = int(bool(clip_near))
    p.height, p.width = height, width
    p.y_offset = float(y_offset)
    p.none = int(none)
    with torch.cuda.device(device):
        _launch(table_fn, p, "texel_table")
        _launch(shade_fn, p, "texel_shade")
    views += 1
    return out
