"""Rasterizer dispatch.

Counterpart of `semantic_meshes/rasterize/__init__.py`. One backend is
ported so far, the tile rasterizer (`tiles` setup and binning +
`tile_kernel` z-resolve: the CUDA kernel for CUDA tensors, its plain
PyTorch version for CPU tensors). Meshes at or above DENSE_THRESHOLD faces
belong to the dense rasterizer, which is not ported yet: they raise unless
the caller asks for the tile backend explicitly (`backend="tile"`; its
per-tile candidate cap then counts every dropped pair in `overflow`).
"""

from __future__ import annotations

import torch

from . import tile_kernel, tiles  # noqa: F401

DENSE_THRESHOLD = 16384
Z_NEAR = tiles.Z_NEAR


def check_backend(num_tris, backend=None):
    """Raise unless the tile backend may rasterize `num_tris` faces."""
    if backend not in (None, "tile"):
        raise ValueError(f"unknown rasterizer backend {backend!r}")
    if backend is None and num_tris >= DENSE_THRESHOLD:
        raise NotImplementedError(
            "dense rasterizer: not ported yet, see ROADMAP"
        )


def rasterize(vertices, faces, *args, backend=None, tri_ids=None, **kwargs):
    """(ids (H, W) int32 with -1 empty, depth (H, W) f32, overflow) — see
    tile_kernel.rasterize. tri_ids: optional (T,) ids to report per face
    row, remapped per pixel after the z-resolve (as the JAX package's
    non-dense backends do, so depth ties break by face row)."""
    check_backend(faces.shape[0], backend)
    idx, z, overflow = tile_kernel.rasterize(vertices, faces, *args, **kwargs)
    if tri_ids is not None:
        tri_ids = torch.as_tensor(tri_ids, dtype=torch.int32,
                                  device=idx.device)
        idx = torch.where(idx >= 0, tri_ids[idx.clamp(min=0).long()], idx)
    return idx, z, overflow
