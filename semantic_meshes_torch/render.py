"""Public render API: `triangles(mesh)`, pinhole cameras.

Counterpart of `TrianglesRenderer`, `_OverflowPolicy` and `triangles()` in
`semantic_meshes/render.py` (reference:
python/semantic_meshes/src/Render.cu:12-25,
include/semantic_meshes/render/TriangleRenderer.h:11-95).

`renderer.render(camera)` returns `(primitive_indices, depth)` as tensors
on the renderer's device shaped (width, height), the reference's layout.
Ids are `torch.uint32`: the bit view of an int32 image that holds -1 for
background, so empty pixels read 0xFFFFFFFF. Depth is f32 with +inf for
background. Inside the port, ids travel as int32 with -1 for background.

Not ported yet (see ROADMAP): texel mode, lens distortion (a camera with a
nonzero lens raises), near-plane clipping (`clip_near=True` raises), the
dense rasterizer (meshes of DENSE_THRESHOLD faces or more raise unless
`backend="tile"`), and the face-count bucketing that the JAX package uses
only to share jit compilations.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from . import rasterize as rast
from .data import Camera, Ply, resolve_device

logger = logging.getLogger("semantic_meshes_torch")


def check_pinhole(cameras):
    for c in cameras:
        d = getattr(c, "distortion", None)
        if d is not None and np.any(np.asarray(d)):
            raise NotImplementedError(
                "lens distortion: not ported yet, see ROADMAP"
            )


def _camera_hw(camera: Camera):
    # camera.resolution is (width, height); the rasterizer works in (H, W)
    return camera.resolution[1], camera.resolution[0]


class _OverflowPolicy:
    """Overflow reporting without a device sync per frame.

    Overflow is a configuration property (candidate cap too small for this
    mesh at this resolution), so the first frame at each resolution is
    checked synchronously and warns; later frames only keep their
    (unsynced) counts, which total() sums on demand.
    """

    def __init__(self):
        self._pending = {}  # key -> per-frame device scalars (unsynced)
        self._base = {}  # key -> synced drop total

    def check(self, overflow, key, max_tris_per_tile):
        """Returns the drops found by this call's sync (0 after a key's
        first frame, which stays asynchronous)."""
        first = key not in self._pending
        self._pending.setdefault(key, []).append(overflow)
        if not first:
            return 0
        new = self._key_total(key)
        if new:
            logger.warning(
                "rasterizer overflow: %d candidate pairs dropped; raise "
                "max_tris_per_tile (current %d)", new, max_tris_per_tile,
            )
        return new

    def _key_total(self, key) -> int:
        pend = self._pending[key]
        if pend:
            self._base[key] = self._base.get(key, 0) + int(
                torch.stack(pend).sum()
            )
            pend.clear()
        return self._base.get(key, 0)

    def total(self) -> int:
        """Accumulated dropped pairs across all renders so far (one sync)."""
        return sum(self._key_total(key) for key in self._pending)


class TrianglesRenderer:
    """Whole-triangle primitive renderer (primitive index == triangle
    index), on `device` (default "cuda")."""

    def __init__(self, mesh: Ply, max_tris_per_tile: int = 256,
                 backend: str | None = None, clip_near: bool = False,
                 device="cuda"):
        if clip_near:
            raise NotImplementedError(
                "near-plane clipping: not ported yet, see ROADMAP"
            )
        self.device = resolve_device(device)
        self.mesh = mesh
        self.vertices = torch.as_tensor(
            np.asarray(mesh.vertices, np.float32), device=self.device
        )
        self.faces = torch.as_tensor(
            np.asarray(mesh.faces, np.int64), device=self.device
        )
        self._num_faces = int(self.faces.shape[0])
        rast.check_backend(self._num_faces, backend)
        # pre-expanded face-vertex positions: per-view setup is gather-free
        self.face_vertices = self.vertices[self.faces]
        self.max_tris_per_tile = int(max_tris_per_tile)
        self.backend = backend
        self.overflow_policy = _OverflowPolicy()

    def getPrimitivesNum(self) -> int:
        return self._num_faces

    def _rasterize(self, camera):
        check_pinhole([camera])
        height, width = _camera_hw(camera)
        ids, depth, overflow = rast.rasterize(
            self.vertices, self.faces, camera.rotation, camera.translation,
            camera.focal_lengths, camera.principal_point,
            face_vertices=self.face_vertices, backend=self.backend,
            height=height, width=width,
            max_tris_per_tile=self.max_tris_per_tile, device=self.device,
        )
        self.overflow_policy.check(overflow, (height, width),
                                   self.max_tris_per_tile)
        return ids, depth

    def render(self, camera: Camera):
        """(ids (W, H) uint32, depth (W, H) f32) on the renderer's device."""
        ids, depth = self._rasterize(camera)
        return ids.t().contiguous().view(torch.uint32), depth.t().contiguous()

    def render_many(self, cameras):
        """Render same-resolution cameras: (ids (N, W, H) uint32, depth
        (N, W, H) f32)."""
        cams = list(cameras)
        hw = _camera_hw(cams[0])
        if any(_camera_hw(c) != hw for c in cams):
            raise ValueError("render_many needs equal camera resolutions")
        out = [self._rasterize(c) for c in cams]
        ids = torch.stack([i for i, _ in out]).transpose(1, 2).contiguous()
        depth = torch.stack([d for _, d in out]).transpose(1, 2).contiguous()
        return ids.view(torch.uint32), depth

    def overflow_total(self) -> int:
        """Total dropped candidate pairs across all renders (syncs once)."""
        return self.overflow_policy.total()

    def prepare(self, cameras):
        """Pre-size candidate budgets for a camera set: a no-op for the tile
        rasterizer (its budget is the static max_tris_per_tile)."""
        check_pinhole(cameras)


def triangles(mesh: Ply, **kwargs) -> TrianglesRenderer:
    """Factory matching `semantic_meshes.render.triangles(mesh)`
    (ref: python/semantic_meshes/src/Render.cu:24)."""
    return TrianglesRenderer(mesh, **kwargs)


# Reference-compatible class alias (ref: Render.cu:16)
PlyRendererTriangles = TrianglesRenderer
