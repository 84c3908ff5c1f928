"""Rasterizer dispatch.

Counterpart of `semantic_meshes/rasterize/__init__.py`. Two backends:

- `tile`: setup and (32, 128)-tile binning (`tiles`) + the z-resolve of
  `tile_kernel`, for meshes under DENSE_THRESHOLD faces;
- `dense`: sort binning, micro fragments and the streaming z-resolve of
  `dense` / `dense_kernel`, for meshes of DENSE_THRESHOLD faces or more.

Each z-resolve is a CUDA kernel for CUDA tensors and its plain PyTorch
version for CPU tensors. `backend="tile"|"dense"` forces a backend; the
JAX package's names are accepted too: "pallas" and "xla", its two
tile-binned rasterizers, both name "tile".

Routing follows the JAX package's rule on its accelerator
(`semantic_meshes/rasterize/__init__.py:21-32`), whatever the tensors'
device: the SM_RASTERIZER environment variable ("tile", "dense", "pallas"
or "xla"; other values are ignored) picks the backend of every call that
names none, else meshes of DENSE_THRESHOLD faces or more (16384, or
SM_DENSE_THRESHOLD read at import) go to `dense` and the rest to `tile`.
"""

from __future__ import annotations

import os

import torch

from . import dense, dense_kernel, tile_kernel, tiles  # noqa: F401
from .tiles import barycentrics_at_pixels  # noqa: F401

DENSE_THRESHOLD = int(os.environ.get("SM_DENSE_THRESHOLD", 16384))
# every accepted backend name -> the port's backend ("tile" or "dense")
BACKEND_NAMES = {"tile": "tile", "dense": "dense", "pallas": "tile",
                 "xla": "tile"}
Z_NEAR = tiles.Z_NEAR


def default_backend(num_tris=None):
    """The backend of a call that names none: SM_RASTERIZER when it holds a
    known name, else dense at DENSE_THRESHOLD faces or more
    (`semantic_meshes.rasterize.default_backend` on its accelerator)."""
    env = os.environ.get("SM_RASTERIZER")
    if env in BACKEND_NAMES:
        return BACKEND_NAMES[env]
    if num_tris is not None and num_tris >= DENSE_THRESHOLD:
        return "dense"
    return "tile"


def check_backend(num_tris, backend=None):
    """The backend ("tile" or "dense") that rasterizes `num_tris` faces:
    `backend` if given (a name of BACKEND_NAMES), else default_backend."""
    if backend is None:
        return default_backend(num_tris)
    if backend not in BACKEND_NAMES:
        raise ValueError(f"unknown rasterizer backend {backend!r}")
    return BACKEND_NAMES[backend]


def uses_dense(backend=None, num_tris=None):
    """True when dispatch picks the dense backend (the renderers then probe
    its budgets once per resolution)."""
    return check_backend(num_tris or 0, backend) == "dense"


def rasterize(vertices, faces, *args, backend=None, tri_ids=None,
              dense_e_cap=None, **kwargs):
    """(ids (H, W) int32 with -1 empty, depth (H, W) f32, overflow) — see
    tile_kernel.rasterize and dense.rasterize.

    tri_ids: optional (T,) ids to report per face row. The dense backend
    writes them into its candidate table and fragment keys, so depth ties
    break by these ids; the tile backend remaps each pixel after its
    z-resolve, as the JAX package's non-dense backends do, so ties break
    by face row there. With clip_near the tile backend remaps after its
    piece ids are mapped back to triangles; the dense backend refuses
    tri_ids (its rows are clip pieces, not faces). dense_e_cap: the dense
    budget, a dense.DenseBudget or any form of the JAX package's
    (DenseBudget.of); ignored by the tile backend."""
    if check_backend(faces.shape[0], backend) == "dense":
        kwargs.pop("max_tris_per_tile", None)
        return dense.rasterize(vertices, faces, *args, tri_ids=tri_ids,
                               **dense.DenseBudget.of(dense_e_cap).kwargs(),
                               **kwargs)
    idx, z, overflow = tile_kernel.rasterize(vertices, faces, *args, **kwargs)
    if tri_ids is not None:
        tri_ids = torch.as_tensor(tri_ids, dtype=torch.int32,
                                  device=idx.device)
        idx = torch.where(idx >= 0, tri_ids[idx.clamp(min=0).long()], idx)
    return idx, z, overflow


def dense_candidate_count(*args, **kwargs):
    return dense.candidate_count(*args, **kwargs)


def dense_candidate_stats(*args, **kwargs):
    return dense.candidate_stats(*args, **kwargs)


def dense_routing_stats(*args, **kwargs):
    return dense.routing_stats(*args, **kwargs)
