"""Batched single-device render+fuse pipeline.

Counterpart of the single-device part of `semantic_meshes/distributed.py`:
`render_and_accumulate`, `fuse_views`, `FusePlan`, `plan_fuse` and
`fuse_views_planned`. The JAX package scans the views inside one compiled
program; here `fuse_views` is a Python loop over views whose every step
stays on the device (no host sync), with the (P, C) accumulator in device
memory. Multi-device sharding, lens distortion (`resample_grid`), the
dense plan's probes and its face permutation are not ported yet (see
ROADMAP).

Layout: probs here are (N, H, W, C), not the public API's (W, H).
"""

from __future__ import annotations

import torch

from . import fusion
from . import rasterize as rast
from .data import resolve_device


def render_and_accumulate(vertices, faces, camera_arrays, probs, weights,
                          images_equal_weight, *, num_primitives, aggregator,
                          height, width, max_tris_per_tile=256,
                          face_vertices=None, device="cuda"):
    """One fused render+aggregate step on one view.

    camera_arrays: (rotation, translation, focal_lengths, principal_point).
    probs: (H, W, C); weights: optional (H, W). Returns ((P, C) fusion
    delta, overflow int32 tensor): overflow counts candidate pairs the
    rasterizer dropped under its per-tile cap this view.
    """
    rot, trans, fl, pp = camera_arrays
    tri, _, overflow = rast.rasterize(
        vertices, faces, rot, trans, fl, pp,
        height=height, width=width, max_tris_per_tile=max_tris_per_tile,
        face_vertices=face_vertices, device=device,
    )
    probs = fusion._as_f32(probs, device)
    if weights is not None:
        weights = fusion._as_f32(weights, device)
    delta = fusion._accumulate_view(
        tri, probs, weights, images_equal_weight,
        num_primitives=num_primitives, aggregator=aggregator,
    )
    return delta, overflow


def fuse_views(vertices, faces, rotations, translations, focal_lengths,
               principal_points, probs, images_equal_weight, weights=None, *,
               num_primitives, aggregator, height, width,
               max_tris_per_tile=256, predict_fn=None, device="cuda"):
    """Render and fuse N views into one accumulator.

    rotations (N,3,3), translations (N,3), focal_lengths/principal_points
    (N,2), probs (N,H,W,C) (numpy or a tensor; a device tensor is read view
    by view in place), optional per-pixel weights (N,H,W). Returns
    (accumulator (P, C), overflow int32 tensor): read the accumulator out
    with fusion._get / MeshAggregator.state; overflow must be 0 in a
    correctly budgeted run.

    predict_fn: optional per-view hook `(H, W, ...) -> (H, W, C)` probs;
    `probs` then holds its inputs.
    """
    device = resolve_device(device)
    vertices = fusion._as_f32(vertices, device)
    faces = torch.as_tensor(faces, dtype=torch.int64, device=device)
    face_vertices = vertices[faces]  # one gather for all views
    acc = None
    overflow = torch.zeros((), dtype=torch.int32, device=device)
    for i in range(len(rotations)):
        pr = probs[i]
        if predict_fn is not None:
            pr = predict_fn(pr)
        delta, ov = render_and_accumulate(
            vertices, faces,
            (rotations[i], translations[i], focal_lengths[i],
             principal_points[i]),
            pr, None if weights is None else weights[i], images_equal_weight,
            num_primitives=num_primitives, aggregator=aggregator,
            height=height, width=width, max_tris_per_tile=max_tris_per_tile,
            face_vertices=face_vertices, device=device,
        )
        acc = delta if acc is None else acc + delta
        overflow = overflow + ov
    if acc is None:
        raise ValueError("fuse_views needs at least one view")
    return acc, overflow


class FusePlan:
    """Per-scene fusion plan from `plan_fuse`: the faces to rasterize. The
    tile rasterizer needs no probed budget and no face permutation, so its
    plan holds the faces (on the device) only."""

    __slots__ = ("faces",)

    def __init__(self, faces):
        self.faces = faces


def plan_fuse(vertices, faces, rotations, translations, focal_lengths,
              principal_points, *, height, width, backend=None,
              device="cuda"):
    """Build the FusePlan every batched fusion shares. For the tile
    rasterizer this is a no-op plan (no probes, no budget); a mesh that
    needs the dense rasterizer raises NotImplementedError."""
    faces = torch.as_tensor(faces, dtype=torch.int64,
                            device=resolve_device(device))
    rast.check_backend(int(faces.shape[0]), backend)
    return FusePlan(faces)


def fuse_views_planned(plan, vertices, rotations, translations,
                       focal_lengths, principal_points, probs,
                       images_equal_weight, weights=None, *,
                       num_primitives, aggregator, height, width, **kwargs):
    """fuse_views under a FusePlan. Equals fuse_views(plan.faces)."""
    return fuse_views(
        vertices, plan.faces, rotations, translations, focal_lengths,
        principal_points, probs, images_equal_weight, weights,
        num_primitives=num_primitives,
        aggregator=aggregator, height=height, width=width, **kwargs,
    )
