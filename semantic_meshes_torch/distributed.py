"""Batched single-device render+fuse pipeline.

Counterpart of the single-device part of `semantic_meshes/distributed.py`:
`render_and_accumulate`, `lens_shared`, `fuse_views`, `FusePlan`,
`plan_fuse`, `fuse_views_planned`, `fuse_views_split` and
`fuse_views_texels`. The JAX package scans the views inside one compiled
program; here each batched fusion is a Python loop over views whose every
step stays on the device (no host sync), with the (P, C) accumulator in
device memory. Distorted views (`distortions`, any COLMAP lens) render
under their virtual-pinhole focal and gather the primitive image onto the
distorted pixels before they fuse; `shared_lens` computes the
undistortion grid once for a batch of one physical camera. `clip_near`
renders each view through the near-plane clipper, as the per-view
renderers do; a clipped plan never takes the uni-slot split.
Multi-device sharding is not ported yet (see ROADMAP).

Layout: probs here are (N, H, W, C), not the public API's (W, H).
"""

from __future__ import annotations

import numpy as np
import torch

from . import fusion
from . import rasterize as rast
from . import render
from .data import resolve_device


def render_and_accumulate(vertices, faces, camera_arrays, probs, weights,
                          images_equal_weight, *, num_primitives, aggregator,
                          height, width, max_tris_per_tile=256,
                          prim_transform=None, face_vertices=None,
                          clip_near=False, dense_e_cap=None, tri_ids=None,
                          backend=None, resample_grid=None, device="cuda"):
    """One fused render+aggregate step on one view.

    camera_arrays: (rotation, translation, focal_lengths, principal_point).
    probs: (H, W, C); weights: optional (H, W). dense_e_cap: the dense
    rasterizer's probed budget (FusePlan); tri_ids: (T,) ids to emit per
    face row (a split plan's original face ids). prim_transform: optional
    `fn(tri_index, depth, camera_arrays) -> (H, W) primitive ids` (the
    texel shader); without it the triangle ids are the primitives.
    resample_grid: optional (H, W, 2) undistorted normalized rays of the
    distorted pixel centres (render._undistort_grid), with the virtual
    (scaled) focal in camera_arrays: rasterizer and prim_transform run in
    pinhole space, and one gather maps the primitive image onto the
    distorted pixels before it fuses, as the per-view render() -> add()
    path does. clip_near: rasterize the near-plane-clipped pieces
    (tiles.setup_clipped). Returns
    ((P, C) fusion delta, overflow int32 tensor): overflow counts the
    candidate pairs and micro rows the rasterizer dropped under its budgets
    this view.
    """
    rot, trans, fl, pp = camera_arrays
    tri, depth, overflow = rast.rasterize(
        vertices, faces, rot, trans, fl, pp,
        height=height, width=width, max_tris_per_tile=max_tris_per_tile,
        face_vertices=face_vertices, clip_near=clip_near,
        dense_e_cap=dense_e_cap, tri_ids=tri_ids, backend=backend,
        device=device,
    )
    if prim_transform is not None:
        tri = prim_transform(tri, depth, camera_arrays)
    if resample_grid is not None:
        ix, iy = render._sample_pixel(resample_grid, fl, pp, width, height)
        tri = tri.reshape(-1)[iy * width + ix]
    probs = fusion._as_f32(probs, device)
    if weights is not None:
        weights = fusion._as_f32(weights, device)
    delta = fusion._accumulate_view(
        tri, probs, weights, images_equal_weight,
        num_primitives=num_primitives, aggregator=aggregator,
    )
    return delta, overflow


def lens_shared(focal_lengths, principal_points, distortions):
    """True when every view carries the same (focal_lengths,
    principal_point, distortion): one physical camera, COLMAP's usual
    workspace. The fusions can then compute the undistortion grid once
    per batch (`shared_lens=True`) instead of once per view. A host-side
    compare of the inputs' values; plan_fuse stores it on the FusePlan."""
    if distortions is None:
        return False
    fl, pp, d = (_host(a) for a in (focal_lengths, principal_points,
                                    distortions))
    return bool((fl == fl[:1]).all() and (pp == pp[:1]).all()
                and (d == d[:1]).all())


def _host(a):
    return a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def fuse_views(vertices, faces, rotations, translations, focal_lengths,
               principal_points, probs, images_equal_weight, weights=None,
               distortions=None, prim_remap=None, *, num_primitives,
               aggregator, height, width, max_tris_per_tile=256,
               clip_near=False, dense_e_cap=None, backend=None,
               predict_fn=None, prim_transform=None, shared_lens=False,
               device="cuda"):
    """Render and fuse N views into one accumulator.

    rotations (N,3,3), translations (N,3), focal_lengths/principal_points
    (N,2), probs (N,H,W,C) (numpy or a tensor; a device tensor is read view
    by view in place), optional per-pixel weights (N,H,W). Returns
    (accumulator (P, C), overflow int32 tensor): read the accumulator out
    with fusion._get / MeshAggregator.state; overflow must be 0 in a
    correctly budgeted run. No step syncs with the host.

    distortions: optional (N, 4|9) lens wires (data.stack_distortions).
    Every view then renders under its virtual focal and resamples onto
    its distorted pixels (render_and_accumulate resample_grid); a zero
    lens among them gives its pinhole render's ids. Equals the per-view
    render() -> add() path. shared_lens: every view has the same lens and
    intrinsics (lens_shared): the grid is computed once, from view 0; the
    result is bit-identical.

    prim_remap: optional (T,) int32 primitive id to emit per face row, how
    a split plan returns its accumulator in original face order (the dense
    rasterizer writes the ids into its tables, see rasterize.rasterize).
    clip_near: render through the near-plane clipper (a clipped plan has
    no prim_remap). dense_e_cap / backend: the dense budget and the
    backend (plan_fuse).
    predict_fn: optional per-view hook `(H, W, ...) -> (H, W, C)` probs;
    `probs` then holds its inputs. prim_transform: see
    render_and_accumulate (fuse_views_texels passes its shader).
    """
    device = resolve_device(device)
    vertices = fusion._as_f32(vertices, device)
    faces = torch.as_tensor(faces, dtype=torch.int64, device=device)
    face_vertices = vertices[faces]  # one gather for all views
    hoisted = None
    if distortions is not None:
        focal_lengths, principal_points, distortions = (
            fusion._as_f32(a, device)
            for a in (focal_lengths, principal_points, distortions))
        if shared_lens:
            hoisted = render._undistort_grid(
                focal_lengths[0], principal_points[0], distortions[0],
                height=height, width=width)
    if prim_remap is not None:
        prim_remap = torch.as_tensor(prim_remap, dtype=torch.int32,
                                     device=device)
    acc = None
    overflow = torch.zeros((), dtype=torch.int32, device=device)
    for i in range(len(rotations)):
        pr = probs[i]
        if predict_fn is not None:
            pr = predict_fn(pr)
        fl, grid = focal_lengths[i], None
        if distortions is not None:
            grid, s = hoisted if hoisted is not None else \
                render._undistort_grid(fl, principal_points[i],
                                       distortions[i], height=height,
                                       width=width)
            fl = fl * s  # the rasterizer, shader and gather's focal
        delta, ov = render_and_accumulate(
            vertices, faces,
            (rotations[i], translations[i], fl, principal_points[i]),
            pr, None if weights is None else weights[i], images_equal_weight,
            num_primitives=num_primitives, aggregator=aggregator,
            height=height, width=width, max_tris_per_tile=max_tris_per_tile,
            prim_transform=prim_transform, face_vertices=face_vertices,
            clip_near=clip_near, dense_e_cap=dense_e_cap, tri_ids=prim_remap,
            backend=backend, resample_grid=grid, device=device,
        )
        acc = delta if acc is None else acc + delta
        overflow = overflow + ov
    if acc is None:
        raise ValueError("fuse_views needs at least one view")
    return acc, overflow


def fuse_views_texels(vertices, faces, resolutions, first_texel_index,
                      rotations, translations, focal_lengths,
                      principal_points, probs, images_equal_weight,
                      weights=None, distortions=None, *, num_primitives,
                      aggregator, height, width, max_tris_per_tile=256,
                      clip_near=False, dense_e_cap=None, backend=None,
                      predict_fn=None, shared_lens=False, device="cuda"):
    """Batched texel-mode fusion: fuse_views with the texel shader between
    the rasterizer and the fusion, so the primitives are a TexelsRenderer's
    texels (pass its reordered `faces`, `resolutions`, `first_texel_index`
    and getPrimitivesNum()). Returns (accumulator (P, C), overflow int32
    tensor), like fuse_views; no step syncs with the host.

    dense_e_cap / backend: the dense budget of `plan_fuse(...,
    allow_split=False)` (texel tables are per face, so a texel plan never
    splits) and the backend it was planned for. distortions,
    shared_lens: see fuse_views; texels shade under the virtual focal,
    then the texel image is resampled onto the distorted pixels.
    predict_fn: see fuse_views. clip_near: rasterize the clipped pieces
    and shade with the camera-space ray form, as a TexelsRenderer(
    clip_near=True) does (pass its tables)."""
    device = resolve_device(device)
    vertices = fusion._as_f32(vertices, device)
    faces = torch.as_tensor(faces, dtype=torch.int64, device=device)
    resolutions = torch.as_tensor(resolutions, dtype=torch.int32,
                                  device=device)
    first_texel_index = torch.as_tensor(first_texel_index,
                                        dtype=torch.int32, device=device)

    def shade(tri, _depth, camera_arrays):
        return render._texel_prim_image(
            vertices, faces, *camera_arrays, tri, resolutions,
            first_texel_index, num_primitives, clip_near=clip_near)

    # the cameras move to the device once; the rasterizer and the shader
    # then read each view's slices in place
    return fuse_views(
        vertices, faces, *(fusion._as_f32(a, device) for a in (
            rotations, translations, focal_lengths, principal_points)),
        probs, images_equal_weight, weights, distortions,
        num_primitives=num_primitives, aggregator=aggregator, height=height,
        width=width, max_tris_per_tile=max_tris_per_tile,
        clip_near=clip_near, dense_e_cap=dense_e_cap, backend=backend,
        predict_fn=predict_fn, prim_transform=shade, shared_lens=shared_lens,
        device=device,
    )


class FusePlan:
    """Per-scene fusion plan from `plan_fuse`: the (possibly uni-permuted)
    faces to rasterize (on the device), the dense budget tuple (None for
    the tile rasterizer), and, when the plan split, `remap`, the (T,) map
    from the rasterizer's row ids to original face ids (faces[remap] is
    the permuted order). The remap rides the dense rasterizer's tables, so
    the accumulator lands in original face order and depth ties break by
    the original id, as in the unpermuted run. `lens_shared`: every view
    shares one lens and intrinsics (see lens_shared), so the fusions may
    compute the undistortion grid once."""

    __slots__ = ("faces", "dense_e_cap", "remap", "micro_max", "split_k",
                 "lens_shared")

    def __init__(self, faces, dense_e_cap, remap=None, micro_max=None,
                 split_k=0, lens_shared=False):
        self.faces = faces
        self.dense_e_cap = dense_e_cap
        self.remap = remap  # (T,) int32 permuted id -> original id
        self.micro_max = micro_max  # routing threshold probed (or None)
        self.split_k = split_k  # uni-prefix length (0 = no split)
        self.lens_shared = lens_shared


def plan_fuse(vertices, faces, rotations, translations, focal_lengths,
              principal_points, *, height, width, backend=None,
              clip_near=False, micro_max=None, distortions=None,
              allow_split=True, route=None, device="cuda"):
    """Probe a scene once and build the FusePlan every batched fusion
    shares. For the tile rasterizer this is a no-op plan (no probes, no
    budget). For the dense rasterizer: the routing pick (micro_max=None:
    dense.pick_route on the max routing curve over the views, with
    `route` overriding its cost coefficients) or the stats at a fixed
    micro_max, then the choice between the uni-slot prefix and micro
    compaction (dense.split_wins; the two are mutually exclusive).
    allow_split=False always plans compaction, and so does clip_near: its
    probes count the 2T piece rows, and a uni prefix would permute faces,
    not pieces. distortions: (N, 4|9) lens
    wires or None; the probes then run under each view's virtual focal
    (render._distortion_scales), the focal its render rasterizes with. A
    few host syncs in all, never one per view."""
    device = resolve_device(device)
    faces_t = torch.as_tensor(faces, dtype=torch.int64, device=device)
    n_rows = int(faces_t.shape[0]) * (2 if clip_near else 1)
    shared = lens_shared(focal_lengths, principal_points, distortions)
    if not rast.uses_dense(backend, int(faces_t.shape[0])):
        return FusePlan(faces_t, None, lens_shared=shared)
    dense = rast.dense
    face_vertices = fusion._as_f32(vertices, device)[faces_t]
    fl = focal_lengths
    if distortions is not None and np.any(_host(distortions)):
        s = render._distortion_scales(
            *(fusion._as_f32(a, device) for a in (
                focal_lengths, principal_points, distortions)),
            height=height, width=width)
        fl = _host(focal_lengths).astype(np.float32) * \
            s.cpu().numpy()[:, None]
    cams = (rotations, translations, fl, principal_points)
    kw = dict(face_vertices=face_vertices, height=height, width=width,
              device=device)
    if micro_max is None:
        curve = dense.routing_stats_batch(None, None, *cams,
                                          clip_near=clip_near, **kw)
        pairs, micro, micro_max = dense.pick_route(curve.tolist(), n_rows,
                                                   **(route or {}))
    else:
        pairs, micro = dense.candidate_stats_batch(
            None, None, *cams, clip_near=clip_near, micro_max=micro_max,
            **kw).tolist()

    if allow_split and not clip_near:
        perm, k = dense.uni_order(None, None, *cams, **kw)
        if k and dense.split_wins(k, n_rows, micro, micro_max):
            perm_t = torch.as_tensor(perm, device=device)
            pairs_s = int(dense.candidate_stats_batch(
                None, None, *cams, micro_split=k, micro_max=micro_max,
                **dict(kw, face_vertices=face_vertices[perm_t]))[0])
            return FusePlan(
                faces_t[perm_t],
                (dense.BUDGET_MARGIN * pairs_s, 0, micro_max, k),
                remap=perm_t.to(torch.int32), micro_max=micro_max,
                split_k=k, lens_shared=shared,
            )
    return FusePlan(
        faces_t,
        (dense.BUDGET_MARGIN * pairs, dense.BUDGET_MARGIN * micro,
         micro_max),
        micro_max=micro_max, lens_shared=shared,
    )


def fuse_views_planned(plan, vertices, rotations, translations,
                       focal_lengths, principal_points, probs,
                       images_equal_weight, weights=None, *,
                       num_primitives, aggregator, height, width, **kwargs):
    """fuse_views under a FusePlan (no probes). The accumulator comes out
    in original face order even when the plan split. Equals
    fuse_views(faces) on the plan's backend. A plan whose views share one
    lens hoists the grid, once lens_shared has held for this batch's
    `distortions` too (a plan may be reused on other views)."""
    if plan.dense_e_cap is not None:
        kwargs.setdefault("backend", "dense")
    dists = kwargs.get("distortions")
    if dists is not None and plan.lens_shared:
        kwargs.setdefault("shared_lens", lens_shared(
            focal_lengths, principal_points, dists))
    return fuse_views(
        vertices, plan.faces, rotations, translations, focal_lengths,
        principal_points, probs, images_equal_weight, weights,
        prim_remap=plan.remap, num_primitives=num_primitives,
        aggregator=aggregator, height=height, width=width,
        dense_e_cap=plan.dense_e_cap, **kwargs,
    )


def fuse_views_split(vertices, faces, rotations, translations,
                     focal_lengths, principal_points, probs,
                     images_equal_weight, weights=None, *, num_primitives,
                     aggregator, height, width, backend=None, clip_near=False,
                     micro_max=None, distortions=None, route=None,
                     device="cuda", **kwargs):
    """plan_fuse + fuse_views_planned in one call: the dense path's
    uni-slot prefix where dense.split_wins says it beats micro compaction,
    right-sized compaction budgets otherwise (always with clip_near).
    Equals fuse_views."""
    plan = plan_fuse(
        vertices, faces, rotations, translations, focal_lengths,
        principal_points, height=height, width=width, backend=backend,
        clip_near=clip_near, micro_max=micro_max, distortions=distortions,
        route=route, device=device,
    )
    if clip_near:
        kwargs["clip_near"] = True
    if backend is not None:
        kwargs["backend"] = backend
    if distortions is not None:
        kwargs["distortions"] = distortions
    return fuse_views_planned(
        plan, vertices, rotations, translations, focal_lengths,
        principal_points, probs, images_equal_weight, weights,
        num_primitives=num_primitives, aggregator=aggregator,
        height=height, width=width, device=device, **kwargs,
    )
