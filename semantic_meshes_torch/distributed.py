"""Batched render+fuse pipelines, on one device and across many.

Counterpart of `semantic_meshes/distributed.py`: `render_and_accumulate`,
`view_accumulate`, `lens_shared`, `fuse_views`, `FusePlan`, `plan_fuse`,
`fuse_views_planned`, `fuse_views_split`, `fuse_views_texels`, and the
multi-device layer `initialize_multihost`, `make_device_mesh` and
`make_sharded_fuse`. The JAX package scans the views inside one compiled
program; here each batched fusion is a Python loop over views whose every
step stays on the device (no host sync), with the (P, C) accumulator in
device memory. Distorted views (`distortions`, any COLMAP lens) render
under their virtual-pinhole focal and gather the primitive image onto the
distorted pixels before they fuse; `shared_lens` computes the
undistortion grid once for a batch of one physical camera. `clip_near`
renders each view through the near-plane clipper, as the per-view
renderers do; a clipped plan never takes the uni-slot split.

Across devices the port runs as PyTorch does: one process per card,
`torch.distributed` with NCCL on the cards (gloo when the caller asks for
`device="cpu"`), and a `DeviceMesh` with named dimensions `views`,
`pixels` and optionally `faces` in place of the JAX mesh. Every rank calls
the function `make_sharded_fuse` returns, as every chip runs the JAX
package's `shard_map` body.

Layout: probs here are (N, H, W, C), not the public API's (W, H).
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from . import fusion
from . import rasterize as rast
from . import render
from .data import resolve_device


def view_accumulate(prim_image, probs, weights, images_equal_weight,
                    num_primitives, aggregator, group=None):
    """Fusion contribution of one view: (H, W) ids x (H, W, C) probs ->
    (P, C). group: the MeshAxis the image's rows are split over (or None):
    the segment sums and pixels-per-face counts are summed over its ranks
    before the weight mix (fusion._accumulate_view)."""
    return fusion._accumulate_view(
        prim_image, probs, weights, images_equal_weight,
        num_primitives=num_primitives, aggregator=aggregator, group=group,
    )


def render_and_accumulate(vertices, faces, camera_arrays, probs, weights,
                          images_equal_weight, *, num_primitives, aggregator,
                          height, width, max_tris_per_tile=256,
                          prim_transform=None, face_vertices=None,
                          clip_near=False, dense_e_cap=None, tri_ids=None,
                          backend=None, resample_grid=None, group=None,
                          y_offset=None, device="cuda"):
    """One fused render+aggregate step on one view.

    camera_arrays: (rotation, translation, focal_lengths, principal_point).
    probs: (H, W, C); weights: optional (H, W). dense_e_cap: the dense
    rasterizer's probed budget (FusePlan); tri_ids: (T,) ids to emit per
    face row (a split plan's original face ids). prim_transform: optional
    `fn(tri_index, depth, camera_arrays) -> (H, W) primitive ids` (the
    texel shader, or a sharded fuse's face-block merge); without it the
    triangle ids are the primitives.
    resample_grid: optional (H, W, 2) undistorted normalized rays of the
    distorted pixel centres (render._undistort_grid), with the virtual
    (scaled) focal in camera_arrays: rasterizer and prim_transform run in
    pinhole space, and one gather maps the primitive image onto the
    distorted pixels before it fuses, as the per-view render() -> add()
    path does. clip_near: rasterize the near-plane-clipped pieces
    (tiles.setup_clipped). y_offset: render the row band [y_offset,
    y_offset + height) of a taller image; group: the MeshAxis whose ranks
    hold the other bands (view_accumulate). Returns
    ((P, C) fusion delta, overflow int32 tensor): overflow counts the
    candidate pairs and micro rows the rasterizer dropped under its budgets
    this view.
    """
    rot, trans, fl, pp = camera_arrays
    tri, depth, overflow = rast.rasterize(
        vertices, faces, rot, trans, fl, pp,
        y_offset=0.0 if y_offset is None else y_offset,
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
    delta = view_accumulate(
        tri, probs, weights, images_equal_weight,
        num_primitives, aggregator, group=group,
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
    `probs` then holds its inputs: a stack, or a tuple or list of stacks
    whose view i is the tuple of each stack's slice i (the JAX scan's
    pytree), e.g. top-k `(values, indices)` with probs_io.TopKDensify. prim_transform: see
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
        # a tuple or list of stacks is a pytree of per-view leaves, as the
        # JAX scan reads it: view i gets every leaf's slice i
        pr = tuple(leaf[i] for leaf in probs) if isinstance(
            probs, (tuple, list)) else probs[i]
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


# the face-block merge's "no triangle", above every id (the JAX
# package's 2**31 - 1)
_NO_ID = 2**31 - 1


def initialize_multihost(coordinator_address=None, num_processes=None,
                         process_id=None, *, device="cuda"):
    """Join the torch.distributed world: one process per card.

    The backend is NCCL for a CUDA `device` and gloo for the CPU; a CUDA
    request on a machine without a card raises (there is no gloo
    fallback). `coordinator_address` "host:port" is rank 0's rendezvous
    (tcp://); an address with a scheme, such as file:///path/store, is
    used as it is; without one the launcher's environment is read (env://:
    MASTER_ADDR, MASTER_PORT, WORLD_SIZE and RANK, as torch.distributed.run
    sets them). On a card the process first binds to its device (the
    device's index, else LOCAL_RANK, else process_id modulo the cards), so
    that NCCL does not put every rank on card 0. Call once per process
    before make_device_mesh; a no-op when the group is already
    initialised."""
    device = resolve_device(device)
    if dist.is_initialized():
        return
    if device.type == "cuda":
        local = device.index
        if local is None:
            local = int(os.environ.get("LOCAL_RANK", process_id or 0))
        torch.cuda.set_device(local % torch.cuda.device_count())
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    kwargs = {}
    if num_processes is not None:
        kwargs["world_size"] = int(num_processes)
    if process_id is not None:
        kwargs["rank"] = int(process_id)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method=init_method, **kwargs)


def make_device_mesh(views_axis=None, pixels_axis=1, faces_axis=1, *,
                     device="cuda"):
    """A (views, pixels[, faces]) DeviceMesh over every rank of the world.

    The default puts every rank on `views` (data parallel), the layout for
    plentiful images; pixels_axis > 1 splits each image's rows across
    ranks (frames too large for one card), faces_axis > 1 the mesh's
    triangles (a rasterize working set that outgrows one card). Every
    rank calls it, after initialize_multihost."""
    from torch.distributed.device_mesh import init_device_mesh

    device = resolve_device(device)
    n = dist.get_world_size()
    if views_axis is None:
        views_axis = n // (pixels_axis * faces_axis)
    if views_axis * pixels_axis * faces_axis != n:
        raise ValueError(
            f"views_axis * pixels_axis * faces_axis must equal device "
            f"count {n}"
        )
    if faces_axis > 1:
        return init_device_mesh(
            device.type, (views_axis, pixels_axis, faces_axis),
            mesh_dim_names=("views", "pixels", "faces"))
    return init_device_mesh(device.type, (views_axis, pixels_axis),
                            mesh_dim_names=("views", "pixels"))


class Collective(NamedTuple):
    """One collective a MeshAxis issued: the operation ("all_reduce_sum",
    "all_reduce_min" or "reduce_scatter"), the mesh dimensions it ran
    over, its input and output shapes, and whether it was skipped (over a
    single rank nothing moves)."""

    op: str
    axes: tuple
    in_shape: tuple
    out_shape: tuple
    skipped: bool


class MeshAxis:
    """Named dimensions of a DeviceMesh and the collectives over their
    ranks; every collective of make_sharded_fuse is issued here. Each call
    appends a Collective to `log` when one is given. Several names must be
    every dimension of a mesh over the whole world (the overflow sum)."""

    def __init__(self, mesh, names, log=None):
        sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
        self.names = tuple(names)
        self.size = int(np.prod([sizes[n] for n in self.names]))
        self.log = log
        if len(self.names) == 1:
            self.group = mesh.get_group(self.names[0])
        elif (set(self.names) == set(sizes)
              and mesh.size() == dist.get_world_size()):
            self.group = dist.group.WORLD
        else:
            raise ValueError(f"no process group for mesh dimensions "
                             f"{self.names} of a mesh {sizes}")

    def _record(self, op, t, out):
        if self.log is not None:
            self.log.append(Collective(op, self.names, tuple(t.shape),
                                       tuple(out.shape), self.size == 1))

    def all_reduce(self, t, op="sum"):
        """t summed ("sum") or minimised ("min") elementwise over the
        ranks, in place when t is contiguous."""
        t = t.contiguous()
        if self.size > 1:
            dist.all_reduce(t, op=getattr(dist.ReduceOp, op.upper()),
                            group=self.group)
        self._record(f"all_reduce_{op}", t, t)
        return t

    def reduce_scatter(self, t):
        """The sum over the ranks of t's row block with this rank's index
        (t's rows divide by the size), as the JAX package's tiled
        psum_scatter."""
        out = t
        if self.size > 1:
            out = t.new_empty((t.shape[0] // self.size, *t.shape[1:]))
            dist.reduce_scatter_tensor(out, t.contiguous(), group=self.group)
        self._record("reduce_scatter", t, out)
        return out


def merge_face_blocks(tri, depth, f0, faces):
    """Each pixel's winner across the face blocks of the MeshAxis `faces`:
    (H, W) int32 global triangle ids, -1 where no block covers the pixel.
    tri and depth are this rank's block render (block-local ids from row 0
    at `f0`, -1 and +inf where empty). Two MIN all-reduces, as the JAX
    package's two pmins: the depths' f32 bits as int32 (order-preserving
    for the rasterizer's non-negative depths; +inf where empty on every
    rank), then the global ids of the blocks at that depth, so a tie
    across blocks goes to the lowest id, as on one device."""
    zbits = depth.contiguous().view(torch.int32)
    zmin = faces.all_reduce(zbits.clone(), "min")
    tri_g = torch.where(tri >= 0, tri + f0, _NO_ID)
    win = faces.all_reduce(torch.where(zbits == zmin, tri_g, _NO_ID), "min")
    return torch.where(win < _NO_ID, win, -1)


def make_sharded_fuse(mesh, *, num_primitives, aggregator, height, width,
                      max_tris_per_tile=256, shard_primitives=False,
                      texel_params=None, clip_near=False, dense_e_cap=None,
                      with_weights=False, with_distortion=False,
                      shared_lens=False, backend=None, collectives=None):
    """Build the multi-device fuse over the DeviceMesh `mesh`
    (make_device_mesh). Every rank calls the returned function with the
    same global arguments: vertices, faces, rotations (N, 3, 3),
    translations (N, 3), focal_lengths and principal_points (N, 2), probs
    (N, H, W, C), images_equal_weight[, weights (N, H, W) when
    with_weights][, distortions (N, 4|9) when with_distortion], as numpy
    arrays or tensors. Each rank uploads only its slices to its device:

      - `views`: its contiguous block of N / views_axis views;
      - `pixels`: its row band [row0, row0 + H / pixels_axis) of probs and
        weights; the band rasterizes at y_offset = row0, and each view's
        (P, C+1) segment sums are summed over `pixels` before the weight
        mix (view_accumulate);
      - `faces` (an optional third dimension): its contiguous block of
        T / faces_axis triangles, rasterized by the backend its own face
        count picks; the blocks' winners merge per pixel by
        merge_face_blocks (two int32 MIN all-reduces; texel mode adds a
        third for the owner's texel ids).

    Returns (accumulator, overflow). The accumulator is the fully merged
    (P, C), the same on every rank (one all-reduce over `views` per call),
    or with shard_primitives=True this rank's block of P / n_ranks rows:
    each view's delta is reduce-scattered over `views` and sliced, so rank
    (v, p, f) holds the rows from ((v * pixels_axis + p) * faces_axis + f)
    * P / n_ranks on (the JAX package's out_specs P(('views', 'pixels'[,
    'faces']))). overflow: the int32 total of dropped candidates, summed
    over every rank (a band's tiles start at its row0, so under a per-tile
    cap they drop other candidates than one device's full image does).

    texel_params: (resolutions, first_texel_index) of a TexelsRenderer
    (pass its reordered faces); the texel shader runs on the band at its
    global rows. with_distortion: views render under their virtual
    pinholes and resample onto the distorted pixels; refused with a
    `pixels` axis above 1 (the resample gathers across bands).
    shared_lens: every view has one lens (lens_shared); the grid is
    computed once per rank. backend, dense_e_cap, clip_near,
    max_tris_per_tile: as fuse_views. collectives: a list to which every
    collective the function issues is appended (MeshAxis, Collective).
    """
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    n_views, n_pixels = sizes["views"], sizes["pixels"]
    n_faces = sizes.get("faces", 1)
    if with_distortion and n_pixels > 1:
        raise ValueError(
            "with_distortion is incompatible with a 'pixels' mesh axis > 1 "
            "(the undistortion resample gathers across row bands); shard "
            "distorted scenes over 'views' (and optionally 'faces')"
        )
    local_h = height // n_pixels
    if local_h * n_pixels != height:
        raise ValueError(
            f"height {height} must divide by 'pixels' axis {n_pixels}"
        )
    n_chips = n_views * n_pixels * n_faces
    if shard_primitives and num_primitives % n_chips != 0:
        raise ValueError(
            f"num_primitives ({num_primitives}) must divide by the total "
            f"chip count {n_chips} for shard_primitives"
        )
    device = resolve_device(mesh.device_type)
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    views = MeshAxis(mesh, ("views",), collectives)
    pixels = MeshAxis(mesh, ("pixels",), collectives)
    faces_axis = MeshAxis(mesh, ("faces",), collectives) \
        if n_faces > 1 else None
    every = MeshAxis(mesh, mesh.mesh_dim_names, collectives)
    v = mesh.get_local_rank("views")
    p = mesh.get_local_rank("pixels")
    f = mesh.get_local_rank("faces") if n_faces > 1 else 0
    row0 = p * local_h
    blk_rows = num_primitives // n_chips

    def fuse(vertices, faces, rotations, translations, focal_lengths,
             principal_points, probs, images_equal_weight, *extra):
        if len(extra) != with_weights + with_distortion:
            raise TypeError(
                f"the fuse takes {8 + with_weights + with_distortion} "
                f"arguments (with_weights={with_weights}, with_distortion="
                f"{with_distortion}), got {8 + len(extra)}")
        weights = extra[0] if with_weights else None
        distortions = extra[-1] if with_distortion else None
        n = len(rotations)
        if n == 0 or n % n_views:
            raise ValueError(
                f"view count {n} must be a positive multiple of the "
                f"'views' axis {n_views}")
        T = len(faces)
        if T % n_faces:
            raise ValueError(
                f"face count {T} must divide by the 'faces' axis "
                f"{n_faces} (pad with degenerate faces)"
            )
        blk = T // n_faces
        f0 = f * blk
        nloc = n // n_views
        images_equal_weight = float(images_equal_weight)
        vs = slice(v * nloc, (v + 1) * nloc)
        rows = slice(row0, row0 + local_h)
        vertices = fusion._as_f32(vertices, device)
        faces = torch.as_tensor(faces[f0:f0 + blk], dtype=torch.int64,
                                device=device)
        face_vertices = vertices[faces]
        rot, trans, fl, pp = (fusion._as_f32(a[vs], device) for a in (
            rotations, translations, focal_lengths, principal_points))
        probs = fusion._as_f32(probs[vs, rows], device)
        if weights is not None:
            weights = fusion._as_f32(weights[vs, rows], device)
        if texel_params is not None:
            res, first = (torch.as_tensor(a[f0:f0 + blk], dtype=torch.int32,
                                          device=device)
                          for a in texel_params)
        hoisted = None
        if distortions is not None:
            distortions = fusion._as_f32(distortions[vs], device)
            if shared_lens:
                hoisted = render._undistort_grid(
                    fl[0], pp[0], distortions[0], height=local_h,
                    width=width)

        def prim_transform(tri, depth, camera_arrays):
            """The texel shade and / or the face-block merge of one
            view's band (the JAX package's prim_transform_factory)."""
            def shade(t):
                return render._texel_prim_image(
                    vertices, faces, *camera_arrays, t, res, first,
                    num_primitives, y_offset=row0, clip_near=clip_near)

            if faces_axis is None:
                return shade(tri)
            win = merge_face_blocks(tri, depth, f0, faces_axis)
            if texel_params is None:
                return win
            # the winner's owner shades it (the don't-care sentinel where
            # its resolution is 0); a third MIN hands its ids to the rest
            owned = (win >= f0) & (win < f0 + blk)
            prim = shade(torch.where(owned, win - f0, -1))
            prim = faces_axis.all_reduce(
                torch.where(owned, prim, _NO_ID), "min")
            return torch.where(prim < _NO_ID, prim, num_primitives)

        transform = prim_transform if (faces_axis is not None
                                       or texel_params is not None) else None
        acc = None
        overflow = torch.zeros((), dtype=torch.int32, device=device)
        for i in range(nloc):
            fl_i, grid = fl[i], None
            if distortions is not None:
                # no pixels axis here: the band is the whole image
                grid, s = hoisted if hoisted is not None else \
                    render._undistort_grid(fl_i, pp[i], distortions[i],
                                           height=local_h, width=width)
                fl_i = fl_i * s
            delta, ov = render_and_accumulate(
                vertices, faces, (rot[i], trans[i], fl_i, pp[i]), probs[i],
                None if weights is None else weights[i], images_equal_weight,
                num_primitives=num_primitives, aggregator=aggregator,
                height=local_h, width=width,
                max_tris_per_tile=max_tris_per_tile, prim_transform=transform,
                face_vertices=face_vertices, clip_near=clip_near,
                dense_e_cap=dense_e_cap, backend=backend, resample_grid=grid,
                group=pixels, y_offset=row0, device=device,
            )
            if shard_primitives:
                # merge this view now: its `views` reduce-scatter keeps
                # P / views_axis rows, of which the (pixels, faces) index
                # picks this rank's block (delta is the same over `pixels`
                # and `faces` already), so no rank holds a (P, C)
                # accumulator
                delta = views.reduce_scatter(delta)
                j = p * n_faces + f
                delta = delta[j * blk_rows:(j + 1) * blk_rows]
            acc = delta if acc is None else acc + delta
            overflow = overflow + ov
        if not shard_primitives:
            acc = views.all_reduce(acc)
        return acc, every.all_reduce(overflow)

    return fuse
