"""Public render API: `triangles(mesh)` and `texels(mesh, cameras, tpp)`.

Counterpart of `TrianglesRenderer`, `TexelsRenderer`, `_OverflowPolicy`,
`_DenseCapPolicy`, the dense probes, the texel sizing and shader, and
`triangles()` / `texels()` in `semantic_meshes/render.py` (reference:
python/semantic_meshes/src/Render.cu:12-25,
include/semantic_meshes/render/TriangleRenderer.h:11-95,
TexturedTriangleRenderer.h:54-226).

`renderer.render(camera)` returns `(primitive_indices, depth)` as tensors
on the renderer's device shaped (width, height), the reference's layout.
Ids are `torch.uint32`: the bit view of an int32 image that holds -1 for
background, so empty pixels read 0xFFFFFFFF. Depth is f32 with +inf for
background. Inside the port, ids travel as int32 with -1 for background.

Meshes of DENSE_THRESHOLD faces or more go to the dense rasterizer, whose
budgets the renderer probes once per resolution (`_DenseCapPolicy`); the
rest go to the tile rasterizer, whose per-tile list `prepare` sizes from a
probe of every camera (`tile_caps`; the JAX package keeps its fixed
max_tris_per_tile, which a renderer never prepared keeps too). Texel
mode rasterizes whole triangles the same way and turns each pixel's
triangle id into a texel id with `_texel_prim_image`.

A camera with a nonzero lens (any COLMAP model, on the classic (4,) or
the extended (9,) wire, see geometry.py) renders as a pinhole render under
a virtual focal fl * s (s <= 1, from `_undistort_grid`), shaded there, and
then one gather that samples that image at each distorted pixel's
undistorted ray (`_resample_wh`). A zero lens inside a distorted batch
takes that path too and gives the pinhole render's bits.

`clip_near=True` renders the in-front part of every triangle that crosses
the near plane (cameras inside the scene, e.g. indoor ScanNet) instead of
culling it: the rasterizers resolve the 2T clipped pieces (budgets count
pieces) and return triangle ids; texel mode sizes straddling triangles by
their clamped piece areas and shades with the camera-space ray form.

`bucket=True` (or `SM_FACE_BUCKETS` set and not "0" when `bucket` is None)
pads the face and vertex counts up to a coarse bucket (`_face_bucket`) with
degenerate rows, as the JAX package does, and a texel renderer's sizing
pads the camera count too. The padding renders nothing, but the renderer
routes on the padded face count: a mesh of 14337-16383 faces pads to
DENSE_THRESHOLD and goes to the dense rasterizer, as it does in the JAX
package on its own device.
"""

from __future__ import annotations

import logging
import os

import numpy as np
import torch

from . import geometry, texel_kernel
from . import rasterize as rast
from .data import (Camera, Colmap, Ply, resolve_device, stack_cameras,
                   stack_distortions)
from .fusion import _as_f32
from .profiling import annotate, counter_max, span
from .rasterize.dense import _to_i32

logger = logging.getLogger("semantic_meshes_torch")


def _has_distortion(cameras):
    """True when any camera carries a nonzero lens (host-side check)."""
    for c in cameras:
        d = getattr(c, "distortion", None)
        if d is not None and np.any(np.asarray(d)):
            return True
    return False


def _camera_hw(camera: Camera):
    # camera.resolution is (width, height); the rasterizer works in (H, W)
    return camera.resolution[1], camera.resolution[0]


class _OverflowPolicy:
    """Overflow reporting without a device sync per frame.

    Overflow is a configuration property (a budget too small for this mesh
    at this resolution), so "first" (the default mode) checks
    synchronously on each key's first frame and stays asynchronous
    afterwards; "always" checks every frame; "never" checks nothing. Every
    frame's overflow tensor is kept unsynced and summed on demand by
    total(), so no drop passes unseen: read overflow_total() at the end of
    a run.
    """

    RECHECK_EVERY = 64

    def __init__(self, mode="first"):
        self.mode = mode
        self._calls = {}  # key -> number of check() calls so far
        self._pending = {}  # key -> per-frame device scalars (unsynced)
        self._base = {}  # key -> synced drop total
        self._warned = {}  # key -> drop total already reported
        self._dropped = set()  # keys with any detected drops so far

    def check(self, overflow, key, max_tris_per_tile, dense=False,
              recheck=False, hot=False):
        """Returns the number of new drops found by this call (0 when it
        stayed asynchronous or nothing new accrued); the renderers
        invalidate the dense cap on a nonzero return.

        recheck: later frames may breach this key's budget (every dense
        key), so in "first" mode it also re-checks at power-of-two call
        counts (frames 2, 3, 5, 9, 17, ...): a persistent breach is found
        within ~2x its onset, for O(log N) syncs in all. hot: the key is
        known to be breach-prone (a zero-pinned dense budget); it then also
        re-checks every RECHECK_EVERY frames, as does every key that has
        dropped."""
        if self.mode == "never":
            return 0
        self._pending.setdefault(key, []).append(overflow)
        n = self._calls.get(key, 0)
        self._calls[key] = n + 1
        first = n == 0
        if (
            self.mode == "first"
            and not first
            and not (recheck and (
                (n & (n - 1)) == 0  # n is a power of two
                or ((hot or key in self._dropped)
                    and n % self.RECHECK_EVERY == 0)
            ))
        ):
            return 0
        # per-key totals and watermarks: a warning never attributes one
        # resolution's drops to another, nor repeats drops already reported
        total = self._key_total(key)  # one sync, drains this key's pending
        new = total - self._warned.get(key, 0)
        if not new:
            return 0
        self._warned[key] = total
        self._dropped.add(key)
        if first or self.mode == "always":
            knob = (
                "e_cap_rows/n_global (dense backend)" if dense
                else f"max_tris_per_tile (current {max_tris_per_tile})"
            )
            logger.warning(
                "rasterizer overflow: %d candidate pairs dropped; "
                "raise %s", new, knob,
            )
        else:
            logger.warning(
                "rasterizer overflow: %d candidate pairs dropped since "
                "the last check at %s; later frames exceed the probe "
                "frame — re-probe or set e_cap_rows explicitly", new, key,
            )
        return new

    def _key_total(self, key) -> int:
        pend = self._pending.get(key)
        if pend:
            self._base[key] = self._base.get(key, 0) + int(
                torch.stack(pend).sum()
            )
            pend.clear()
        return self._base.get(key, 0)

    def total(self) -> int:
        """Accumulated dropped pairs across all renders so far (one sync)."""
        for key in list(self._pending):
            self._key_total(key)
        return sum(self._base.values())


class _DenseCapPolicy:
    """Caches the dense rasterizer's budget per resolution.

    A budget (dense.DenseBudget) is probed once per resolution, with one
    sync (dense.probe_budget); render_many and prepare probe the max over
    their whole batch. For single renders, a later view above the margin
    spills to the overflow counter, and when the overflow policy finds
    the breach the budget is invalidated, so the next render re-probes
    over a grow-only floor (DenseBudget.grown).
    """

    def __init__(self):
        self._cap = {}  # (H, W) -> DenseBudget
        self._floor = {}  # (H, W) -> floor DenseBudget (grow-only re-probes)

    def lookup(self, key, probe):
        """probe(floor) -> the DenseBudget of the views at hand over key's
        floor (None before any breach); cached per key. A pair budget of 0
        makes the dense backend skip binning and its kernel; any later
        pair at this resolution spills to overflow, as do micro rows past
        the micro budget."""
        if key not in self._cap:
            self._cap[key] = probe(self._floor.get(key))
        return self._cap[key]

    def invalidate(self, key):
        """Drop the cached budget so the next render re-probes, over the
        breached budget's grown floor."""
        cap = self._cap.pop(key, None)
        if cap is not None:
            self._floor[key] = cap.grown()


def _batch(rot, trans, fl, pp):
    """Camera arrays as a batch (leading axis) of f32 numpy arrays."""
    arrs = [np.asarray(a, np.float32) for a in (rot, trans, fl, pp)]
    if arrs[0].ndim == 2:
        arrs = [a[None] for a in arrs]
    return arrs


def _size_bucket(t: int, floor: int) -> int:
    """Round a count up to a coarse bucket: at most ~25% padding, 8 buckets
    per power of two (`semantic_meshes.render._size_bucket`)."""
    if t <= floor:
        return floor
    step = 1 << max(t.bit_length() - 3, 8)
    return -(-t // step) * step


def _face_bucket(t: int) -> int:
    """The face and vertex count bucket (`semantic_meshes.render.
    _face_bucket`)."""
    return _size_bucket(t, 1024)


def _bucket_enabled(bucket) -> bool:
    """bucket, or with None the SM_FACE_BUCKETS environment variable (set
    and not "0")."""
    if bucket is None:
        return os.environ.get("SM_FACE_BUCKETS", "") not in ("", "0")
    return bool(bucket)


def _pad_faces(faces, vertices):
    """Faces padded up to their bucket with all-zero rows: a padding face
    is vertex 0 three times, of zero screen area, so setup marks it invalid
    (denominator 0) and it renders nothing. A mesh without vertices is not
    padded. Returns (padded faces, the real count)."""
    t = int(faces.shape[0])
    target = _face_bucket(t)
    if target == t or vertices.shape[0] == 0:
        return faces, t
    return torch.cat([faces, faces.new_zeros((target - t, 3))]), t


def _pad_vertices(vertices):
    """Vertices padded up to their bucket with zero rows, which no face
    references (padding faces reference vertex 0). An empty vertex array
    is not padded."""
    v = int(vertices.shape[0])
    target = _face_bucket(v)
    if target == v or v == 0:
        return vertices
    return torch.cat([vertices,
                      vertices.new_zeros((target - v, vertices.shape[1]))])


class TrianglesRenderer:
    """Whole-triangle primitive renderer (primitive index == triangle
    index), on `device` (default "cuda").

    backend: None picks the dense rasterizer at DENSE_THRESHOLD faces or
    more and the tile rasterizer below; "tile" or "dense" forces one.
    micro_max: the dense routing threshold; None picks one per resolution
    from one probe (dense.pick_route). route: keyword overrides of the
    pick's cost coefficients (alpha, beta, gamma; dense.pick_micro_max).
    clip_near: render the in-front part of triangles that cross the near
    plane (tiles.setup_clipped) instead of culling them; the dense budgets
    then count the 2T piece rows. bucket: pad the vertices, then the
    faces, up to their `_face_bucket` (None reads SM_FACE_BUCKETS); the
    backend and the budgets then follow the padded face count, while
    getPrimitivesNum() stays the real one. max_tris_per_tile: the tile
    route's per-tile list length, which `prepare` raises per resolution
    to what its cameras need (`tile_caps`).
    """

    def __init__(self, mesh: Ply, max_tris_per_tile: int = 256,
                 backend: str | None = None, clip_near: bool = False,
                 bucket: bool | None = None, micro_max=None, route=None,
                 device="cuda"):
        rast.dense._check_micro_max(micro_max)
        self.device = resolve_device(device)
        self.mesh = mesh
        self.vertices = torch.as_tensor(
            np.asarray(mesh.vertices, np.float32), device=self.device
        )
        self.faces = torch.as_tensor(
            np.asarray(mesh.faces, np.int64), device=self.device
        )
        self._num_faces = int(self.faces.shape[0])
        if _bucket_enabled(bucket):
            self.vertices = _pad_vertices(self.vertices)
            self.faces, _ = _pad_faces(self.faces, self.vertices)
        rast.check_backend(int(self.faces.shape[0]), backend)
        # pre-expanded face-vertex positions: per-view setup is gather-free
        self.face_vertices = self.vertices[self.faces]
        self.max_tris_per_tile = int(max_tris_per_tile)
        self.backend = backend
        self.clip_near = bool(clip_near)
        self.micro_max = micro_max
        self.route = dict(route or {})
        self.overflow_policy = _OverflowPolicy()
        self.dense_cap_policy = _DenseCapPolicy()
        self.tile_caps = {}  # (H, W) -> the tile route's list length

    def getPrimitivesNum(self) -> int:
        return self._num_faces

    def _tile_cap(self, key):
        """The tile route's per-tile list length at key = (H, W)."""
        return self.tile_caps.get(key, self.max_tris_per_tile)

    def _size_tile_lists(self, height, width, rot, trans, fl, pp,
                         dist=None):
        """Grow the tile route's list length at (height, width) to the
        largest tile list over the cameras (a batch), rounded up to a
        multiple of 32, and at least max_tris_per_tile; one host sync. A
        no-op for the dense backend. dist as in _dense_e_cap. The profiling
        counters `tiles.max_tile_rows` and `tiles.cap` record both."""
        if rast.uses_dense(self.backend, int(self.faces.shape[0])):
            return
        rot, trans, fl, pp = _batch(rot, trans, fl, pp)
        fl_v = _virtual_focals(fl, pp, dist, height=height, width=width,
                               device=self.device)
        rows = int(rast.tiles.max_tile_rows(
            self.face_vertices, rot, trans, fl_v, pp, height=height,
            width=width, clip_near=self.clip_near, device=self.device))
        key = (height, width)
        cap = max(self._tile_cap(key), -(-rows // 32) * 32)
        self.tile_caps[key] = cap
        counter_max("tiles.max_tile_rows", rows)
        counter_max("tiles.cap", cap)

    def _dense_e_cap(self, height, width, rot, trans, fl, pp, dist=None):
        """The dense budget (a dense.DenseBudget) for (height, width),
        probed over the given cameras (a batch, or one camera) on first
        use; None for the tile backend. dist: the cameras' lenses (None for
        pinholes); the probe then runs under each view's virtual focal
        fl * s, the focal its render rasterizes with."""
        if not rast.uses_dense(self.backend, int(self.faces.shape[0])):
            return None
        rot, trans, fl, pp = _batch(rot, trans, fl, pp)

        def probe(floor):
            fl_v = _virtual_focals(fl, pp, dist, height=height, width=width,
                                   device=self.device)
            return rast.dense.probe_budget(
                self.face_vertices, rot, trans, fl_v, pp, height=height,
                width=width, clip_near=self.clip_near,
                micro_max=self.micro_max, route=self.route, floor=floor,
                device=self.device)
        return self.dense_cap_policy.lookup((height, width), probe)

    def _view(self, camera, dense_e_cap, dist=None):
        """(ids (W, H) int32 with -1 empty, depth (W, H) f32, overflow) of
        one camera. dist: None renders the pinhole; a lens wire (zero or
        not) renders under the virtual focal fl * s, shades there and
        resamples onto the distorted pixels, as the JAX package's
        `_render_triangles_distorted_jit` / `_render_texels_distorted_jit`
        do."""
        height, width = _camera_hw(camera)
        rot, trans, fl, pp = _camera_arrays(camera)
        if dist is not None:
            fl, pp, dist = (_as_f32(a, self.device) for a in (fl, pp, dist))
            grid, s = _undistort_grid(fl, pp, dist, height=height,
                                      width=width)
            fl = fl * s
        arrays = (rot, trans, fl, pp)
        tri, depth, overflow = rast.rasterize(
            self.vertices, self.faces, *arrays,
            face_vertices=self.face_vertices, backend=self.backend,
            height=height, width=width,
            max_tris_per_tile=self._tile_cap((height, width)),
            clip_near=self.clip_near, dense_e_cap=dense_e_cap,
            device=self.device,
        )
        ids = self._shade(arrays, tri)
        if dist is None:
            return ids.t(), depth.t(), overflow
        return (*_resample_wh(ids.t(), depth.t(), grid, fl, pp), overflow)

    def _check_overflow(self, overflow, key, dense_e_cap):
        """Overflow policy check + dense-budget regrowth: every dense key
        re-checks at the policy's low duty cycle, and a drop found after
        the probe invalidates the cached cap, so the next render re-probes
        with a grow-only budget."""
        new = self.overflow_policy.check(
            overflow, key, self._tile_cap(key),
            dense=(dense_e_cap is not None),
            recheck=(dense_e_cap is not None),
            hot=dense_e_cap is not None and dense_e_cap.zero,
        )
        if new and dense_e_cap is not None:
            self.dense_cap_policy.invalidate(key)

    def _shade(self, camera_arrays, tri):
        """Primitive ids (int32, -1 for none) of a triangle-id image
        rasterized under camera_arrays: the triangle ids themselves
        (TexelsRenderer shades them into texels)."""
        return tri

    def render(self, camera: Camera):
        """(ids (W, H) uint32, depth (W, H) f32) on the renderer's device."""
        with span("smt.render"):
            dist = camera.distortion if _has_distortion([camera]) else None
            hw = _camera_hw(camera)
            dense_e_cap = self._dense_e_cap(*hw, *_camera_arrays(camera),
                                            dist=dist)
            ids, depth, overflow = self._view(camera, dense_e_cap, dist)
            self._check_overflow(overflow, hw, dense_e_cap)
            return ids.contiguous().view(torch.uint32), depth.contiguous()

    def render_many(self, cameras):
        """Render same-resolution cameras: (ids (N, W, H) uint32, depth
        (N, W, H) f32). The dense budget is probed over the whole batch;
        when any camera has a lens, every view takes the distorted path
        (lenses stacked by data.stack_distortions)."""
        cams = list(cameras)
        hw = _camera_hw(cams[0])
        if any(_camera_hw(c) != hw for c in cams):
            raise ValueError("render_many needs equal camera resolutions")
        with span("smt.render"):
            lenses = stack_distortions(cams) if _has_distortion(cams) \
                else None
            dense_e_cap = self._dense_e_cap(*hw, *stack_cameras(cams),
                                            dist=lenses)
            out = [self._view(c, dense_e_cap, None if lenses is None else
                              lenses[k]) for k, c in enumerate(cams)]
            self._check_overflow(torch.stack([o for _, _, o in out]).sum(),
                                 hw, dense_e_cap)
            ids = torch.stack([i for i, _, _ in out])
            return ids.view(torch.uint32), torch.stack(
                [d for _, d, _ in out])

    def overflow_total(self) -> int:
        """Total dropped candidate pairs across all renders (syncs once)."""
        return self.overflow_policy.total()

    def prepare(self, cameras):
        """Pre-size the rasterizer for a whole camera set: one probe of the
        max over all cameras per resolution (under the virtual focals of
        distorted cameras), so later renders never breach: the dense
        budgets, or the tile route's per-tile list length."""
        by_hw = {}
        for c in cameras:
            by_hw.setdefault(_camera_hw(c), []).append(c)
        with annotate("smt.setup.budgets"):
            for (height, width), group in by_hw.items():
                arrays = stack_cameras(group)
                dist = (stack_distortions(group) if _has_distortion(group)
                        else None)
                self._dense_e_cap(height, width, *arrays, dist=dist)
                self._size_tile_lists(height, width, *arrays, dist=dist)


def _texel_resolutions(vertices, faces, cameras, texels_per_pixel,
                       clip_near=False, bucket=False):
    """Per-triangle texel grid resolution r = ceil(tpp * sqrt(max screen
    area)) as (T,) int32 on the device of `vertices`.

    The reference's host loop over (triangles x cameras)
    (ref: TexturedTriangleRenderer.h:93-127): a camera counts a triangle's
    screen area iff a vertex lies in front of it (z > 0) and all three
    projected vertices fall inside the 0.5-resolution border box around
    the image. A running max over the cameras keeps memory O(T) however
    many cameras there are.

    clip_near: a camera keeps the reference's area where it is positive
    (all three vertices in front of the clipping plane and inside the
    box); otherwise, for straddlers and triangles partly out of frame, the
    summed area of the clipped pieces with their projected vertices
    clamped into the box (a straddler's raw projection is unbounded), so
    a triangle the clipped rasterizer covers gets texels.

    bucket: pad the camera count up to `_size_bucket(C, 16)`, as the JAX
    package does, with cameras of identity rotation, zero translation,
    focal (1, 1), principal point (0, 0) and resolution (0, 0): their
    border box is empty, so they add zero area under both rules."""
    device = vertices.device

    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=device)

    cams = [np.asarray(a, np.float32) for a in stack_cameras(cameras)]
    cams.append(np.asarray([c.resolution for c in cameras], np.float32))
    n = _size_bucket(len(cameras), 16) - len(cameras) if bucket else 0
    if n > 0:
        pad = (np.broadcast_to(np.eye(3, dtype=np.float32), (n, 3, 3)),
               np.zeros((n, 3), np.float32), np.ones((n, 2), np.float32),
               np.zeros((n, 2), np.float32), np.zeros((n, 2), np.float32))
        cams = [np.concatenate([a, b]) for a, b in zip(cams, pad)]
    rot, trans, fl, pp, res = (f32(a) for a in cams)
    flat = vertices[faces.long()].reshape(-1, 3)  # (3T, 3), gathered once
    max_area = torch.zeros(faces.shape[0], dtype=torch.float32,
                           device=device)
    for k in range(len(rot)):
        cam = geometry.rigid_transform(rot[k], trans[k], flat)
        lo = -0.5 * res[k]
        hi = 1.5 * res[k]
        p = geometry.pinhole_project(fl[k], pp[k], cam).reshape(-1, 3, 2)
        inside = ((p >= lo) & (p < hi)).reshape(-1, 6).all(dim=-1)
        area = geometry.triangle_screen_area(p)
        if clip_near:
            all_front = (cam[:, 2].reshape(-1, 3)
                         > rast.tiles.CLIP_Z_NEAR).all(dim=-1)
            area = torch.where(all_front & inside, area,
                               torch.zeros_like(area))
            pieces, valid = geometry.clip_triangles_near(
                cam.reshape(-1, 3, 3), rast.tiles.CLIP_Z_NEAR)
            pc = geometry.pinhole_project(fl[k], pp[k],
                                          pieces.reshape(-1, 3))
            pc = torch.minimum(torch.maximum(pc, lo), hi)
            piece_area = geometry.triangle_screen_area(
                pc.reshape(-1, 3, 2)).reshape(-1, 2)
            area_clip = torch.where(valid, piece_area,
                                    torch.zeros_like(piece_area)).sum(-1)
            area = torch.where(area > 0, area, area_clip)
        else:
            in_front = (cam[:, 2].reshape(-1, 3) > 0).any(dim=-1)
            area = torch.where(in_front & inside, area,
                               torch.zeros_like(area))
        max_area = torch.maximum(max_area, area)
    return torch.ceil(float(texels_per_pixel) * torch.sqrt(max_area)).to(
        torch.int32)


class TexelsRenderer(TrianglesRenderer):
    """Sub-triangle texel renderer (the paper's texel mode), on `device`
    (default "cuda"): each triangle is cut into an r x r triangular grid of
    r(r+1)/2 texel primitives, so fusion resolution does not depend on
    triangle size.

    cameras: a Colmap workspace or a list of Cameras, used once to size
    each triangle's grid (`_texel_resolutions`, on the faces as given);
    then each face is reordered so its most right-angled vertex maps to uv
    (0, 0) (`geometry.reorder_faces_for_texels`; the mesh's own face array
    is not touched). Rendering, budgets and overflow are
    TrianglesRenderer's, with each triangle-id image shaded into texel ids;
    pixels of no texel (background, or a triangle no sizing camera saw)
    read 0xFFFFFFFF. backend, clip_near and bucket as in
    TrianglesRenderer; with clip_near the sizing counts clipped pieces and
    the shader uses the camera-space ray form. With bucket the sizing runs
    on the padded faces and a padded camera set, every padding face gets
    resolution 0 (no texels), and the texel ids do not change."""

    def __init__(self, mesh: Ply, cameras, texels_per_pixel: float = 0.1,
                 max_tris_per_tile: int = 256, backend: str | None = None,
                 clip_near: bool = False, bucket: bool | None = None,
                 device="cuda"):
        bucket = _bucket_enabled(bucket)
        super().__init__(mesh, max_tris_per_tile, backend, clip_near,
                         bucket=bucket, device=device)
        if isinstance(cameras, Colmap):
            cameras = cameras.getCameras()
        cameras = list(cameras)
        if not cameras:
            raise ValueError("texels renderer needs at least one camera")
        # the span ends with the read that waits for the sizing's device
        # work
        with annotate("smt.setup.texel_sizing"):
            self.resolutions = _texel_resolutions(
                self.vertices, self.faces, cameras, texels_per_pixel,
                self.clip_near, bucket)
            resolutions = self.resolutions.cpu()
        self.faces = geometry.reorder_faces_for_texels(self.vertices,
                                                       self.faces)
        self.face_vertices = self.vertices[self.faces]
        counts = geometry.texel_count(resolutions.long()).numpy()
        first = np.zeros(len(counts) + 1, np.int64)
        np.cumsum(counts, out=first[1:])
        self._primitive_num = int(first[-1])
        if self._primitive_num >= 2 ** 31:
            raise ValueError(f"{self._primitive_num} texels overflow int32 "
                             "ids; lower texels_per_pixel")
        self.first_texel_index = torch.as_tensor(
            first[:-1].astype(np.int32), device=self.device)
        logger.info(
            "Got %d triangles, %d texels and %d triangles without texels",
            self._num_faces, self._primitive_num,
            int(np.sum(counts[:self._num_faces] == 0)),
        )

    def getPrimitivesNum(self) -> int:
        return self._primitive_num

    def _shade(self, camera_arrays, tri):
        # camera_arrays carry the virtual focal of a distorted view: the
        # shader must see the focal the triangle ids were rasterized under
        with span("smt.texel_shader"):
            return _texel_prim_image(
                self.vertices, self.faces, *camera_arrays, tri,
                self.resolutions, self.first_texel_index, -1,
                clip_near=self.clip_near)


def _camera_arrays(camera):
    return (camera.rotation, camera.translation, camera.focal_lengths,
            camera.principal_point)


def _texel_prim_image(vertices, faces, rotation, translation, focal_lengths,
                      principal_point, tri_index, resolutions,
                      first_texel_index, num_primitives, y_offset=0,
                      clip_near=False):
    """Texel primitive ids (H, W) int32 of a rasterized triangle-id image
    tri_index (H, W) int32 (-1 empty); pixels of no texel (empty, or on a
    triangle of resolution 0) get `num_primitives`, the id the caller
    gives them (the texel count P, or -1).

    A CUDA tri_index is shaded by the hand-written kernels of texel_kernel
    (two launches, the camera by value, no host wait), a CPU one by the
    plain chain `_texel_prim_image_plain`; both give the same ids."""
    if tri_index.is_cuda:
        return texel_kernel.texel_ids(
            vertices, faces, (rotation, translation, focal_lengths,
                              principal_point), tri_index, resolutions,
            first_texel_index, num_primitives, y_offset=y_offset,
            clip_near=clip_near)
    return _texel_prim_image_plain(
        vertices, faces, rotation, translation, focal_lengths,
        principal_point, tri_index, resolutions, first_texel_index,
        num_primitives, y_offset, clip_near)


def _texel_prim_image_plain(vertices, faces, rotation, translation,
                            focal_lengths, principal_point, tri_index,
                            resolutions, first_texel_index, num_primitives,
                            y_offset=0, clip_near=False):
    """_texel_prim_image as a chain of PyTorch ops: the CPU implementation
    and the card kernels' oracle (texel_kernel).

    TexturedTriangle::getTexelIndex (ref: TexturedTriangleRenderer.h:31-41)
    as a pass over the winning fragments. A pixel's perspective-correct uv
    is a ratio of affine forms, u = A1(x, y) / S(x, y), v = A2 / S, with
    A_i = w_i * inv_z_i and S = A0 + A1 + A2, so the shader reads one
    table row per pixel: the 9 f32 coefficients of A1, A2 and S as int32
    bits, the resolution and the first texel index, (T, 11) int32. u and v
    are true divisions. Runs on tri_index's device; the same op order as
    the JAX package's `_texel_prim_image`.

    clip_near: the forms come from camera-space vertices V_i instead: for
    the pixel ray d(x, y) = ((x - cx) / fx, (y - cy) / fy, 1), A_i =
    d . (V_j x V_k) is affine in (x, y) and holds when a vertex lies
    behind the camera, so the triangle ids of a clipped render index the
    per-triangle table as usual. The cross products are written out as
    separate multiplies and subtractions (a fused cross kernel on the card
    may contract a*b - c*d into an FMA, which the CPU's does not) and the
    focal lengths divide truly, so the card's ids equal the CPU's."""
    device = tri_index.device

    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=device)

    faces = torch.as_tensor(faces, device=device).long()
    if clip_near:
        v_cam = geometry.rigid_transform(f32(rotation), f32(translation),
                                         f32(vertices))[faces]  # (T, 3, 3)
        fl, pp = f32(focal_lengths), f32(principal_point)

        def aff_ray(j, k):  # d . (V_j x V_k) as an affine form in (x, y)
            vj, vk = v_cam[:, j], v_cam[:, k]
            n0 = vj[:, 1] * vk[:, 2] - vj[:, 2] * vk[:, 1]
            n1 = vj[:, 2] * vk[:, 0] - vj[:, 0] * vk[:, 2]
            n2 = vj[:, 0] * vk[:, 1] - vj[:, 1] * vk[:, 0]
            a = torch.div(n0, fl[0])
            b = torch.div(n1, fl[1])
            return [a, b, n2 - pp[0] * a - pp[1] * b]

        aff = [aff_ray(1, 2), aff_ray(2, 0), aff_ray(0, 1)]
    else:
        pix, z_cam = rast.tiles.project_vertices(
            f32(vertices), f32(rotation), f32(translation),
            f32(focal_lengths), f32(principal_point))
        setup = rast.tiles._triangle_setup(pix, z_cam, faces)
        inv_z = torch.reciprocal(torch.clamp(z_cam[faces], min=rast.Z_NEAR))
        aff = [[setup[k][:, i] * inv_z[:, i] for k in ("a", "b", "c")]
               for i in range(3)]  # A_i = (a_i, b_i, c_i) * inv_z_i
    s = [aff[0][k] + aff[1][k] + aff[2][k] for k in range(3)]
    table = torch.stack(
        [c.view(torch.int32) for c in aff[1] + aff[2] + s]
        + [torch.as_tensor(resolutions, dtype=torch.int32, device=device),
           torch.as_tensor(first_texel_index, dtype=torch.int32,
                           device=device)], dim=-1)  # (T, 11)

    height, width = tri_index.shape
    row = table[tri_index.clamp(min=0).long()]  # the one per-pixel gather
    coef = row.view(torch.float32)  # lanes 0-8 are the f32 coefficients
    py, px = rast.tiles.pixel_centres(height, width, y_offset, device)

    def form(i):
        return coef[..., i] * px + coef[..., i + 1] * py + coef[..., i + 2]

    s_val = form(6)
    u = torch.div(form(0), s_val)
    v = torch.div(form(3), s_val)
    res = row[..., 9]
    rel = geometry.texel_index_uv(u, v, res.clamp(min=1))
    valid = (tri_index >= 0) & (res >= 1)
    return torch.where(valid, row[..., 10] + rel,
                       torch.full_like(rel, num_primitives))


# ------------------------------------------------------------ lens distortion
# The rasterizers stay pinhole (straight edges are what tiles need): a
# distorted view renders under a virtual pinhole whose focal is shrunk just
# enough to hold every distorted pixel's ray, then one gather samples that
# image at each distorted pixel's ray (the on-device form of COLMAP's image
# undistortion, which the reference leaves to its users,
# ref: include/semantic_meshes/render/Camera.h:9-12).


def _undistort_grid(fl, pp, dist, *, height, width):
    """(undistorted normalized coords (H, W, 2) of every distorted pixel
    centre, the virtual-pinhole focal scale s <= 1 as a 0-dim tensor that
    keeps fl * s * n + pp inside the (height, width) image), from f32
    tensors fl (2,), pp (2,), dist (4,) or (9,) on one device
    (`semantic_meshes.render._undistort_grid`). No host sync.

    Clamps: the extended wire caps each pixel's radius at the inverse of
    the sampled radial response at its own distorted radius (one sample
    up), and pixels past the largest response the lens produces have no
    ray and take no part in s; the classic wire caps every radius at
    min(max_monotonic_radius, 3 * the largest distorted radius), so one
    diverged corner cannot shrink s for the whole frame. A zero lens
    selects the identity grid and s = 1 structurally, so its render is
    the pinhole render bit for bit."""
    yy, xx = rast.tiles.pixel_centres(height, width, 0, dist.device)
    nd = torch.stack([(xx - pp[0]) / fl[0], (yy - pp[1]) / fl[1]], dim=-1)
    n = geometry.undistort_normalized(nd, dist)
    r_d = torch.sqrt(nd[..., 0] * nd[..., 0] + nd[..., 1] * nd[..., 1])
    r_n = torch.sqrt(n[..., 0] * n[..., 0] + n[..., 1] * n[..., 1])
    inf = float("inf")
    valid = None
    if dist.shape[-1] == geometry.LENS_EXTENDED_DIM:
        rr, rd_s, good = geometry._radial_response(dist)
        rd_sorted = torch.where(good, rd_s, inf)
        rd_prod_max = torch.where(good, rd_s, -inf).max() * 0.999
        valid = r_d <= rd_prod_max
        i = torch.searchsorted(rd_sorted, torch.minimum(r_d, rd_prod_max))
        r_cap = rr[i.clamp(max=rr.shape[0] - 1)]
    else:
        r_cap = torch.minimum(geometry.max_monotonic_radius(dist),
                              3.0 * r_d.max())
    n = n * torch.clamp(r_cap / torch.clamp(r_n, min=1e-20),
                        max=1.0)[..., None]

    def axis_scale(nv, f, c, size):
        # the largest s with 0.5 <= s * f * nv + c <= size - 0.5 at every
        # pixel; a pixel without a ray (nv = 0) bounds nothing
        if valid is not None:
            nv = torch.where(valid, nv, 0.0)
        fnv = f * nv
        s = torch.where(nv > 0, (float(size) - 0.5 - c) / fnv,
                        torch.where(nv < 0, (0.5 - c) / fnv, inf))
        return s.min()

    s = torch.clamp(torch.minimum(axis_scale(n[..., 0], fl[0], pp[0], width),
                                  axis_scale(n[..., 1], fl[1], pp[1],
                                             height)), max=1.0)
    is_zero = (dist == 0.0).all()
    return torch.where(is_zero, nd, n), torch.where(is_zero, 1.0, s)


def _distortion_scales(fl, pp, dist, *, height, width):
    """(N,) virtual-pinhole focal scales of a camera batch, f32 tensors fl,
    pp (N, 2) and dist (N, 4|9): _undistort_grid per view, keeping s (the
    budget probes run under fl * s, the focal the render uses)."""
    return torch.stack([
        _undistort_grid(fl[k], pp[k], dist[k], height=height, width=width)[1]
        for k in range(len(fl))])


def _host(a):
    return a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def _virtual_focals(fl, pp, dist, *, height, width, device):
    """The focals (N, 2) a camera batch rasterizes with: fl itself, or,
    when any lens of dist ((N, 4|9), or one lens for every view) is
    nonzero, fl * s as f32 numpy, s each view's virtual-pinhole scale
    (_distortion_scales). The set-up probes run under them."""
    if dist is None or not np.any(_host(dist)):
        return fl
    fl_t, pp_t, d = (_as_f32(a, device) for a in (fl, pp, dist))
    s = _distortion_scales(fl_t, pp_t, d.expand(len(fl_t), d.shape[-1]),
                           height=height, width=width)
    return _host(fl).astype(np.float32) * s.cpu().numpy()[:, None]


def _sample_pixel(grid, fl_s, pp, width, height):
    """(ix, iy) int64 (H, W): the virtual-pinhole pixel holding each
    distorted pixel's ray. The float -> int conversion saturates, as XLA's
    does: a plain cast turns a ray off at infinity into INT_MIN, which the
    clamp would send to column 0 instead of column width - 1."""
    px = fl_s[0] * grid[..., 0] + pp[0]
    py = fl_s[1] * grid[..., 1] + pp[1]
    return (_to_i32(px).clamp(0, width - 1),
            _to_i32(py).clamp(0, height - 1))


def _resample_wh(idx_wh, depth_wh, grid, fl_s, pp):
    """Nearest-sample the (W, H) int32 id and f32 depth images of a
    virtual-pinhole render (focal fl_s) at each distorted pixel's ray
    grid (H, W, 2): (ids (W, H), depth (W, H))
    (`semantic_meshes.render._resample_wh`). One gather of 8-byte rows,
    the id and the depth's bits side by side as int32 lanes, so every bit
    pattern (the -1 background, ids that read as denormal floats, +inf)
    moves unchanged."""
    w_img, h_img = idx_wh.shape
    ix, iy = _sample_pixel(grid, fl_s, pp, w_img, h_img)
    packed = torch.stack([idx_wh.reshape(-1),
                          depth_wh.reshape(-1).view(torch.int32)], dim=-1)
    out = packed.view(torch.int64)[:, 0][ix * h_img + iy]
    out = out.unsqueeze(-1).view(torch.int32)  # (H, W, 2)
    return out[..., 0].t(), out[..., 1].view(torch.float32).t()


def triangles(mesh: Ply, **kwargs) -> TrianglesRenderer:
    """Factory matching `semantic_meshes.render.triangles(mesh)`
    (ref: python/semantic_meshes/src/Render.cu:24)."""
    return TrianglesRenderer(mesh, **kwargs)


def texels(mesh: Ply, cameras, texels_per_pixel: float = 0.1,
           **kwargs) -> TexelsRenderer:
    """Factory matching `semantic_meshes.render.texels(mesh, colmap |
    [cameras][, texels_per_pixel])` (ref: Render.cu:20-23)."""
    return TexelsRenderer(mesh, cameras, texels_per_pixel, **kwargs)


# Reference-compatible class aliases (ref: Render.cu:16-17)
PlyRendererTriangles = TrianglesRenderer
PlyRendererTexels = TexelsRenderer
