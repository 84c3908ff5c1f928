"""Public render API: `triangles(mesh)`, pinhole cameras.

Counterpart of `TrianglesRenderer`, `_OverflowPolicy`, `_DenseCapPolicy`,
the dense probes and `triangles()` in `semantic_meshes/render.py` (reference:
python/semantic_meshes/src/Render.cu:12-25,
include/semantic_meshes/render/TriangleRenderer.h:11-95).

`renderer.render(camera)` returns `(primitive_indices, depth)` as tensors
on the renderer's device shaped (width, height), the reference's layout.
Ids are `torch.uint32`: the bit view of an int32 image that holds -1 for
background, so empty pixels read 0xFFFFFFFF. Depth is f32 with +inf for
background. Inside the port, ids travel as int32 with -1 for background.

Meshes of DENSE_THRESHOLD faces or more go to the dense rasterizer, whose
budgets the renderer probes once per resolution (`_DenseCapPolicy`).

Not ported yet (see ROADMAP): texel mode, lens distortion (a camera with a
nonzero lens raises), near-plane clipping (`clip_near=True` raises), and
the face-count bucketing that the JAX package uses only to share jit
compilations.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from . import rasterize as rast
from .data import Camera, Ply, resolve_device, stack_cameras

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


def _zero_budget(dense_e_cap):
    """True when the dense pair budget or micro budget is pinned to zero
    (the probe saw none of that class, so any later occurrence spills):
    such keys re-check on the overflow policy's fixed duty cycle too."""
    if dense_e_cap is None:
        return False
    if isinstance(dense_e_cap, tuple):
        return dense_e_cap[0] == 0 or dense_e_cap[1] == 0
    return dense_e_cap == 0


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
    """Right-sizes the dense rasterizer's budgets per resolution.

    The exact (pairs, micro) counts are probed once per resolution (one
    sync) and budgeted with a 2x margin. render_many and prepare probe the
    max over their whole batch; for single renders, a later view above the
    margin spills to the overflow counter, and when the overflow policy
    finds the breach the cap is invalidated, so the next render re-probes
    with a grow-only floor.
    """

    MARGIN = 2

    def __init__(self):
        self._cap = {}  # (H, W) -> (pair rows, micro rows[, micro_max])
        self._floor = {}  # (H, W) -> previous cap (grow-only re-probes)

    def lookup(self, key, probe):
        """probe() -> exact (pairs, micro[, micro_max]) host ints for the
        views at hand. Returns the budget tuple; a trailing micro_max (the
        routing threshold the counts were probed at) is carried unscaled.
        A pair budget of 0 makes the dense backend skip binning and its
        kernel; any later pair at this resolution spills to overflow, as
        do micro rows past the micro budget."""
        if key not in self._cap:
            vals = tuple(int(x) for x in probe())
            floor = self._floor.get(key, (0, 0))
            self._cap[key] = (
                max(self.MARGIN * vals[0], floor[0]),
                max(self.MARGIN * vals[1], floor[1]),
            ) + vals[2:]
        return self._cap[key]

    def floor(self, key):
        """Grow-only budget floor of a key (nonzero after a breach): a
        nonzero pair floor keeps the binning alive at zero probed pairs,
        which the routing pick must know."""
        return self._floor.get(key, (0, 0))

    def invalidate(self, key):
        """Drop the cached budget so the next render re-probes. The floor
        of later probes is double the breached cap (at least 256 rows):
        the re-probe sees whichever camera renders next, which may be a
        small one, and the doubling makes the budget pass any fixed need in
        O(log) breaches."""
        cap = self._cap.pop(key, None)
        if cap is not None:
            self._floor[key] = (
                max(2 * cap[0], 256),
                max(2 * cap[1], 256),
            )


def _batch(rot, trans, fl, pp):
    """Camera arrays as a batch (leading axis) of f32 numpy arrays."""
    arrs = [np.asarray(a, np.float32) for a in (rot, trans, fl, pp)]
    if arrs[0].ndim == 2:
        arrs = [a[None] for a in arrs]
    return arrs


def _dense_count_probe(face_vertices, rot, trans, fl, pp, *, height, width,
                       micro_max=None, device="cuda"):
    """Max dense-path (pairs, micro) over a camera batch as a (2,) device
    tensor: the _DenseCapPolicy probe at a fixed routing threshold."""
    return rast.dense.candidate_stats_batch(
        None, None, rot, trans, fl, pp, face_vertices=face_vertices,
        height=height, width=width, micro_max=micro_max, device=device)


def _dense_routing_probe(face_vertices, rot, trans, fl, pp, *, height, width,
                         device="cuda"):
    """Max (pairs, micro) per routing threshold over a camera batch as a
    (len(ROUTING_THRESHOLDS), 2) device tensor: the automatic routing
    probe."""
    return rast.dense.routing_stats_batch(
        None, None, rot, trans, fl, pp, face_vertices=face_vertices,
        height=height, width=width, device=device)


class TrianglesRenderer:
    """Whole-triangle primitive renderer (primitive index == triangle
    index), on `device` (default "cuda").

    backend: None picks the dense rasterizer at DENSE_THRESHOLD faces or
    more and the tile rasterizer below; "tile" or "dense" forces one.
    micro_max: the dense routing threshold; None picks one per resolution
    from one probe (dense.pick_route). route: keyword overrides of the
    pick's cost coefficients (alpha, beta, gamma; dense.pick_micro_max).
    """

    def __init__(self, mesh: Ply, max_tris_per_tile: int = 256,
                 backend: str | None = None, clip_near: bool = False,
                 micro_max=None, route=None, device="cuda"):
        if clip_near:
            raise NotImplementedError(
                "near-plane clipping: not ported yet, see ROADMAP"
            )
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
        rast.check_backend(self._num_faces, backend)
        # pre-expanded face-vertex positions: per-view setup is gather-free
        self.face_vertices = self.vertices[self.faces]
        self.max_tris_per_tile = int(max_tris_per_tile)
        self.backend = backend
        self.micro_max = micro_max
        self.route = dict(route or {})
        self.overflow_policy = _OverflowPolicy()
        self.dense_cap_policy = _DenseCapPolicy()

    def getPrimitivesNum(self) -> int:
        return self._num_faces

    def _dense_e_cap(self, height, width, rot, trans, fl, pp):
        """The dense budget tuple for (height, width), probed over the
        given cameras (a batch, or one camera) on first use; None for the
        tile backend."""
        if not rast.uses_dense(self.backend, self._num_faces):
            return None
        rot, trans, fl, pp = _batch(rot, trans, fl, pp)
        key = (height, width)
        kw = dict(height=height, width=width, device=self.device)
        if self.micro_max is None:
            def probe():
                curve = _dense_routing_probe(self.face_vertices, rot, trans,
                                             fl, pp, **kw)
                return rast.dense.pick_route(
                    curve.tolist(), self._num_faces,
                    min_pairs_budget=self.dense_cap_policy.floor(key)[0],
                    **self.route,
                )
        else:
            def probe():
                stats = _dense_count_probe(self.face_vertices, rot, trans,
                                           fl, pp, micro_max=self.micro_max,
                                           **kw)
                return stats.tolist() + [self.micro_max]
        return self.dense_cap_policy.lookup(key, probe)

    def _rasterize(self, camera, dense_e_cap):
        height, width = _camera_hw(camera)
        return rast.rasterize(
            self.vertices, self.faces, camera.rotation, camera.translation,
            camera.focal_lengths, camera.principal_point,
            face_vertices=self.face_vertices, backend=self.backend,
            height=height, width=width,
            max_tris_per_tile=self.max_tris_per_tile,
            dense_e_cap=dense_e_cap, device=self.device,
        )

    def _check_overflow(self, overflow, key, dense_e_cap):
        """Overflow policy check + dense-budget regrowth: every dense key
        re-checks at the policy's low duty cycle, and a drop found after
        the probe invalidates the cached cap, so the next render re-probes
        with a grow-only budget."""
        new = self.overflow_policy.check(
            overflow, key, self.max_tris_per_tile,
            dense=(dense_e_cap is not None),
            recheck=(dense_e_cap is not None),
            hot=_zero_budget(dense_e_cap),
        )
        if new and dense_e_cap is not None:
            self.dense_cap_policy.invalidate(key)

    def render(self, camera: Camera):
        """(ids (W, H) uint32, depth (W, H) f32) on the renderer's device."""
        check_pinhole([camera])
        height, width = _camera_hw(camera)
        dense_e_cap = self._dense_e_cap(
            height, width, camera.rotation, camera.translation,
            camera.focal_lengths, camera.principal_point)
        ids, depth, overflow = self._rasterize(camera, dense_e_cap)
        self._check_overflow(overflow, (height, width), dense_e_cap)
        return ids.t().contiguous().view(torch.uint32), depth.t().contiguous()

    def render_many(self, cameras):
        """Render same-resolution cameras: (ids (N, W, H) uint32, depth
        (N, W, H) f32). The dense budget is probed over the whole batch."""
        cams = list(cameras)
        check_pinhole(cams)
        hw = _camera_hw(cams[0])
        if any(_camera_hw(c) != hw for c in cams):
            raise ValueError("render_many needs equal camera resolutions")
        dense_e_cap = self._dense_e_cap(*hw, *stack_cameras(cams))
        out = [self._rasterize(c, dense_e_cap) for c in cams]
        self._check_overflow(torch.stack([o for _, _, o in out]).sum(), hw,
                             dense_e_cap)
        ids = torch.stack([i for i, _, _ in out]).transpose(1, 2).contiguous()
        depth = torch.stack([d for _, d, _ in out]).transpose(1, 2)
        return ids.view(torch.uint32), depth.contiguous()

    def overflow_total(self) -> int:
        """Total dropped candidate pairs across all renders (syncs once)."""
        return self.overflow_policy.total()

    def prepare(self, cameras):
        """Pre-size the dense budgets for a whole camera set: one probe of
        the max over all cameras per resolution, so later renders never
        breach. A no-op for the tile backend."""
        cams = list(cameras)
        check_pinhole(cams)
        by_hw = {}
        for c in cams:
            by_hw.setdefault(_camera_hw(c), []).append(c)
        for (height, width), group in by_hw.items():
            self._dense_e_cap(height, width, *stack_cameras(group))


def triangles(mesh: Ply, **kwargs) -> TrianglesRenderer:
    """Factory matching `semantic_meshes.render.triangles(mesh)`
    (ref: python/semantic_meshes/src/Render.cu:24)."""
    return TrianglesRenderer(mesh, **kwargs)


# Reference-compatible class alias (ref: Render.cu:16)
PlyRendererTriangles = TrianglesRenderer
