"""Dense-mesh rasterizer: sort binning, micro fragments, streaming z-resolve.

Counterpart of `semantic_meshes/rasterize/dense.py`, for meshes of
DENSE_THRESHOLD faces or more (ScanNet scale), in four steps per view:

1. classify every triangle on a (16, 128)-pixel tile grid: "micro" when
   its pixel-centre bbox is at most micro_max x micro_max, "small" when it
   spans at most 2x2 tiles (up to 4 (tile, triangle) pairs), "big"
   otherwise (one pair in a global bucket that every tile tests, capped at
   n_global);
2. one stable sort of the T x 5 pairs by tile id (ascending triangle ids
   within a tile) and `searchsorted` for each tile's range `starts`; the
   pair budget e_cap and the n_global cap count every pair they drop in
   `overflow`;
3. micro triangles go to the fragment path: each emits up to micro_max^2
   pixel fragments, and the per-pixel winner is the lexicographic minimum
   of (z bits, id), one `scatter_reduce_("amin")` of a packed int64 key
   into the image (z > 0, so its int32 bits order like z). The JAX package
   uses two 3-key sorts there because scatters are slow on a TPU; the
   minimum is order-independent, so the scatter is deterministic;
4. the streaming z-resolve of every tile's candidates, merged with the
   micro image: `dense_kernel.resolve_dense` (CUDA kernel for CUDA
   tensors, plain PyTorch for CPU tensors).

Steps 1-3 and the candidate table are the dense preparation,
`resolve_inputs`. On a CUDA device it runs the hand-written kernels of
`dense_prep` (csrc/dense_prep.cu): a setup pass that also classifies,
writes the tile ids and the table and fills the micro image, the stable
`torch.sort` of the tile ids, a pass for the ids, starts and overflow,
and a micro-fragment pass (64-bit atomicMin into the packed image): 3
kernel launches and the sort's own a view, the camera passed by value,
no host sync. On the CPU it runs `resolve_inputs_plain`, the chain of
PyTorch ops below (~550 launches a view if run on a card), which is also
the kernels' oracle: on the card the two give the same bits (table,
sorted ids, starts, overflow, micro keys). There is no fallback from one
to the other.

Every float -> int32 conversion saturates (NaN -> 0) and int32 sums wrap,
as XLA's do, so classification and counts equal the JAX package's number
for number.

clip_near: every step runs on the 2T setup rows of the clipped pieces
(tiles.setup_clipped), probes and budgets count pieces, and `rasterize`
maps each winning piece id back to its triangle with id >> 1 at its
return. `tri_ids` is refused there: the rows are pieces, not faces.
"""

from __future__ import annotations

import torch

from ..data import resolve_device
from ..profiling import span
from . import dense_kernel, dense_prep, tile_kernel, tiles

TILE_H = dense_kernel.TILE_H
TILE_W = dense_kernel.TILE_W
K_SPAN = 5  # 4 span slots + 1 global-bucket slot per triangle
# pair budgets round up to a multiple of CHUNK (as in the JAX package, so
# the overflow counts agree)
CHUNK = 256
N_GLOBAL = 1024
# routing threshold of a direct rasterize() call with micro_max=None; the
# renderers and plan_fuse pick one per resolution (pick_micro_max)
MICRO_MAX = 2
ROUTING_THRESHOLDS = (2, 3, 4, 5)
# the cap policy's budget margin (render._DenseCapPolicy.MARGIN)
BUDGET_MARGIN = 2

# Cost model of the routing pick, in ns: alpha per (tile, triangle) pair
# (raster_dense's test of a whole tile), beta per fragment row (the micro
# path, compaction included), gamma per binning-sort row (classify, sort
# binning and table; paid only while any pair exists). Each is a per-view
# time over its count, all three timed alike (CUDA events around the views
# launched one by one from Python), from chip_smoke.py's routing line at
# bench.py's `scannet` preset (micro_max 2) on an NVIDIA H100 80GB HBM3
# with a 700 W power limit (PERF.md): alpha 0.949726 for the split, culled
# kernel (8.354779 for the kernel of one CTA per tile), beta 17.069335,
# gamma 3.771932.
ROUTE_ALPHA = 0.950
ROUTE_BETA = 17.1
ROUTE_GAMMA = 3.77

_SETUP_KEYS = ("a", "b", "c", "az", "bz", "cz", "denom", "xmin", "xmax",
               "ymin", "ymax")


def _cdiv(a, b):
    return -(-a // b)


def _check_micro_max(micro_max):
    if micro_max is not None and not 1 <= int(micro_max) <= 8:
        raise ValueError(f"micro_max must be in [1, 8]; got {micro_max}")


def _to_i32(x):
    """XLA's f32 -> int32 convert: saturating, NaN -> 0 (a plain torch
    cast of an off-screen coordinate would not saturate). As int64."""
    x = torch.nan_to_num(x.double(), nan=0.0, posinf=2.0**31 - 1,
                         neginf=-(2.0**31))
    return x.clamp(-(2.0**31), 2.0**31 - 1).to(torch.int64)


def _wrap_i32(x):
    """An int64 sum of int32 values, wrapped to int32 as XLA's is."""
    return ((x + 2**31) % 2**32 - 2**31).to(torch.int32)


def _micro_pixel_range(setup):
    """First covered pixel centre (ix0, iy0) and centre counts (nx, ny) of
    each triangle's bbox (int32). Pixel centres are at integer + 0.5."""
    ix0 = _to_i32(torch.ceil(setup["xmin"] - 0.5))
    iy0 = _to_i32(torch.ceil(setup["ymin"] - 0.5))
    nx = _wrap_i32(_to_i32(torch.floor(setup["xmax"] - 0.5)) - ix0 + 1)
    ny = _wrap_i32(_to_i32(torch.floor(setup["ymax"] - 0.5)) - iy0 + 1)
    return ix0.to(torch.int32), iy0.to(torch.int32), nx, ny


def _is_micro(setup, micro_max=None):
    m = MICRO_MAX if micro_max is None else int(micro_max)
    _, _, nx, ny = _micro_pixel_range(setup)
    return (nx <= m) & (ny <= m)


def _classify(setup, height, width, y_offset, micro_max=None,
              micro_split=None):
    """Span/micro/big classification shared by the binning and the
    closed-form probes: (micro, small, big, bx0, by0, span_h, span_w).

    micro_split: rows [0, k) are "uni" rows (one fragment slot, so their
    micro bound is a 1x1 bbox whatever micro_max is); a uni row whose bbox
    exceeds 1x1 in this view falls through to the small/big classes."""
    nby = _cdiv(height, TILE_H)
    nbx = _cdiv(width, TILE_W)
    ymin = setup["ymin"] - y_offset
    ymax = setup["ymax"] - y_offset

    def tile(v, size, n):
        return _to_i32(torch.floor(v / size)).clamp(0, n - 1).to(torch.int32)

    bx0 = tile(setup["xmin"], TILE_W, nbx)
    bx1 = tile(setup["xmax"], TILE_W, nbx)
    by0 = tile(ymin, TILE_H, nby)
    by1 = tile(ymax, TILE_H, nby)
    onscreen = ((setup["xmax"] >= 0) & (setup["xmin"] < width)
                & (ymax >= 0) & (ymin < height))
    valid = setup["valid"] & onscreen
    span_h = by1 - by0 + 1
    span_w = bx1 - bx0 + 1
    # micro triangles are resolved on the fragment path: testing them
    # against whole tiles wastes ~2000x the work on a dense mesh
    micro = valid & _is_micro(setup, micro_max)
    if micro_split is not None:
        _, _, nx, ny = _micro_pixel_range(setup)
        uni = torch.arange(micro.shape[0], device=micro.device) < int(
            micro_split)
        micro = micro & (~uni | ((nx <= 1) & (ny <= 1)))
    small = valid & ~micro & (span_h <= 2) & (span_w <= 2)
    big = valid & ~micro & ~small
    return micro, small, big, bx0, by0, span_h, span_w


def _pair_count(small, big, span_h, span_w):
    """Exact (tile, triangle) pair count the binning emits for a _classify
    result (int32 scalar tensor) — the one definition the probes and the
    zero-budget path share."""
    span_pairs = torch.where(small, span_h * span_w, 0)
    return _wrap_i32(span_pairs.sum() + big.sum())


def count_pairs(setup, height, width, y_offset, micro_max=None,
                micro_split=None):
    """Exact (tile, triangle) pair count of the dense binning, in closed
    form (no sort): the probe that right-sizes `e_cap_rows`."""
    _, small, big, _, _, span_h, span_w = _classify(
        setup, height, width, y_offset, micro_max, micro_split)
    return _pair_count(small, big, span_h, span_w)


def _build_sorted_bins(setup, height, width, y_offset, e_cap, n_global,
                       micro_max=None, micro_split=None):
    """Returns (sorted_ids (<= e_cap,) int32, starts (B + 2,) int32,
    overflow int32 scalar tensor, micro (T,) bool).

    Tile b's candidates are sorted_ids[starts[b]:starts[b+1]]; the global
    (big-triangle) bucket is sorted_ids[starts[B]:starts[B+1]]. overflow
    counts both the pairs past the e_cap budget and the big triangles past
    the kernel's n_global clamp (after the e_cap clamp, so the two do not
    count a pair twice)."""
    T = setup["denom"].shape[0]
    device = setup["denom"].device
    nbx = _cdiv(width, TILE_W)
    B = _cdiv(height, TILE_H) * nbx
    micro, small, big, bx0, by0, span_h, span_w = _classify(
        setup, height, width, y_offset, micro_max, micro_split)

    # slots 0..3 -> span cells of small triangles; slot 4 -> the global
    # bucket (big triangles); everything else -> sentinel tile B + 1
    ks = torch.arange(4, dtype=torch.int32, device=device)
    dy, dx = ks // 2, ks % 2
    in_span = (dy[None, :] < span_h[:, None]) & (dx[None, :] < span_w[:, None])
    cell = (by0[:, None] + dy[None, :]) * nbx + (bx0[:, None] + dx[None, :])
    span_tiles = torch.where(small[:, None] & in_span, cell, B + 1)
    global_tile = torch.where(big, B, B + 1)[:, None]
    tile_ids = torch.cat([span_tiles, global_tile], 1).to(torch.int32)
    # stable: triangle-major emission keeps ids ascending within a tile
    tiles_sorted, order = torch.sort(tile_ids.reshape(-1), stable=True)
    sorted_ids = (order[:e_cap] // K_SPAN).to(torch.int32)
    starts = torch.searchsorted(
        tiles_sorted, torch.arange(B + 2, dtype=torch.int32, device=device),
        side="left", out_int32=True)
    overflow = torch.clamp(starts[B + 1] - e_cap, min=0)
    starts = torch.clamp(starts, max=e_cap)
    overflow = overflow + torch.clamp(
        (starts[B + 1] - starts[B]) - n_global, min=0)
    return sorted_ids, starts, overflow.to(torch.int32), micro


def _compact_micro(setup, micro, cap):
    """Gather the micro rows of `setup` into a cap-row prefix (ascending
    ids, by one stable sort of the not-micro flag). Rows past the cap are
    counted, never dropped silently.

    Returns (sub_setup, take (cap,) int64 row ids, valid (cap,) bool,
    dropped int32 scalar tensor)."""
    order = torch.argsort((~micro).to(torch.int32), stable=True)
    take = order[:cap]
    n_micro = micro.sum()
    valid = torch.arange(cap, device=micro.device) < torch.clamp(n_micro,
                                                                 max=cap)
    dropped = torch.clamp(n_micro - cap, min=0).to(torch.int32)
    return {k: setup[k][take] for k in _SETUP_KEYS}, take, valid, dropped


def _rasterize_micro(setup, micro, height, width, y_offset, tri_ids=None,
                     micro_max=None, micro_split=None):
    """Fragment path: the (height, width) int64 image of packed keys
    (z bits << 32) | id, dense_kernel.BG_KEY where empty.

    tri_ids: (T,) ids to emit for the rows of `setup` (default the row
    index). micro_split = k: rows [0, k) emit the (0, 0) slot only."""
    T = setup["denom"].shape[0]
    device = setup["denom"].device
    HW = height * width
    mm = MICRO_MAX if micro_max is None else int(micro_max)
    if tri_ids is None:
        tri_ids = torch.arange(T, dtype=torch.int32, device=device)
    tri_ids = torch.as_tensor(tri_ids, device=device).to(torch.int64)
    y_band = int(y_offset)  # truncates toward zero, as astype(int32) does
    img = torch.full((HW + 1,), dense_kernel.BG_KEY, dtype=torch.int64,
                     device=device)

    def emit(sub, sub_micro, ids, slots):
        ix0, iy0, _, _ = _micro_pixel_range(sub)
        ix0, iy0 = ix0.to(torch.int64), iy0.to(torch.int64)
        sgn = torch.sign(sub["denom"])
        for dy, dx in slots:
            ix = ix0 + dx
            iy = iy0 + dy
            iy_local = iy - y_band
            pxc = ix.to(torch.float32) + 0.5
            pyc = iy.to(torch.float32) + 0.5
            w0 = sub["a"][:, 0] * pxc + sub["b"][:, 0] * pyc + sub["c"][:, 0]
            w1 = sub["a"][:, 1] * pxc + sub["b"][:, 1] * pyc + sub["c"][:, 1]
            w2 = sub["a"][:, 2] * pxc + sub["b"][:, 2] * pyc + sub["c"][:, 2]
            inside = (w0 * sgn >= 0) & (w1 * sgn >= 0) & (w2 * sgn >= 0)
            inv_z = sub["az"] * pxc + sub["bz"] * pyc + sub["cz"]
            ok = (sub_micro & inside & (inv_z > 0) & (ix >= 0) & (ix < width)
                  & (iy_local >= 0) & (iy_local < height))
            zbits = torch.reciprocal(inv_z).view(torch.int32).to(torch.int64)
            pix = torch.where(ok, iy_local * width + ix, HW)
            img.scatter_reduce_(0, pix, (zbits << 32) | ids, "amin")

    slots = [(s // mm, s % mm) for s in range(mm * mm)]
    if micro_split is None or int(micro_split) <= 0:
        emit(setup, micro, tri_ids, slots)
    else:
        k = min(int(micro_split), T)
        emit(setup, micro, tri_ids, slots[:1])
        tail = {key: setup[key][k:] for key in _SETUP_KEYS}
        emit(tail, micro[k:], tri_ids[k:], slots[1:])
    return img[:HW].view(height, width)


def _micro_key(setup, micro, height, width, y_offset, tri_ids=None,
               micro_max=None, micro_split=None, micro_cap_rows=None):
    """Micro image (packed keys) + the count of micro rows dropped by a
    `micro_cap_rows` budget below T (compaction first, then fragments)."""
    cap = _micro_cap(micro_cap_rows, setup["denom"].shape[0])
    if cap is not None:
        sub, take, valid, dropped = _compact_micro(setup, micro, cap)
        ids = take if tri_ids is None else torch.as_tensor(
            tri_ids, device=take.device)[take]
        key = _rasterize_micro(sub, valid, height, width, y_offset,
                               tri_ids=ids, micro_max=micro_max)
        return key, dropped
    key = _rasterize_micro(setup, micro, height, width, y_offset,
                           tri_ids=tri_ids, micro_max=micro_max,
                           micro_split=micro_split)
    return key, torch.zeros((), dtype=torch.int32, device=key.device)


def _check_args(micro_max, micro_split, micro_cap_rows, clip_near=False,
                tri_ids=None):
    _check_micro_max(micro_max)
    if tri_ids is not None and clip_near:
        raise ValueError(
            "tri_ids is unsupported with clip_near: setup rows are clip "
            "pieces, not faces (and micro_split already excludes "
            "clip_near)")
    if micro_split is not None and micro_cap_rows is not None:
        raise ValueError(
            "micro_split and micro_cap_rows are mutually exclusive: the "
            "uni-slot prefix targets micro-dominated meshes where "
            "compaction is a no-op")


def _e_cap(rows, e_cap_factor, e_cap_rows):
    """The pair budget: e_cap_rows, or e_cap_factor rows a setup row,
    rounded up to a CHUNK multiple."""
    want = int(e_cap_factor) * rows if e_cap_rows is None else int(e_cap_rows)
    return _cdiv(max(want, CHUNK), CHUNK) * CHUNK


def _micro_cap(micro_cap_rows, rows):
    """The compaction cap of a micro-row budget below `rows` (a multiple
    of 8, at least 8, at most rows), or None: no compaction."""
    if micro_cap_rows is None or int(micro_cap_rows) >= rows:
        return None
    return min(_cdiv(max(int(micro_cap_rows), 8), 8) * 8, rows)


def resolve_inputs(vertices, faces, rotation, translation, focal_lengths,
                   principal_point, y_offset=0.0, face_vertices=None, *,
                   height, width, n_global=N_GLOBAL, e_cap_factor=3,
                   e_cap_rows=None, micro_cap_rows=None, micro_max=None,
                   micro_split=None, tri_ids=None, clip_near=False,
                   device="cuda"):
    """Everything of one view before the streaming z-resolve.

    Returns (args, micro_key, overflow): `args` is the argument tuple of
    dense_kernel.resolve_dense, or None when e_cap_rows == 0 (the pure-micro
    path: no binning and no kernel; every pair counts as overflow);
    micro_key is the fragment path's packed image; overflow an int32
    scalar tensor (dropped pairs + dropped micro rows). With clip_near
    every id in them is a piece id (rasterize maps it back).

    On a CUDA device the hand-written kernels of `dense_prep` compute it
    in a few launches with no host sync; on the CPU the plain chain
    `resolve_inputs_plain` does. The two are bit-identical on the card."""
    with span("smt.dense_prep"):
        _check_args(micro_max, micro_split, micro_cap_rows, clip_near, tri_ids)
        device = resolve_device(device)
        if device.type == "cpu":
            return resolve_inputs_plain(
                vertices, faces, rotation, translation, focal_lengths,
                principal_point, y_offset, face_vertices, height=height,
                width=width, n_global=n_global, e_cap_factor=e_cap_factor,
                e_cap_rows=e_cap_rows, micro_cap_rows=micro_cap_rows,
                micro_max=micro_max, micro_split=micro_split,
                tri_ids=tri_ids, clip_near=clip_near, device=device)
        if device.type != "cuda":
            raise ValueError(f"no dense preparation for device {device}")
        if face_vertices is None:
            v = torch.as_tensor(vertices, dtype=torch.float32, device=device)
            face_vertices = v[torch.as_tensor(faces, dtype=torch.int64,
                                              device=device)]
        fv = torch.as_tensor(face_vertices, dtype=torch.float32,
                             device=device).contiguous()
        rows = fv.shape[0] * (2 if clip_near else 1)
        if tri_ids is not None:
            tri_ids = torch.as_tensor(tri_ids, dtype=torch.int32,
                                      device=device).contiguous()
        zero = e_cap_rows is not None and int(e_cap_rows) == 0
        nbx = _cdiv(width, TILE_W)
        table, sorted_ids, starts, key, overflow = dense_prep.prepare(
            fv, (rotation, translation, focal_lengths, principal_point),
            height=height, width=width, y_offset=float(y_offset),
            e_cap=0 if zero else _e_cap(rows, e_cap_factor, e_cap_rows),
            n_global=n_global,
            micro_max=MICRO_MAX if micro_max is None else int(micro_max),
            micro_split=micro_split,
            micro_cap=_micro_cap(micro_cap_rows, rows), tri_ids=tri_ids,
            clip_near=clip_near, nbx=nbx,
            num_tiles=_cdiv(height, TILE_H) * nbx)
        if table is None:
            return None, key, overflow
        args = (table, sorted_ids, starts, n_global, key, float(y_offset),
                nbx, height, width)
        return args, key, overflow


def resolve_inputs_plain(vertices, faces, rotation, translation,
                         focal_lengths, principal_point, y_offset=0.0,
                         face_vertices=None, *, height, width,
                         n_global=N_GLOBAL, e_cap_factor=3, e_cap_rows=None,
                         micro_cap_rows=None, micro_max=None,
                         micro_split=None, tri_ids=None, clip_near=False,
                         device="cuda"):
    """resolve_inputs as a chain of PyTorch ops on any device: the CPU
    implementation, and on the card the oracle of the dense_prep kernels
    (~550 launches and a host sync for each camera upload there)."""
    _check_args(micro_max, micro_split, micro_cap_rows, clip_near, tri_ids)
    setup = tiles.setup_inputs(vertices, faces, rotation, translation,
                               focal_lengths, principal_point,
                               face_vertices, device, clip_near)
    T = setup["denom"].shape[0]
    y_offset = float(y_offset)
    if tri_ids is not None:
        tri_ids = torch.as_tensor(tri_ids, dtype=torch.int32,
                                  device=setup["denom"].device)
    micro_kw = dict(tri_ids=tri_ids, micro_max=micro_max,
                    micro_split=micro_split, micro_cap_rows=micro_cap_rows)
    if e_cap_rows is not None and int(e_cap_rows) == 0:
        micro, small, big, _, _, span_h, span_w = _classify(
            setup, height, width, y_offset, micro_max, micro_split)
        key, dropped = _micro_key(setup, micro, height, width, y_offset,
                                  **micro_kw)
        return None, key, _pair_count(small, big, span_h, span_w) + dropped
    e_cap = _e_cap(T, e_cap_factor, e_cap_rows)
    sorted_ids, starts, overflow, micro = _build_sorted_bins(
        setup, height, width, y_offset, e_cap, n_global, micro_max,
        micro_split)
    key, dropped = _micro_key(setup, micro, height, width, y_offset,
                              **micro_kw)
    table = tile_kernel.candidate_table(setup, tri_ids)
    args = (table, sorted_ids, starts, n_global, key, y_offset,
            _cdiv(width, TILE_W), height, width)
    return args, key, overflow + dropped


def rasterize(vertices, faces, rotation, translation, focal_lengths,
              principal_point, y_offset=0.0, face_vertices=None, *, height,
              width, n_global=N_GLOBAL, e_cap_factor=3, clip_near=False,
              e_cap_rows=None, micro_cap_rows=None, micro_max=None,
              micro_split=None, tri_ids=None, device="cuda"):
    """Dense-mesh rasterizer: (ids (H, W) int32 with -1 empty, depth (H, W)
    f32 with +inf empty, overflow int32 scalar tensor); the contract of
    tile_kernel.rasterize, with no per-tile candidate cap.

    e_cap_rows: pair budget (rounded up to a CHUNK multiple; default
    e_cap_factor rows per triangle); 0 skips binning and the kernel.
    micro_cap_rows: micro-row budget; below T, micro rows are compacted
    first. micro_max: routing threshold (default MICRO_MAX); any value
    gives the same image, but budgets probed at one threshold hold only at
    that threshold. micro_split: rows [0, k) emit one fragment slot
    (exclusive with micro_cap_rows). tri_ids: (T,) ids to emit per face
    row; depth ties then break by these ids (refused with clip_near).
    clip_near: resolve the 2T clipped piece rows and return triangle ids.
    Every dropped pair or micro row is counted in overflow."""
    args, key, overflow = resolve_inputs(
        vertices, faces, rotation, translation, focal_lengths,
        principal_point, y_offset, face_vertices, height=height, width=width,
        n_global=n_global, e_cap_factor=e_cap_factor, e_cap_rows=e_cap_rows,
        micro_cap_rows=micro_cap_rows, micro_max=micro_max,
        micro_split=micro_split, tri_ids=tri_ids, clip_near=clip_near,
        device=device)
    if args is None:
        depth, ids = dense_kernel.decode_micro(key)
    else:
        depth, ids = dense_kernel.resolve_dense(*args)
    if clip_near:
        # piece id -> triangle id, after the micro merge (the pure-micro
        # path too), as the JAX package's dense.py:740 and 809 do. Until
        # here ids are piece ids < 2T: the micro keys (z bits << 32) | id
        # and the id lane of raster_dense's table carry them, 998784 at
        # `dense` (499392 faces), well inside the 31 bits both allow
        # (the micro background is id 0x7FFFFFFF).
        ids = torch.where(ids >= 0, ids >> 1, ids)
    return ids, depth, overflow


# --------------------------------------------------------------- probes


def _setups(vertices, faces, rotations, translations, focal_lengths,
            principal_points, face_vertices, device, clip_near=False):
    """Triangle setup of each view of a camera batch (leading axis), from
    one face-vertex gather (clip_near: the clipped piece rows)."""
    device = resolve_device(device)
    if face_vertices is None:
        v = torch.as_tensor(vertices, dtype=torch.float32, device=device)
        f = torch.as_tensor(faces, dtype=torch.int64, device=device)
        face_vertices = v[f]
    for i in range(len(rotations)):
        yield tiles.setup_inputs(None, None, rotations[i], translations[i],
                                 focal_lengths[i], principal_points[i],
                                 face_vertices, device, clip_near)


def _stats(setup, height, width, y_offset, micro_max, micro_split):
    micro, small, big, _, _, span_h, span_w = _classify(
        setup, height, width, y_offset, micro_max, micro_split)
    return torch.stack([_pair_count(small, big, span_h, span_w),
                        micro.sum().to(torch.int32)])


def candidate_count(vertices, faces, rotation, translation, focal_lengths,
                    principal_point, y_offset=0.0, face_vertices=None, *,
                    height, width, clip_near=False, micro_max=None,
                    micro_split=None, device="cuda"):
    """Exact dense-path pair count of one view (int32 device scalar)."""
    return candidate_stats(
        vertices, faces, rotation, translation, focal_lengths,
        principal_point, y_offset, face_vertices, height=height, width=width,
        clip_near=clip_near, micro_max=micro_max, micro_split=micro_split,
        device=device)[0]


def candidate_stats(vertices, faces, rotation, translation, focal_lengths,
                    principal_point, y_offset=0.0, face_vertices=None, *,
                    height, width, clip_near=False, micro_max=None,
                    micro_split=None, device="cuda"):
    """(pairs, micro triangles) of one view as a (2,) int32 device tensor:
    the probe for `e_cap_rows` and `micro_cap_rows` (with clip_near, of
    the 2T piece rows)."""
    _check_micro_max(micro_max)
    setup = tiles.setup_inputs(vertices, faces, rotation, translation,
                               focal_lengths, principal_point, face_vertices,
                               device, clip_near)
    return _stats(setup, height, width, float(y_offset), micro_max,
                  micro_split)


def candidate_stats_batch(vertices, faces, rotations, translations,
                          focal_lengths, principal_points, y_offset=0.0,
                          face_vertices=None, *, height, width,
                          clip_near=False, micro_max=None, micro_split=None,
                          device="cuda"):
    """Elementwise max over a camera batch of candidate_stats (a loop over
    the views on the device, carrying the running max; no host sync)."""
    _check_micro_max(micro_max)
    best = None
    for setup in _setups(vertices, faces, rotations, translations,
                         focal_lengths, principal_points, face_vertices,
                         device, clip_near):
        s = _stats(setup, height, width, float(y_offset), micro_max,
                   micro_split)
        best = s if best is None else torch.maximum(best, s)
    return best


def candidate_count_batch(vertices, faces, rotations, translations,
                          focal_lengths, principal_points, y_offset=0.0,
                          face_vertices=None, *, height, width,
                          clip_near=False, micro_max=None, micro_split=None,
                          device="cuda"):
    """Max over a camera batch of candidate_count (int32 device scalar)."""
    return candidate_stats_batch(
        vertices, faces, rotations, translations, focal_lengths,
        principal_points, y_offset, face_vertices, height=height,
        width=width, clip_near=clip_near, micro_max=micro_max,
        micro_split=micro_split, device=device)[0]


def _uni_from_setup(setup, height, width):
    _, _, nx, ny = _micro_pixel_range(setup)
    onscreen = ((setup["xmax"] >= 0) & (setup["xmin"] < width)
                & (setup["ymax"] >= 0) & (setup["ymin"] < height))
    return ~(setup["valid"] & onscreen) | ((nx <= 1) & (ny <= 1))


def uni_eligible(vertices, faces, rotation, translation, focal_lengths,
                 principal_point, face_vertices=None, *, height, width,
                 clip_near=False, device="cuda"):
    """(T,) bool: the triangle's pixel-centre bbox is at most 1x1 in this
    view, or it is invalid or off screen (it emits nothing either way).
    With clip_near the mask is per piece row (2T): a prefix permutes
    faces, not pieces, so the uni-slot split is not used with clipping."""
    setup = tiles.setup_inputs(vertices, faces, rotation, translation,
                               focal_lengths, principal_point, face_vertices,
                               device, clip_near)
    return _uni_from_setup(setup, height, width)


def uni_eligible_batch(vertices, faces, rotations, translations,
                       focal_lengths, principal_points, face_vertices=None, *,
                       height, width, clip_near=False, device="cuda"):
    """AND of uni_eligible over a camera batch (leading axis), on the
    device."""
    uni = None
    for setup in _setups(vertices, faces, rotations, translations,
                         focal_lengths, principal_points, face_vertices,
                         device, clip_near):
        u = _uni_from_setup(setup, height, width)
        uni = u if uni is None else uni & u
    return uni


def uni_order(vertices, faces, rot, trans, fl, pp, *, height, width,
              face_vertices=None, device="cuda"):
    """The micro_split recipe: AND uni_eligible over a camera batch and
    stable-sort the eligible rows first. Returns (perm (T,) int64 numpy,
    k): rasterize faces[perm] with micro_split=k (one host sync)."""
    uni = uni_eligible_batch(vertices, faces, rot, trans, fl, pp,
                             face_vertices, height=height, width=width,
                             device=device)
    perm = torch.argsort((~uni).to(torch.int8), stable=True)
    return perm.cpu().numpy(), int(uni.sum())


def routing_curve(setup, height, width, y_offset,
                  thresholds=ROUTING_THRESHOLDS):
    """(len(thresholds), 2) int32 of (pairs, micro triangles) per routing
    threshold (one elementwise pass per threshold, no sort)."""
    return torch.stack([_stats(setup, height, width, y_offset, m, None)
                        for m in thresholds])


def routing_stats(vertices, faces, rotation, translation, focal_lengths,
                  principal_point, y_offset=0.0, face_vertices=None, *,
                  height, width, clip_near=False,
                  thresholds=ROUTING_THRESHOLDS, device="cuda"):
    """routing_curve of one view (the candidate_stats argument contract)."""
    setup = tiles.setup_inputs(vertices, faces, rotation, translation,
                               focal_lengths, principal_point, face_vertices,
                               device, clip_near)
    return routing_curve(setup, height, width, float(y_offset), thresholds)


def routing_stats_batch(vertices, faces, rotations, translations,
                        focal_lengths, principal_points, y_offset=0.0,
                        face_vertices=None, *, height, width,
                        clip_near=False, thresholds=ROUTING_THRESHOLDS,
                        device="cuda"):
    """Elementwise max over a camera batch of routing_stats (no sync)."""
    best = None
    for setup in _setups(vertices, faces, rotations, translations,
                         focal_lengths, principal_points, face_vertices,
                         device, clip_near):
        c = routing_curve(setup, height, width, float(y_offset), thresholds)
        best = c if best is None else torch.maximum(best, c)
    return best


# -------------------------------------------------------------- routing


def split_frag_rows(k, n_setup_rows, micro_max=None):
    """Fragment rows under the uni-slot prefix (micro_split=k)."""
    m = MICRO_MAX if micro_max is None else int(micro_max)
    return int(k) + m * m * (int(n_setup_rows) - int(k))


def compact_frag_rows(micro, n_setup_rows, micro_max=None):
    """Fragment rows under micro compaction at the cap policy's margin."""
    m = MICRO_MAX if micro_max is None else int(micro_max)
    return m * m * min(BUDGET_MARGIN * int(micro), int(n_setup_rows))


def split_wins(k, n_setup_rows, micro, micro_max=None):
    """True iff the uni-slot prefix gives fewer fragment rows than micro
    compaction (the two are mutually exclusive)."""
    return (split_frag_rows(k, n_setup_rows, micro_max)
            < compact_frag_rows(micro, n_setup_rows, micro_max))


def pick_micro_max(curve, n_setup_rows, thresholds=ROUTING_THRESHOLDS,
                   min_pairs_budget=0, *, alpha=None, beta=None, gamma=None):
    """The routing threshold minimising alpha*pairs + beta*fragment_rows
    (+ gamma*K_SPAN*rows while any pair remains: the binning sort is
    skipped at zero pairs, unless a grow-only pair floor keeps it).

    curve: (pairs, micro) host ints per threshold. n_setup_rows: rows of
    the setup (2 x faces under clip_near). alpha/beta/gamma (ns)
    default to ROUTE_ALPHA/BETA/GAMMA. Fragment rows are
    threshold^2 * min(2*micro, rows), the budget the cap policy gives.
    Ties go to the smaller threshold."""
    alpha = ROUTE_ALPHA if alpha is None else float(alpha)
    beta = ROUTE_BETA if beta is None else float(beta)
    gamma = ROUTE_GAMMA if gamma is None else float(gamma)
    best_m, best_cost = None, None
    rows = int(n_setup_rows)
    for m, row in zip(thresholds, curve):
        pairs, micro = int(row[0]), int(row[1])
        frag_rows = m * m * min(BUDGET_MARGIN * micro, rows)
        cost = alpha * pairs + beta * frag_rows
        if pairs > 0 or min_pairs_budget > 0:
            cost += gamma * K_SPAN * rows
        if best_cost is None or cost < best_cost:
            best_m, best_cost = int(m), cost
    return best_m


def pick_route(curve, n_setup_rows, thresholds=ROUTING_THRESHOLDS,
               min_pairs_budget=0, **coeffs):
    """(pairs, micro, micro_max) at the pick_micro_max threshold: the probe
    -> pick -> budget step the renderers and plan_fuse share (scale the
    first two by BUDGET_MARGIN for budgets)."""
    curve = [(int(r[0]), int(r[1])) for r in curve]
    m = pick_micro_max(curve, n_setup_rows, thresholds, min_pairs_budget,
                       **coeffs)
    i = list(thresholds).index(m)
    return (curve[i][0], curve[i][1], m)
