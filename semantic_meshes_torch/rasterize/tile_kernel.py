"""Tile z-resolve: candidate table, plain PyTorch version, CUDA wrapper.

Counterpart of `semantic_meshes/rasterize/pallas_kernel.py`: the Pallas TPU
kernel `_raster_kernel` becomes the hand-written CUDA kernel in
`csrc/raster_tile.cu` (see the note there for its design and bound: each
warp owns a 16 x 8 rectangle of a tile and scans the tile's whole list
with an exact cull), and `rasterize()` here is the port of
`pallas_kernel.rasterize`.

Per (32, 128) screen tile, the resolve loops over the tile's candidates in
ascending triangle id and keeps, per pixel centre, the candidate that is
inside all three pre-signed edge forms (w_i >= 0) with the largest inverse
depth; the strict `>` keeps the lowest id on a tie. Outputs are depth
1/inv_z (+inf where empty) and the id (-1 where empty).

`resolve_tiles` is the one entry to the z-resolve: for CUDA tensors it
launches the kernel (or raises), for CPU tensors it runs
`resolve_tiles_plain`. There is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes

import torch

from ..profiling import span
from . import tiles

TILE_H = tiles.TILE_H
TILE_W = tiles.TILE_W

# table lane layout, 16 f32 lanes a row (one 64-byte row per triangle):
# 0..2: a0,b0,c0 | 3..5: a1,b1,c1 | 6..8: a2,b2,c2  (edge forms,
#   PRE-MULTIPLIED by sign(denom): inside is w_i >= 0 directly)
# 9: triangle id, the int32's own bits (read back with a bit view)
# 10..12: az,bz,cz (inverse-z plane) | 13..15: zero
# Row T is a sentinel (all zero but c_i = -1: never inside); candidate
# lists pad with its id.
N_LANES = 16
# warps per tile in the kernel (csrc/raster_tile.cu: a 16 x 8 rectangle
# each): every candidate of a tile's list is one (candidate, warp) test per
# warp, which the kernel's cull may skip
WARPS = 32

# kernel launches (a caller that counts sets it to 0 first); the plain
# version never counts
launches = 0
# views whose setup and binning resolve_inputs made (span smt.tile_prep),
# on any device
views = 0

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _kernel():
    """The C entry point of csrc/raster_tile.cu (built at first use); it
    returns cudaGetLastError() after its launch."""
    from .. import _build

    fn = _build.load("raster_tile").sm_raster_tile
    fn.argtypes = (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P)
    fn.restype = ctypes.c_int
    return fn


def candidate_table(setup, tri_ids=None):
    """(T+1, 16) f32 table of per-triangle resolve parameters.

    Invalid triangles (sign 0) and the sentinel row T get c_i = -1, so the
    pre-signed inside test w_i = a_i*px + b_i*py + c_i >= 0 always fails.
    Unlike the TPU table, the id lane carries no 2^23 bias: that only
    worked around the TPU's flush-to-zero of denormal f32 bit patterns.

    tri_ids: optional (T,) int32 ids to emit for each setup row (default:
    the row index), as `_gather_candidate_tables` takes them: a permuted
    face order then renders original face ids, with depth ties broken by
    the original id.
    """
    denom = setup["denom"]
    T = denom.shape[0]
    device = denom.device
    sgn = torch.sign(torch.where(setup["valid"], denom, torch.zeros_like(denom)))
    bad = sgn == 0.0
    zero = torch.zeros_like(sgn)
    minus_one = torch.full_like(sgn, -1.0)
    cols = []
    for e in range(3):
        cols.append(torch.where(bad, zero, setup["a"][:, e] * sgn))
        cols.append(torch.where(bad, zero, setup["b"][:, e] * sgn))
        cols.append(torch.where(bad, minus_one, setup["c"][:, e] * sgn))
    if tri_ids is None:
        tri_ids = torch.arange(T, dtype=torch.int32, device=device)
    cols.append(torch.as_tensor(tri_ids, dtype=torch.int32, device=device)
                .view(torch.float32))
    cols += [setup["az"], setup["bz"], setup["cz"]]
    table = torch.zeros((T + 1, N_LANES), dtype=torch.float32, device=device)
    table[:T, : len(cols)] = torch.stack(cols, dim=-1)
    table[T, [2, 5, 8]] = -1.0
    return table


def _pixel_centres(nby, nbx, y_offset, device, tile_h=TILE_H):
    """(B, tile_h, 128) pixel-centre coordinates, in the kernels' op order:
    py = ((row + tile_y*tile_h) + 0.5) + y_offset,
    px = (col + tile_x*128) + 0.5."""
    b = torch.arange(nby * nbx, device=device)
    base_y = ((b // nbx) * tile_h).to(torch.float32)
    base_x = ((b % nbx) * TILE_W).to(torch.float32)
    yy = torch.arange(tile_h, dtype=torch.float32, device=device)
    xx = torch.arange(TILE_W, dtype=torch.float32, device=device)
    py = (yy[None, :, None] + base_y[:, None, None]) + 0.5 + y_offset
    px = (xx[None, None, :] + base_x[:, None, None]) + 0.5
    return px, py


def resolve_tiles_plain(table, cand, counts, y_offset, nbx, height, width,
                        tile_h=TILE_H):
    """Plain PyTorch z-resolve: same function as the CUDA kernel.

    table (T+1, 16) f32, cand (B, N) int32, counts (B,) int32 ->
    (depth (height, width) f32, ids (height, width) int32). Every tile is
    resolved at once, one candidate slot per step; each edge and plane form
    is evaluated as (p0*px + p1*py) + p2, the kernel's rounding order.
    tile_h: tile height (32 here; the dense rasterizer's 16-row tiles
    reuse this loop).
    """
    B, N = cand.shape
    nby = B // nbx
    px, py = _pixel_centres(nby, nbx, y_offset, table.device, tile_h)
    params = table[cand.long()]  # (B, N, 16)
    ids = params[..., 9].contiguous().view(torch.int32)
    invz = torch.zeros((B, tile_h, TILE_W), dtype=torch.float32,
                       device=table.device)
    idx = torch.full((B, tile_h, TILE_W), -1, dtype=torch.int32,
                     device=table.device)
    # slots past a tile's count hold the sentinel; slots past every tile's
    # count need no step at all
    for n in range(int(counts.max()) if B else 0):
        p = params[:, n, :, None, None]  # (B, 16, 1, 1)
        w0 = p[:, 0] * px + p[:, 1] * py + p[:, 2]
        w1 = p[:, 3] * px + p[:, 4] * py + p[:, 5]
        w2 = p[:, 6] * px + p[:, 7] * py + p[:, 8]
        inv_zc = p[:, 10] * px + p[:, 11] * py + p[:, 12]
        ok = (
            (w0 >= 0.0) & (w1 >= 0.0) & (w2 >= 0.0) & (inv_zc > invz)
            & (n < counts)[:, None, None]
        )
        invz = torch.where(ok, inv_zc, invz)
        idx = torch.where(ok, ids[:, n, None, None], idx)
    z = torch.where(invz > 0.0, torch.reciprocal(invz),
                    torch.full_like(invz, float("inf")))

    def image(t):  # (B, tile_h, 128) tiles -> (height, width)
        return (
            t.reshape(nby, nbx, tile_h, TILE_W)
            .permute(0, 2, 1, 3)
            .reshape(nby * tile_h, nbx * TILE_W)[:height, :width]
        )

    return image(z), image(idx)


def resolve_tiles_cuda(table, cand, counts, y_offset, nbx, height, width,
                       tested=None):
    """Launch csrc/raster_tile.cu on the current stream (no sync). The
    candidate ids must index rows of `table` (tiles._bin_triangles pads
    with the sentinel row T). `tested`, None or a zeroed (1,) int64 CUDA
    tensor, gets the (candidate, warp) tests the kernel's cull left added
    to it (of WARPS per candidate of every tile's list)."""
    global launches
    checks = [("table", table, torch.float32), ("cand", cand, torch.int32),
              ("counts", counts, torch.int32)]
    if tested is not None:
        checks.append(("tested", tested, torch.int64))
    for name, t, dtype in checks:
        if not t.is_cuda or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(
                f"{name} must be a contiguous CUDA {dtype} tensor, got "
                f"{t.dtype} on {t.device} (contiguous={t.is_contiguous()})"
            )
    B, N = cand.shape
    if table.ndim != 2 or table.shape[1] != N_LANES:
        raise ValueError(f"table must be (T+1, {N_LANES}), got {table.shape}")
    if counts.shape != (B,) or B % nbx:
        raise ValueError(
            f"bad tile shapes: cand {tuple(cand.shape)}, counts "
            f"{tuple(counts.shape)}, nbx {nbx}"
        )
    if B // nbx < tiles._cdiv(height, TILE_H) or nbx < tiles._cdiv(
            width, TILE_W):
        raise ValueError(f"{B} tiles do not cover a {height}x{width} image")
    if table.data_ptr() % 16:
        raise ValueError("table must be 16-byte aligned (float4 rows)")
    kernel = _kernel()
    z = torch.empty((height, width), dtype=torch.float32, device=table.device)
    ids = torch.empty((height, width), dtype=torch.int32, device=table.device)
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = kernel(
            ctypes.c_void_p(table.data_ptr()),
            ctypes.c_void_p(cand.data_ptr()),
            ctypes.c_void_p(counts.data_ptr()),
            ctypes.c_void_p(z.data_ptr()),
            ctypes.c_void_p(ids.data_ptr()),
            ctypes.c_void_p(0 if tested is None else tested.data_ptr()),
            ctypes.c_int(B), ctypes.c_int(N), ctypes.c_int(nbx),
            ctypes.c_int(height), ctypes.c_int(width),
            ctypes.c_float(float(y_offset)),
            ctypes.c_void_p(stream),
        )
    if err != 0:
        raise RuntimeError(f"raster_tile launch failed: CUDA error {err}")
    launches += 1
    return z, ids


def resolve_tiles(table, cand, counts, y_offset, nbx, height, width):
    """z-resolve of every tile: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors. Returns (depth, ids), each (height, width)."""
    if table.is_cuda:
        return resolve_tiles_cuda(table, cand, counts, y_offset, nbx,
                                  height, width)
    if table.device.type != "cpu":
        raise ValueError(f"no z-resolve for device {table.device}")
    return resolve_tiles_plain(table, cand, counts, y_offset, nbx, height,
                               width)


def resolve_inputs(vertices, faces, rotation, translation, focal_lengths,
                   principal_point, y_offset=0.0, face_vertices=None, *,
                   height, width, max_tris_per_tile=256, clip_near=False,
                   device="cuda"):
    """Setup + binning of one view, the tile route's preparation (span
    smt.tile_prep): (the argument tuple of resolve_tiles, overflow int32
    scalar tensor). Tiles list at most max_tris_per_tile candidates, any
    number (the kernel stages longer lists in chunks). With clip_near the
    rows are the 2T clipped pieces and the resolve returns piece ids."""
    global views
    with span("smt.tile_prep"):
        setup = tiles.setup_inputs(
            vertices, faces, rotation, translation, focal_lengths,
            principal_point, face_vertices, device, clip_near,
        )
        y_offset = float(y_offset)
        cand, counts, overflow = tiles._bin_triangles(
            setup, height, width, max_tris_per_tile, y_offset
        )
        args = (candidate_table(setup), cand, counts, y_offset,
                tiles._cdiv(width, TILE_W), height, width)
    views += 1
    return args, overflow


def rasterize(vertices, faces, rotation, translation, focal_lengths,
              principal_point, y_offset=0.0, face_vertices=None, *, height,
              width, max_tris_per_tile=256, clip_near=False, device="cuda"):
    """Rasterize a triangle mesh into (ids (H, W) int32, depth (H, W) f32,
    overflow int32 scalar tensor).

    ids is -1 for empty pixels; depth is +inf there. Pixel centres are
    sampled at (x + 0.5, y + 0.5). Coverage is inclusive; ties on depth go
    to the lower triangle index. `y_offset` (a python number) renders the
    row band [y_offset, y_offset + height) of a taller image.

    clip_near: triangles crossing z = tiles.CLIP_Z_NEAR render their
    in-front part (tiles.setup_clipped) instead of being culled; the
    resolve runs on the 2T piece rows and each winning piece id maps back
    to its triangle, as `pallas_kernel.rasterize` does.
    """
    args, overflow = resolve_inputs(
        vertices, faces, rotation, translation, focal_lengths,
        principal_point, y_offset, face_vertices, height=height,
        width=width, max_tris_per_tile=max_tris_per_tile,
        clip_near=clip_near, device=device,
    )
    depth, ids = resolve_tiles(*args)
    if clip_near:  # piece id -> triangle id
        ids = torch.where(ids >= 0, ids >> 1, ids)
    return ids, depth, overflow
