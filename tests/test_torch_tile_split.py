"""The design of the tile z-resolve kernel (csrc/raster_tile.cu), checked on
the CPU without the card.

The kernel splits each (32, 128) tile by pixels: a warp owns a 16 x 8
rectangle (16 columns, 8 rows) and scans the tile's whole candidate list
in order, in batches of 32; per batch it culls each candidate by the
corner rule against the rectangle (the edge forms, and the inverse-depth
plane against the smallest inv_z in the warp's buffer at the batch's
start), then tests the survivors at its pixels in list order. (The list
itself is staged once per CTA, which changes nothing the warps compute.)
`warp_scan` does the same in plain torch; it must equal the serial scan
of the whole list (tile_kernel.resolve_tiles_plain) bit for bit, whatever
the cull skips.
The cull itself is proved by the hypothesis tests of
tests/test_torch_dense_split.py, whose rectangles include 16 x 8 ones and
the 32-row tiles' y offsets.
"""

import re

import numpy as np
import pytest
import torch

from semantic_meshes_torch import _build, testing
from semantic_meshes_torch.rasterize import tile_kernel
from test_torch_dense_split import (  # noqa: F401 (an autouse fixture)
    _item_scan, _random_lists, one_torch_thread)

TILE_H, TILE_W = tile_kernel.TILE_H, tile_kernel.TILE_W
RW, RH = 16, 8  # a warp's rectangle: RW columns x RH rows
BATCH = 32  # candidates a warp culls at once


def warp_scan(table, cand, counts, y_offset, nbx, height, width):
    """The kernel's per-warp scan and cull in plain torch. Returns (depth,
    ids) images, as resolve_tiles_plain does, and the (candidate, warp)
    tests the cull left."""
    B, N = cand.shape
    bands, cols = TILE_H // RH, TILE_W // RW
    R = bands * cols
    px, py = tile_kernel._pixel_centres(B // nbx, nbx, y_offset,
                                        table.device)
    # (B * R, RH, RW) pixel centres, rectangle r = band * cols + col
    px = px.reshape(B, 1, 1, cols, RW).expand(B, bands, RH, cols, RW)
    py = py.reshape(B, bands, RH, 1, 1).expand(B, bands, RH, cols, RW)
    px = px.permute(0, 1, 3, 2, 4).reshape(B * R, RH, RW)
    py = py.permute(0, 1, 3, 2, 4).reshape(B * R, RH, RW)
    pxl, pxh = px[:, 0, 0], px[:, 0, -1]
    pyl, pyh = py[:, 0, 0], py[:, -1, 0]

    def corner(a, b, c):  # the kernel's corner_max, rounded op by op
        return (a * torch.where(a >= 0, pxh[:, None], pxl[:, None])
                + b * torch.where(b >= 0, pyh[:, None], pyl[:, None])) + c

    params = table[cand.long()].repeat_interleave(R, dim=0)  # (B*R, N, 16)
    n = counts.long().repeat_interleave(R)
    state = None
    tests = 0
    for cb in range(0, int(counts.max()) if B else 0, BATCH):
        lo = (torch.zeros(B * R) if state is None
              else state[0].amin(dim=(1, 2)))
        p = params[:, cb:cb + BATCH]
        slot = cb + torch.arange(p.shape[1])
        live = ((slot[None, :] < n[:, None])
                & ~(corner(p[..., 0], p[..., 1], p[..., 2]) < 0)
                & ~(corner(p[..., 3], p[..., 4], p[..., 5]) < 0)
                & ~(corner(p[..., 6], p[..., 7], p[..., 8]) < 0)
                & ~(corner(p[..., 10], p[..., 11], p[..., 12])
                    <= lo[:, None]))
        tests += int(live.sum())
        state = _item_scan(p, cb, live, px, py, state)
    if state is None:  # no candidate in any tile
        state = (torch.zeros((B * R, RH, RW)),
                 torch.full((B * R, RH, RW), -1, dtype=torch.int64))
    invz, pos = state
    found = pos >= 0
    rows = torch.gather(cand.long().repeat_interleave(R, dim=0), 1,
                        pos.clamp(min=0).reshape(B * R, -1)).reshape(pos.shape)
    ids = torch.where(found, table[rows, 9].contiguous().view(torch.int32),
                      torch.full_like(rows, -1, dtype=torch.int32))
    z = torch.where(found, torch.reciprocal(invz),
                    torch.full_like(invz, float("inf")))

    def image(t):  # (B * R, RH, RW) rectangles -> (height, width)
        return (t.reshape(B // nbx, nbx, bands, cols, RH, RW)
                .permute(0, 2, 4, 1, 3, 5)
                .reshape(B // nbx * TILE_H, nbx * TILE_W)[:height, :width])

    return image(z), image(ids), tests


def _check(args):
    """warp_scan == resolve_tiles_plain, bit for bit; returns (ids, tests,
    candidates listed)."""
    want_z, want_i = tile_kernel.resolve_tiles_plain(*args)
    got_z, got_i, tests = warp_scan(*args)
    assert torch.equal(got_i, want_i)
    assert torch.equal(got_z.view(torch.int32), want_z.view(torch.int32))
    listed = int(args[2].sum())
    assert 0 <= tests <= tile_kernel.WARPS * listed
    return want_i, tests, listed


@pytest.mark.parametrize("y_offset", [0.0, 3.0, 32.0, 37.0])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_warp_scan_equals_the_serial_scan(seed, y_offset):
    """Random lists with exact depth ties, inv_z <= 0, NaN and +-inf lanes
    and duplicated rows, on 3 x 2 tiles of a 256 x 40 image."""
    table, cand, counts, nbx = _random_lists(seed)
    ids, tests, listed = _check((table, cand, counts, y_offset, nbx, 40,
                                 256))
    assert bool((ids >= 0).any())
    assert tests < tile_kernel.WARPS * listed  # the cull skipped some


@pytest.mark.parametrize("name", testing.TILE_SCENES)
def test_warp_scan_equals_the_serial_scan_on_the_tile_scenes(name):
    args = testing.tile_resolve_scene(name)
    ids, tests, listed = _check(args)
    counts = args[2]
    if name == "empty":
        assert listed == 0 and tests == 0 and not bool((ids >= 0).any())
        return
    assert bool((ids >= 0).any())
    if name == "cap":
        assert int(counts.max()) == 256
    if name == "ties":  # copies at list positions 0, 12, 34 and 11, 33,
        # with ids reversed: the earliest copy wins with the largest id
        T = args[0].shape[0] - 1
        assert bool((ids == T - 1).any()) and bool((ids == T - 1 - 11).any())
        for later in (12, 34, 33):
            assert not bool((ids == T - 1 - later).any())
    if name == "ragged":
        assert args[6] % TILE_W and args[5] % TILE_H
    if name == "band":
        assert args[3] == 37.0


@pytest.mark.parametrize("view", [0, 1, 3])
def test_warp_scan_equals_the_serial_scan_on_large_cube_views(view):
    """bench.py's `large` preset (cube s=16, 2048 x 1536), cut to the row
    band of two tile rows that holds a view's heaviest tile."""
    vertices, faces = testing.make_cube(16)
    cam = testing.make_ring_cameras(8, 2048, 1536)[view]

    def inputs(**kw):
        return tile_kernel.resolve_inputs(
            vertices, faces, cam.rotation, cam.translation,
            cam.focal_lengths, cam.principal_point, width=2048,
            device="cpu", **kw)[0]

    counts = inputs(height=1536)[2]
    heavy_row = int(counts.argmax()) // (2048 // TILE_W)
    r0 = min(heavy_row, 1536 // TILE_H - 2)
    args = inputs(height=2 * TILE_H, y_offset=float(r0 * TILE_H))
    assert int(args[2].max()) == int(counts.max()) > 100
    _, tests, listed = _check(args)
    assert tests < 0.3 * tile_kernel.WARPS * listed


def test_kernel_constants_match_the_source():
    src = (_build.CSRC / "raster_tile.cu").read_text()

    def const(name):
        m = re.search(rf"constexpr int {name} = ([^;]+);", src)
        return m.group(1).split("//")[0].strip()

    assert int(const("kTileH")) == TILE_H and int(const("kTileW")) == TILE_W
    # the rectangle warp_scan uses: lane l takes column l % kWarpCols and
    # rows l / kWarpCols + (32 / kWarpCols) k for k < kRowsPerThread
    assert int(const("kWarpCols")) == RW
    assert const("kRowStep") == "32 / kWarpCols"
    assert const("kWarpRows") == "kRowStep * kRowsPerThread"
    assert 32 // RW * int(const("kRowsPerThread")) == RH
    assert int(const("kBatch")) == BATCH
    assert (TILE_H // RH) * (TILE_W // RW) == tile_kernel.WARPS
    # the cull and the pixel test are the shared ones
    assert '#include "raster_common.cuh"' in src
    assert "may_pass(" in src and "test_pixels(" in src


@pytest.mark.parametrize("rect", [0, 5, 8, 19, 31])
def test_a_triangle_inside_one_rectangle_is_tested_by_one_warp(rect):
    """Rectangle r = band * 8 + column of the kernel's warps: a triangle
    strictly inside r's pixel centres survives only r's edge cull."""
    band, col = divmod(rect, TILE_W // RW)
    x0, y0 = 128 + col * RW, 32 + band * RH  # in tile (1, 1)
    # legs along the rectangle's sides: every other rectangle fails one
    # edge's corner test
    p = torch.tensor([[[x0 + 1.0, y0 + 1.0], [x0 + 14.0, y0 + 1.0],
                       [x0 + 1.0, y0 + 6.0]]])
    setup = tile_kernel.tiles._setup_from_projected(p, torch.full((1, 3),
                                                                  2.0))
    cand, counts, _ = tile_kernel.tiles._bin_triangles(setup, 64, 256, 256,
                                                       0.0)
    args = (tile_kernel.candidate_table(setup), cand, counts, 0.0, 2, 64,
            256)
    ids, tests, listed = _check(args)
    assert listed == 1 and tests == 1
    hit = (ids == 0).nonzero()
    assert int(hit[:, 0].min()) >= y0 and int(hit[:, 0].max()) < y0 + RH
    assert int(hit[:, 1].min()) >= x0 and int(hit[:, 1].max()) < x0 + RW
