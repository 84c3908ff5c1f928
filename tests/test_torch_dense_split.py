"""The design of the dense z-resolve kernel (csrc/raster_dense.cu), checked
on the CPU without the card.

1. The work-item split: each tile's candidate list cut into items, each
   item scanned alone from an empty buffer, and the items merged per pixel
   by the maximum of the packed key (bits(inv_z) << 32) | (0xFFFFFFFF -
   position) in any order, equals the serial scan of the whole list
   (tile_kernel.resolve_tiles_plain), ties, inv_z <= 0, NaN and +-inf
   forms included.
2. The per-warp cull: where the form (a*px + b*py) + c, rounded op by op
   in float32, is < 0 at the corner of a warp's rectangle chosen by the
   signs of a and b, no pixel centre of the rectangle has it >= 0; and
   where the inverse-depth plane is <= a lower bound there, no pixel has
   it above the bound.
"""

import re

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from semantic_meshes_torch import _build, testing
from semantic_meshes_torch.rasterize import dense_kernel, tile_kernel

TILE_H, TILE_W = dense_kernel.TILE_H, dense_kernel.TILE_W
_MASK32 = 0xFFFFFFFF


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The scans below are thousands of small torch ops; beside other test
    workers on the same cores, a pool of intra-op threads per op waits on
    the scheduler at every op, so each test runs on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _item_scan(params, first, n, px, py, state=None):
    """Serial scan of one work item: params (B, K, 16) rows, n (B,) live
    candidates or a (B, K) mask of them, px and py pixel centres of B
    pixel blocks (a tile each, or a warp's rectangle), from `state`
    (inv_z, position) or an empty buffer; returns (inv_z, list position
    or -1) per pixel of every block."""
    B, K = params.shape[:2]
    shape = (B, *torch.broadcast_shapes(px.shape, py.shape)[1:])
    if state is None:
        state = (torch.zeros(shape, dtype=torch.float32),
                 torch.full(shape, -1, dtype=torch.int64))
    invz, pos = state
    live = n if n.ndim == 2 else torch.arange(K)[None, :] < n[:, None]
    for c in range(K):
        p = params[:, c, :, None, None]
        w0 = p[:, 0] * px + p[:, 1] * py + p[:, 2]
        w1 = p[:, 3] * px + p[:, 4] * py + p[:, 5]
        w2 = p[:, 6] * px + p[:, 7] * py + p[:, 8]
        iz = p[:, 10] * px + p[:, 11] * py + p[:, 12]
        ok = ((w0 >= 0) & (w1 >= 0) & (w2 >= 0) & (iz > invz)
              & live[:, c, None, None])
        invz = torch.where(ok, iz, invz)
        pos = torch.where(ok, torch.full_like(pos, first + c), pos)
    return invz, pos


def split_merge(table, cand, counts, y_offset, nbx, height, width, item,
                seed=0):
    """The kernel's split and merge in plain torch: items of `item`
    candidates, merged in a shuffled order by the packed-key maximum.
    Returns (depth, ids) images, as resolve_tiles_plain does."""
    B, N = cand.shape
    px, py = tile_kernel._pixel_centres(B // nbx, nbx, y_offset,
                                        table.device, TILE_H)
    key = torch.zeros((B, TILE_H, TILE_W), dtype=torch.int64)
    firsts = list(range(0, max(N, 1), item))
    np.random.default_rng(seed).shuffle(firsts)
    for first in firsts:
        params = table[cand[:, first:first + item].long()]
        n = torch.clamp(counts.long() - first, 0, item)
        invz, pos = _item_scan(params, first, n, px, py)
        k = (invz.view(torch.int32).to(torch.int64) << 32) | (_MASK32 - pos)
        key = torch.maximum(key, torch.where(pos >= 0, k,
                                             torch.zeros_like(k)))
    found = key != 0
    invz = (key >> 32).to(torch.int32).view(torch.float32)
    pos = torch.where(found, _MASK32 - (key & _MASK32), 0)
    rows = torch.gather(cand.long(), 1, pos.reshape(B, -1)).reshape(pos.shape)
    ids = torch.where(found, table[rows, 9].contiguous().view(torch.int32),
                      torch.full_like(rows, -1, dtype=torch.int32))
    z = torch.where(found, torch.reciprocal(invz),
                    torch.full_like(invz, float("inf")))

    def image(t):
        return (t.reshape(B // nbx, nbx, TILE_H, TILE_W).permute(0, 2, 1, 3)
                .reshape(-1, nbx * TILE_W)[:height, :width])

    return image(z), image(ids)


def _random_lists(seed, n_max=90):
    """Random candidate lists of 3 x 2 tiles of a 256 x 40 image: screen
    triangles, with forced exact depth ties (constant planes), inv_z <= 0,
    NaN and +-inf lanes, and duplicated rows."""
    rng = np.random.default_rng(seed)
    T = 160
    p, z = testing._screen_tris(rng, T, (0, 0, 256, 40), 30.0)
    setup = tile_kernel.tiles._setup_from_projected(
        torch.as_tensor(p, dtype=torch.float32),
        torch.as_tensor(z, dtype=torch.float32))
    table = tile_kernel.candidate_table(setup)
    flat = rng.random(T) < 0.3  # constant planes from 3 values: ties
    table[:T, 10:12][torch.as_tensor(flat)] = 0.0
    table[:T, 12][torch.as_tensor(flat)] = torch.as_tensor(
        rng.choice([0.25, 0.5, 0.125], size=int(flat.sum())),
        dtype=torch.float32)
    behind = torch.as_tensor(rng.random(T) < 0.1)
    table[:T, 12][behind] = -table[:T, 12][behind].abs() - 1.0
    specials = [float("nan"), float("inf"), -float("inf"), 0.0, -0.0]
    for _ in range(25):
        row = int(rng.integers(0, T))
        lane = int(rng.choice([0, 1, 2, 3, 4, 5, 6, 7, 8, 10, 11, 12]))
        table[row, lane] = specials[int(rng.integers(0, len(specials)))]
    dup = rng.integers(0, T, size=20)
    table[dup[10:]] = table[dup[:10]]  # same forms, other ids...
    table[dup[10:], 9] = torch.as_tensor(dup[10:], dtype=torch.int32).view(
        torch.float32)  # ...and their own id lanes
    B, nbx = 6, 2
    counts = torch.as_tensor(rng.integers(0, n_max, size=B), dtype=torch.int32)
    counts[3] = 0  # an empty tile
    cand = torch.full((B, int(counts.max())), T, dtype=torch.int32)
    for b in range(B):
        cand[b, :counts[b]] = torch.as_tensor(
            np.sort(rng.choice(T, size=int(counts[b]), replace=False)))
    return table, cand, counts, nbx


@pytest.mark.parametrize("item", [1, 7, dense_kernel.ITEM])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_split_merge_equals_the_serial_scan(seed, item):
    table, cand, counts, nbx = _random_lists(seed)
    y_offset = [0.0, 3.0, 0.0, 16.0][seed]
    want = tile_kernel.resolve_tiles_plain(table, cand, counts, y_offset,
                                           nbx, 40, 256, tile_h=TILE_H)
    got = split_merge(table, cand, counts, y_offset, nbx, 40, 256, item,
                      seed)
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    assert bool((want[1] >= 0).any())


@pytest.mark.parametrize("name", testing.DENSE_SCENES)
def test_split_merge_equals_resolve_dense_on_the_hand_binned_scenes(name):
    """The hand-binned scenes the card tests use, through the split: equal
    to resolve_dense_plain before its micro merge; the tie scenes keep the
    earlier candidate in list order."""
    args = testing.dense_resolve_scene(name)
    table, sorted_ids, starts, n_global, _, y_offset, nbx, h, w = args
    cand, counts = dense_kernel.candidates(sorted_ids, starts, n_global,
                                           table.shape[0] - 1)
    want = dense_kernel.resolve_dense_plain(*args[:4], None, *args[5:])
    got = split_merge(table, cand, counts, y_offset, nbx, h, w,
                      dense_kernel.ITEM)
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    K, T = dense_kernel.ITEM, table.shape[0] - 1
    if name == "tie_items":  # three copies, K + 17 and 2K + 2 apart
        assert bool((want[1] == 3).any())
        assert not bool(((want[1] == K + 20) | (want[1] == 2 * K + 5)).any())
    if name == "tie_global":  # the global copy (the largest id) wins
        assert bool((want[1] == T - 2).any())
        assert not bool(((want[1] == 0) | (want[1] == K + 10)).any())


def test_kernel_constants_match_the_source():
    src = (_build.CSRC / "raster_dense.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("kItem") == dense_kernel.ITEM
    assert const("kThreads") // 32 == dense_kernel.WARPS
    assert const("kTileH") == TILE_H and const("kTileW") == TILE_W
    assert const("kWarpCols") == 16  # the rectangle the cull test below uses
    # the scratch: a uint64 key per pixel of every tile, a uint32 per tile
    for B in (1, 2, 671):
        assert dense_kernel.work_size(B) * 8 >= B * TILE_H * TILE_W * 8 \
            + B * 4


@pytest.mark.parametrize("name", testing.DENSE_SCENES)
def test_work_items_cut_each_list(name):
    """work_items: ceil(len / ITEM) items per tile's list, one for an empty
    list, as the kernel's block scan counts them."""
    _, sorted_ids, starts, n_global, *_ = testing.dense_resolve_scene(name)
    _, counts = dense_kernel.candidates(sorted_ids, starts, n_global, -1)
    want = [max(1, -(-int(n) // dense_kernel.ITEM)) for n in counts]
    got = dense_kernel.work_items(starts, n_global)
    assert got.tolist() == want
    assert int(got.max()) > 1  # every scene splits a tile


# ----------------------------------------------------------------- the cull

_F32 = np.float32
_SPECIAL = [0.0, -0.0, np.inf, -np.inf, np.nan, 1e-45, -1e-45, 3.4e38,
            -3.4e38, 1e-30, 1.0, -1.0]
_floats = st.one_of(
    st.floats(width=32, allow_nan=True, allow_infinity=True),
    st.floats(-1e3, 1e3, width=32),
    st.sampled_from(_SPECIAL),
)


def _rect(x0, y0, y_offset, cols=16, rows=16):
    """Pixel centres of a warp's rectangle, as the kernel computes them:
    px = x + 0.5, py = (y + 0.5) + y_offset, in float32."""
    xs = np.arange(x0, x0 + cols, dtype=np.float32)
    ys = np.arange(y0, y0 + rows, dtype=np.float32)
    px = xs + _F32(0.5)
    py = (ys + _F32(0.5)) + _F32(y_offset)
    return px[None, :], py[:, None]


def _form(a, b, c, px, py):
    with np.errstate(all="ignore"):
        return (_F32(a) * px + _F32(b) * py) + _F32(c)


def _corner(a, b, c, px, py):
    """The kernel's corner_max: the form at px_hi if a >= 0 else px_lo,
    py_hi if b >= 0 else py_lo."""
    pxc = px[0, -1] if _F32(a) >= 0 else px[0, 0]
    pyc = py[-1, 0] if _F32(b) >= 0 else py[0, 0]
    return _form(a, b, c, np.float32(pxc), np.float32(pyc))


# (x0, y0, y offset, rows): y offsets of the dense rasterizer and of the
# tile rasterizer's row bands of 32-row tiles (and an odd one); 16 rows
# (the dense kernel's warps) or 8 (the tile kernel's)
_rects = st.tuples(st.integers(0, 4096 - 16), st.integers(0, 4096 - 16),
                   st.sampled_from([0.0, 7.0, 0.5, 1024.0, -0.5, -100.0,
                                    32.0, 37.0, 96.0, 736.0]),
                   st.sampled_from([16, 8]))


def _edge_through(data, x0, y0):
    """(a, b, c) of a line through a point near the rectangle, so the
    corner's value is near 0 and its rounding matters."""
    a = data.draw(st.floats(-50, 50, width=32))
    b = data.draw(st.floats(-50, 50, width=32))
    x = x0 + data.draw(st.floats(-4, 20, width=32))
    y = y0 + data.draw(st.floats(-4, 20, width=32))
    c = -(np.float64(a) * x + np.float64(b) * y)
    c += data.draw(st.floats(-1e-3, 1e-3))
    return a, b, float(_F32(c))


@settings(max_examples=600, deadline=None, database=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(data=st.data(), rect=_rects, near=st.booleans())
def test_edge_cull_never_drops_a_passing_pixel(data, rect, near):
    x0, y0, y_offset, rows = rect
    if near:
        a, b, c = _edge_through(data, x0, y0)
    else:
        a, b, c = (data.draw(_floats) for _ in range(3))
    px, py = _rect(x0, y0, y_offset, rows=rows)
    if _corner(a, b, c, px, py) < 0:  # the kernel skips the candidate
        assert not (_form(a, b, c, px, py) >= 0).any()


@settings(max_examples=600, deadline=None, database=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(data=st.data(), rect=_rects, near=st.booleans(),
       lo=st.one_of(st.floats(0, 10, width=32),
                    st.sampled_from([0.0, 1e-45, 0.5])))
def test_depth_cull_never_drops_a_nearer_pixel(data, rect, near, lo):
    x0, y0, y_offset, rows = rect
    if near:
        a, b, c = _edge_through(data, x0, y0)
        c = float(_F32(c + lo))
    else:
        a, b, c = (data.draw(_floats) for _ in range(3))
    px, py = _rect(x0, y0, y_offset, rows=rows)
    if _corner(a, b, c, px, py) <= _F32(lo):  # the kernel skips it
        assert not (_form(a, b, c, px, py) > _F32(lo)).any()
