"""Kernel A (csrc/raster_tile.cu) on lists past 256 candidates, on the card.

The kernel stages a tile's list in shared memory in chunks of 256 rows,
and each warp keeps its buffer in registers from chunk to chunk, so the
result is the serial scan's whatever the list's length. Here: one heavy
tile of 257, 511 or 1024 candidates (exact depth ties between rows in
different chunks, the earlier row winning) beside light tiles, equal to
the plain version bit for bit, ids and depths, with the (candidate, warp)
tests of the CPU emulation of its cull; repeated launches bit-identical;
lists of 256 or fewer resolved alike with any number of padding slots; and
the `scannet-simplified` cell's mesh and ring through a `prepare`d renderer
with no pair dropped. Marked `gpu`; without a card it skips. Run on the
card with

    python -m pytest -m gpu tests/test_torch_tile_cap_kernel.py
"""

import numpy as np
import pytest
import torch

from semantic_meshes_torch import render, testing
from semantic_meshes_torch.data import Camera
from semantic_meshes_torch.rasterize import tile_kernel, tiles

pytestmark = pytest.mark.gpu

WIDTH, HEIGHT = 512, 128  # 4 x 4 tiles
# ScanNet v2's colour camera, as the benchmark's eval cells use it
EVAL_W, EVAL_H = 1296, 968
FOCAL, PRINCIPAL = 1170.187988, (647.75, 483.75)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (sm_90a): the kernels have no CPU "
                    "mode; their plain versions are tested on the CPU")
    return torch.device("cuda", 0)


def _heavy_scene(listed, device):
    """resolve_tiles arguments of screen triangles: tile 0 lists `listed`
    candidates, the first base of its own and then copies of the first
    listed - base (exact depth ties with rows of the first chunk), with
    ids reversed so that the earlier row wins a tie by its position; the
    tiles right of column 0 hold a few hundred light triangles; lists are
    padded to every row."""
    rng = np.random.default_rng(listed)
    base = 3 * listed // 5
    p, z = testing._screen_tris(rng, base, (10, 8, 118, 24), 6.0)
    lp, lz = testing._screen_tris(rng, 300, (150, 0, WIDTH, HEIGHT), 15.0)
    copies = listed - base
    p = np.concatenate([p, p[:copies], lp])
    z = np.concatenate([z, z[:copies], lz])
    setup = tiles._setup_from_projected(
        torch.as_tensor(p, dtype=torch.float32),
        torch.as_tensor(z, dtype=torch.float32))
    rows = len(p)
    cand, counts, overflow = tiles._bin_triangles(
        setup, HEIGHT, WIDTH, rows, 0.0)
    assert int(overflow) == 0 and int(counts[0]) == listed
    assert int(counts[1:].max()) < 256
    ids = np.arange(rows, dtype=np.int32)[::-1].copy()
    table = tile_kernel.candidate_table(setup, ids)
    return (table.to(device), cand.to(device), counts.to(device), 0.0,
            tiles._cdiv(WIDTH, tiles.TILE_W), HEIGHT, WIDTH)


def _same(a, b):
    (za, ia), (zb, ib) = a, b
    assert torch.equal(ia.cpu(), ib.cpu())
    assert torch.equal(za.cpu().view(torch.int32),
                       zb.cpu().view(torch.int32))


@pytest.mark.parametrize("listed", [257, 511, 1024])
def test_long_lists_match_plain(cuda, listed):
    from test_torch_tile_split import warp_scan

    args = _heavy_scene(listed, cuda)
    tested = torch.zeros(1, dtype=torch.int64, device=cuda)
    got = tile_kernel.resolve_tiles_cuda(*args, tested=tested)
    want = tile_kernel.resolve_tiles_plain(*args)
    torch.cuda.synchronize()
    _same(got, want)
    cpu_args = [a.cpu() if torch.is_tensor(a) else a for a in args]
    _same(got, tile_kernel.resolve_tiles_plain(*cpu_args))
    z, ids, tests = warp_scan(*cpu_args)
    _same(got, (z, ids))
    assert int(tested) == tests
    # no copy owns a pixel: its original, listed earlier (in an earlier
    # chunk for those at 256 and past) at the same depth, holds every one
    # it covers
    T = args[0].shape[0] - 1
    owners = set(got[1].unique().tolist())
    assert not owners & {T - 1 - r for r in range(3 * listed // 5, listed)}
    for _ in range(3):
        _same(got, tile_kernel.resolve_tiles_cuda(*args))


@pytest.mark.parametrize("name", testing.TILE_SCENES)
@pytest.mark.parametrize("slots", [None, 300, 1024])
def test_short_lists_resolve_alike_with_any_padding(cuda, name, slots):
    """The hand-binned scenes (lists of at most 256, the `cap` scene at
    256) at their own slots and padded past 256 slots with the sentinel:
    equal to the plain version bit for bit and to each other."""
    table, cand, counts, *rest = testing.tile_resolve_scene(name, cuda)
    if slots is not None:
        pad = torch.full((cand.shape[0], slots - cand.shape[1]),
                         table.shape[0] - 1, dtype=torch.int32, device=cuda)
        cand = torch.cat([cand, pad], dim=1).contiguous()
    args = (table, cand, counts, *rest)
    got = tile_kernel.resolve_tiles_cuda(*args)
    _same(got, tile_kernel.resolve_tiles_plain(*args))
    _same(got, tile_kernel.resolve_tiles_cuda(
        *testing.tile_resolve_scene(name, cuda)))


def test_eval_ring_on_the_simplified_mesh(cuda):
    """The `scannet-simplified` cell's mesh (the cube at s = 29, padded to
    10240 faces by bucketing: the tile route) on 8 views of its ring at
    ScanNet's intrinsics: prepare sizes the list past 256, nothing drops,
    one raster_tile launch a view, and each view equals the plain resolve
    of the uncapped lists."""
    from types import SimpleNamespace

    v, f = testing.make_cube(29)
    ring = testing.make_ring_cameras(8, EVAL_W, EVAL_H, radius=2.0,
                                     elevation=0.35, focal=FOCAL)
    cams = [Camera(c.rotation, c.translation, (EVAL_W, EVAL_H),
                   [FOCAL, FOCAL], PRINCIPAL) for c in ring]
    r = render.triangles(SimpleNamespace(vertices=v, faces=f), bucket=True,
                         device=cuda)
    assert r.faces.shape[0] == 10240 and r.backend is None
    r.prepare(cams)
    assert r.tile_caps[(EVAL_H, EVAL_W)] > 256
    before = tile_kernel.launches
    for cam in cams:
        ids, depth = r.render(cam)
        args, overflow = tile_kernel.resolve_inputs(
            None, None, cam.rotation, cam.translation, cam.focal_lengths,
            cam.principal_point, face_vertices=r.face_vertices,
            height=EVAL_H, width=EVAL_W, max_tris_per_tile=len(r.faces),
            device=cuda)
        assert int(overflow) == 0
        z, want = tile_kernel.resolve_tiles_plain(*args)
        _same((depth.t(), ids.view(torch.int32).t()), (z, want))
    assert tile_kernel.launches == before + len(cams)
    assert r.overflow_total() == 0
