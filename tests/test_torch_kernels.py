"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here is marked `gpu` and decides inside itself whether a
CUDA card is present; without one it skips. Run on the card with

    python -m pytest -m gpu tests/test_torch_kernels.py
"""

import numpy as np
import pytest
import torch

from semantic_meshes_torch import distributed, fusion, ops, render, testing
from semantic_meshes_torch.rasterize import dense, dense_kernel, tile_kernel
from semantic_meshes_torch.data import Camera, stack_cameras

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (sm_90a): the kernels have no CPU "
                    "mode; their plain versions are tested on the CPU")
    return torch.device("cuda", 0)


def _inputs(vertices, faces, cam, device, cap=256, y_offset=0.0,
            height=None):
    args, _ = tile_kernel.resolve_inputs(
        vertices, faces, cam.rotation, cam.translation, cam.focal_lengths,
        cam.principal_point, y_offset, height=height or cam.resolution[1],
        width=cam.resolution[0], max_tris_per_tile=cap, device=device)
    return args


def _scenes():
    v, f = testing.make_cube(5)
    for cam in testing.make_ring_cameras(3, 200, 72):  # ragged tiles
        yield v, f, cam, {}
    cam = testing.make_ring_cameras(1, 128, 96)[0]
    yield v, f, cam, dict(y_offset=32.0, height=32)  # a row band
    rng = np.random.default_rng(9)
    rv = rng.normal(size=(80, 3)).astype(np.float32) * 1.5
    rv[:, 2] += 5
    rf = rng.integers(0, 80, size=(60, 3)).astype(np.int32)
    rcam = Camera(np.eye(3), np.zeros(3), (256, 64), [50.0, 50.0],
                  [128.0, 32.0])
    yield rv, rf, rcam, {}
    yield rv, rf, rcam, dict(cap=3)  # overflowing tiles


@pytest.mark.parametrize("k", [*range(6), *testing.TILE_SCENES])
def test_raster_tile_matches_plain(cuda, k):
    """Cube and random scenes (ragged tiles, a row band, overflowing
    tiles) and the hand-binned testing.TILE_SCENES (a tile at the 256 cap,
    slivers on the warps' rectangle boundaries, exact ties inside one
    rectangle and across two, ragged edges, a band, an empty view): ids
    equal and depths bit-equal to the plain version; on the hand-binned
    scenes, the (candidate, warp) tests the kernel counts are those of the
    CPU emulation of its cull (tests/test_torch_tile_split.py)."""
    if isinstance(k, str):
        args = testing.tile_resolve_scene(k, cuda)
    else:
        v, f, cam, kw = list(_scenes())[k]
        args = _inputs(v, f, cam, cuda, **kw)
    before = tile_kernel.launches
    tested = torch.zeros(1, dtype=torch.int64, device=cuda)
    zk, ik = tile_kernel.resolve_tiles_cuda(*args, tested=tested)
    z2, i2 = tile_kernel.resolve_tiles(*args)
    torch.cuda.synchronize()
    assert tile_kernel.launches == before + 2
    assert torch.equal(i2, ik)
    assert torch.equal(z2.view(torch.int32), zk.view(torch.int32))
    zp, ip = tile_kernel.resolve_tiles_plain(*args)
    assert torch.equal(ik, ip)
    assert torch.equal(zk.view(torch.int32), zp.view(torch.int32))
    # and the CPU run of the plain version agrees with the card's
    cpu_args = [a.cpu() if torch.is_tensor(a) else a for a in args]
    zc, ic = tile_kernel.resolve_tiles_plain(*cpu_args)
    assert torch.equal(ic, ik.cpu())
    assert torch.equal(zc.view(torch.int32), zk.cpu().view(torch.int32))
    assert 0 <= int(tested) <= tile_kernel.WARPS * int(args[2].sum())
    if isinstance(k, str):
        from test_torch_tile_split import warp_scan

        assert int(tested) == warp_scan(*cpu_args)[2]


def test_segment_sum_is_deterministic_on_the_card(cuda):
    rng = np.random.default_rng(0)
    data = torch.from_numpy(rng.normal(size=(200000, 20)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(-10, 3000, size=200000))
    a = ops.segment_sum(data.to(cuda), idx.to(cuda), 3000)
    b = ops.segment_sum(data.to(cuda), idx.to(cuda), 3000)
    assert torch.equal(a, b)
    np.testing.assert_allclose(a.cpu().numpy(),
                               ops.segment_sum(data, idx, 3000).numpy(),
                               rtol=1e-5, atol=1e-5)


def test_batched_pipeline_card_equals_cpu(cuda):
    v, f = testing.make_cube(6)
    cams = testing.make_ring_cameras(3, 256, 192)
    rot, trans, fl, pp = stack_cameras(cams)
    probs = np.stack([testing.random_probs(np.random.default_rng(i), 192,
                                           256, 7) for i in range(3)])
    kw = dict(num_primitives=len(f), aggregator="summax", height=192,
              width=256)
    acc_g, ov_g = distributed.fuse_views(v, f, rot, trans, fl, pp, probs,
                                         0.5, device=cuda, **kw)
    acc_c, ov_c = distributed.fuse_views(v, f, rot, trans, fl, pp, probs,
                                         0.5, device="cpu", **kw)
    assert int(ov_g) == int(ov_c) == 0
    np.testing.assert_allclose(acc_g.cpu().numpy(), acc_c.numpy(),
                               rtol=1e-5, atol=1e-6)
    agg = fusion.MeshAggregator(len(f), 7, "summax", device=cuda)
    assert agg.device.type == "cuda"


def _mixed_scene():
    """Micro, small and big triangles at 256x96 (all three dense classes)."""
    rng = np.random.default_rng(3)
    verts, tris = [], []
    for n, size, z in ((30, 0.01, 4.0), (10, 0.6, 5.0)):
        for _ in range(n):
            c = rng.normal(size=3) * 0.8
            c[2] = z + rng.random()
            base = len(verts)
            verts += [c, c + [size, 0, 0], c + [0, size, 0]]
            tris.append([base, base + 1, base + 2])
    base = len(verts)
    verts += [[-4, -4, 7], [4, -4, 7], [0, 5, 7]]
    tris.append([base, base + 1, base + 2])
    cam = Camera(np.eye(3), np.zeros(3), (256, 96), [40.0, 40.0],
                 [128.0, 48.0])
    return np.asarray(verts, np.float32), np.asarray(tris, np.int32), cam


def _dense_scenes():
    v, f, cam = _mixed_scene()
    yield v, f, cam, {}
    yield v, f, cam, dict(n_global=0, micro_max=1)  # no global bucket
    v, f = testing.make_cube(9)  # bench.py's `default`, forced dense
    yield v, f, testing.make_ring_cameras(8, 1024, 768)[3], {}
    v, f = testing.make_cube(91)  # one view of bench.py's `scannet`
    yield v, f, testing.make_ring_cameras(8, 1296, 968)[5], dict(
        micro_max=3)


@pytest.mark.parametrize("k", range(4))
def test_raster_dense_matches_plain(cuda, k):
    v, f, cam, kw = list(_dense_scenes())[k]
    args, _, overflow = dense.resolve_inputs(
        v, f, cam.rotation, cam.translation, cam.focal_lengths,
        cam.principal_point, height=cam.height, width=cam.width,
        device=cuda, **kw)
    before = dense_kernel.launches
    zk, ik = dense_kernel.resolve_dense(*args)
    torch.cuda.synchronize()
    assert dense_kernel.launches == before + 1
    zp, ip = dense_kernel.resolve_dense_plain(*args)
    # only the big triangles past an n_global cap may be dropped
    starts = args[2]
    n_big = int(starts[-1] - starts[-2])
    assert int(overflow) == max(n_big - kw.get("n_global", dense.N_GLOBAL),
                                0)
    assert torch.equal(ik, ip)
    assert torch.equal(zk.view(torch.int32), zp.view(torch.int32))
    assert bool((ik >= 0).any())
    # and the CPU run of the plain version agrees with the card's
    zc, ic = dense_kernel.resolve_dense_plain(
        *(a.cpu() if torch.is_tensor(a) else a for a in args))
    assert torch.equal(ic, ik.cpu())
    assert torch.equal(zc.view(torch.int32), zk.cpu().view(torch.int32))


@pytest.mark.parametrize("name", testing.DENSE_SCENES)
def test_raster_dense_split_ties_and_cull(cuda, name):
    """Hand-binned scenes: a tile of ITEM - 1, ITEM, ITEM + 1 and
    3 ITEM + 5 candidates (work items), exact depth ties across an item
    boundary and between a global and an own candidate (the earlier in
    the tile's list wins), n_global = 0 and global buckets over ITEM,
    empty tiles, slivers and far-off-screen vertices. Bit-equal to the
    plain version, the same bits on a second run, and the scratch left
    zero for the next launch."""
    args = testing.dense_resolve_scene(name, cuda)
    before = dense_kernel.launches
    tested = torch.zeros(1, dtype=torch.int64, device=cuda)
    zk, ik = dense_kernel.resolve_dense_cuda(*args, tested=tested)
    z2, i2 = dense_kernel.resolve_dense(*args)
    torch.cuda.synchronize()
    assert dense_kernel.launches == before + 2
    work = dense_kernel._scratch[(cuda.index,
                                  torch.cuda.current_stream(cuda).cuda_stream)]
    assert not bool(work.any())
    zp, ip = dense_kernel.resolve_dense_plain(*args)
    assert torch.equal(ik, ip)
    assert torch.equal(zk.view(torch.int32), zp.view(torch.int32))
    assert torch.equal(i2, ik)
    assert torch.equal(z2.view(torch.int32), zk.view(torch.int32))
    assert bool((ik >= 0).any())
    starts = args[2].long()
    B = starts.numel() - 2
    g = max(min(int(starts[-1] - starts[-2]), args[3]), 0)
    listed = B * g + int(starts[-2])
    assert int(dense_kernel.work_items(args[2], args[3]).sum()) >= B
    assert 0 < int(tested) <= dense_kernel.WARPS * listed
    if name == "tie_items":  # the first of the three copies wins
        K = dense_kernel.ITEM
        assert int((ik == 3).sum()) > 0
        assert not bool(((ik == K + 20) | (ik == 2 * K + 5)).any())
    if name == "tie_global":  # the global copy beats both own copies
        T = args[0].shape[0] - 1
        assert int((ik == T - 2).sum()) > 0
        assert not bool(((ik == 0) | (ik == dense_kernel.ITEM + 10)).any())


def test_dense_renderer_card_equals_cpu(cuda):
    """The dense main path (auto dispatch, probed budgets, micro scatter,
    kernel) on the card gives the CPU run's ids, bit for bit."""
    from types import SimpleNamespace

    v, f = testing.make_cube(37)  # 16428 faces: the dense rasterizer
    mesh = SimpleNamespace(vertices=v, faces=f)
    cams = testing.make_ring_cameras(2, 640, 480)
    out = {}
    for device in (cuda, "cpu"):
        r = render.triangles(mesh, device=device)
        r.prepare(cams)
        out[str(device)] = [r.render(c) for c in cams]
        assert r.overflow_total() == 0
    for (ig, dg), (ic, dc) in zip(out[str(cuda)], out["cpu"]):
        assert torch.equal(ig.cpu().view(torch.int32), ic.view(torch.int32))
        assert torch.equal(dg.cpu().view(torch.int32), dc.view(torch.int32))
