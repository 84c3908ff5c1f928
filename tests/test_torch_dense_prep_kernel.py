"""The dense preparation's CUDA kernels (csrc/dense_prep.cu, wrapper
rasterize/dense_prep.py) against the plain chain of PyTorch ops they
replace, bit for bit, on the card. Every test here is marked `gpu` and
decides inside itself whether a CUDA card is present; without one it
skips. Run on the card with

    python -m pytest -m gpu tests/test_torch_dense_prep_kernel.py

Each case compares the candidate table, the sorted ids up to the global
bucket's end, the tile starts, the overflow, the micro key image and the
ids and depth kernel B then resolves, against `dense.resolve_inputs_plain`
on the same card.
"""

import numpy as np
import pytest
import torch

from semantic_meshes_torch import testing
from semantic_meshes_torch.rasterize import dense, dense_kernel, dense_prep

pytestmark = pytest.mark.gpu

# The scenes of ScanNet's eval and of the Cityscapes demo at their cameras'
# intrinsics and frame sizes: a cube of 12 s^2 triangles, `size` a side,
# seen from a ring of 12 views (radius, elevation as a share of it,
# target). "scannet-room" puts the eval's camera inside a 4 m room of the
# same triangle count, where some frames see more big rows than n_global.
RINGS = {
    "scannet-eval": dict(subdivisions=91, size=1.0, width=1296, height=968,
                         focal=(1170.187988, 1170.187988),
                         principal=(647.75, 483.75), radius=2.0,
                         elevation=0.35, target=(0.0, 0.0, 0.0)),
    "cityscapes-demo": dict(subdivisions=64, size=1.0, width=2048,
                            height=1024, focal=(2262.52, 2265.30),
                            principal=(1096.98, 513.137), radius=4.0,
                            elevation=0.35, target=(0.0, 0.0, 0.0)),
    "scannet-room": dict(subdivisions=91, size=4.0, width=1296, height=968,
                         focal=(1170.187988, 1170.187988),
                         principal=(647.75, 483.75), radius=0.8,
                         elevation=-0.625, target=(0.0, -0.9, 0.0)),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (sm_90a): the kernels have no CPU "
                    "mode; the plain chain is tested on the CPU")
    return torch.device("cuda", 0)


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _compare(fv, cam, cuda, **kw):
    """Fused and plain preparation of one view on the card, compared bit
    for bit; returns (fused overflow, micro pixels, fused args)."""
    fv = torch.as_tensor(fv, dtype=torch.float32, device=cuda)
    launches, views = dense_prep.launches, dense_prep.views
    args, key, ov = dense.resolve_inputs(None, None, *cam, face_vertices=fv,
                                         device=cuda, **kw)
    zero = kw.get("e_cap_rows") == 0
    assert dense_prep.launches - launches == (2 if zero else 3)
    assert dense_prep.views - views == 1
    pargs, pkey, pov = dense.resolve_inputs_plain(
        None, None, *cam, face_vertices=fv, device=cuda, **kw)
    torch.cuda.synchronize()
    assert key.dtype == torch.int64 and torch.equal(key, pkey)
    assert ov.dtype == torch.int32 and int(ov) == int(pov)
    if zero:
        assert args is None and pargs is None
        z, ids = dense_kernel.decode_micro(key)
        pz, pids = dense_kernel.decode_micro(pkey)
    else:
        table, sids, starts = args[:3]
        ptable, psids, pstarts = pargs[:3]
        assert torch.equal(_bits(table), _bits(ptable))
        assert torch.equal(starts, pstarts)
        end = int(pstarts[-1])
        assert sids.shape == psids.shape
        assert torch.equal(sids[:end], psids[:end])
        assert torch.equal(args[4], key)
        assert ([a for a in args[3:] if not torch.is_tensor(a)]
                == [a for a in pargs[3:] if not torch.is_tensor(a)])
        z, ids = dense_kernel.resolve_dense(*args)
        pz, pids = dense_kernel.resolve_dense(*pargs)
    assert torch.equal(ids, pids)
    assert torch.equal(_bits(z), _bits(pz))
    micro_px = int(((key >> 32) != 0x7F800000).sum())
    return int(ov), micro_px, args


def _ring(name, frames):
    """(face vertices, the cameras of views `frames` of RINGS[name]'s 12,
    height, width)."""
    r = RINGS[name]
    v, f = testing.make_cube(r["subdivisions"], r["size"])
    fv = torch.as_tensor(v)[torch.as_tensor(f).long()]
    ring = testing.make_ring_cameras(
        12, r["width"], r["height"], radius=r["radius"],
        elevation=r["elevation"], target=r["target"])
    cams = [(ring[i].rotation, ring[i].translation,
             np.array(r["focal"], np.float32),
             np.array(r["principal"], np.float32)) for i in frames]
    return fv, cams, r["height"], r["width"]


@pytest.mark.parametrize("config", ["scannet-eval", "cityscapes-demo"])
def test_cells_rings_match_plain(cuda, config):
    """Frames of the benchmark cells' rings at their budgets' defaults, a
    pair budget that drops pairs, and a micro-row budget that drops micro
    rows at micro_max 8 (both counted in the overflow)."""
    fv, cams, h, w = _ring(config, (0, 5, 9))
    for cam in cams:
        ov, _, _ = _compare(fv, cam, cuda, height=h, width=w)
        assert ov == 0
        ov, _, _ = _compare(fv, cam, cuda, height=h, width=w,
                            e_cap_rows=20000)
        assert ov > 0
        ov, micro_px, _ = _compare(fv, cam, cuda, height=h, width=w,
                                   micro_max=8, micro_cap_rows=16)
        assert ov > 0 and micro_px > 0


def _micro_scene():
    """A cube of 19200 faces at 256x192: most triangles cover a few
    pixels, so every micro_max from 2 to 5 routes rows to the fragments."""
    v, f = testing.make_cube(40)
    fv = torch.as_tensor(v)[torch.as_tensor(f).long()]
    cams = testing.make_ring_cameras(3, 256, 192, radius=3.0)
    return v, f, fv, [(c.rotation, c.translation, c.focal_lengths,
                       c.principal_point) for c in cams]


@pytest.mark.parametrize("micro_max", [2, 3, 4, 5])
def test_micro_rows_match_plain(cuda, micro_max):
    """Micro rows at micro_max 2-5: all of them, a budget that drops some
    (compaction), no pair budget at all (e_cap_rows = 0, every pair
    counted), permuted ids (tri_ids) and a row band (y_offset)."""
    _, _, fv, cams = _micro_scene()
    perm = np.random.default_rng(micro_max).permutation(fv.shape[0])
    for cam in cams:
        kw = dict(height=192, width=256, micro_max=micro_max)
        _, micro_px, _ = _compare(fv, cam, cuda, **kw)
        assert micro_px > 1000
        ov, _, _ = _compare(fv, cam, cuda, micro_cap_rows=300, **kw)
        assert ov > 0
        _compare(fv, cam, cuda, e_cap_rows=0, **kw)
        _compare(fv, cam, cuda, e_cap_rows=0, micro_cap_rows=100, **kw)
        _compare(fv, cam, cuda, tri_ids=perm.astype(np.int32), **kw)
        _compare(fv, cam, cuda, **{**kw, "height": 64}, y_offset=96.0)
        _compare(fv, cam, cuda, **{**kw, "height": 64}, y_offset=37.5)


def test_micro_split_plan_matches_plain(cuda):
    """The uni-slot plan: faces permuted uni-first by dense.uni_order,
    rows [0, k) emitting one fragment slot, original ids in tri_ids."""
    v, f, _, cams = _micro_scene()
    rot, trans, fl, pp = (np.stack(a) for a in zip(*cams))
    perm, k = dense.uni_order(v, f, rot, trans, fl, pp, height=192,
                              width=256, device=cuda)
    assert 0 < k < len(f)
    fv = torch.as_tensor(v)[torch.as_tensor(f[perm]).long()]
    for cam in cams:
        for m in (2, 4):
            _, micro_px, _ = _compare(fv, cam, cuda, height=192, width=256,
                                      micro_max=m, micro_split=k,
                                      tri_ids=perm.astype(np.int32))
            assert micro_px > 0


def test_indoor_clip_near_matches_plain(cuda):
    """clip_near on the indoor ring (rows are the 2T clipped pieces; the
    global bucket passes n_global on some frames and its excess is
    counted) and the same frames culled."""
    fv, cams, h, w = _ring("scannet-room", (0, 1, 4))
    dropped = []
    for cam in cams:
        ov, _, _ = _compare(fv, cam, cuda, height=h, width=w, clip_near=True)
        dropped.append(ov)
        _compare(fv, cam, cuda, height=h, width=w)
        _compare(fv, cam, cuda, height=h, width=w, clip_near=True,
                 micro_max=4, micro_cap_rows=8)
    assert dropped[0] == 0 and dropped[1] > 0


def test_adversarial_rows_match_plain(cuda):
    """Random rows around the camera at the origin: behind it, through
    z = 0, at the near and clipping planes, huge and degenerate; culled,
    clipped, without a pair budget, under a micro budget, in a band, and
    with n_global = 3 (the big rows past it counted)."""
    rng = np.random.default_rng(7)
    pts = rng.normal(size=(3000, 3, 3)).astype(np.float32) * 3
    pts[:, :, 2] += rng.uniform(-2, 6, size=(3000, 1)).astype(np.float32)
    pts[:100, 0, 2] = 0.0
    pts[100:200] *= 1e6
    pts[200:300, 1] = pts[200:300, 0]
    pts[300:310, :, 2] = 1e-6
    pts[310:320, :, 2] = 1e-4
    cam = (np.eye(3, dtype=np.float32), np.zeros(3, np.float32),
           np.array([200.0, 200.0], np.float32),
           np.array([128.0, 96.0], np.float32))
    for kw in (dict(), dict(clip_near=True), dict(e_cap_rows=0),
               dict(micro_max=5, micro_cap_rows=50),
               dict(y_offset=32.0, height=64)):
        _compare(pts, cam, cuda, **{"height": 192, "width": 256, **kw})
    ov, _, _ = _compare(pts, cam, cuda, height=192, width=256, n_global=3)
    assert ov > 0


def test_camera_on_the_device_and_on_the_host(cuda):
    """A camera whose arrays are CUDA tensors (the lens path's virtual
    focal, a batch moved to the device once), float64 arrays and lists
    give the plain chain's bits."""
    _, _, fv, cams = _micro_scene()
    rot, trans, fl, pp = cams[1]
    s = torch.tensor(1.0371, device=cuda)
    on_device = (torch.as_tensor(rot, device=cuda),
                 torch.as_tensor(trans, device=cuda),
                 torch.as_tensor(fl, device=cuda) * s,
                 torch.as_tensor(pp, device=cuda))
    _compare(fv, on_device, cuda, height=192, width=256)
    mixed = (rot, trans, on_device[2], on_device[3])
    _compare(fv, mixed, cuda, height=192, width=256, micro_max=3)
    host = (rot.astype(np.float64) + 1e-9, [float(x) for x in trans],
            [230.3, 231.7], np.array([128.1, 96.3]))
    _compare(fv, host, cuda, height=192, width=256)


def test_no_host_sync_inside_the_preparation(cuda):
    """One view of the eval's frame (host camera, face vertices on the
    card) with the sync debug mode raising on any synchronizing call; the
    three kernels are the layer's only launches besides the sort."""
    fv, cams, h, w = _ring("scannet-eval", (5,))
    fv = fv.to(cuda)
    dense.resolve_inputs(None, None, *cams[0], face_vertices=fv, height=h,
                         width=w, device=cuda)  # builds and loads first
    torch.cuda.synchronize()
    launches = dense_prep.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        args, key, ov = dense.resolve_inputs(
            None, None, *cams[0], face_vertices=fv, height=h, width=w,
            device=cuda)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert dense_prep.launches - launches == 3
    z, ids = dense_kernel.resolve_dense(*args)
    assert int(ov) == 0 and bool((ids >= 0).any())
