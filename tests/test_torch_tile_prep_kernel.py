"""The tile preparation's CUDA kernels (csrc/tile_prep.cu, wrapper
rasterize/tile_prep.py) against the plain chain of PyTorch ops they
replace (tile_kernel.resolve_inputs_plain), bit for bit, on the card.
Every test here is marked `gpu` and decides inside itself whether a CUDA
card is present; without one it skips. Run on the card with

    python -m pytest -m gpu tests/test_torch_tile_prep_kernel.py

Each case compares the candidate table, the tile lists, their counts and
the overflow against the plain chain on the same card, and the ids and
depth kernel A resolves from them against kernel A on the plain chain's.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from semantic_meshes_torch import render, testing
from semantic_meshes_torch.data import Camera
from semantic_meshes_torch.rasterize import tile_kernel, tile_prep

pytestmark = pytest.mark.gpu

# the ScanNet eval's frame and intrinsics; the `scannet-simplified` cell's
# ring around the cube at s = 29 (10092 faces), and a 4 m room of it
# around the sensor
SCANNET = dict(width=1296, height=968, focal=1170.187988,
               principal=(647.75, 483.75))
OUTSIDE = dict(size=1.0, radius=2.0, elevation=0.35, target=(0, 0, 0))
INSIDE = dict(size=4.0, radius=0.8, elevation=-0.625, target=(0, -0.9, 0))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (sm_90a): the kernels have no CPU "
                    "mode; the plain chain is tested on the CPU")
    return torch.device("cuda", 0)


def _ring(views, where, frame=SCANNET):
    ring = testing.make_ring_cameras(
        views, frame["width"], frame["height"], radius=where["radius"],
        elevation=where["elevation"], target=where["target"],
        focal=frame["focal"])
    return [Camera(c.rotation, c.translation,
                   (frame["width"], frame["height"]),
                   [frame["focal"], frame["focal"]], frame["principal"])
            for c in ring]


def _cam(c):
    return (c.rotation, c.translation, c.focal_lengths, c.principal_point)


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _same_image(a, b):
    (za, ia), (zb, ib) = a, b
    assert torch.equal(ia, ib)
    assert torch.equal(za.view(torch.int32), zb.view(torch.int32))


def _compare(cuda, cam, *, face_vertices=None, vertices=None, faces=None,
             height=SCANNET["height"], width=SCANNET["width"], **kw):
    """The kernels' and the plain chain's preparation of one view on the
    card, compared bit for bit (table, lists, counts, overflow: values,
    shapes and types), and kernel A's ids and depth from each; two
    launches, one view, no host sync. Returns (overflow, counts)."""
    kw = dict(height=height, width=width, **kw)
    launches, views = tile_prep.launches, tile_prep.views
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got, ov = tile_kernel.resolve_inputs(vertices, faces, *cam,
                                             face_vertices=face_vertices,
                                             device=cuda, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert tile_prep.launches - launches == 2
    assert tile_prep.views - views == 1
    want, ov_want = tile_kernel.resolve_inputs_plain(
        vertices, faces, *cam, face_vertices=face_vertices, device=cuda,
        **kw)
    assert len(got) == len(want)
    for name, a, b in zip(("table", "cand", "counts"), got, want):
        assert a.is_cuda and a.is_contiguous(), name
        assert (a.dtype, a.shape) == (b.dtype, b.shape), name
        diff = int((_bits(a) != _bits(b)).sum())
        assert diff == 0, f"{name}: {diff} entries differ from plain"
    assert tuple(got[3:]) == tuple(want[3:])
    assert (ov.dtype, ov.shape) == (ov_want.dtype, ov_want.shape)
    assert int(ov) == int(ov_want)
    _same_image(tile_kernel.resolve_tiles(*got),
                tile_kernel.resolve_tiles(*want))
    return int(ov), got[2]


def _scene(subdivisions, where, cuda):
    v, f = testing.make_cube(subdivisions, where["size"])
    fv = torch.as_tensor(v[f], dtype=torch.float32, device=cuda)
    return v, f, fv


@pytest.mark.parametrize("cap", [256, 448])
def test_eval_ring_on_the_simplified_mesh(cuda, cap):
    """The `scannet-simplified` cell's mesh on 8 views of its ring at
    ScanNet's frame: at the JAX package's 256 the heaviest tiles drop rows
    (overflow > 0 on some view), at the cell's probed 448 none do; both
    bit-equal to the plain chain."""
    _, f, fv = _scene(29, OUTSIDE, cuda)
    assert len(f) == 10092
    drops = [_compare(cuda, _cam(c), face_vertices=fv,
                      max_tris_per_tile=cap)[0]
             for c in _ring(8, OUTSIDE)]
    if cap == 256:
        assert max(drops) > 0
    else:
        assert drops == [0] * 8


@pytest.mark.parametrize("clip_near", [False, True])
def test_inside_the_room(cuda, clip_near):
    """The sensor inside a 4 m room of the s = 29 cube: rows behind the
    camera culled, or with clip_near cut at the near plane into 2T piece
    rows."""
    _, _, fv = _scene(29, INSIDE, cuda)
    for c in _ring(6, INSIDE):
        _compare(cuda, _cam(c), face_vertices=fv, clip_near=clip_near,
                 max_tris_per_tile=512)


@pytest.mark.parametrize("clip_near", [False, True])
def test_row_bands(cuda, clip_near):
    """Row bands of the frame with their y_offset (a band of a taller
    image, as the sharded fuse renders), whole tiles and ragged."""
    _, _, fv = _scene(29, OUTSIDE, cuda)
    cam = _cam(_ring(3, OUTSIDE)[1])
    for y0, h in ((0, 320), (320, 320), (640, 328), (100, 77), (900, 68)):
        _compare(cuda, cam, face_vertices=fv, height=h, y_offset=float(y0),
                 clip_near=clip_near)


def test_camera_facing_away(cuda):
    """A camera turned away from the cube: every row is behind it, every
    tile's list is empty (counts 0, the sentinel in every slot), the
    overflow 0."""
    _, f, fv = _scene(29, OUTSIDE, cuda)
    c = _ring(1, OUTSIDE)[0]
    flip = np.diag([-1.0, 1.0, -1.0]).astype(np.float32)
    cam = (flip @ c.rotation, flip @ c.translation, c.focal_lengths,
           c.principal_point)
    ov, counts = _compare(cuda, cam, face_vertices=fv)
    assert ov == 0 and int(counts.max()) == 0
    got, _ = tile_kernel.resolve_inputs(None, None, *cam, face_vertices=fv,
                                        device=cuda, height=968, width=1296)
    assert bool((got[1] == len(f)).all())


def test_fewer_rows_than_the_cap(cuda):
    """A mesh of fewer rows than the cap: each list is T long (N = T)."""
    v, f = testing.make_cube(3)
    fv = torch.as_tensor(v[f], dtype=torch.float32, device=cuda)
    for c in _ring(4, OUTSIDE):
        _compare(cuda, _cam(c), face_vertices=fv, max_tris_per_tile=256)
    got, _ = tile_kernel.resolve_inputs(None, None, *_cam(c),
                                        face_vertices=fv, device=cuda,
                                        height=968, width=1296)
    assert got[1].shape == (341, len(f)) and len(f) < 256


def test_a_list_exactly_full(cuda):
    """A cap equal to the heaviest tile's count: that list is exactly full
    (no sentinel, no overflow); one less drops one row of each tile at
    that count."""
    _, _, fv = _scene(29, OUTSIDE, cuda)
    cam = _cam(_ring(8, OUTSIDE)[3])
    uncapped = tile_kernel.resolve_inputs_plain(
        None, None, *cam, face_vertices=fv, device=cuda, height=968,
        width=1296, max_tris_per_tile=len(fv))[0][2]
    heaviest = int(uncapped.max())
    ov, counts = _compare(cuda, cam, face_vertices=fv,
                          max_tris_per_tile=heaviest)
    assert ov == 0 and int(counts.max()) == heaviest
    ov, counts = _compare(cuda, cam, face_vertices=fv,
                          max_tris_per_tile=heaviest - 1)
    assert ov == int((uncapped == heaviest).sum()) > 0


@pytest.mark.parametrize("faces_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("clip_near", [False, True])
def test_gather_path(cuda, faces_dtype, clip_near):
    """vertices and faces in place of face vertices: the kernels gather
    each triangle's vertices by its int32 or int64 face."""
    v, f, _ = _scene(29, OUTSIDE, cuda)
    vt = torch.as_tensor(v, dtype=torch.float32, device=cuda)
    ft = torch.as_tensor(f, device=cuda).to(faces_dtype)
    for c in _ring(3, OUTSIDE):
        _compare(cuda, _cam(c), vertices=vt, faces=ft, clip_near=clip_near,
                 max_tris_per_tile=448)
    # host arrays are uploaded first (a sync then), then the same kernels
    got, ov = tile_kernel.resolve_inputs(v, f, *_cam(c), device=cuda,
                                         height=968, width=1296,
                                         max_tris_per_tile=448)
    want, _ = tile_kernel.resolve_inputs_plain(
        v, f, *_cam(c), device=cuda, height=968, width=1296,
        max_tris_per_tile=448)
    assert torch.equal(_bits(got[0]), _bits(want[0]))
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])


def test_bucket_padding_rows(cuda):
    """The bucketed renderer's face vertices: 10092 faces padded to 10240
    with degenerate rows (vertex 0 three times), which bin nowhere; the
    renderer's frames through the kernels equal the plain chain's."""
    v, f = testing.make_cube(29)
    r = render.triangles(SimpleNamespace(vertices=v, faces=f), bucket=True,
                         device=cuda)
    assert r.face_vertices.shape[0] == 10240
    cams = _ring(4, OUTSIDE)
    r.prepare(cams)
    cap = r.tile_caps[(968, 1296)]
    for c in cams:
        _compare(cuda, _cam(c), face_vertices=r.face_vertices,
                 max_tris_per_tile=cap)
        ids, depth = r.render(c)
        args, ov = tile_kernel.resolve_inputs_plain(
            None, None, *_cam(c), face_vertices=r.face_vertices, device=cuda,
            height=968, width=1296, max_tris_per_tile=cap)
        z, want = tile_kernel.resolve_tiles_cuda(*args)
        _same_image((depth.t(), ids.view(torch.int32).t()), (z, want))
    assert r.overflow_total() == 0


def test_device_camera(cuda):
    """Camera arrays held on the card (f32 and f64) are read where they lie,
    and equal the host camera's preparation."""
    _, _, fv = _scene(29, OUTSIDE, cuda)
    c = _ring(3, OUTSIDE)[2]
    for dtype in (torch.float32, torch.float64):
        cam = tuple(torch.as_tensor(np.asarray(x), dtype=dtype, device=cuda)
                    for x in _cam(c))
        _compare(cuda, cam, face_vertices=fv, max_tris_per_tile=448)
    host, _ = tile_kernel.resolve_inputs(None, None, *_cam(c),
                                         face_vertices=fv, device=cuda,
                                         height=968, width=1296,
                                         max_tris_per_tile=448)
    dev, _ = tile_kernel.resolve_inputs(None, None, *cam, face_vertices=fv,
                                        device=cuda, height=968, width=1296,
                                        max_tris_per_tile=448)
    for a, b in zip(host[:3], dev[:3]):
        assert torch.equal(_bits(a), _bits(b))


def test_repeated_calls_are_bit_identical(cuda):
    """The lists do not depend on the order the tile blocks run in: ten
    calls give the same bits."""
    _, _, fv = _scene(29, OUTSIDE, cuda)
    cam = _cam(_ring(8, OUTSIDE)[5])
    first, ov = tile_kernel.resolve_inputs(None, None, *cam,
                                           face_vertices=fv, device=cuda,
                                           height=968, width=1296)
    for _ in range(10):
        again, ov2 = tile_kernel.resolve_inputs(
            None, None, *cam, face_vertices=fv, device=cuda, height=968,
            width=1296)
        for a, b in zip(first[:3], again[:3]):
            assert torch.equal(_bits(a), _bits(b))
        assert int(ov2) == int(ov)


def test_rasterize_equals_plain_preparation_then_kernel_a(cuda):
    """tile_kernel.rasterize (the kernels, then kernel A) gives the ids and
    depths of the plain preparation followed by kernel A, exactly, with and
    without clip_near."""
    _, _, fv = _scene(29, OUTSIDE, cuda)
    for clip_near in (False, True):
        for c in _ring(4, OUTSIDE):
            ids, depth, ov = tile_kernel.rasterize(
                None, None, *_cam(c), face_vertices=fv, height=968,
                width=1296, max_tris_per_tile=448, clip_near=clip_near,
                device=cuda)
            args, ov_want = tile_kernel.resolve_inputs_plain(
                None, None, *_cam(c), face_vertices=fv, device=cuda,
                height=968, width=1296, max_tris_per_tile=448,
                clip_near=clip_near)
            z, want = tile_kernel.resolve_tiles_cuda(*args)
            if clip_near:
                want = torch.where(want >= 0, want >> 1, want)
            _same_image((depth, ids), (z, want))
            assert int(ov) == int(ov_want) == 0
            assert bool((ids >= 0).any())


@pytest.mark.parametrize("case", ["fv_float64", "fv_strided", "vertices_f64",
                                  "faces_float", "faces_strided",
                                  "faces_elsewhere"])
def test_the_wrapper_refuses_wrong_cuda_tensors(cuda, case):
    """tile_prep.prepare raises on a CUDA input of the wrong type or
    strides, and launches nothing (resolve_inputs converts before it)."""
    v, f, fv = _scene(5, OUTSIDE, cuda)
    vt = torch.as_tensor(v, dtype=torch.float32, device=cuda)
    ft = torch.as_tensor(f, device=cuda)
    args = {
        "fv_float64": (fv.double(), None, None),
        "fv_strided": (torch.cat([fv, fv], 2)[..., ::2], None, None),
        "vertices_f64": (None, vt.double(), ft),
        "faces_float": (None, vt, ft.float()),
        "faces_strided": (None, vt, torch.cat([ft, ft], 1)[:, ::2]),
        "faces_elsewhere": (None, vt, ft.cpu()),
    }[case]
    launches = tile_prep.launches
    with pytest.raises(ValueError):
        tile_prep.prepare(*args, _cam(_ring(1, OUTSIDE)[0]), height=968,
                          width=1296, y_offset=0.0, max_tris_per_tile=256,
                          clip_near=False)
    assert tile_prep.launches == launches
