"""The texel shader's CUDA kernels (csrc/texel_shader.cu, wrapper
texel_kernel.py) against the plain chain of PyTorch ops they replace
(render._texel_prim_image_plain), bit for bit on every pixel, on the same
card inputs. Every test here is marked `gpu` and decides inside itself
whether a CUDA card is present; without one it skips. Run on the card with

    python -m pytest -m gpu tests/test_torch_texel_shader_kernel.py
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from semantic_meshes_torch import (distributed, fusion, geometry, render,
                                   texel_kernel, testing)
from semantic_meshes_torch import rasterize as rast
from semantic_meshes_torch.data import Camera, stack_cameras

pytestmark = pytest.mark.gpu

# the ScanNet eval's frame and intrinsics, outside the cube and inside a
# 4 m room of it (the benchmark's scannet-eval and scannet-room rings)
SCANNET = dict(width=1296, height=968, focal=(1170.187988, 1170.187988),
               principal=(647.75, 483.75))
OUTSIDE = dict(size=1.0, radius=2.0, elevation=0.35, target=(0, 0, 0))
INSIDE = dict(size=4.0, radius=0.8, elevation=-0.625, target=(0, -0.9, 0))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (sm_90a): the kernels have no CPU "
                    "mode; the plain chain is tested on the CPU")
    return torch.device("cuda", 0)


def _arrays(cam):
    return (cam.rotation, cam.translation, cam.focal_lengths,
            cam.principal_point)


def _scene(cuda, subdivisions, where, tpp, clip_near=False, views=3,
           bucket=False, frame=None, backend=None):
    """A texel renderer of the cube on the card and its triangle-id images
    of `views` ring cameras: (renderer, cameras, ids (H, W) int32)."""
    frame = frame or dict(width=256, height=192, focal=None, principal=None)
    v, f = testing.make_cube(subdivisions, where["size"])
    cams = testing.make_ring_cameras(
        views, frame["width"], frame["height"], radius=where["radius"],
        elevation=where["elevation"], target=where["target"],
        focal=None if frame["focal"] is None else frame["focal"][0])
    if frame["principal"] is not None:
        cams = [Camera(c.rotation, c.translation, c.resolution,
                       frame["focal"], frame["principal"]) for c in cams]
    r = render.texels(SimpleNamespace(vertices=v, faces=f), cams, tpp,
                      clip_near=clip_near, bucket=bucket, backend=backend,
                      device=cuda)
    r.prepare(cams)
    ids = []
    for c in cams:
        cap = r._dense_e_cap(frame["height"], frame["width"], *_arrays(c))
        ids.append(rast.rasterize(
            r.vertices, r.faces, *_arrays(c), face_vertices=r.face_vertices,
            height=frame["height"], width=frame["width"],
            backend=backend, clip_near=clip_near, dense_e_cap=cap,
            device=cuda)[0])
    return r, cams, ids


def _shade(cuda, vertices, faces, cam, tri, res, first, none, **kw):
    """The kernels' texel ids, held to the plain chain's on the same card
    inputs bit for bit; two launches, one view."""
    launches, views = texel_kernel.launches, texel_kernel.views
    got = render._texel_prim_image(vertices, faces, *cam, tri, res, first,
                                   none, **kw)
    assert texel_kernel.launches - launches == 2
    assert texel_kernel.views - views == 1
    want = render._texel_prim_image_plain(vertices, faces, *cam, tri, res,
                                          first, none, **kw)
    assert got.is_cuda and got.dtype == torch.int32
    assert got.shape == tri.shape
    diff = int((got != want).sum())
    assert diff == 0, f"{diff} pixels differ from the plain chain"
    return got


def _tables(r):
    return (r.vertices, r.faces), (r.resolutions, r.first_texel_index)


@pytest.mark.parametrize("clip_near", [False, True])
@pytest.mark.parametrize("tpp", [0.1, 2.0])
def test_scannet_frames_match_plain(cuda, tpp, clip_near):
    """The eval's frames (1296x968, 99372 faces; outside the cube, or
    clipped inside the room) at 0.1 texels a pixel (r <= 1) and 2.0
    (r > 1): both none values, background included."""
    where = INSIDE if clip_near else OUTSIDE
    r, cams, ids = _scene(cuda, 91, where, tpp, clip_near, frame=SCANNET)
    (vertices, faces), (res, first) = _tables(r)
    P = r.getPrimitivesNum()
    # outside the cube 0.1 texels a pixel gives every face r <= 1; inside
    # the room the faces beside the sensor are larger
    assert (int(res.max()) == 1) == (tpp == 0.1 and not clip_near)
    for cam, tri in zip(cams, ids):
        for none in (-1, P):
            got = _shade(cuda, vertices, faces, _arrays(cam), tri, res,
                         first, none, clip_near=clip_near)
            assert bool((got[tri < 0] == none).all())
        covered = tri >= 0
        assert bool(covered.any())
        assert bool(((got[covered] >= 0) & (got[covered] < P)).all())


@pytest.mark.parametrize("clip_near", [False, True])
def test_card_ids_equal_the_cpu_chain(cuda, clip_near):
    """The card's texel ids equal the plain chain's on the CPU from the
    same triangle ids and tables, and the texel renderer's public ids on
    the card equal the CPU renderer's (-1 for no texel, through _shade)."""
    where = INSIDE if clip_near else OUTSIDE
    r, cams, ids = _scene(cuda, 20, where, 1.5, clip_near)
    (vertices, faces), (res, first) = _tables(r)
    P = r.getPrimitivesNum()
    cpu = [t.cpu() for t in (vertices, faces, res, first)]
    v, f = testing.make_cube(20, where["size"])
    r_cpu = render.texels(SimpleNamespace(vertices=v, faces=f), cams, 1.5,
                          clip_near=clip_near, device="cpu")
    for cam, tri in zip(cams, ids):
        got = _shade(cuda, vertices, faces, _arrays(cam), tri, res, first, P,
                     clip_near=clip_near)
        want = render._texel_prim_image_plain(
            *cpu[:2], *_arrays(cam), tri.cpu(), *cpu[2:], P,
            clip_near=clip_near)
        assert torch.equal(got.cpu(), want)
        assert torch.equal(r.render(cam)[0].cpu().view(torch.int32),
                           r_cpu.render(cam)[0].view(torch.int32))


def test_resolution_zero_and_bucket_padding(cuda):
    """Faces of resolution 0 shade to none; a bucketed renderer's padding
    faces (resolution 0) never take a pixel; ids past the table read none
    (the plain chain cannot index them)."""
    r, cams, ids = _scene(cuda, 12, OUTSIDE, 2.0, bucket=True)
    (vertices, faces), (res, first) = _tables(r)
    assert faces.shape[0] > 12 * 12 * 12  # padded
    assert bool((res[12 * 12 * 12:] == 0).all())
    rng = np.random.default_rng(3)
    res0 = res.clone()
    res0[torch.as_tensor(rng.random(res.shape[0]) < 0.3, device=cuda)] = 0
    counts = geometry.texel_count(res0.long())
    first0 = (torch.cumsum(counts, 0) - counts).to(torch.int32)
    P0 = int(counts.sum())
    for cam, tri in zip(cams, ids):
        got = _shade(cuda, vertices, faces, _arrays(cam), tri, res0, first0,
                     P0)
        zero = (tri >= 0) & (res0[tri.clamp(min=0).long()] == 0)
        assert bool(zero.any()) and bool((got[zero] == P0).all())
        _shade(cuda, vertices, faces, _arrays(cam), tri, res, first, -1)
    past = ids[0].clone()
    past[:, ::7] = faces.shape[0] + 5
    got = render._texel_prim_image(vertices, faces, *_arrays(cams[0]), past,
                                   res, first, -1)
    masked = torch.where(past < faces.shape[0], past, -1)
    assert torch.equal(got, render._texel_prim_image_plain(
        vertices, faces, *_arrays(cams[0]), masked, res, first, -1))


def test_all_background_and_int64_strided_ids(cuda):
    """An empty frame reads none everywhere; int64 ids and a transposed
    (strided) id image give the contiguous int32 image's texels."""
    r, cams, ids = _scene(cuda, 12, OUTSIDE, 2.0)
    (vertices, faces), (res, first) = _tables(r)
    cam = _arrays(cams[1])
    empty = torch.full_like(ids[1], -1)
    got = _shade(cuda, vertices, faces, cam, empty, res, first, 77)
    assert bool((got == 77).all())
    want = _shade(cuda, vertices, faces, cam, ids[1], res, first, -1)
    _shade(cuda, vertices, faces, cam, ids[1].long(), res, first, -1)
    strided = ids[1].t().contiguous().t()
    assert strided.stride() == (1, ids[1].shape[0])
    got = _shade(cuda, vertices, faces, cam, strided, res, first, -1)
    assert torch.equal(got, want)
    # int32 faces read in place give the int64 faces' texels
    got32 = _shade(cuda, vertices, faces.to(torch.int32), cam, ids[1], res,
                   first, -1)
    assert torch.equal(got32, want)


@pytest.mark.parametrize("clip_near", [False, True])
def test_bands_and_face_blocks(cuda, clip_near):
    """What make_sharded_fuse shades: row bands of the frame with their
    y_offset, and a face block's sliced table with the -1-masked local ids
    (win - f0); each equals the whole frame's texels where it owns them."""
    where = INSIDE if clip_near else OUTSIDE
    r, cams, ids = _scene(cuda, 16, where, 2.0, clip_near, views=2)
    (vertices, faces), (res, first) = _tables(r)
    P = r.getPrimitivesNum()
    T = faces.shape[0]
    owned_pixels = 0
    for cam, tri in zip(cams, ids):
        whole = _shade(cuda, vertices, faces, _arrays(cam), tri, res, first,
                       P, clip_near=clip_near)
        for row0, rows in ((0, 48), (48, 48), (96, 96), (37, 11)):
            band = tri[row0:row0 + rows]
            got = _shade(cuda, vertices, faces, _arrays(cam), band, res,
                         first, P, y_offset=row0, clip_near=clip_near)
            assert torch.equal(got, whole[row0:row0 + rows])
        blk = T // 4
        for f0 in (0, blk, 3 * blk):
            owned = (tri >= f0) & (tri < f0 + blk)
            local = torch.where(owned, tri - f0, -1)
            got = _shade(cuda, vertices, faces[f0:f0 + blk], _arrays(cam),
                         local, res[f0:f0 + blk], first[f0:f0 + blk], P,
                         clip_near=clip_near)
            owned_pixels += int(owned.sum())
            assert torch.equal(got[owned], whole[owned])
            assert bool((got[~owned] == P).all())
    assert owned_pixels > 0


def test_adversarial_triangles(cuda):
    """Random triangles around a camera at the origin: behind it, through
    z = 0, at the near planes, huge and degenerate, each pixel given a
    random face (so u and v range far outside [0, 1], to inf and NaN),
    pinhole and ray form, resolutions 0-9."""
    rng = np.random.default_rng(11)
    T = 4000
    pts = rng.normal(size=(T, 3, 3)).astype(np.float32) * 3
    pts[:, :, 2] += rng.uniform(-2, 6, size=(T, 1)).astype(np.float32)
    pts[:100, 0, 2] = 0.0
    pts[100:200] *= 1e6
    pts[200:300, 1] = pts[200:300, 0]
    pts[300:310, :, 2] = 1e-6
    pts[310:320, :, 2] = 1e-4
    pts[320:330] = 0.0
    vertices = torch.as_tensor(pts.reshape(-1, 3), device=cuda)
    faces = torch.arange(3 * T, device=cuda).reshape(T, 3)
    res = torch.as_tensor(rng.integers(0, 10, T).astype(np.int32),
                          device=cuda)
    counts = geometry.texel_count(res.long())
    first = (torch.cumsum(counts, 0) - counts).to(torch.int32)
    cam = (np.eye(3, dtype=np.float32), np.zeros(3, np.float32),
           np.array([200.0, 200.0], np.float32),
           np.array([128.0, 96.0], np.float32))
    tri = torch.as_tensor(rng.integers(-1, T, size=(192, 256)).astype(
        np.int32), device=cuda)
    for clip_near in (False, True):
        got = _shade(cuda, vertices, faces, cam, tri, res, first, -1,
                     clip_near=clip_near)
        assert bool((got >= 0).any())
        _shade(cuda, vertices, faces, cam, tri[40:100], res, first, -1,
               y_offset=40, clip_near=clip_near)


def test_camera_on_the_device_and_on_the_host(cuda):
    """Camera arrays as numpy (float32 and float64), lists, and CUDA
    tensors (a batch's slices, the lens path's virtual focal fl * s) give
    the plain chain's bits."""
    r, cams, ids = _scene(cuda, 12, OUTSIDE, 2.0)
    (vertices, faces), (res, first) = _tables(r)
    rot, trans, fl, pp = (torch.as_tensor(a, device=cuda)
                          for a in stack_cameras(cams))
    s = torch.tensor(0.9371, device=cuda)
    for k, tri in enumerate(ids):
        on_device = (rot[k], trans[k], fl[k], pp[k])
        got = _shade(cuda, vertices, faces, on_device, tri, res, first, -1)
        host = _shade(cuda, vertices, faces, _arrays(cams[k]), tri, res,
                      first, -1)
        assert torch.equal(got, host)
        _shade(cuda, vertices, faces, (rot[k], trans[k], fl[k] * s, pp[k]),
               tri, res, first, -1)
        c = cams[k]
        _shade(cuda, vertices, faces,
               (c.rotation.astype(np.float64) + 1e-9,
                [float(x) for x in c.translation], [230.3, 231.7],
                np.array([128.1, 96.3])), tri, res, first, -1)


def test_repeated_calls_are_bit_identical_and_take_two_launches(cuda):
    """At the eval's frame: the same call twice gives the same bits, two
    kernel launches a call and no host sync (the camera by value from
    numpy arrays, as TexelsRenderer._shade passes it)."""
    r, cams, ids = _scene(cuda, 91, OUTSIDE, 0.1, views=1, frame=SCANNET)
    (vertices, faces), (res, first) = _tables(r)
    cam = _arrays(cams[0])
    render._texel_prim_image(vertices, faces, *cam, ids[0], res, first, -1)
    torch.cuda.synchronize()  # built and loaded
    launches = texel_kernel.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        a = render._texel_prim_image(vertices, faces, *cam, ids[0], res,
                                     first, -1)
        b = render._texel_prim_image(vertices, faces, *cam, ids[0], res,
                                     first, -1)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert texel_kernel.launches - launches == 4
    assert torch.equal(a, b)
    assert torch.equal(a, render._texel_prim_image_plain(
        vertices, faces, *cam, ids[0], res, first, -1))


def test_batched_texel_fuse_takes_the_kernels(cuda):
    """fuse_views_texels shades every view through the kernels (the
    cameras moved to the card once, P as the none value) and equals the
    texel renderer's render + add."""
    r, cams, _ = _scene(cuda, 12, OUTSIDE, 2.0, backend="dense")
    P = r.getPrimitivesNum()
    rot, trans, fl, pp = stack_cameras(cams)
    budget = r._dense_e_cap(192, 256, rot, trans, fl, pp)
    gen = torch.Generator(device=cuda).manual_seed(2)
    probs = torch.softmax(torch.randn((len(cams), 192, 256, 5), device=cuda,
                                      generator=gen), -1)
    texel_kernel.launches = texel_kernel.views = 0
    acc, ov = distributed.fuse_views_texels(
        r.vertices, r.faces, r.resolutions, r.first_texel_index, rot, trans,
        fl, pp, probs, 0.5, num_primitives=P, aggregator="sum", height=192,
        width=256, backend="dense", dense_e_cap=budget, device=cuda)
    assert int(ov) == 0
    assert (texel_kernel.views, texel_kernel.launches) == (len(cams),
                                                           2 * len(cams))
    agg = fusion.MeshAggregator(P, 5, "sum", 0.5, device=cuda)
    for k, cam in enumerate(cams):
        agg.add(r.render(cam)[0], probs[k].transpose(0, 1))
    assert torch.equal(agg.state, acc)
