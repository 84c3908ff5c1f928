"""Near-plane clipping at the surface of semantic_meshes_torch against the
JAX package on the CPU: renderers with a camera inside the room, texel
mode (the clipped sizing and the camera-space ray shader), lenses, and
the batched pipeline (fuse_views, fuse_views_texels, plan_fuse,
fuse_views_planned). Mirrors tests/test_clipping.py's
TestCameraInsideScene (but the sharded test, which waits for the
multi-GPU port).

Tolerances: ids and empty pixels exactly, depths at rtol 2e-5, fused
states at rtol 2e-5 and atol 1e-5 (another summation order), texel ids on
at most 1e-3 of the covered pixels, each inside the same triangle (a uv
within an ulp of a texel-grid line: XLA contracts FMAs, the port rounds
every op). The texel sizing of straddling triangles is compared with JAX
op by op: under jit XLA contracts the clamped piece areas, which moves a
few areas across zero (test_clipped_sizing_gap_is_xla_fma_contraction).
"""

import jax
import numpy as np
import pytest
import torch

import semantic_meshes
from semantic_meshes import render as jrender
from semantic_meshes import testing as jtesting
from semantic_meshes.data import stack_cameras
from semantic_meshes_torch import (convert, data, distributed, fusion,
                                   geometry, render, testing)
from semantic_meshes_torch.io.ply import write_mesh

H, W = 64, 128
DEPTH_RTOL = 2e-5
RTOL, ATOL = 2e-5, 1e-5
MISMATCH = 1e-3
BG = 0xFFFFFFFF


def _room(tmp_path, subdivisions):
    """A closed 4 m room (cube of `subdivisions`), as a PLY both packages
    load: (port Ply, JAX Ply)."""
    vertices, faces = testing.make_cube(subdivisions, size=4.0)
    path = tmp_path / f"room{subdivisions}.ply"
    write_mesh(path, vertices, faces)
    return data.Ply(str(path)), semantic_meshes.data.Ply(str(path))


def _inside(eye, target, distortion=None):
    """A camera inside the room: (port Camera, JAX Camera)."""
    rot, trans = geometry.look_at(eye, target, [0, 1, 0])
    args = (rot, trans, np.array([W, H]), np.array([50.0, 50.0]),
            np.array([W / 2, H / 2]))
    return (data.Camera(*args, distortion=distortion),
            semantic_meshes.data.Camera(*args, distortion=distortion))


CORNER = ([0.0, 0.0, 0.0], [1.0, 0.2, 0.3])


def _u32(ids):
    return ids.view(torch.int32).numpy().view(np.uint32)


def _assert_texels_match(got, want, first, faces_hit):
    """Texel images (W, H) uint32: the same covered pixels; at most
    MISMATCH of them differ, each inside the triangle both hit."""
    covered = want != BG
    np.testing.assert_array_equal(got != BG, covered)
    diff = got != want
    assert diff[covered].mean() <= MISMATCH, int(diff.sum())
    owner = np.searchsorted(first, got[diff], side="right") - 1
    np.testing.assert_array_equal(owner, faces_hit[diff])


@pytest.fixture(scope="module")
def room4(tmp_path_factory):
    """Room s=4 and the corner camera; JAX's clipped and culled renders."""
    mesh, jmesh = _room(tmp_path_factory.mktemp("room4"), 4)
    cam, jcam = _inside(*CORNER)
    clip = [np.asarray(x) for x in semantic_meshes.render.triangles(
        jmesh, clip_near=True).render(jcam)]
    return mesh, jmesh, cam, jcam, clip


@pytest.mark.parametrize("backend", ["tile", "dense"])
def test_camera_inside_cube_sees_walls(room4, backend):
    """The indoor case: inside a closed room the clipped render covers
    every pixel with a finite positive depth, where culling loses the
    walls that cross the near plane; ids equal JAX's, depths at rtol
    2e-5; render_many equals render."""
    mesh, _, cam, _, (want_ids, want_z) = room4
    r_cull = render.triangles(mesh, backend=backend, device="cpu")
    r_clip = render.triangles(mesh, clip_near=True, backend=backend,
                              device="cpu")
    idx_cull, _ = r_cull.render(cam)
    idx_clip, depth = r_clip.render(cam)
    cov_cull = (_u32(idx_cull) != BG).mean()
    cov_clip = (_u32(idx_clip) != BG).mean()
    assert cov_clip > 0.999 and cov_clip >= cov_cull
    d = depth.numpy()
    assert np.isfinite(d).all() and (d > 0).all()
    np.testing.assert_array_equal(_u32(idx_clip), want_ids)
    np.testing.assert_allclose(d, want_z, rtol=DEPTH_RTOL)
    many, many_z = r_clip.render_many([cam, cam])
    assert torch.equal(many[1], idx_clip) and torch.equal(many_z[0], depth)
    assert r_clip.overflow_total() == 0


def _jax_texels(jmesh, jcams, tpp, **kw):
    """A JAX texels renderer sized op by op (see the module note)."""
    with jax.disable_jit():
        return semantic_meshes.render.texels(jmesh, jcams, tpp, **kw)


def test_texels_camera_inside_cube(room4):
    """Texel mode with clipping from inside a closed room: the clipped
    sizing equals JAX's on every face, the ray-form shader gives near-full
    coverage with in-range ids, equal to JAX's render under the texel
    rule."""
    mesh, jmesh, cam, jcam, _ = room4
    renderer = render.texels(mesh, [cam], 1.0, clip_near=True, device="cpu")
    jr = _jax_texels(jmesh, [jcam], 1.0, clip_near=True)
    rfaces, res, first, P = convert.texel_params(jr)
    assert renderer.getPrimitivesNum() == P
    np.testing.assert_array_equal(renderer.resolutions.numpy(), res)
    np.testing.assert_array_equal(renderer.faces.numpy(), rfaces)
    idx, depth = renderer.render(cam)
    idx = _u32(idx)
    assert (idx != BG).mean() > 0.99
    assert idx[idx != BG].max() < P
    d = depth.numpy()
    assert np.isfinite(d).all() and (d > 0).all()
    want, _ = jr.render(jcam)
    tri = render.triangles(mesh, clip_near=True, device="cpu").render(cam)[0]
    _assert_texels_match(idx, np.asarray(want), first,
                         tri.view(torch.int32).numpy())


def test_clipped_sizing_gap_is_xla_fma_contraction(room4):
    """Witness for sizing against JAX op by op: the port's clipped
    resolutions equal JAX's op by op on every face; jitted JAX differs
    from its own op-by-op sizing on the same faces as from the port (a
    clamped piece area that the contraction moves across zero)."""
    mesh, jmesh, cam, jcam, _ = room4
    v = torch.as_tensor(mesh.vertices)
    f = torch.as_tensor(mesh.faces.astype(np.int64))
    got = render._texel_resolutions(v, f, [cam], 1.0, clip_near=True).numpy()
    with jax.disable_jit():
        op = np.asarray(jrender._texel_resolutions(
            jmesh.vertices, jmesh.faces, [jcam], 1.0, clip_near=True))
    jit = np.asarray(jrender._texel_resolutions(
        jmesh.vertices, jmesh.faces, [jcam], 1.0, clip_near=True))
    np.testing.assert_array_equal(got, op)
    np.testing.assert_array_equal(got != jit, op != jit)
    assert (got != jit).sum() <= 4
    # the clipped rule sizes faces the culling rule leaves without texels
    cull = render._texel_resolutions(v, f, [cam], 1.0).numpy()
    assert (got > 0).sum() > (cull > 0).sum()


def test_ray_form_shader_matches_jax_on_identical_tables(room4):
    """The camera-space ray shader against JAX's on the same triangle ids
    and tables, under the texel rule."""
    mesh, jmesh, cam, jcam, _ = room4
    jr = _jax_texels(jmesh, [jcam], 3.0, clip_near=True)
    rfaces, res, first, P = convert.texel_params(jr)
    args = (cam.rotation, cam.translation, cam.focal_lengths,
            cam.principal_point)
    tri = semantic_meshes.rasterize.rasterize(
        jmesh.vertices, rfaces, *args, height=H, width=W, clip_near=True,
        backend="xla")[0]
    tri = np.asarray(tri)
    want = np.asarray(jrender._texel_prim_image(
        jmesh.vertices, rfaces, *args, tri, res, first, P, clip_near=True))
    got = render._texel_prim_image(
        torch.as_tensor(mesh.vertices), torch.as_tensor(rfaces), *args,
        torch.as_tensor(tri), torch.as_tensor(res), torch.as_tensor(first),
        P, clip_near=True).numpy()
    assert (res[tri] > 1).mean() > 0.5 and (tri >= 0).all()
    to_u32 = np.where(want < P, want, -1).astype(np.int32).view(np.uint32)
    _assert_texels_match(np.where(got < P, got, -1).astype(np.int32).view(
        np.uint32).T, to_u32.T, first, tri.T)


@pytest.fixture(scope="module")
def cube3(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cube3")
    vertices, faces = testing.make_cube(3)
    write_mesh(tmp / "c.ply", vertices, faces)
    cams = testing.make_ring_cameras(num_views=2, width=W, height=H)
    jcams = jtesting.make_ring_cameras(num_views=2, width=W, height=H)
    return (data.Ply(str(tmp / "c.ply")),
            semantic_meshes.data.Ply(str(tmp / "c.ply")), cams, jcams)


def test_texels_clip_matches_noclip_when_in_front(cube3):
    """On a scene in front of the cameras the ray form and the projected
    form give the same uv: the same sizing and background, the same texel
    on nearly every pixel; the clipped sizing equals JAX's."""
    mesh, jmesh, cams, jcams = cube3
    r0 = render.texels(mesh, cams, 1.5, device="cpu")
    r1 = render.texels(mesh, cams, 1.5, clip_near=True, device="cpu")
    assert r0.getPrimitivesNum() == r1.getPrimitivesNum()
    assert torch.equal(r0.resolutions, r1.resolutions)
    jr = semantic_meshes.render.texels(jmesh, jcams, 1.5, clip_near=True)
    np.testing.assert_array_equal(r1.resolutions.numpy(),
                                  np.asarray(jr.resolutions))
    for cam in cams:
        i0, i1 = _u32(r0.render(cam)[0]), _u32(r1.render(cam)[0])
        np.testing.assert_array_equal(i0 == BG, i1 == BG)
        assert (i0 == i1).mean() > 0.99


def _probs(views, classes, seed):
    rng = np.random.default_rng(seed)
    return np.stack([jtesting.random_probs(rng, H, W, classes)
                     for _ in range(views)])


@pytest.fixture(scope="module")
def room3(tmp_path_factory):
    """Room s=3 and two cameras inside it, one grazing the floor."""
    mesh, jmesh = _room(tmp_path_factory.mktemp("room3"), 3)
    pairs = [_inside([0.0, 0.0, 0.0], [1.0, 0.0, 0.2]),
             _inside([0.3, -1.9, -1.0], [0.5, -1.95, 2.0])]
    return mesh, jmesh, [p[0] for p in pairs], [p[1] for p in pairs]


def _jax_per_view(jrenderer, jcams, probs):
    agg = semantic_meshes.fusion.MeshAggregator(
        jrenderer.getPrimitivesNum(), probs.shape[-1], aggregator="sum")
    for k, jcam in enumerate(jcams):
        agg.add(jrenderer.render(jcam)[0], probs[k].transpose(1, 0, 2))
    return np.asarray(agg.state)


def _port_per_view(renderer, cams, probs):
    agg = fusion.MeshAggregator(renderer.getPrimitivesNum(),
                                probs.shape[-1], "sum", 0.5, device="cpu")
    for k, cam in enumerate(cams):
        agg.add(renderer.render(cam)[0], probs[k].transpose(1, 0, 2))
    return agg.state


@pytest.mark.parametrize("backend", ["tile", "dense"])
def test_fuse_views_clip_matches_sequential(room3, backend):
    """fuse_views(clip_near=True) on straddling views equals the port's
    per-view renderer + MeshAggregator loop, and JAX's; so do plan_fuse +
    fuse_views_planned (no split under clipping)."""
    mesh, jmesh, cams, jcams = room3
    renderer = render.triangles(mesh, clip_near=True, backend=backend,
                                device="cpu")
    P = renderer.getPrimitivesNum()
    probs = _probs(len(cams), 4, 3)
    per_view = _port_per_view(renderer, cams, probs)
    kw = dict(num_primitives=P, aggregator="sum", height=H, width=W,
              clip_near=True, device="cpu")
    rot, trans, fl, pp = stack_cameras(cams)
    acc, ov = distributed.fuse_views(renderer.vertices, renderer.faces, rot,
                                     trans, fl, pp, probs, 0.5,
                                     backend=backend, **kw)
    assert int(ov) == 0
    np.testing.assert_allclose(acc.numpy(), per_view.numpy(), rtol=1e-6,
                               atol=0)
    plan = distributed.plan_fuse(renderer.vertices, renderer.faces, rot,
                                 trans, fl, pp, height=H, width=W,
                                 backend=backend, clip_near=True,
                                 device="cpu")
    assert plan.remap is None
    assert (plan.dense_e_cap is None) == (backend == "tile")
    assert plan.dense_e_cap is None or plan.dense_e_cap.split_k == 0
    planned, ov = distributed.fuse_views_planned(
        plan, renderer.vertices, rot, trans, fl, pp, probs, 0.5,
        backend=backend, **kw)
    assert int(ov) == 0 and torch.equal(planned, acc)
    want = _jax_per_view(semantic_meshes.render.triangles(
        jmesh, clip_near=True), jcams, probs)
    np.testing.assert_allclose(acc.numpy(), want, rtol=RTOL, atol=ATOL)


def test_fuse_views_texels_clip_matches_sequential(room3):
    """fuse_views_texels(clip_near=True) equals the per-view texel renderer
    loop (tile and forced dense) and JAX's per-view loop on the same
    tables."""
    mesh, jmesh, cams, jcams = room3
    jr = _jax_texels(jmesh, jcams, 1.0, clip_near=True)
    renderer = render.texels(mesh, cams, 1.0, clip_near=True, device="cpu")
    P = renderer.getPrimitivesNum()
    assert P == jr.getPrimitivesNum()
    probs = _probs(len(cams), 3, 4)
    per_view = _port_per_view(renderer, cams, probs)
    for backend in (None, "dense"):
        acc, ov = distributed.fuse_views_texels(
            renderer.vertices, renderer.faces, renderer.resolutions,
            renderer.first_texel_index, *stack_cameras(cams), probs, 0.5,
            num_primitives=P, aggregator="sum", height=H, width=W,
            clip_near=True, backend=backend, device="cpu")
        assert int(ov) == 0
        np.testing.assert_allclose(acc.numpy(), per_view.numpy(), rtol=1e-6,
                                   atol=0)
    want = _jax_per_view(jr, jcams, probs)
    np.testing.assert_allclose(acc.numpy(), want, rtol=RTOL, atol=ATOL)


def test_clipped_render_under_a_lens_matches_jax(room3):
    """A lens inside the room: the clipped render rasterizes under the
    virtual focal and resamples (ids equal JAX's), and the texel ray
    shader takes that focal too (texel rule); render_many equals render,
    and fuse_views(distortions=) equals the per-view loop."""
    mesh, jmesh, _, _ = room3
    # a mild lens: at this focal (50 px) the frame's corners reach r 1.43,
    # and a stronger one puts them near its fold, where jitted JAX's
    # Newton and JAX op by op already differ in the last bits
    lens = [0.02, 0.0, 0.0, 0.0]
    cam, jcam = _inside([0.0, 0.0, 0.0], [1.0, 0.0, 0.2], lens)
    r = render.triangles(mesh, clip_near=True, device="cpu")
    ids, _ = r.render(cam)
    want, _ = semantic_meshes.render.triangles(jmesh, clip_near=True).render(
        jcam)
    np.testing.assert_array_equal(_u32(ids), np.asarray(want))
    assert (_u32(ids) != BG).mean() > 0.99
    assert torch.equal(r.render_many([cam])[0][0], ids)
    jr = _jax_texels(jmesh, [jcam], 1.0, clip_near=True)
    tr = render.texels(mesh, [cam], 1.0, clip_near=True, device="cpu")
    np.testing.assert_array_equal(tr.resolutions.numpy(),
                                  np.asarray(jr.resolutions))
    tids, _ = tr.render(cam)
    _assert_texels_match(_u32(tids), np.asarray(jr.render(jcam)[0]),
                         np.asarray(jr.first_texel_index),
                         ids.view(torch.int32).numpy())
    probs = _probs(1, 3, 5)
    acc, ov = distributed.fuse_views_texels(
        tr.vertices, tr.faces, tr.resolutions, tr.first_texel_index,
        *stack_cameras([cam]), probs, 0.5,
        distortions=data.stack_distortions([cam]),
        num_primitives=tr.getPrimitivesNum(), aggregator="sum", height=H,
        width=W, clip_near=True, device="cpu")
    assert int(ov) == 0
    np.testing.assert_allclose(acc.numpy(),
                               _port_per_view(tr, [cam], probs).numpy(),
                               rtol=1e-6, atol=0)
