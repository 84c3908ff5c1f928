"""Texel mode of semantic_meshes_torch against the JAX package, on the CPU:
the texel geometry, the face reorder, the resolution sizing, the texel
shader and TexelsRenderer (tile and dense backends). Inputs are made with
numpy from fixed seeds and fed to both sides.

Texel ids may differ where a pixel's uv lies within an ulp of a texel-grid
line: the JAX package projects through a matmul and XLA contracts a*b + c
into FMAs on the CPU, while the port rounds every op. So a shader
comparison allows 1e-3 of the covered pixels to differ, each inside the
same triangle, and none where r = 1 (one texel per triangle). Depths
compare at rtol 2e-5 (test_torch_rasterize.py)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import semantic_meshes
from semantic_meshes import geometry as jgeo
from semantic_meshes import render as jrender
from semantic_meshes.rasterize import xla as jxla
from semantic_meshes_torch import convert, data, geometry, render, testing
from semantic_meshes_torch import rasterize as rast
from semantic_meshes_torch.io.ply import write_mesh

DEPTH_RTOL = 2e-5
MISMATCH = 1e-3  # share of covered pixels whose texel id may differ
SIZE, TPP = 400, 0.05  # the one-triangle scenes of tests/test_texels.py


def _t(x):
    return torch.from_numpy(np.array(x))


def _mesh(tmp_path, vertices, faces, name="m.ply"):
    write_mesh(tmp_path / name, vertices, faces, binary=False)
    return str(tmp_path / name)


@pytest.fixture(scope="module")
def cube_cams():
    return testing.make_ring_cameras(num_views=3, width=128, height=96)


@pytest.fixture(scope="module")
def camera():
    """tests/test_texels.py's 400x400 camera looking at the z=0 plane."""
    rotation, translation = geometry.look_at(
        [-0.5, -0.5, 4.0], [-0.5, -0.5, 0.0], [0.0, 1.0, 0.0])
    pp = np.asarray([SIZE, SIZE], np.float32) / 2.0
    fl = pp / math.tan(math.radians(45.0) / 2.0)
    return data.Camera(rotation, translation, (SIZE, SIZE), fl, pp)


# ----------------------------------------------------------------- geometry


@pytest.mark.parametrize("seed", [0, 1])
def test_triangle_helpers_match_jax(seed):
    rng = np.random.default_rng(seed)
    a, b, c, p = (rng.normal(size=(64, 2)).astype(np.float32) * 50
                  for _ in range(4))
    tri = np.stack([a, b, c], axis=1)
    for got, want in (
        (geometry.signed_area2(_t(a), _t(b), _t(c)),
         jgeo.signed_area2(a, b, c)),
        (geometry.triangle_screen_area(_t(tri)),
         jgeo.triangle_screen_area(tri)),
        (geometry.barycentric_2d(_t(p), _t(a), _t(b), _t(c)),
         jgeo.barycentric_2d(p, a, b, c)),
    ):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
    bary = rng.uniform(0.0, 1.0, size=(64, 3)).astype(np.float32)
    z = rng.uniform(1.0, 5.0, size=(64, 3)).astype(np.float32)
    b3, depth = geometry.perspective_correct(_t(bary), _t(z))
    jb3, jdepth = jgeo.perspective_correct(bary, z)
    np.testing.assert_allclose(b3.numpy(), np.asarray(jb3), rtol=1e-6)
    np.testing.assert_allclose(depth.numpy(), np.asarray(jdepth), rtol=1e-6)


def _uv_cases(rng, r_max=8, n=4000):
    """Random uv and uv exactly on the grid lines u = k/r (+ eps) of each
    resolution, and a few outside [0, 1] and non-finite."""
    r = rng.integers(1, r_max + 1, size=n).astype(np.int32)
    u = rng.uniform(-0.1, 1.1, size=n).astype(np.float32)
    v = rng.uniform(-0.1, 1.1, size=n).astype(np.float32)
    k = rng.integers(0, r + 1)
    on_line = (k / r + 1e-6).astype(np.float32)
    u[: n // 4] = on_line[: n // 4]
    v[n // 4: n // 2] = on_line[n // 4: n // 2]
    u[-4:] = [np.nan, np.inf, -np.inf, 3e9]
    return u, v, r


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_texel_index_matches_jax_on_random_uv_and_cell_boundaries(seed):
    u, v, r = _uv_cases(np.random.default_rng(seed))
    got = geometry.texel_index_uv(_t(u), _t(v), _t(r)).numpy()
    want = np.asarray(jgeo.texel_index_uv(u, v, r))
    np.testing.assert_array_equal(got, want)
    assert np.all((got >= 0) & (got < r * (r + 1) // 2))
    bary = np.stack([1 - u - v, u, v], axis=-1)
    np.testing.assert_array_equal(
        geometry.texel_index(_t(bary), _t(r)).numpy(),
        np.asarray(jgeo.texel_index(bary, r)))
    np.testing.assert_array_equal(geometry.texel_count(_t(r)).numpy(),
                                  np.asarray(jgeo.texel_count(r)))


def _random_mesh(seed, degenerate):
    rng = np.random.default_rng(seed)
    vertices = rng.normal(size=(40, 3)).astype(np.float32)
    faces = np.stack([rng.choice(40, 3, replace=False)
                      for _ in range(200)]).astype(np.int32)
    if degenerate:
        vertices[faces[0, 1]] = vertices[faces[0, 0]]  # a zero-length edge
        faces[1] = [faces[1, 0], faces[1, 0], faces[1, 2]]
    return vertices, faces


@pytest.mark.parametrize("case", ["cube3", "cube9", "random", "degenerate"])
def test_reorder_faces_matches_jax_on_every_face(case):
    if case.startswith("cube"):
        vertices, faces = testing.make_cube(subdivisions=int(case[4:]))
    else:
        vertices, faces = _random_mesh(7, case == "degenerate")
    got = geometry.reorder_faces_for_texels(
        _t(vertices), _t(faces.astype(np.int64))).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jgeo.reorder_faces_for_texels(vertices, faces)))
    with jax.disable_jit():
        op_by_op = np.asarray(jgeo.reorder_faces_for_texels(vertices, faces))
    np.testing.assert_array_equal(got, op_by_op)
    # a permutation of each face's vertices
    np.testing.assert_array_equal(np.sort(got, 1), np.sort(faces, 1))


# ------------------------------------------------------------------- sizing


@pytest.mark.parametrize("tpp", [0.1, 1.5])
def test_texel_resolutions_match_jax_on_the_cube(cube_cams, tpp):
    vertices, faces = testing.make_cube(subdivisions=3)
    got = render._texel_resolutions(_t(vertices), _t(faces.astype(np.int64)),
                                    cube_cams, tpp).numpy()
    want = np.asarray(jrender._texel_resolutions(
        jnp.asarray(vertices), jnp.asarray(faces), cube_cams, tpp))
    np.testing.assert_array_equal(got, want)
    assert got.min() >= 1 and got.max() == (12 if tpp > 1 else 1)


def test_unseen_triangle_gets_zero_texels(tmp_path, camera):
    vertices = np.array([(0.4, 0, 0), (0.5, 1, 0), (0.6, 0, 0),
                         (0.4, 0, 100), (0.5, 1, 100), (0.6, 0, 100)],
                        np.float32)
    faces = np.asarray([[0, 1, 2], [3, 4, 5]], np.int32)
    path = _mesh(tmp_path, vertices, faces)
    r = render.texels(data.Ply(path), [camera], TPP, device="cpu")
    jr = semantic_meshes.render.texels(semantic_meshes.data.Ply(path),
                                       [camera], TPP)
    res = r.resolutions.numpy()
    np.testing.assert_array_equal(res, np.asarray(jr.resolutions))
    assert res[1] == 0 and res[0] >= 1
    assert r.getPrimitivesNum() == res[0] * (res[0] + 1) // 2
    assert int(r.first_texel_index[1]) == r.getPrimitivesNum()


def test_larger_on_screen_triangles_get_more_texels(tmp_path, camera):
    vertices = np.array([(0.4, 0, 0), (0.5, 1, 0), (0.6, 0, 0),
                         (-1.4, 0, 0), (-1.39, 0.1, 0), (-1.38, 0, 0)],
                        np.float32)
    path = _mesh(tmp_path, vertices, np.asarray([[0, 1, 2], [3, 4, 5]]))
    res = render.texels(data.Ply(path), [camera], TPP,
                        device="cpu").resolutions.numpy()
    assert res[0] > res[1] >= 1


# ------------------------------------------------------------------- shader


def _id_rule(got, want, tri, first, res, num_primitives):
    """Texel ids under this file's rule: the same background, at most
    MISMATCH of the covered pixels differ, each inside the same triangle,
    none on a triangle of r = 1."""
    covered = want < num_primitives
    np.testing.assert_array_equal(got < num_primitives, covered)
    diff = got != want
    assert diff[covered].mean() <= MISMATCH, int(diff.sum())
    owner = np.searchsorted(first, got[diff], side="right") - 1
    np.testing.assert_array_equal(owner, tri[diff])
    assert not np.any(diff & (res[np.maximum(tri, 0)] == 1))
    return int(diff.sum())


@pytest.mark.parametrize("tpp", [0.1, 1.5, 4.0])
def test_shader_matches_jax_on_identical_tables(tmp_path, cube_cams, tpp):
    vertices, faces = testing.make_cube(subdivisions=3)
    jr = semantic_meshes.render.texels(
        semantic_meshes.data.Ply(_mesh(tmp_path, vertices, faces)),
        cube_cams, tpp)
    rfaces, res, first, P = convert.texel_params(jr)
    for cam in cube_cams:
        args = (cam.rotation, cam.translation, cam.focal_lengths,
                cam.principal_point)
        tri, _, _ = jxla.rasterize(vertices, rfaces, *args, height=96,
                                   width=128)
        tri = np.asarray(tri)
        want = np.asarray(jrender._texel_prim_image(
            vertices, rfaces, *args, tri, res, first, P))
        got = render._texel_prim_image(vertices, rfaces, *args, _t(tri),
                                       res, first, P).numpy()
        assert got.dtype == np.int32
        _id_rule(got, want, tri, first, res, P)
        assert np.all(got[tri < 0] == P)


def test_shader_matches_the_barycentric_oracle(camera):
    """The affine shader (one table row per pixel) against the direct
    barycentric formulation (rasterize.barycentrics_at_pixels), as
    tests/test_texels.py checks the JAX package's."""
    rng = np.random.default_rng(4)
    vertices = rng.normal(size=(30, 3)).astype(np.float32) * 0.4
    faces = np.stack([rng.choice(30, 3, replace=False)
                      for _ in range(20)]).astype(np.int64)
    args = (camera.rotation, camera.translation, camera.focal_lengths,
            camera.principal_point)
    tri, _, _ = rast.rasterize(_t(vertices), _t(faces), *args, height=SIZE,
                               width=SIZE, device="cpu")
    resolutions = rng.integers(1, 5, len(faces)).astype(np.int32)
    counts = resolutions * (resolutions + 1) // 2
    first = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int32)
    P = int(counts.sum())
    got = render._texel_prim_image(vertices, faces, *args, tri, resolutions,
                                   first, P).numpy()
    bary = rast.barycentrics_at_pixels(vertices, faces, *args, tri)
    tri = tri.numpy()
    covered = tri >= 0
    rel = geometry.texel_index(
        bary, _t(np.maximum(resolutions[np.maximum(tri, 0)], 1))).numpy()
    want = np.where(covered, first[np.maximum(tri, 0)] + rel, P)
    diff = got != want
    assert covered.mean() > 0.05
    assert diff[covered].mean() < 0.002, int(diff[covered].sum())
    assert not np.any(diff[~covered])
    # the oracle itself matches the JAX package's
    jbary = np.asarray(jxla.barycentrics_at_pixels(
        vertices, faces.astype(np.int32), *args, tri))
    np.testing.assert_allclose(bary.numpy()[covered], jbary[covered],
                               rtol=1e-4, atol=1e-4)


VERTEX = np.array([(0.4, 0, 0), (0.5, 1, 0), (0.6, 0, 0)], np.float32)
ORDERS = [[0, 1, 2], [0, 2, 1], [1, 0, 2], [1, 2, 0], [2, 0, 1], [2, 1, 0]]


def _render_order(tmp_path, camera, order):
    path = _mesh(tmp_path, VERTEX, np.asarray([order]),
                 f"mesh-{'-'.join(map(str, order))}.ply")
    renderer = render.texels(data.Ply(path), [camera], TPP, device="cpu")
    idx, depth = renderer.render(camera)
    idx = idx.view(torch.int32).numpy().T.astype(np.int64)
    return renderer, idx, depth.numpy().T


def test_six_vertex_orders_render_the_same_texel_grid(tmp_path, camera):
    """The debug harness of the reference (debug_render_texels.py), as
    tests/test_texels.py runs it: every vertex order of one triangle gives
    the same count s(s+1)/2, the same coverage and depth, every texel hit,
    and each texel a compact region."""
    results = [_render_order(tmp_path, camera, o) for o in ORDERS]
    counts = {r.getPrimitivesNum() for r, _, _ in results}
    assert len(counts) == 1
    count = counts.pop()
    s = int(-0.5 + math.sqrt(0.25 + 2 * count))
    assert s * (s + 1) // 2 == count and s > 1
    cover0 = results[0][1] >= 0
    for _, idx, depth in results:
        cover = idx >= 0
        np.testing.assert_array_equal(cover, cover0)
        assert idx[cover].min() >= 0 and idx[cover].max() < count
        assert len(np.unique(idx[cover])) == count
        np.testing.assert_allclose(depth[cover], results[0][2][cover],
                                   rtol=1e-5)
    idx = results[0][1]
    ys, xs = np.nonzero(cover0)
    ids = idx[cover0]
    extent = max(np.ptp(ys), np.ptp(xs))
    spreads = [max(np.ptp(ys[ids == t]), np.ptp(xs[ids == t]))
               for t in range(count) if (ids == t).sum() >= 2]
    assert np.mean(spreads) < 3 * extent / s


# ----------------------------------------------------------------- renderer


@pytest.mark.parametrize("backend", ["tile", "dense"])
def test_texels_renderer_matches_jax(tmp_path, cube_cams, backend):
    vertices, faces = testing.make_cube(subdivisions=3)
    path = _mesh(tmp_path, vertices, faces)
    renderer = render.texels(data.Ply(path), cube_cams, 1.5,
                             backend=backend, device="cpu")
    jr = semantic_meshes.render.texels(
        semantic_meshes.data.Ply(path), cube_cams, 1.5,
        backend="xla" if backend == "tile" else "dense")
    P = renderer.getPrimitivesNum()
    rfaces, res, first, jP = convert.texel_params(jr)
    assert P == jP
    np.testing.assert_array_equal(renderer.first_texel_index.numpy(), first)
    np.testing.assert_array_equal(renderer.resolutions.numpy(), res)
    np.testing.assert_array_equal(renderer.faces.numpy(), rfaces)

    many, many_depth = renderer.render_many(cube_cams)
    assert many.dtype == torch.uint32 and tuple(many.shape) == (3, 128, 96)
    for k, cam in enumerate(cube_cams):
        ids, depth = renderer.render(cam)
        assert torch.equal(many[k].view(torch.int32), ids.view(torch.int32))
        assert torch.equal(many_depth[k], depth)
        # the dense path op by op (.claude/skills/verify/SKILL.md)
        with jax.disable_jit(backend == "dense"):
            jids, jdepth = jr.render(cam)
        got = ids.view(torch.int32).numpy().T.astype(np.int64)
        want = np.asarray(jids).T.astype(np.int64)
        got[got < 0] = P
        want[want == 0xFFFFFFFF] = P
        tri, _, _ = rast.rasterize(_t(vertices), renderer.faces,
                                   *render._camera_arrays(cam), height=96,
                                   width=128, backend=backend, device="cpu")
        _id_rule(got, want, tri.numpy(), first, res, P)
        jd = np.asarray(jdepth)
        fin = np.isfinite(jd)
        np.testing.assert_array_equal(np.isfinite(depth.numpy()), fin)
        np.testing.assert_allclose(depth.numpy()[fin], jd[fin],
                                   rtol=DEPTH_RTOL)
    renderer.prepare(cube_cams)
    assert renderer.overflow_total() == 0


def test_texels_renderer_takes_a_colmap_workspace(tmp_path, cube_cams,
                                                  monkeypatch):
    vertices, faces = testing.make_cube(subdivisions=3)
    mesh = data.Ply(_mesh(tmp_path, vertices, faces))
    ws = object.__new__(data.Colmap)
    monkeypatch.setattr(ws, "getCameras", lambda: list(cube_cams),
                        raising=False)
    a = render.texels(mesh, ws, 1.5, device="cpu")
    b = render.PlyRendererTexels(mesh, cube_cams, 1.5, device="cpu")
    assert a.getPrimitivesNum() == b.getPrimitivesNum() > len(faces)
    assert torch.equal(a.first_texel_index, b.first_texel_index)
    with pytest.raises(ValueError, match="at least one camera"):
        render.texels(mesh, [], device="cpu")


def test_unported_texel_features_raise(tmp_path, cube_cams):
    """Near-plane clipping (ported) sizes and shades as JAX's clipped
    texel renderer; a lens (ported) renders, batched or not, the JAX
    package's distorted texel ids under this file's rule."""
    vertices, faces = testing.make_cube(subdivisions=3)
    path = _mesh(tmp_path, vertices, faces)
    mesh = data.Ply(path)
    clipped = render.texels(mesh, cube_cams, 1.5, clip_near=True,
                            device="cpu")
    jclipped = semantic_meshes.render.texels(
        semantic_meshes.data.Ply(path), cube_cams, 1.5, clip_near=True)
    _, res, first, P = convert.texel_params(jclipped)
    np.testing.assert_array_equal(clipped.resolutions.numpy(), res)
    assert clipped.getPrimitivesNum() == P
    for cam in cube_cams:
        got = clipped.render(cam)[0].view(torch.int32).numpy().T.astype(
            np.int64)
        want = np.asarray(jclipped.render(cam)[0]).T.astype(np.int64)
        got[got < 0] = P
        want[want == 0xFFFFFFFF] = P
        tri = render.triangles(mesh, device="cpu").render(cam)[0]
        _id_rule(got, want, tri.view(torch.int32).numpy().T, first, res, P)
    renderer = render.texels(mesh, cube_cams, 1.5, bucket=True,
                             device="cpu")
    cam = cube_cams[0]
    lens = data.Camera(cam.rotation, cam.translation, cam.resolution,
                       cam.focal_lengths, cam.principal_point,
                       distortion=[0.01, 0, 0, 0])
    renderer.prepare([cam, lens])  # a no-op for the tile rasterizer
    ids, _ = renderer.render(lens)
    many, _ = renderer.render_many([lens])
    assert torch.equal(many[0].view(torch.int32), ids.view(torch.int32))
    jr = semantic_meshes.render.texels(semantic_meshes.data.Ply(path),
                                       cube_cams, 1.5)
    jids, _ = jr.render(convert_lens(lens))
    P = renderer.getPrimitivesNum()
    got = ids.view(torch.int32).numpy().T.astype(np.int64)
    want = np.asarray(jids).T.astype(np.int64)
    got[got < 0] = P
    want[want == 0xFFFFFFFF] = P
    # the triangle under each pixel: the same resample of the triangle ids
    owner, _ = render.triangles(mesh, device="cpu").render(lens)
    _, res, first, _ = convert.texel_params(jr)
    _id_rule(got, want, owner.view(torch.int32).numpy().T, first, res, P)


def convert_lens(cam):
    """The JAX package's camera of a port camera with a lens."""
    return semantic_meshes.data.Camera(
        cam.rotation, cam.translation, cam.resolution, cam.focal_lengths,
        cam.principal_point, distortion=cam.distortion)
