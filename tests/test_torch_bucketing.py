"""Face, vertex and camera-count bucketing in semantic_meshes_torch against
the JAX package, on the CPU.

Mirrors tests/test_bucketing.py case by case on its scene (the 108-face
cube, two ring views of 128x96): the bucket function, padding that
leaves every render output bit-identical to the unpadded mesh (triangles,
clip_near, texels, render_many), SM_FACE_BUCKETS, and camera-count
padding that leaves the texel resolutions unchanged. Each case also holds
the port's bucketed renderer to the JAX package's (ids exact, depths at
rtol 2e-5: jitted XLA contracts a*b + c into FMAs on the CPU; texel ids
may differ on MISMATCH of the covered pixels, as in test_torch_texels.py).
test_bucketing.py's jit-cache test (one compiled sizing program across
camera counts) has no counterpart: the port compiles nothing; its place
is taken by a check that the padded sizing equals the unpadded one at
those camera counts.

Bucketing changes the route: a renderer rasterizes with the backend its
padded face count picks. The routing witness renders a 14700-face cube,
which pads to DENSE_THRESHOLD = 16384 rows: bucketed, the port goes dense
and equals the JAX package's bucketed dense render bit for bit (JAX op by
op); unbucketed it goes to the tile rasterizer, whose 256-candidate cap
drops pairs. The routing knobs (the JAX backend names, SM_RASTERIZER,
SM_DENSE_THRESHOLD) and the eval CLI's default and --no_face_buckets are
checked here too.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import semantic_meshes
import semantic_meshes.rasterize as jrast
from semantic_meshes import render as jrender
from semantic_meshes import testing as jtesting
from semantic_meshes_torch import data, eval_scannet, render, testing
from semantic_meshes_torch import rasterize as rast
from semantic_meshes_torch.io.ply import write_mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEPTH_RTOL = 2e-5
MISMATCH = 1e-3  # share of covered pixels whose texel id may differ
WITNESS_SUB = 35  # cube s=35: 14700 faces, which pad to 16384


def _ids(x):
    """(W, H) ids of either package as int64 numpy with -1 background."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int32).numpy().astype(np.int64)
    return np.asarray(x).astype(np.uint32).view(np.int32).astype(np.int64)


def _same_render(a, b):
    """Two port renders (ids, depth) bit for bit."""
    assert torch.equal(a[0].view(torch.int32), b[0].view(torch.int32))
    assert torch.equal(a[1].view(torch.int32), b[1].view(torch.int32))


def _like_jax(got, want):
    """A port render against a jitted JAX render on the tile route: ids
    exact, depths at DEPTH_RTOL with the same background."""
    np.testing.assert_array_equal(_ids(got[0]), _ids(want[0]))
    d, jd = got[1].numpy(), np.asarray(want[1])
    fin = np.isfinite(jd)
    np.testing.assert_array_equal(np.isfinite(d), fin)
    np.testing.assert_allclose(d[fin], jd[fin], rtol=DEPTH_RTOL)


def _texels_like_jax(got, want, P):
    """Texel ids against the JAX package's: the same background, at most
    MISMATCH of the covered pixels differ."""
    g, w = _ids(got), _ids(want)
    covered = w >= 0
    np.testing.assert_array_equal(g >= 0, covered)
    assert (g[covered] < P).all()
    assert (g != w)[covered].mean() <= MISMATCH


# ------------------------------------------------------------ bucket function


class TestBucketFn:
    def test_monotone_and_bounded(self):
        prev = 0
        for t in [1, 7, 1024, 1025, 2100, 5000, 49152, 100000, 2_000_000]:
            b = render._face_bucket(t)
            assert b == jrender._face_bucket(t)
            assert b >= t
            assert b >= prev
            prev = b
            if t > 1024:
                assert b <= t * 1.26, (t, b)

    def test_small_counts_share_one_bucket(self):
        assert render._face_bucket(1) == render._face_bucket(1024) == 1024
        for c in (1, 2, 9, 16, 17, 100):
            assert render._size_bucket(c, 16) == jrender._size_bucket(c, 16)

    def test_nearby_scene_sizes_collapse(self):
        assert render._face_bucket(43000) == render._face_bucket(45000)

    def test_pad_faces_degenerate(self):
        import jax.numpy as jnp

        faces = torch.tensor([[0, 1, 2]], dtype=torch.int64)
        verts = torch.zeros((3, 3))
        padded, real = render._pad_faces(faces, verts)
        want, jreal = jrender._pad_faces(jnp.asarray([[0, 1, 2]], jnp.int32),
                                         jnp.zeros((3, 3), jnp.float32))
        assert real == jreal == 1
        assert padded.shape[0] == 1024 and padded.dtype == torch.int64
        assert bool((padded[1:] == 0).all())
        np.testing.assert_array_equal(padded.numpy(), np.asarray(want))

    def test_pad_vertices_and_empty_meshes(self):
        import jax.numpy as jnp

        verts = torch.ones((1500, 3))
        padded = render._pad_vertices(verts)
        want = jrender._pad_vertices(jnp.ones((1500, 3), jnp.float32))
        np.testing.assert_array_equal(padded.numpy(), np.asarray(want))
        assert padded.shape[0] == 1536 and bool((padded[1500:] == 0).all())
        empty = torch.zeros((0, 3))
        assert render._pad_vertices(empty) is empty
        faces = torch.zeros((0, 3), dtype=torch.int64)
        assert render._pad_faces(faces, empty) == (faces, 0)


# --------------------------------------------------------------------- scene


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """test_bucketing.py's scene: cube s=3 (108 faces), two ring views of
    128x96; the port's mesh and the JAX package's, from one file."""
    tmp = tmp_path_factory.mktemp("bucket")
    vertices, faces = testing.make_cube(subdivisions=3)
    write_mesh(tmp / "cube.ply", vertices, faces)
    mesh = data.Ply(str(tmp / "cube.ply"))
    jmesh = semantic_meshes.data.Ply(str(tmp / "cube.ply"))
    cams = testing.make_ring_cameras(num_views=2, width=128, height=96)
    jcams = jtesting.make_ring_cameras(num_views=2, width=128, height=96)
    return mesh, jmesh, cams, jcams


class TestBucketedRenderParity:
    def test_triangles_bit_identical(self, scene):
        mesh, jmesh, cams, jcams = scene
        r0 = render.triangles(mesh, bucket=False, device="cpu")
        r1 = render.triangles(mesh, bucket=True, device="cpu")
        jr = jrender.triangles(jmesh, bucket=True)
        assert r1.getPrimitivesNum() == r0.getPrimitivesNum() == 108
        assert r1.faces.shape[0] == jr.faces.shape[0] == 1024
        assert r1.vertices.shape[0] == jr.vertices.shape[0] == 1024
        np.testing.assert_array_equal(r1.faces.numpy(), np.asarray(jr.faces))
        for cam, jcam in zip(cams, jcams):
            got = r1.render(cam)
            _same_render(r0.render(cam), got)
            _like_jax(got, jr.render(jcam))
        assert r1.overflow_total() == 0

    def test_triangles_clip_near_bit_identical(self, scene):
        mesh, jmesh, cams, jcams = scene
        r0 = render.triangles(mesh, clip_near=True, bucket=False,
                              device="cpu")
        r1 = render.triangles(mesh, clip_near=True, bucket=True, device="cpu")
        got = r1.render(cams[0])
        _same_render(r0.render(cams[0]), got)
        jr = jrender.triangles(jmesh, clip_near=True, bucket=True)
        _like_jax(got, jr.render(jcams[0]))

    @pytest.mark.parametrize("backend", ["tile", "dense"])
    def test_clip_near_with_vertex_0_behind_the_camera(self, scene, backend):
        """A camera inside the cube looking away from vertex 0, which every
        padding row repeats: the 2 x 1024 piece rows of the padded mesh
        render what the 216 of the real one do, on both rasterizers, and
        what the JAX package's bucketed renderer does (its dense path op
        by op)."""
        from semantic_meshes import geometry as jgeo
        from semantic_meshes_torch import geometry

        mesh, jmesh = scene[:2]
        eye, target, up = [0.0, 0.0, 0.0], [0.5, 0.5, -0.5], [0.0, 1.0, 0.0]
        fl, pp = np.float32([90.0, 90.0]), np.float32([64.0, 48.0])
        cam = data.Camera(*geometry.look_at(eye, target, up), (128, 96),
                          fl, pp)
        jcam = semantic_meshes.data.Camera(*jgeo.look_at(eye, target, up),
                                           (128, 96), fl, pp)
        v0 = cam.rotation @ mesh.vertices[0] + cam.translation
        assert v0[2] < 0  # vertex 0 lies behind the camera
        r0, r1 = (render.triangles(mesh, clip_near=True, bucket=b,
                                   backend=backend, device="cpu")
                  for b in (False, True))
        got = r1.render(cam)
        _same_render(r0.render(cam), got)
        ids = _ids(got[0])
        assert (ids >= 0).any() and ids.max() < 108
        jr = jrender.triangles(jmesh, clip_near=True, bucket=True,
                               backend="xla" if backend == "tile" else backend)
        with jax.disable_jit(backend == "dense"):
            _like_jax(got, jr.render(jcam))

    def test_texels_bit_identical(self, scene):
        mesh, jmesh, cams, jcams = scene
        r0 = render.texels(mesh, cams, 1.5, bucket=False, device="cpu")
        r1 = render.texels(mesh, cams, 1.5, bucket=True, device="cpu")
        jr = jrender.texels(jmesh, jcams, 1.5, bucket=True)
        P = r0.getPrimitivesNum()
        assert r1.getPrimitivesNum() == P == jr.getPrimitivesNum()
        n = r0.resolutions.shape[0]
        assert r1.resolutions.shape[0] == r1.faces.shape[0] == 1024
        np.testing.assert_array_equal(r0.resolutions.numpy(),
                                      r1.resolutions[:n].numpy())
        # padding triangles get no texels
        assert bool((r1.resolutions[n:] == 0).all())
        np.testing.assert_array_equal(r1.resolutions.numpy(),
                                      np.asarray(jr.resolutions))
        np.testing.assert_array_equal(r1.first_texel_index.numpy(),
                                      np.asarray(jr.first_texel_index))
        # the reorder on padded rows: vertex 0 three times, as JAX's
        np.testing.assert_array_equal(r1.faces.numpy(), np.asarray(jr.faces))
        for cam, jcam in zip(cams, jcams):
            got = r1.render(cam)
            _same_render(r0.render(cam), got)
            _texels_like_jax(got[0], jr.render(jcam)[0], P)

    def test_env_default(self, scene, monkeypatch):
        mesh = scene[0]
        monkeypatch.setenv("SM_FACE_BUCKETS", "1")
        assert render.triangles(mesh, device="cpu").faces.shape[0] == 1024
        monkeypatch.setenv("SM_FACE_BUCKETS", "0")
        assert render.triangles(mesh, device="cpu").faces.shape[0] == 108
        monkeypatch.delenv("SM_FACE_BUCKETS")
        assert render.triangles(mesh, device="cpu").faces.shape[0] == 108
        monkeypatch.setenv("SM_FACE_BUCKETS", "1")
        r = render.texels(mesh, scene[2], 1.5, device="cpu")
        assert r.faces.shape[0] == r.resolutions.shape[0] == 1024

    def test_render_many_bucketed(self, scene):
        mesh, jmesh, cams, jcams = scene
        r0 = render.triangles(mesh, bucket=False, device="cpu")
        r1 = render.triangles(mesh, bucket=True, device="cpu")
        got = r1.render_many(cams)
        _same_render(r0.render_many(cams), got)
        ji, jd = jrender.triangles(jmesh, bucket=True).render_many(jcams)
        for k in range(len(cams)):
            _like_jax((got[0][k], got[1][k]), (ji[k], jd[k]))


class TestCameraCountBucketing:
    @pytest.mark.parametrize("clip_near", [False, True])
    def test_resolutions_unchanged_by_dummy_cameras(self, scene, clip_near):
        """Padding the camera set with resolution-(0, 0) cameras changes no
        triangle's texel resolution, under either sizing rule."""
        mesh, jmesh, cams, jcams = scene
        r0 = render.texels(mesh, cams, 1.5, bucket=False,
                           clip_near=clip_near, device="cpu")
        r1 = render.texels(mesh, cams, 1.5, bucket=True, clip_near=clip_near,
                           device="cpu")
        n = r0.resolutions.shape[0]
        np.testing.assert_array_equal(r0.resolutions.numpy(),
                                      r1.resolutions[:n].numpy())
        assert r0.getPrimitivesNum() == r1.getPrimitivesNum()
        jr = jrender.texels(jmesh, jcams, 1.5, bucket=True,
                            clip_near=clip_near)
        np.testing.assert_array_equal(r1.resolutions.numpy(),
                                      np.asarray(jr.resolutions))

    @pytest.mark.parametrize("views", [3, 5, 9, 17])
    def test_padded_sizing_equals_unpadded(self, scene, views):
        """The sizing at 3, 5, 9 and 17 cameras (padded to 16 and 32) equals
        the unpadded sizing and the JAX package's padded one."""
        mesh = scene[0]
        cams = testing.make_ring_cameras(num_views=views, width=128,
                                         height=96)
        v = torch.as_tensor(mesh.vertices)
        f = torch.as_tensor(mesh.faces.astype(np.int64))
        got = render._texel_resolutions(v, f, cams, 1.5, bucket=True)
        want = render._texel_resolutions(v, f, cams, 1.5, bucket=False)
        assert torch.equal(got, want)
        jres = jrender._texel_resolutions(
            np.asarray(mesh.vertices), np.asarray(mesh.faces, np.int32),
            jtesting.make_ring_cameras(num_views=views, width=128, height=96),
            1.5, bucket=True)
        np.testing.assert_array_equal(got.numpy(), np.asarray(jres))


# ----------------------------------------------------------- routing witness


@pytest.fixture(scope="module")
def witness(tmp_path_factory):
    """The 14700-face cube and one ring view of 256x192, for both
    packages."""
    tmp = tmp_path_factory.mktemp("witness")
    vertices, faces = testing.make_cube(subdivisions=WITNESS_SUB)
    assert len(faces) == 14700
    write_mesh(tmp / "cube.ply", vertices, faces)
    cams = testing.make_ring_cameras(num_views=1, width=256, height=192)
    jcams = jtesting.make_ring_cameras(num_views=1, width=256, height=192)
    return (data.Ply(str(tmp / "cube.ply")),
            semantic_meshes.data.Ply(str(tmp / "cube.ply")), cams[0],
            jcams[0])


def test_jax_routes_the_padded_count_dense_on_its_accelerator(monkeypatch):
    """The JAX package's rule on its accelerator
    (semantic_meshes/rasterize/__init__.py:24-32): dense at 16384 faces or
    more, pallas below. A bucketed 14700-face mesh counts 16384 rows."""
    monkeypatch.delenv("SM_RASTERIZER", raising=False)
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    assert jrast.default_backend(16384) == "dense"
    assert jrast.default_backend(14700) == "pallas"
    assert jrender._face_bucket(14700) == 16384
    for n in (14337, 16383):
        assert render._face_bucket(n) == rast.DENSE_THRESHOLD
    assert render._face_bucket(14336) < rast.DENSE_THRESHOLD


def test_bucketed_port_routes_dense_and_equals_jax(witness):
    mesh, jmesh, cam, jcam = witness
    r = render.triangles(mesh, bucket=True, device="cpu")
    assert r.faces.shape[0] == 16384 and r.getPrimitivesNum() == 14700
    assert rast.check_backend(r.faces.shape[0], r.backend) == "dense"
    ids, depth = r.render(cam)
    assert r.overflow_total() == 0
    assert (192, 256) in r.dense_cap_policy._cap  # budgets probed
    jr = jrender.triangles(jmesh, bucket=True, backend="dense")
    assert jr.faces.shape[0] == 16384
    with jax.disable_jit():  # the dense path op by op
        jids, jdepth = jr.render(jcam)
    got = _ids(ids)
    np.testing.assert_array_equal(got, _ids(jids))
    np.testing.assert_array_equal(depth.numpy().view(np.int32),
                                  np.asarray(jdepth).view(np.int32))
    assert got.max() < 14700 and (got >= 0).sum() == 4426


def test_unbucketed_port_routes_tile_and_drops_pairs(witness):
    """bucket=False keeps the unpadded count, so the tile rasterizer, whose
    per-tile cap drops candidate pairs on this mesh and view."""
    mesh, _, cam, _ = witness
    r = render.triangles(mesh, bucket=False, device="cpu")
    assert r.faces.shape[0] == 14700
    assert rast.check_backend(r.faces.shape[0], r.backend) == "tile"
    ids, _ = r.render(cam)
    assert r.overflow_total() > 0
    assert (_ids(ids) >= 0).sum() < 4426


# ------------------------------------------------------------- routing knobs


def test_jax_backend_names_map_to_the_port_backends(monkeypatch):
    monkeypatch.delenv("SM_RASTERIZER", raising=False)
    for name, want in (("pallas", "tile"), ("xla", "tile"), ("tile", "tile"),
                       ("dense", "dense")):
        assert rast.check_backend(10, name) == want
        assert rast.check_backend(10 ** 6, name) == want
    assert rast.uses_dense("dense", 10) and not rast.uses_dense("pallas",
                                                                10 ** 6)
    for bad in ("vulkan", "Dense", ""):
        with pytest.raises(ValueError, match="unknown rasterizer backend"):
            rast.check_backend(10, bad)


@pytest.mark.parametrize("env", ["xla", "pallas", "dense", "tile", "bogus",
                                 None])
def test_sm_rasterizer_follows_the_jax_rule(monkeypatch, env):
    """SM_RASTERIZER picks the backend of every call that names none, as
    the JAX package reads it on its accelerator; an unknown value is
    ignored, and a backend named in the call wins."""
    if env is None:
        monkeypatch.delenv("SM_RASTERIZER", raising=False)
    else:
        monkeypatch.setenv("SM_RASTERIZER", env)
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    for n in (100, 16383, 16384, 10 ** 6):
        want = {"pallas": "tile", "xla": "tile"}.get(
            jrast.default_backend(n), jrast.default_backend(n))
        if env == "tile":  # the port's own name, which JAX ignores
            want = "tile"
        assert rast.default_backend(n) == want
        assert rast.check_backend(n) == want
        assert rast.check_backend(n, "dense") == "dense"


def test_sm_rasterizer_routes_a_renderer(scene, monkeypatch):
    mesh, _, cams, _ = scene
    monkeypatch.setenv("SM_RASTERIZER", "dense")
    r = render.triangles(mesh, device="cpu")
    assert isinstance(r._dense_e_cap(96, 128, *render._camera_arrays(cams[0])),
                      rast.dense.DenseBudget)
    monkeypatch.setenv("SM_RASTERIZER", "pallas")
    r = render.triangles(mesh, device="cpu")
    assert r._dense_e_cap(96, 128, *render._camera_arrays(cams[0])) is None


def test_sm_dense_threshold_is_read_at_import():
    """SM_DENSE_THRESHOLD sets DENSE_THRESHOLD when the package is
    imported, in both packages."""
    code = ("import semantic_meshes.rasterize as j, "
            "semantic_meshes_torch.rasterize as t; "
            "print(j.DENSE_THRESHOLD, t.DENSE_THRESHOLD, "
            "t.check_backend(999), t.check_backend(1000))")
    env = dict(os.environ, SM_DENSE_THRESHOLD="1000", JAX_PLATFORMS="cpu",
               PYTHONPATH=REPO)
    env.pop("SM_RASTERIZER", None)
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["1000", "1000", "tile", "dense"]


# ------------------------------------------------------------------- eval CLI


def test_eval_cli_buckets_by_default(tmp_path, monkeypatch):
    """The eval CLI builds its renderer bucketed, as the JAX entry point
    does: on a 14700-face scene it has 16384 rows and routes dense;
    --no_face_buckets keeps 14700 rows and the tile route."""
    testing.write_scannet_label_tsv(tmp_path / "scannetv2-labels.combined.tsv")
    os.makedirs(tmp_path / "scans")
    testing.build_synthetic_scannet_scene(
        tmp_path, "scene0000_00", subdivisions=WITNESS_SUB, num_views=2)
    built = []
    make = render.triangles

    def triangles(mesh, **kw):
        built.append(make(mesh, **kw))
        return built[-1]

    monkeypatch.setattr(render, "triangles", triangles)
    base = ["--scannet", str(tmp_path), "--model", "probs", "--probs_dir",
            str(tmp_path / "probs"), "--aggregator", "sum", "--device", "cpu"]
    for extra, rows, backend in (([], 16384, "dense"),
                                 (["--no_face_buckets"], 14700, "tile")):
        eval_scannet.main(base + ["--output", str(tmp_path / f"out{rows}")]
                          + extra)
        r = built.pop()
        assert r.faces.shape[0] == rows and r.getPrimitivesNum() == 14700
        assert rast.check_backend(r.faces.shape[0], r.backend) == backend
        if backend == "dense":
            assert r.overflow_total() == 0
    assert not built
