"""Lens distortion of semantic_meshes_torch (the classic (k1, k2, p1, p2)
wire: SIMPLE_RADIAL / RADIAL / OPENCV) against the JAX package and an
independent numpy transcription of COLMAP's equations, on the CPU. Mirrors
tests/test_distortion.py.

Tolerances against JAX: forward maps at rtol 1e-5, atol 1e-6; grids at
atol 1e-5 in normalized coordinates; s at rtol 1e-6; ids after the
resample exactly (a zero lens also bit for bit against the port's own
pinhole render); depths at rtol 2e-5 (test_torch_rasterize.py); fused
states at rtol 1e-5, atol 1e-6 (another summation order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import semantic_meshes
from semantic_meshes import distributed as jdist
from semantic_meshes import geometry as jgeo
from semantic_meshes import render as jrender
from semantic_meshes import testing as jtesting
from semantic_meshes_torch import convert, data, distributed, fusion
from semantic_meshes_torch import geometry, render
from semantic_meshes_torch.io import colmap as colmap_io
from semantic_meshes_torch.io.ply import write_mesh

RTOL, ATOL = 1e-5, 1e-6
GRID_ATOL = 1e-5
DEPTH_RTOL = 2e-5


@pytest.fixture(autouse=True)
def one_thread():
    """The Newton loops are hundreds of small torch ops; beside other test
    workers, a pool of intra-op threads per op waits on the scheduler at
    every op, so each test runs on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


# an independent numpy oracle of COLMAP's Distortion() (camera_models.h)


def oracle_distort(model, raw_params, xy):
    x, y = xy[..., 0], xy[..., 1]
    if model == "SIMPLE_RADIAL":
        k1, k2, p1, p2 = raw_params[3], 0.0, 0.0, 0.0
    elif model == "RADIAL":
        k1, k2, p1, p2 = raw_params[3], raw_params[4], 0.0, 0.0
    else:  # OPENCV
        k1, k2, p1, p2 = raw_params[4:8]
    r2 = x * x + y * y
    radial = k1 * r2 + k2 * r2 * r2
    dx = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    dy = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return np.stack([x + dx, y + dy], axis=-1)


def oracle_undistort(dist4, xy_d, iters=200):
    """Fixed-point inversion x <- x_d - delta(x), another algorithm than
    the Newton under test."""
    k1, k2, p1, p2 = dist4
    xy = xy_d.copy()
    for _ in range(iters):
        x, y = xy[..., 0], xy[..., 1]
        r2 = x * x + y * y
        radial = k1 * r2 + k2 * r2 * r2
        dx = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        xy = xy_d - np.stack([dx, dy], axis=-1)
    return xy


PARAM_SETS = [
    ("SIMPLE_RADIAL", np.array([40.0, 32.0, 24.0, 0.08])),
    ("SIMPLE_RADIAL", np.array([40.0, 32.0, 24.0, -0.12])),
    ("RADIAL", np.array([40.0, 32.0, 24.0, 0.06, -0.02])),
    ("OPENCV", np.array([40.0, 42.0, 32.0, 24.0, -0.08, 0.015, 0.004,
                         -0.003])),
]


def canonical(model, raw):
    if model == "SIMPLE_RADIAL":
        return np.array([raw[3], 0, 0, 0], np.float32)
    if model == "RADIAL":
        return np.array([raw[3], raw[4], 0, 0], np.float32)
    return np.asarray(raw[4:8], np.float32)


class TestDistortionMath:
    def test_forward_matches_colmap_oracle_and_jax(self):
        xy = np.random.default_rng(0).uniform(
            -0.6, 0.6, size=(257, 2)).astype(np.float32)
        for model, raw in PARAM_SETS:
            d4 = canonical(model, raw)
            got = geometry.distort_normalized(_t(xy), _t(d4)).numpy()
            want = oracle_distort(model, raw, xy.astype(np.float64))
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(
                got, np.asarray(jgeo.distort_normalized(xy, d4)), rtol=1e-5,
                atol=1e-6)

    def test_undistort_inverts_forward(self):
        xy = np.random.default_rng(1).uniform(
            -0.5, 0.5, size=(301, 2)).astype(np.float32)
        for model, raw in PARAM_SETS:
            d4 = _t(canonical(model, raw))
            xy_d = geometry.distort_normalized(_t(xy), d4)
            back = geometry.undistort_normalized(xy_d, d4).numpy()
            np.testing.assert_allclose(back, xy, atol=2e-5)
            np.testing.assert_allclose(
                back, np.asarray(jgeo.undistort_normalized(
                    xy_d.numpy(), d4.numpy())), atol=GRID_ATOL)

    def test_undistort_matches_independent_fixed_point(self):
        xy_d = np.random.default_rng(2).uniform(-0.4, 0.4, size=(101, 2))
        for model, raw in PARAM_SETS:
            d4 = canonical(model, raw)
            got = geometry.undistort_normalized(_t(xy_d), _t(d4)).numpy()
            want = oracle_undistort(d4.astype(np.float64), xy_d)
            np.testing.assert_allclose(got, want, atol=3e-5)

    def test_max_monotonic_radius(self):
        """The closed-form fold radius the grid clamps diverged Newton
        pixels to, equal to the JAX package's."""
        def mmr(d):
            got = float(geometry.max_monotonic_radius(_t(d)))
            want = float(jgeo.max_monotonic_radius(np.float32(d)))
            np.testing.assert_allclose(got, want, rtol=1e-6)
            return got

        inf = float("inf")
        assert mmr([0, 0, 0, 0]) == inf
        assert mmr([0.2, 0, 0, 0]) == inf  # pincushion
        # barrel k1 < 0, k2 = 0: the fold is at r = sqrt(-1 / (3 k1))
        np.testing.assert_allclose(mmr([-0.12, 0, 0, 0]),
                                   np.sqrt(1.0 / (3 * 0.12)), rtol=1e-6)
        for k1, k2 in [(-0.08, 0.015), (0.06, -0.02), (-0.3, -0.05)]:
            r = mmr([k1, k2, 0, 0])
            if np.isfinite(r):
                d = 1 + 3 * k1 * r**2 + 5 * k2 * r**4
                np.testing.assert_allclose(d, 0.0, atol=1e-4)
                rin = np.linspace(0, r * 0.98, 64)
                assert (1 + 3 * k1 * rin**2 + 5 * k2 * rin**4 > 0).all()

    def test_undistort_grid_fold_clamp_preserves_focal_scale(self):
        """A barrel lens whose corners sit past the fold: every ray is
        clamped inside the fold radius, so s stays 1 (as in JAX), instead
        of one diverged corner shrinking the whole frame's focal. Past the
        fold Newton has no root and wanders, so the clamped rays there need
        not equal JAX's; inside it the grids agree."""
        fl, pp, dist = _t([30.0, 30.0]), _t([48.0, 36.0]), _t([-0.5, 0, 0, 0])
        n, s = render._undistort_grid(fl, pp, dist, height=72, width=96)
        jn, js = jrender._undistort_grid(fl.numpy(), pp.numpy(), dist.numpy(),
                                         height=72, width=96)
        r_fold = float(geometry.max_monotonic_radius(dist))
        r_n = n.norm(dim=-1).numpy()
        assert r_n.max() <= r_fold * (1 + 1e-5)
        assert float(s) == float(js) == 1.0
        # the fold's distorted radius r (1 + k1 r^2): rays inside it
        # have an inverse
        ys, xs = np.mgrid[0:72, 0:96]
        r_d = np.hypot((xs + 0.5 - 48) / 30, (ys + 0.5 - 36) / 30)
        inside = r_d < 0.95 * r_fold * (1 - 0.5 * r_fold**2)
        assert inside.mean() > 0.05
        np.testing.assert_allclose(n.numpy()[inside], np.asarray(jn)[inside],
                                   atol=GRID_ATOL)

    def test_zero_distortion_is_identity(self):
        xy = np.linspace(-1, 1, 20).reshape(10, 2).astype(np.float32)
        z = _t(np.zeros(4))
        np.testing.assert_array_equal(
            geometry.distort_normalized(_t(xy), z).numpy(), xy)
        np.testing.assert_array_equal(
            geometry.undistort_normalized(_t(xy), z).numpy(), xy)


class TestCameraPytree:
    """The port's Camera is a plain dataclass, not a pytree: what applies
    is the constructor's lens handling and convert.camera's copy of a JAX
    camera's lens."""

    def test_ctor_pads_and_defaults(self):
        cam = data.Camera(np.eye(3), np.zeros(3), (64, 48), [40, 40],
                          [32, 24])
        assert cam.distortion.shape == (4,) and not np.any(cam.distortion)
        cam2 = data.Camera(np.eye(3), np.zeros(3), (64, 48), [40, 40],
                           [32, 24], distortion=[0.1])
        np.testing.assert_allclose(cam2.distortion, [0.1, 0, 0, 0])
        with pytest.raises(ValueError, match="distortion"):
            data.Camera(np.eye(3), np.zeros(3), (64, 48), [40, 40], [32, 24],
                        distortion=np.zeros(10))

    def test_convert_keeps_distortion(self):
        for lens in ([0.1, -0.02, 0.003, 0.001],
                     [0.03, -0.011, 0.002, -0.0005, 0, 0, 0, 0, 1]):
            jcam = semantic_meshes.data.Camera(
                np.eye(3), np.zeros(3), (64, 48), [40, 40], [32, 24],
                distortion=lens)
            cam = convert.camera(jcam)
            np.testing.assert_array_equal(cam.distortion, jcam.distortion)
            assert cam.distortion.dtype == np.float32


# ------------------------------------------------------------- rendering


class _Mesh:
    def __init__(self, vertices, faces):
        self.vertices = np.asarray(vertices, np.float32)
        self.faces = np.asarray(faces, np.int32)


def scene():
    """Two overlapping triangles at different depths filling the view."""
    vertices = np.array(
        [[-2.0, -2.0, 4.0], [2.5, -2.0, 4.0], [0.0, 2.5, 4.0],
         [-1.0, -1.5, 3.0], [1.5, -0.5, 3.0], [-0.5, 1.5, 3.0]], np.float32)
    return _Mesh(vertices, np.array([[0, 1, 2], [3, 4, 5]], np.int32))


def make_camera(distortion=None, width=64, height=48, f=40.0):
    """(the port's camera, the JAX package's) with the same parameters."""
    args = (np.eye(3, dtype=np.float32), np.zeros(3, np.float32),
            (width, height), [f, f], [width / 2, height / 2])
    return (data.Camera(*args, distortion=distortion),
            semantic_meshes.data.Camera(*args, distortion=distortion))


def _ids(idx):
    """Public (W, H) uint32 ids of either package as a numpy uint32."""
    if torch.is_tensor(idx):
        return idx.view(torch.int32).numpy().view(np.uint32)
    return np.asarray(idx)


def _depth_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    np.testing.assert_allclose(got[fin], want[fin], rtol=DEPTH_RTOL)


class TestDistortedRender:
    @pytest.mark.parametrize("backend", ["tile", "dense"])
    def test_zero_distortion_path_is_bit_identical(self, backend):
        """The virtual-pinhole + resample path with a zero lens is the
        pinhole render bit for bit (s = 1 and the identity grid are
        selected structurally), on either rasterizer; JAX's distorted path
        gives the same ids."""
        mesh = scene()
        r = render.triangles(mesh, backend=backend, device="cpu")
        cam, jcam = make_camera()
        idx_p, dep_p = r.render(cam)
        cap = r._dense_e_cap(48, 64, *render._camera_arrays(cam))
        assert (cap is None) == (backend == "tile")
        idx_d, dep_d, _ = r._view(cam, cap, cam.distortion)
        assert torch.equal(idx_d, idx_p.view(torch.int32))
        assert torch.equal(dep_d.view(torch.int32), dep_p.view(torch.int32))
        jr = jrender.triangles(mesh)
        jidx, _, _ = jrender._render_triangles_distorted_jit(
            jr.vertices, jr.faces, jr.face_vertices, jcam.rotation,
            jcam.translation, jcam.focal_lengths, jcam.principal_point,
            jcam.distortion, height=48, width=64,
            max_tris_per_tile=jr.max_tris_per_tile, backend=jr.backend)
        np.testing.assert_array_equal(_ids(idx_p), np.asarray(jidx))

    def test_resample_preserves_index_bits(self):
        """Every bit of the id and depth lanes survives the gather: the
        -1 background, an id whose bits read as the smallest normal float
        and one that reads as a denormal, +inf depth (the patterns a
        float-lane gather canonicalized on the TPU)."""
        w_img, h_img = 64, 48
        rng = np.random.default_rng(3)
        idx = rng.integers(0, 1000, (w_img, h_img)).astype(np.uint32)
        idx[rng.random((w_img, h_img)) < 0.3] = 0xFFFFFFFF
        idx[0, 0] = 0x00800000  # smallest normal-float bits
        idx[1, 0] = 1  # denormal bits
        depth = rng.random((w_img, h_img)).astype(np.float32)
        depth[idx == 0xFFFFFFFF] = np.inf
        # identity grid: every distorted pixel samples its own centre
        yy, xx = np.mgrid[0:h_img, 0:w_img].astype(np.float32)
        fl, pp = np.float32([60.0, 60.0]), np.float32([0.0, 0.0])
        n = np.stack([(xx + 0.5) / 60.0, (yy + 0.5) / 60.0], axis=-1)
        got_idx, got_dep = render._resample_wh(
            torch.from_numpy(idx.view(np.int32)), torch.from_numpy(depth),
            _t(n), _t(fl), _t(pp))
        np.testing.assert_array_equal(_ids(got_idx), idx)
        np.testing.assert_array_equal(got_dep.numpy().view(np.uint32),
                                      depth.view(np.uint32))
        jidx, jdep = jrender._resample_wh(*map(jnp.asarray, (
            idx, depth, n, fl, pp)))
        np.testing.assert_array_equal(_ids(got_idx), np.asarray(jidx))
        np.testing.assert_array_equal(got_dep.numpy().view(np.uint32),
                                      np.asarray(jdep).view(np.uint32))

    def test_resample_saturates_rays_off_the_frame(self):
        """A ray at +-inf or NaN samples the border pixel on its own side
        (NaN at 0), as XLA's saturating convert does: a plain int cast of
        +inf would give INT_MIN, i.e. column 0."""
        idx = torch.arange(12, dtype=torch.int32).reshape(4, 3)  # (W, H)
        depth = idx.to(torch.float32)
        n = _t([[[np.inf, np.inf], [-np.inf, 0.3], [np.nan, -np.inf]]])
        got, _ = render._resample_wh(idx, depth, n, _t([1, 1]), _t([0, 0]))
        jgot, _ = jrender._resample_wh(*map(jnp.asarray, (
            idx.numpy().astype(np.uint32), depth.numpy(), n.numpy(),
            np.float32([1, 1]), np.float32([0, 0]))))
        assert got[:, 0].tolist() == [11, 0, 0]
        np.testing.assert_array_equal(got.numpy(), np.asarray(jgot))

    @pytest.mark.parametrize("k1", [0.15, -0.1])
    def test_matches_normalized_space_oracle_and_jax(self, k1):
        """The distorted render == a brute-force z-buffer at each distorted
        pixel's oracle-undistorted ray (up to nearest-resample quantization
        at triangle edges), and == the JAX package's render."""
        mesh = scene()
        r = render.triangles(mesh, device="cpu")
        cam, jcam = make_camera(distortion=[k1], width=96, height=72, f=60.0)
        idx, dep = r.render(cam)
        jidx, jdep = jrender.triangles(mesh).render(jcam)
        np.testing.assert_array_equal(_ids(idx), np.asarray(jidx))
        _depth_close(dep.numpy(), jdep)

        h, w = 72, 96
        ys, xs = np.mgrid[0:h, 0:w]
        nd = np.stack([(xs + 0.5 - 48.0) / 60.0, (ys + 0.5 - 36.0) / 60.0],
                      axis=-1)
        n = oracle_undistort(np.array([k1, 0, 0, 0]), nd)
        best_z = np.full((h, w), np.inf)
        best_i = np.full((h, w), -1)
        for t, f in enumerate(mesh.faces):
            tri = mesh.vertices[f].astype(np.float64)
            pn = tri[:, :2] / tri[:, 2:3]
            bary = geometry.barycentric_2d(
                torch.from_numpy(n), *torch.from_numpy(pn)).numpy()
            inside = np.all(bary >= 0, axis=-1)
            inv_z = bary @ (1.0 / tri[:, 2])
            zz = 1.0 / inv_z
            ok = inside & (inv_z > 0) & (zz < best_z)
            best_z = np.where(ok, zz, best_z)
            best_i = np.where(ok, t, best_i)
        got = idx.view(torch.int32).numpy().T
        mismatch = got != best_i
        assert mismatch.mean() < 0.02, int(mismatch.sum())
        both = (got >= 0) & ~mismatch
        np.testing.assert_allclose(dep.numpy().T[both], best_z[both],
                                   rtol=5e-3)

    def test_render_many_matches_single_and_jax(self):
        mesh = scene()
        r = render.triangles(mesh, device="cpu")
        jr = jrender.triangles(mesh)
        cams = [make_camera(distortion=[0.12]),
                make_camera(distortion=[-0.08, 0.01]),
                make_camera()]  # a pinhole inside the distorted batch
        idxs, deps = r.render_many([c for c, _ in cams])
        jidxs, _ = jr.render_many([j for _, j in cams])
        for k, (cam, jcam) in enumerate(cams):
            idx1, dep1 = r.render(cam)
            assert torch.equal(idxs[k].view(torch.int32),
                               idx1.view(torch.int32))
            assert torch.equal(deps[k], dep1)
            np.testing.assert_array_equal(_ids(idx1), np.asarray(jidxs[k]))

    def test_texels_zero_distortion_bit_identical(self):
        mesh = scene()
        cam, _ = make_camera()
        r = render.texels(mesh, [cam], texels_per_pixel=0.05, device="cpu")
        idx_p, dep_p = r.render(cam)
        idx_d, dep_d, _ = r._view(cam, None, cam.distortion)
        assert torch.equal(idx_d, idx_p.view(torch.int32))
        assert torch.equal(dep_d.view(torch.int32), dep_p.view(torch.int32))

    def test_texels_distorted_match_jax_and_batch(self):
        """Texel ids of distorted views: render_many == render, every id
        < P, and equal to the JAX package's (whose shader sees the same
        virtual focal)."""
        mesh = scene()
        cams = [make_camera(distortion=[0.1]),
                make_camera(distortion=[-0.06])]
        r = render.texels(mesh, [c for c, _ in cams], texels_per_pixel=0.05,
                          device="cpu")
        jr = jrender.texels(mesh, [j for _, j in cams], texels_per_pixel=0.05)
        assert r.getPrimitivesNum() == jr.getPrimitivesNum()
        idxs, _ = r.render_many([c for c, _ in cams])
        for k, (cam, jcam) in enumerate(cams):
            idx1, _ = r.render(cam)
            assert torch.equal(idxs[k].view(torch.int32),
                               idx1.view(torch.int32))
            arr = _ids(idx1)
            fg = arr != 0xFFFFFFFF
            assert fg.any() and arr[fg].max() < r.getPrimitivesNum()
            np.testing.assert_array_equal(arr, np.asarray(jr.render(jcam)[0]))


class TestDistortedFusedPipelines:
    """fuse_views and fuse_views_texels with per-view lenses equal the
    per-view render() -> MeshAggregator.add() path and the JAX package's
    fusions."""

    def _cams(self):
        return [make_camera(distortion=[0.12]),
                make_camera(distortion=[-0.08, 0.01]),
                make_camera(),  # a zero lens inside the batch
                make_camera(distortion=[0.05])]

    @pytest.mark.parametrize("agg_name", ["sum", "mul"])
    def test_fuse_views_distorted_equals_per_view(self, agg_name):
        mesh, cams = scene(), self._cams()
        P, C, H, W = 2, 4, 48, 64
        rng = np.random.default_rng(5)
        probs = np.stack([jtesting.random_probs(rng, H, W, C, 0.1)
                          for _ in cams])
        r = render.triangles(mesh, device="cpu")
        agg = fusion.MeshAggregator(P, C, agg_name, 0.5, device="cpu")
        for (cam, _), pr in zip(cams, probs):
            agg.add(r.render(cam)[0], pr.transpose(1, 0, 2))
        rot, trans, fl, pp = data.stack_cameras([c for c, _ in cams])
        dists = data.stack_distortions([c for c, _ in cams])
        kw = dict(num_primitives=P, aggregator=agg_name, height=H, width=W)
        acc, ov = distributed.fuse_views(mesh.vertices, mesh.faces, rot,
                                         trans, fl, pp, probs, 0.5, None,
                                         dists, device="cpu", **kw)
        assert int(ov) == 0
        np.testing.assert_allclose(acc.numpy(), agg.state.numpy(), rtol=1e-6,
                                   atol=0)
        jacc, jov = jdist.fuse_views(mesh.vertices, mesh.faces, rot, trans,
                                     fl, pp, probs, np.float32(0.5),
                                     distortions=dists, **kw)
        assert int(jov) == 0
        np.testing.assert_allclose(acc.numpy(), np.asarray(jacc), rtol=RTOL,
                                   atol=ATOL)

    def test_fuse_views_texels_distorted_equals_per_view(self):
        mesh, cams = scene(), self._cams()
        pcams = [c for c, _ in cams]
        r = render.texels(mesh, pcams, texels_per_pixel=0.05, device="cpu")
        jr = jrender.texels(mesh, [j for _, j in cams], texels_per_pixel=0.05)
        P, C, H, W = r.getPrimitivesNum(), 3, 48, 64
        rng = np.random.default_rng(6)
        probs = np.stack([jtesting.random_probs(rng, H, W, C) for _ in cams])
        agg = fusion.MeshAggregator(P, C, "sum", 0.5, device="cpu")
        for cam, pr in zip(pcams, probs):
            agg.add(r.render(cam)[0], pr.transpose(1, 0, 2))
        rot, trans, fl, pp = data.stack_cameras(pcams)
        dists = data.stack_distortions(pcams)
        kw = dict(num_primitives=P, aggregator="sum", height=H, width=W)
        acc, ov = distributed.fuse_views_texels(
            mesh.vertices, r.faces, r.resolutions, r.first_texel_index, rot,
            trans, fl, pp, probs, 0.5, distortions=dists, device="cpu", **kw)
        assert int(ov) == 0
        np.testing.assert_allclose(acc.numpy(), agg.state.numpy(), rtol=1e-6,
                                   atol=0)
        jacc, _ = jdist.fuse_views_texels(
            jr.vertices, jr.faces, jr.resolutions, jr.first_texel_index, rot,
            trans, fl, pp, probs, np.float32(0.5), distortions=dists, **kw)
        np.testing.assert_allclose(acc.numpy(), np.asarray(jacc), rtol=RTOL,
                                   atol=ATOL)


class TestColmapWorkspaceEndToEnd:
    def test_simple_radial_workspace_renders_and_fuses(self, tmp_path):
        """A SIMPLE_RADIAL COLMAP workspace (written by the port's own
        writer) loads in both packages, renders the same ids and fuses."""
        mesh = scene()
        write_mesh(tmp_path / "mesh.ply", mesh.vertices, mesh.faces)
        colmap_io.write_cameras_txt(str(tmp_path / "cameras.txt"), {
            1: colmap_io.ColmapCamera(1, "SIMPLE_RADIAL", 96, 72,
                                      np.array([60.0, 60.0]),
                                      np.array([48.0, 36.0]),
                                      np.array([0.12, 0, 0, 0]))})
        (tmp_path / "images.txt").write_text("1 1 0 0 0 0 0 0 1 view0.png\n\n")

        cam = data.Colmap(str(tmp_path)).getCamera(0)
        np.testing.assert_allclose(cam.distortion, [0.12, 0, 0, 0])
        assert cam.resolution == (96, 72)
        r = render.triangles(data.Ply(str(tmp_path / "mesh.ply")),
                             device="cpu")
        idx, _ = r.render(cam)
        jcam = semantic_meshes.data.Colmap(str(tmp_path)).getCamera(0)
        jidx, _ = jrender.triangles(
            semantic_meshes.data.Ply(str(tmp_path / "mesh.ply"))).render(jcam)
        arr = _ids(idx)
        np.testing.assert_array_equal(arr, np.asarray(jidx))
        assert (arr != 0xFFFFFFFF).mean() > 0.2

        # probs that label the far triangle class 0 and the near one 1
        agg = fusion.MeshAggregator(r.getPrimitivesNum(), 2, device="cpu")
        probs = np.stack([arr == 0, arr == 1], axis=-1).astype(np.float32)
        agg.add(idx, probs)
        fused = agg.get().numpy()
        assert fused[0].argmax() == 0 and fused[1].argmax() == 1
