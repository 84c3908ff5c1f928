"""The extended COLMAP lens wire of semantic_meshes_torch (FULL_OPENCV, the
equidistant fisheye family, FOV, THIN_PRISM_FISHEYE: geometry.LENS_*)
against the JAX package and independent numpy transcriptions of COLMAP's
camera_models.h, on the CPU. Mirrors tests/test_lens_models.py.

Tolerances against JAX: forward maps at rtol 1e-5, atol 1e-6; grids at
atol 1e-5 in normalized coordinates; s at rtol 1e-6. The extended grid's
Newton runs through atan, tan and sqrt, which XLA's CPU backend and torch
round differently in the last bit (XLA's sqrt is not correctly rounded),
so after the resample at most 1e-3 of the pixels may hold another id than
JAX's, each within one pixel of an id boundary of JAX's image. Where a ray
sits near theta = 90 degrees, tan multiplies that last bit by its
condition number theta / (sin theta cos theta); the wide-lens tests state
that factor where they use it. Fused states at rtol 1e-5, atol 1e-6."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import semantic_meshes
from semantic_meshes import distributed as jdist
from semantic_meshes import geometry as jgeo
from semantic_meshes import render as jrender
from semantic_meshes import testing as jtesting
from semantic_meshes_torch import data, distributed, fusion, geometry, render
from semantic_meshes_torch.io import colmap as colmap_io
from semantic_meshes_torch.io.ply import write_mesh

RTOL, ATOL = 1e-5, 1e-6
GRID_ATOL = 1e-5
S_RTOL = 1e-6
MISMATCH = 1e-3
EPS32 = float(np.finfo(np.float32).eps)


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


# independent numpy oracles (COLMAP camera_models.h Distortion())


def oracle_full_opencv(k, xy):
    x, y = xy[..., 0], xy[..., 1]
    k1, k2, p1, p2, k3, k4, k5, k6 = k
    r2 = x * x + y * y
    rad = (1 + k1 * r2 + k2 * r2**2 + k3 * r2**3) / (
        1 + k4 * r2 + k5 * r2**2 + k6 * r2**3)
    ox = x * rad + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    oy = y * rad + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    return np.stack([ox, oy], axis=-1)


def oracle_fisheye(ks, xy):
    r = np.sqrt((xy * xy).sum(-1))
    th = np.arctan(r)
    poly = 1.0
    for i, ki in enumerate(ks):
        poly = poly + ki * th ** (2 * (i + 1))
    scale = np.where(r > 1e-12, th * poly / np.maximum(r, 1e-12), 1.0)
    return xy * scale[..., None]


def oracle_fov(omega, xy):
    r = np.sqrt((xy * xy).sum(-1))
    factor = np.arctan(2 * r * np.tan(omega / 2)) / np.maximum(
        r * omega, 1e-12)
    factor = np.where(r > 1e-12, factor, 2 * np.tan(omega / 2) / omega)
    return xy * factor[..., None]


def oracle_thin_prism_fisheye(k8, xy):
    k1, k2, p1, p2, k3, k4, sx1, sy1 = k8
    x, y = xy[..., 0], xy[..., 1]
    r = np.sqrt(x * x + y * y)
    eq = np.where(r > 1e-12, np.arctan(r) / np.maximum(r, 1e-12), 1.0)
    u, v = x * eq, y * eq
    r2 = u * u + v * v
    radial = k1 * r2 + k2 * r2**2 + k3 * r2**3 + k4 * r2**4
    du = u * radial + 2 * p1 * u * v + p2 * (r2 + 2 * u * u) + sx1 * r2
    dv = v * radial + p1 * (r2 + 2 * v * v) + 2 * p2 * u * v + sy1 * r2
    return np.stack([u + du, v + dv], axis=-1)


def wire_full_opencv(k8):
    return np.concatenate([np.asarray(k8, np.float32), [0.0]]).astype(
        np.float32)


def wire_fisheye(ks):
    d = np.zeros(9, np.float32)
    d[:len(ks)] = ks
    d[8] = geometry.LENS_FISHEYE
    return d


def wire_fov(omega):
    d = np.zeros(9, np.float32)
    d[0] = omega
    d[8] = geometry.LENS_FOV
    return d


def wire_thin_prism(k8):
    return np.concatenate([np.asarray(k8, np.float32),
                           [geometry.LENS_THIN_PRISM]]).astype(np.float32)


FULL_K = np.array([-0.08, 0.015, 0.004, -0.003, 0.002, 0.01, -0.004, 0.001])
FISH_K4 = np.array([0.03, -0.011, 0.002, -0.0005])
TPF_K8 = np.array([0.03, -0.011, 0.002, -0.0015, 0.0008, -0.0002, 0.001,
                   -0.0007])


def _points(seed=0, n=257, lim=0.6):
    rng = np.random.default_rng(seed)
    return rng.uniform(-lim, lim, size=(n, 2)).astype(np.float32)


def _forward(xy, dist, want):
    """The port's forward map against `want` and against JAX's."""
    got = geometry.distort_normalized(_t(xy), _t(dist)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        got, np.asarray(jgeo.distort_normalized(xy, dist)), rtol=1e-5,
        atol=1e-6)
    return got


class TestExtendedDistortionMath:
    def test_classic_pad_is_same_model(self):
        """A classic vector zero-padded onto the extended wire is the same
        model (what stack_distortions relies on for a mixed batch)."""
        xy = _t(_points())
        d4 = _t([-0.08, 0.015, 0.004, -0.003])
        a = geometry.distort_normalized(xy, d4)
        b = geometry.distort_normalized(xy, torch.nn.functional.pad(d4,
                                                                    (0, 5)))
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-7)

    def test_full_opencv_matches_oracle(self):
        xy = _points(1)
        _forward(xy, wire_full_opencv(FULL_K),
                 oracle_full_opencv(FULL_K, xy.astype(np.float64)))

    @pytest.mark.parametrize(
        "ks", [FISH_K4, FISH_K4[:2], FISH_K4[:1], np.zeros(4)],
        ids=["opencv_fisheye", "radial_fisheye", "simple_radial_fisheye",
             "zero_k"])
    def test_fisheye_matches_oracle(self, ks):
        xy = _points(2)
        _forward(xy, wire_fisheye(ks), oracle_fisheye(ks,
                                                      xy.astype(np.float64)))

    def test_fisheye_zero_k_is_not_identity(self):
        """Equidistant projection bends rays with zero coefficients too;
        the selector keeps the wire nonzero, which is what
        render._has_distortion and the zero-lens select key on."""
        xy = _points(3)
        d = wire_fisheye(np.zeros(4))
        assert np.any(d) and render._has_distortion(
            [data.Camera(np.eye(3), np.zeros(3), (8, 8), [1, 1], [4, 4],
                         distortion=d)])
        got = geometry.distort_normalized(_t(xy), _t(d)).numpy()
        r = np.sqrt((xy**2).sum(-1))
        assert np.abs(got - xy).max() > 1e-3
        np.testing.assert_allclose(
            got, xy * (np.arctan(r) / np.maximum(r, 1e-12))[:, None],
            atol=1e-6)

    @pytest.mark.parametrize("k8", [TPF_K8, np.zeros(8)],
                             ids=["thin_prism", "zero_params"])
    def test_thin_prism_fisheye_matches_oracle(self, k8):
        xy = _points(7)
        _forward(xy, wire_thin_prism(k8),
                 oracle_thin_prism_fisheye(k8, xy.astype(np.float64)))

    def test_thin_prism_zero_params_equals_equidistant(self):
        xy = _t(_points(8))
        got = geometry.distort_normalized(xy, _t(wire_thin_prism(np.zeros(8))))
        fish = geometry.distort_normalized(xy, _t(wire_fisheye(np.zeros(4))))
        np.testing.assert_allclose(got.numpy(), fish.numpy(), atol=1e-6)

    @pytest.mark.parametrize("omega", [0.3, 0.9, 1.4])
    def test_fov_matches_oracle(self, omega):
        xy = _points(4)
        _forward(xy, wire_fov(omega), oracle_fov(omega,
                                                 xy.astype(np.float64)))

    def test_fov_tiny_omega_is_identity_limit(self):
        xy = _points(5)
        _forward(xy, wire_fov(0.0), xy)

    @pytest.mark.parametrize(
        "dist",
        [wire_full_opencv(FULL_K), wire_fisheye(FISH_K4), wire_fov(0.9),
         wire_fisheye(np.zeros(4)), wire_thin_prism(TPF_K8)],
        ids=["full_opencv", "fisheye", "fov", "fisheye_zero_k",
             "thin_prism"])
    def test_undistort_inverts_forward(self, dist):
        xy = _points(6, n=301, lim=0.5)
        xy_d = geometry.distort_normalized(_t(xy), _t(dist))
        back = geometry.undistort_normalized(xy_d, _t(dist)).numpy()
        np.testing.assert_allclose(back, xy, atol=3e-5)
        np.testing.assert_allclose(
            back, np.asarray(jgeo.undistort_normalized(xy_d.numpy(), dist)),
            atol=GRID_ATOL)

    def test_undistort_wide_fisheye_rays(self):
        """Inversion where undistorted radii far exceed distorted ones (up
        to ~74 degrees), the tan blow-up Newton has to climb."""
        r = np.linspace(0.1, 3.5, 40)
        xy = np.stack([r / np.sqrt(2), r / np.sqrt(2)], -1).astype(np.float32)
        d = _t(wire_fisheye(FISH_K4 * 0.5))
        xy_d = geometry.distort_normalized(_t(xy), d)
        back = geometry.undistort_normalized(xy_d, d).numpy()
        np.testing.assert_allclose(back, xy, rtol=1e-4, atol=1e-4)

    def test_extended_monotonic_radius_matches_classic(self):
        d4 = _t([-0.12, 0, 0, 0])
        want = float(geometry.max_monotonic_radius(d4))
        got = float(geometry.max_monotonic_radius(
            torch.nn.functional.pad(d4, (0, 5))))
        np.testing.assert_allclose(got, want, rtol=2e-2)

    def test_extended_monotonic_radius_fisheye(self):
        assert float(geometry.max_monotonic_radius(
            _t(wire_fisheye(np.zeros(4))))) == float("inf")
        d = wire_fisheye([-0.3, 0, 0, 0])
        r_fold = float(geometry.max_monotonic_radius(_t(d)))
        # the same sample of the response as JAX's (its radii are rounded
        # from float64 here, from f32 linspace + tan in JAX)
        np.testing.assert_allclose(
            r_fold, float(jgeo.max_monotonic_radius(d)), rtol=1e-6)
        assert np.isfinite(r_fold) and r_fold > 0
        rr = np.linspace(1e-3, r_fold * 0.98, 256)
        pts = _t(np.stack([rr, np.zeros_like(rr)], -1))
        rd = geometry.distort_normalized(pts, _t(d)).numpy()[:, 0]
        assert (np.diff(rd) > 0).all()
        beyond = geometry.distort_normalized(_t([[r_fold * 1.3, 0.0]]),
                                             _t(d)).numpy()[0, 0]
        assert beyond < rd[-1] * 1.02

    def test_batched_monotonic_radius_equals_per_lens(self):
        """max_monotonic_radius takes leading dist dims on both wires."""
        wires = np.stack([wire_fisheye([-0.3, 0, 0, 0]), wire_fov(0.9),
                          wire_full_opencv(FULL_K)])
        got = geometry.max_monotonic_radius(_t(wires)).numpy()
        want = [float(geometry.max_monotonic_radius(_t(w))) for w in wires]
        np.testing.assert_array_equal(got, want)
        classic = _t([[-0.12, 0, 0, 0], [0.2, 0, 0, 0]])
        np.testing.assert_array_equal(
            geometry.max_monotonic_radius(classic).numpy(),
            [float(geometry.max_monotonic_radius(c)) for c in classic])


class TestCameraWire:
    def test_ctor_accepts_extended_wire(self):
        cam = data.Camera(np.eye(3), np.zeros(3), (64, 48), [40, 40],
                          [32, 24], distortion=wire_fisheye(FISH_K4))
        assert cam.distortion.shape == (9,)
        with pytest.raises(ValueError, match="distortion"):
            data.Camera(np.eye(3), np.zeros(3), (64, 48), [40, 40], [32, 24],
                        distortion=np.zeros(10))

    def test_ctor_pads_5_to_extended_radtan(self):
        cam = data.Camera(np.eye(3), np.zeros(3), (64, 48), [40, 40],
                          [32, 24], distortion=[0.1, -0.02, 0.003, 0.001,
                                                0.0005])
        np.testing.assert_allclose(
            cam.distortion, [0.1, -0.02, 0.003, 0.001, 0.0005, 0, 0, 0, 0])

    def test_stack_distortions_pads_mixed_batch(self):
        args = (np.eye(3), np.zeros(3), (64, 48), [40, 40], [32, 24])
        cams = [data.Camera(*args, distortion=[0.1]),
                data.Camera(*args, distortion=wire_fisheye(FISH_K4)),
                data.Camera(*args)]
        d = data.stack_distortions(cams)
        assert d.shape == (3, 9)
        np.testing.assert_allclose(d[0], [0.1, 0, 0, 0, 0, 0, 0, 0, 0])
        np.testing.assert_allclose(d[1], wire_fisheye(FISH_K4))
        assert not np.any(d[2])

    def test_stack_distortions_classic_batch_stays_4(self):
        args = (np.eye(3), np.zeros(3), (64, 48), [40, 40], [32, 24])
        cams = [data.Camera(*args, distortion=[0.1]), data.Camera(*args)]
        assert data.stack_distortions(cams).shape == (2, 4)


# ------------------------------------------------- rendering and fusion


class _Mesh:
    def __init__(self, vertices, faces):
        self.vertices = np.asarray(vertices, np.float32)
        self.faces = np.asarray(faces, np.int32)


def scene():
    vertices = np.array(
        [[-2.0, -2.0, 4.0], [2.5, -2.0, 4.0], [0.0, 2.5, 4.0],
         [-1.0, -1.5, 3.0], [1.5, -0.5, 3.0], [-0.5, 1.5, 3.0]], np.float32)
    return _Mesh(vertices, np.array([[0, 1, 2], [3, 4, 5]], np.int32))


def make_camera(distortion=None, width=96, height=72, f=60.0):
    """(the port's camera, the JAX package's) with the same parameters."""
    args = (np.eye(3, dtype=np.float32), np.zeros(3, np.float32),
            (width, height), [f, f], [width / 2, height / 2])
    return (data.Camera(*args, distortion=distortion),
            semantic_meshes.data.Camera(*args, distortion=distortion))


MIXED = [wire_fisheye(FISH_K4), wire_fov(0.8), wire_thin_prism(TPF_K8),
         [0.1], None]


@pytest.fixture(scope="module")
def mixed_views():
    """(the port's MIXED cameras, their (ids, depth) from one render each):
    the per-view path that render_many and fuse_views are held to. Each
    extended grid is ~0.6 s of small torch ops, so the renders are made
    once for the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    cams = [make_camera(distortion=d) for d in MIXED]
    r = render.triangles(scene(), device="cpu")
    views = [r.render(c) for c, _ in cams]
    torch.set_num_threads(threads)
    return cams, views


def _ids_hw(idx):
    """(H, W) int64 ids, -1 empty, of either package's (W, H) image."""
    if torch.is_tensor(idx):
        return idx.view(torch.int32).numpy().T.astype(np.int64)
    return np.asarray(idx).view(np.int32).T.astype(np.int64)


def _extended_id_rule(got, want):
    """At most MISMATCH of the pixels hold another id than JAX's, each
    within one pixel of an id boundary of JAX's image. Returns the count."""
    pad = np.pad(want, 1, mode="edge")
    h, w = want.shape
    edge = np.zeros(want.shape, bool)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            edge |= pad[1 + dy:1 + dy + h, 1 + dx:1 + dx + w] != want
    diff = got != want
    assert diff.mean() <= MISMATCH, int(diff.sum())
    assert not np.any(diff & ~edge), np.argwhere(diff & ~edge)[:5]
    return int(diff.sum())


class TestExtendedLensRender:
    def test_fisheye_render_matches_normalized_space_oracle(self):
        """Fisheye render == a brute-force z-buffer at each distorted
        pixel's bisection-inverted ray (up to nearest-resample edge
        quantization), and JAX's render under the extended rule."""
        mesh = scene()
        cam, jcam = make_camera(distortion=wire_fisheye(FISH_K4))
        idx, dep = render.triangles(mesh, device="cpu").render(cam)
        jidx, _ = jrender.triangles(mesh).render(jcam)
        got = _ids_hw(idx)
        _extended_id_rule(got, _ids_hw(jidx))

        h, w = 72, 96
        ys, xs = np.mgrid[0:h, 0:w]
        nd = np.stack([(xs + 0.5 - 48) / 60.0, (ys + 0.5 - 36) / 60.0], -1)
        rd = np.sqrt((nd**2).sum(-1))
        lo, hi = np.zeros_like(rd), np.full_like(rd, 20.0)
        for _ in range(60):
            mid = 0.5 * (lo + hi)
            th = np.arctan(mid)
            val = th * (1 + FISH_K4[0] * th**2 + FISH_K4[1] * th**4
                        + FISH_K4[2] * th**6 + FISH_K4[3] * th**8)
            lo, hi = np.where(val < rd, mid, lo), np.where(val < rd, hi, mid)
        n = nd * (0.5 * (lo + hi) / np.maximum(rd, 1e-12))[..., None]
        best_z = np.full((h, w), np.inf)
        best_i = np.full((h, w), -1)
        for t, f in enumerate(mesh.faces):
            tri = mesh.vertices[f].astype(np.float64)
            pn = tri[:, :2] / tri[:, 2:3]
            bary = geometry.barycentric_2d(
                torch.from_numpy(n), *torch.from_numpy(pn)).numpy()
            inv_z = bary @ (1.0 / tri[:, 2])
            zz = 1.0 / inv_z
            ok = np.all(bary >= 0, axis=-1) & (inv_z > 0) & (zz < best_z)
            best_z = np.where(ok, zz, best_z)
            best_i = np.where(ok, t, best_i)
        mismatch = got != best_i
        assert mismatch.mean() < 0.02, int(mismatch.sum())
        both = (got >= 0) & ~mismatch
        np.testing.assert_allclose(dep.numpy().T[both], best_z[both],
                                   rtol=5e-3)

    def test_render_many_mixed_wire_batch(self, mixed_views):
        """Fisheye, FOV, thin prism, classic radial and a pinhole ride one
        (N, 9) batch: render_many == render bit for bit, and each view is
        JAX's under the extended rule."""
        mesh = scene()
        r = render.triangles(mesh, device="cpu")
        jr = jrender.triangles(mesh)
        cams, views = mixed_views
        idxs, deps = r.render_many([c for c, _ in cams])
        jidxs, _ = jr.render_many([j for _, j in cams])
        for k, (idx1, dep1) in enumerate(views):
            assert torch.equal(idxs[k].view(torch.int32),
                               idx1.view(torch.int32))
            assert torch.equal(deps[k], dep1)
            _extended_id_rule(_ids_hw(idx1), _ids_hw(jidxs[k]))

    def test_fuse_views_extended_equals_per_view(self, mixed_views):
        mesh = scene()
        cams, views = mixed_views
        pcams = [c for c, _ in cams]
        P, C, H, W = 2, 4, 72, 96
        rng = np.random.default_rng(11)
        probs = np.stack([jtesting.random_probs(rng, H, W, C, 0.1)
                          for _ in cams])
        agg = fusion.MeshAggregator(P, C, "sum", 0.5, device="cpu")
        for (idx, _), pr in zip(views, probs):
            agg.add(idx, pr.transpose(1, 0, 2))
        rot, trans, fl, pp = data.stack_cameras(pcams)
        dists = data.stack_distortions(pcams)
        kw = dict(num_primitives=P, aggregator="sum", height=H, width=W)
        acc, ov = distributed.fuse_views(
            mesh.vertices, mesh.faces, rot, trans, fl, pp, probs, 0.5,
            distortions=dists, device="cpu", **kw)
        assert int(ov) == 0
        np.testing.assert_allclose(acc.numpy(), agg.state.numpy(), rtol=1e-6,
                                   atol=0)
        jacc, _ = jdist.fuse_views(mesh.vertices, mesh.faces, rot, trans, fl,
                                   pp, probs, np.float32(0.5),
                                   distortions=dists, **kw)
        np.testing.assert_allclose(acc.numpy(), np.asarray(jacc), rtol=RTOL,
                                   atol=ATOL)

    @pytest.mark.parametrize("model", ["OPENCV_FISHEYE",
                                       "THIN_PRISM_FISHEYE"])
    def test_colmap_extended_workspace_end_to_end(self, tmp_path, model):
        """A synthetic extended-model COLMAP workspace loads in the port and
        renders JAX's ids under the extended rule."""
        mesh = scene()
        write_mesh(tmp_path / "mesh.ply", mesh.vertices, mesh.faces)
        k = FISH_K4 if model == "OPENCV_FISHEYE" else TPF_K8
        wire = wire_fisheye(k) if model == "OPENCV_FISHEYE" else \
            wire_thin_prism(k)
        colmap_io.write_cameras_txt(str(tmp_path / "cameras.txt"), {
            1: colmap_io.ColmapCamera(1, model, 96, 72,
                                      np.array([60.0, 60.0]),
                                      np.array([48.0, 36.0]), wire)})
        (tmp_path / "images.txt").write_text("1 1 0 0 0 0 0 0 1 view0.png\n\n")
        cam = data.Colmap(str(tmp_path)).getCamera(0)
        assert cam.distortion.shape == (9,)
        assert cam.distortion[8] == wire[8]
        r = render.triangles(data.Ply(str(tmp_path / "mesh.ply")),
                             device="cpu")
        idx, _ = r.render(cam)
        jidx, _ = jrender.triangles(
            semantic_meshes.data.Ply(str(tmp_path / "mesh.ply"))).render(
                semantic_meshes.data.Colmap(str(tmp_path)).getCamera(0))
        got = _ids_hw(idx)
        _extended_id_rule(got, _ids_hw(jidx))
        assert (got >= 0).mean() > 0.2 and got.max() < r.getPrimitivesNum()


class TestLensWireRobustness:
    def test_undistort_grid_finite_for_random_wires(self):
        """Random parameters of every selector, nonsensical magnitudes
        included: the grid stays finite and s in (0, 1] (the Newton ball
        clamp and the response cap keep one bad lens from poisoning a
        batch). Two draws per selector (the JAX test draws six)."""
        rng = np.random.default_rng(42)
        fl, pp = _t([60.0, 60.0]), _t([48.0, 36.0])
        for trial in range(8):
            d = np.zeros(9, np.float32)
            sel = trial % 4
            if sel == 0:
                d[:8] = rng.uniform(-0.5, 0.5, 8)
            elif sel == 1:
                d[:4] = rng.uniform(-0.5, 0.5, 4)
                d[8] = geometry.LENS_FISHEYE
            elif sel == 2:
                d[0] = rng.uniform(0.01, 1.5)
                d[8] = geometry.LENS_FOV
            else:
                d[:8] = rng.uniform(-0.3, 0.3, 8)
                d[8] = geometry.LENS_THIN_PRISM
            n, s = render._undistort_grid(fl, pp, _t(d), height=72, width=96)
            assert bool(torch.isfinite(n).all()), (trial, d)
            assert 0.0 < float(s) <= 1.0, (trial, d, float(s))


def test_fuse_views_texels_extended_equals_per_view():
    """Texel-mode fusion on the extended wire (fisheye, FOV, thin prism,
    classic, pinhole) == the per-view render + add, and JAX's."""
    mesh = scene()
    cams = [make_camera(distortion=d) for d in MIXED]
    pcams = [c for c, _ in cams]
    r = render.texels(mesh, pcams, texels_per_pixel=0.05, device="cpu")
    jr = jrender.texels(mesh, [j for _, j in cams], texels_per_pixel=0.05)
    P, C, H, W = r.getPrimitivesNum(), 3, 72, 96
    rng = np.random.default_rng(13)
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


class TestSharedLensHoist:
    """shared_lens=True computes the grid once for a batch of one physical
    camera; the grid's values are the same, so the fusion is bit-equal."""

    def _setup(self, wire):
        cams = [make_camera(distortion=wire)[0] for _ in range(3)]
        rng = np.random.default_rng(21)
        probs = np.stack([jtesting.random_probs(rng, 72, 96, 3)
                          for _ in cams])
        return scene(), cams, probs

    @pytest.mark.parametrize(
        "wire", [np.array([0.1, -0.02, 0, 0], np.float32),
                 wire_fisheye(FISH_K4)], ids=["classic", "fisheye"])
    def test_fuse_views_shared_equals_per_view_grid(self, wire):
        mesh, cams, probs = self._setup(wire)
        rot, trans, fl, pp = data.stack_cameras(cams)
        dists = data.stack_distortions(cams)
        kw = dict(num_primitives=2, aggregator="sum", height=72, width=96,
                  device="cpu")
        assert distributed.lens_shared(fl, pp, dists)
        a, ov_a = distributed.fuse_views(
            mesh.vertices, mesh.faces, rot, trans, fl, pp, probs, 0.5,
            distortions=dists, shared_lens=True, **kw)
        b, ov_b = distributed.fuse_views(
            mesh.vertices, mesh.faces, rot, trans, fl, pp, probs, 0.5,
            distortions=dists, **kw)
        assert int(ov_a) == int(ov_b) == 0
        assert torch.equal(a, b)

    def test_lens_shared_detection(self):
        _, cams, _ = self._setup(wire_fisheye(FISH_K4))
        rot, trans, fl, pp = data.stack_cameras(cams)
        dists = data.stack_distortions(cams)
        assert distributed.lens_shared(fl, pp, dists)
        assert distributed.lens_shared(torch.from_numpy(fl), pp,
                                       torch.from_numpy(dists))
        assert not distributed.lens_shared(fl, pp, None)
        mixed = dists.copy()
        mixed[1, 0] += 0.01
        assert not distributed.lens_shared(fl, pp, mixed)
        fl2 = fl.copy()
        fl2[1, 0] += 1.0
        assert not distributed.lens_shared(fl2, pp, dists)

    def test_plan_fuse_carries_lens_shared(self):
        mesh, cams, probs = self._setup(wire_fisheye(FISH_K4))
        rot, trans, fl, pp = data.stack_cameras(cams)
        dists = data.stack_distortions(cams)
        kw = dict(num_primitives=2, aggregator="sum", height=72, width=96,
                  device="cpu")
        plan = distributed.plan_fuse(mesh.vertices, mesh.faces, rot, trans,
                                     fl, pp, height=72, width=96,
                                     distortions=dists, device="cpu")
        assert plan.lens_shared
        acc, ov = distributed.fuse_views_planned(
            plan, mesh.vertices, rot, trans, fl, pp, probs, 0.5,
            distortions=dists, **kw)
        ref, _ = distributed.fuse_views(mesh.vertices, mesh.faces, rot, trans,
                                        fl, pp, probs, 0.5,
                                        distortions=dists, **kw)
        assert int(ov) == 0
        assert torch.equal(acc, ref)


def _tan_condition(r):
    """Relative condition number of r = tan(theta) at theta = atan(r): an
    ulp of theta moves r by this many ulps."""
    th = np.arctan(r)
    return th / (np.sin(th) * np.cos(th))


class TestWideLensGrid:
    """The extended wire's per-pixel clamp: every valid pixel's ray
    distorts back onto its own centre, and pixels beyond the response the
    lens can produce (no ray) do not shrink the virtual focal."""

    def test_170deg_fisheye_grid_inverts_exactly(self):
        W, H, f = 96, 72, 41.0  # corner r_d 1.46: the true radius ~9
        dist = _t(wire_fisheye(np.zeros(4)))
        fl, pp = _t([f, f]), _t([W / 2, H / 2])
        n, s = render._undistort_grid(fl, pp, dist, height=H, width=W)
        ys, xs = np.mgrid[0:H, 0:W]
        nd = np.stack([(xs + 0.5 - W / 2) / f, (ys + 0.5 - H / 2) / f], -1)
        r_d = np.sqrt((nd**2).sum(-1))
        assert np.tan(r_d.max()) > 3.0 * r_d.max()
        back = geometry.distort_normalized(n, dist).numpy()
        assert np.abs(back - nd).max() < 5e-3
        assert float(s) * f * np.tan(r_d.max()) <= np.hypot(W, H) / 2 + 1
        # against JAX: a ray's radius carries tan's condition number times
        # the last-bit gap of atan / sqrt between the two backends
        jn, js = jrender._undistort_grid(fl.numpy(), pp.numpy(),
                                         dist.numpy(), height=H, width=W)
        r_n = np.sqrt((n.numpy()**2).sum(-1))
        tol = GRID_ATOL + 4 * EPS32 * _tan_condition(r_n) * r_n
        assert (np.abs(n.numpy() - np.asarray(jn)).max(-1) <= tol).all()
        np.testing.assert_allclose(float(s), float(js), rtol=S_RTOL * 10)

    def test_no_ray_corners_do_not_shrink_focal(self):
        W, H, f = 96, 72, 25.0  # corner r_d 2.4: beyond the lens' response
        dist = _t(wire_fisheye(np.zeros(4)))
        fl, pp = _t([f, f]), _t([W / 2, H / 2])
        n, s = render._undistort_grid(fl, pp, dist, height=H, width=W)
        assert bool(torch.isfinite(n).all())
        r_max_valid = np.tan(1.55 * 0.999)
        s_expect = (W / 2) / (f * r_max_valid)
        assert float(s) > 0.5 * s_expect, (float(s), s_expect)
        # s is set by the widest valid ray, at theta ~ 1.548 where tan
        # turns one last bit of atan into ~75 of the radius
        _, js = jrender._undistort_grid(fl.numpy(), pp.numpy(), dist.numpy(),
                                        height=H, width=W)
        cond = _tan_condition(r_max_valid)
        assert 50 < cond < 100
        np.testing.assert_allclose(float(s), float(js),
                                   rtol=2 * EPS32 * cond)

    @pytest.mark.parametrize(
        "dist", [wire_fisheye(FISH_K4), wire_fov(0.8),
                 wire_thin_prism(TPF_K8), wire_full_opencv(FULL_K)],
        ids=["fisheye", "fov", "thin_prism", "full_opencv"])
    def test_principal_point_on_a_pixel_centre(self, dist):
        """With the principal point on a pixel centre, that pixel's ray is
        xy = 0 exactly, where sqrt's tangent is NaN: the `where`s of the
        forward map keep the Jacobian finite, and the grid equals JAX's."""
        W, H = 96, 72
        fl, pp = _t([60.0, 60.0]), _t([48.5, 36.5])
        n, s = render._undistort_grid(fl, pp, _t(dist), height=H, width=W)
        assert float(n[36, 48].abs().max()) == 0.0
        assert bool(torch.isfinite(n).all())
        jn, js = jrender._undistort_grid(fl.numpy(), pp.numpy(), dist,
                                         height=H, width=W)
        np.testing.assert_allclose(n.numpy(), np.asarray(jn), atol=GRID_ATOL)
        np.testing.assert_allclose(float(s), float(js), rtol=S_RTOL)
