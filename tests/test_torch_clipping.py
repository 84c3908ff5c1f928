"""Parity of semantic_meshes_torch's near-plane clipping with the JAX
package on the CPU: `geometry.clip_triangles_near`, the clipped setup and
both rasterizers under clip_near. Mirrors tests/test_clipping.py
(TestClipTrianglesNear, TestClippedRasterization) and
tests/test_dense_rasterizer.py's test_tri_ids_clip_near_raises; the dense
path's probes and n_global cap are in tests/test_torch_clipping_dense.py.

Tolerances. The port rounds every op on its own. JAX run op by op
(`jax.disable_jit()`) does too in the clipper and the setup, so pieces are
bit-equal there and ids exact; depths compare at rtol 2e-5 because the
Pallas kernels contract their forms into FMAs even op by op (see
tests/test_torch_rasterize.py). Under jit XLA also contracts the clipper's
p0 + t * (p1 - p0) and the setup; a piece pinned at z = 1e-4 projects to
~1e4 x the focal length, so the contraction moves a straddler's depth by
up to ~1e-3: test_clipped_depth_gap_is_xla_fma_contraction is the
witness. Ids equal jitted JAX's on these scenes, whose depths are well
separated.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_meshes import geometry as jgeometry
from semantic_meshes import rasterize as jrast
from semantic_meshes import testing as jtesting
from semantic_meshes.data import stack_cameras
from semantic_meshes.rasterize import pallas_kernel, xla
from semantic_meshes_torch import geometry
from semantic_meshes_torch import rasterize as trast
from semantic_meshes_torch.rasterize import dense, tile_kernel, tiles

CAM = (
    np.eye(3, dtype=np.float32), np.zeros(3, np.float32),
    np.array([40.0, 40.0], np.float32), np.array([64.0, 32.0], np.float32),
)
H, W = 64, 128
DEPTH_RTOL = 2e-5
PORTS = {"tile": tile_kernel, "dense": dense}


def _pieces(cam_verts, znear):
    """(port pieces, port valid, JAX pieces, JAX valid) as numpy, JAX op
    by op."""
    pieces, valid = geometry.clip_triangles_near(torch.from_numpy(cam_verts),
                                                 znear)
    with jax.disable_jit():
        jp, jv = jgeometry.clip_triangles_near(jnp.asarray(cam_verts), znear)
    return pieces.numpy(), valid.numpy(), np.asarray(jp), np.asarray(jv)


def _check_pieces(cam_verts, znear):
    """Port == JAX op by op: validity exactly, valid pieces bit for bit.
    Returns the port's (pieces, valid)."""
    p, v, jp, jv = _pieces(cam_verts, znear)
    np.testing.assert_array_equal(v, jv)
    np.testing.assert_array_equal(p[v].view(np.int32), jp[jv].view(np.int32))
    return p, v


class TestClipTrianglesNear:
    def test_fully_in_front(self):
        cam = np.array([[[0, 0, 1], [1, 0, 2], [0, 1, 3]]], np.float32)
        pieces, valid = _check_pieces(cam, 1e-4)
        assert valid[0, 0] and not valid[0, 1]
        np.testing.assert_array_equal(pieces[0, 0], cam[0])

    def test_fully_behind(self):
        cam = np.array([[[0, 0, -1], [1, 0, -2], [0, 1, -3]]], np.float32)
        _, valid = _check_pieces(cam, 1e-4)
        assert not valid.any()

    def test_one_vertex_in_front(self):
        znear = 0.5
        cam = np.array([[[0, 0, 2], [4, 0, -1], [0, 4, -1]]], np.float32)
        pieces, valid = _check_pieces(cam, znear)
        assert valid[0, 0] and not valid[0, 1]
        p = pieces[0, 0]
        assert p[:, 2].min() == np.float32(znear)
        # intersections at t = (0.5 - 2) / (-1 - 2) = 0.5 along both edges
        np.testing.assert_allclose(p[1], [2, 0, znear], atol=1e-5)
        np.testing.assert_allclose(p[2], [0, 2, znear], atol=1e-5)

    def test_two_vertices_in_front_gives_quad(self):
        znear = 0.5
        cam = np.array([[[0, 0, 2], [4, 0, 2], [0, 4, -1]]], np.float32)
        pieces, valid = _check_pieces(cam, znear)
        assert valid[0].all()
        assert (pieces[0, :, :, 2] >= np.float32(znear)).all()

        def area3d(tri):
            return 0.5 * np.linalg.norm(
                np.cross(tri[1] - tri[0], tri[2] - tri[0]))

        # the removed corner is the similar triangle at factor 0.5
        clipped = area3d(pieces[0, 0]) + area3d(pieces[0, 1])
        np.testing.assert_allclose(clipped, area3d(cam[0]) * 0.75,
                                   rtol=1e-5)


def _straddle_scene(seed=8):
    """tests/test_clipping.py's scene of many triangles across the camera
    plane (no +z shift)."""
    rng = np.random.default_rng(seed)
    vertices = rng.normal(size=(40, 3)).astype(np.float32) * 2
    faces = rng.integers(0, 40, size=(30, 3)).astype(np.int32)
    return vertices, faces


@pytest.fixture(scope="module")
def straddle():
    """The straddling scene and JAX's clipped xla render of it, op by op:
    (vertices, faces, (ids, depth, overflow)). JAX's own test holds its
    xla, Pallas and dense backends to the same ids there."""
    vertices, faces = _straddle_scene()
    with jax.disable_jit():
        out = xla.rasterize(vertices, faces, *CAM, height=H, width=W,
                            clip_near=True)
    return vertices, faces, tuple(np.asarray(x) for x in out)


def test_clip_pieces_of_a_straddling_scene_match_jax(straddle):
    """Every piece of the straddling scene, in camera space (the camera is
    the identity), equals JAX's op by op; so do the 2T setup rows."""
    vertices, faces, _ = straddle
    _, valid = _check_pieces(vertices[faces], 1e-4)
    assert valid[:, 1].any() and (~valid[:, 0]).any()  # quads and culls
    with jax.disable_jit():
        want = xla.setup_clipped(jnp.asarray(vertices[faces]),
                                 *(jnp.asarray(c) for c in CAM))
    got = tiles.setup_inputs(None, None, *CAM, face_vertices=vertices[faces],
                             device="cpu", clip_near=True)
    assert got["denom"].shape[0] == 2 * len(faces)
    np.testing.assert_array_equal(got["valid"].numpy(),
                                  np.asarray(want["valid"]))
    ok = got["valid"].numpy()
    for key in ("a", "b", "c", "az", "bz", "cz", "xmin", "ymax"):
        np.testing.assert_array_equal(
            got[key].numpy()[ok].view(np.int32),
            np.asarray(want[key])[ok].view(np.int32), err_msg=key)


@pytest.mark.parametrize("port", ["tile", "dense"])
def test_backends_agree_on_clipped_scene(straddle, port):
    """Both rasterizers of the port equal JAX's xla backend on the
    straddling scene: ids, empty pixels and overflow exactly, depths bit
    for bit (xla resolves without a kernel, so nothing contracts op by
    op)."""
    vertices, faces, (want_ids, want_z, want_ov) = straddle
    ids, depth, overflow = PORTS[port].rasterize(
        vertices, faces, *CAM, height=H, width=W, clip_near=True,
        device="cpu")
    ids, depth = ids.numpy(), depth.numpy()
    assert (ids >= 0).mean() > 0.9 and int(overflow) == int(want_ov) == 0
    np.testing.assert_array_equal(ids, want_ids)
    np.testing.assert_array_equal(depth.view(np.int32), want_z.view(np.int32))


def test_clipped_depth_gap_is_xla_fma_contraction(straddle):
    """Witness for comparing clipped depths with JAX op by op: jitted JAX
    differs from JAX op by op exactly as it differs from the port, by up
    to ~1e-3 relative on this scene, while the ids agree everywhere."""
    vertices, faces, (want_ids, want_z, _) = straddle
    ids, depth, _ = xla.rasterize(vertices, faces, *CAM, height=H, width=W,
                                  clip_near=True)
    ids, depth = np.asarray(ids), np.asarray(depth)
    port = tile_kernel.rasterize(vertices, faces, *CAM, height=H, width=W,
                                 clip_near=True, device="cpu")[1].numpy()
    np.testing.assert_array_equal(ids, want_ids)
    fin = np.isfinite(depth)
    gap_op = np.abs(depth[fin] - want_z[fin]) / depth[fin]
    gap_port = np.abs(depth[fin] - port[fin]) / depth[fin]
    np.testing.assert_array_equal(gap_op, gap_port)
    assert 1e-5 < gap_op.max() < 1e-2


@pytest.mark.parametrize("port", ["tile", "dense"])
def test_crossing_triangle_partially_rendered(port):
    """A floor from behind the camera (z = -2) to far ahead (z = 10): its
    in-front part fills the lower half of the image with the analytic
    depth, where culling shows nothing; ids equal JAX's Pallas kernel's,
    op by op (under jit an FMA moves one edge pixel of this floor)."""
    vertices = np.array([[-5, 0.8, -2], [5, 0.8, -2], [0, 0.8, 10]],
                        np.float32)
    faces = np.array([[0, 1, 2]], np.int32)
    mod = PORTS[port]
    ids, depth, _ = mod.rasterize(vertices, faces, *CAM, height=H, width=W,
                                  clip_near=True, device="cpu")
    ids, depth = ids.numpy(), depth.numpy()
    assert (ids == 0).any()
    assert np.isfinite(depth[ids == 0]).all() and (depth[ids == 0] > 0).all()
    ys, xs = np.nonzero(ids == 0)
    expect = 40.0 * 0.8 / (ys + 0.5 - 32.0)
    # the clipped vertex sits at z = 1e-4 (inv_z = 1e4); interpolating
    # that plane in f32 costs ~0.2% at distant pixels (as in JAX's test)
    np.testing.assert_allclose(depth[ys, xs], expect, rtol=5e-3)
    culled = mod.rasterize(vertices, faces, *CAM, height=H, width=W,
                           device="cpu")[0]
    assert not bool((culled == 0).any())
    with jax.disable_jit():
        want = pallas_kernel.rasterize(vertices, faces, *CAM, height=H,
                                       width=W, clip_near=True)
    np.testing.assert_array_equal(ids, np.asarray(want[0]))
    fin = np.isfinite(np.asarray(want[1]))
    np.testing.assert_allclose(depth[fin], np.asarray(want[1])[fin],
                               rtol=DEPTH_RTOL)


@pytest.mark.parametrize("port", ["tile", "dense"])
def test_ids_map_to_original_triangles(port):
    rng = np.random.default_rng(9)
    vertices = rng.normal(size=(30, 3)).astype(np.float32) * 2
    faces = rng.integers(0, 30, size=(12, 3)).astype(np.int32)
    ids = PORTS[port].rasterize(vertices, faces, *CAM, height=H, width=W,
                                clip_near=True, device="cpu")[0]
    want = xla.rasterize(vertices, faces, *CAM, height=H, width=W,
                         clip_near=True)[0]
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want))
    assert int(ids.max()) < len(faces) and bool((ids >= 0).any())


@pytest.mark.parametrize("port", ["tile", "dense"])
def test_clip_matches_cull_when_all_in_front(port):
    vertices, faces = jtesting.make_cube(4)
    cams = jtesting.make_ring_cameras(num_views=1, width=W, height=H)
    rot, trans, fl, pp = stack_cameras(cams)
    cam = (rot[0], trans[0], fl[0], pp[0])
    a = PORTS[port].rasterize(vertices, faces, *cam, height=H, width=W,
                              device="cpu")
    b = PORTS[port].rasterize(vertices, faces, *cam, height=H, width=W,
                              clip_near=True, device="cpu")
    assert torch.equal(a[0], b[0]) and bool((a[0] >= 0).any())
    fin = torch.isfinite(a[1])
    assert torch.equal(fin, torch.isfinite(b[1]))
    np.testing.assert_allclose(a[1][fin].numpy(), b[1][fin].numpy(),
                               rtol=1e-5)
    want = xla.rasterize(vertices, faces, *cam, height=H, width=W,
                         clip_near=True)
    np.testing.assert_array_equal(b[0].numpy(), np.asarray(want[0]))


def test_tri_ids_clip_near_raises():
    """The dense rasterizer writes tri_ids where ids are born, into rows
    that are clip pieces under clip_near: refused, as in JAX; the tile
    rasterizer remaps after the piece -> triangle map, as JAX's dispatch."""
    v, f = jtesting.make_cube(4)
    cam = jtesting.make_ring_cameras(num_views=1, width=64, height=48)[0]
    args = (cam.rotation, cam.translation, cam.focal_lengths,
            cam.principal_point)
    perm = np.random.default_rng(0).permutation(len(f)).astype(np.int32)
    with pytest.raises(ValueError, match="clip_near"):
        dense.rasterize(v, f, *args, height=48, width=64, clip_near=True,
                        tri_ids=perm, device="cpu")
    with pytest.raises(ValueError, match="clip_near"):
        trast.rasterize(v, f, *args, height=48, width=64, clip_near=True,
                        tri_ids=perm, backend="dense", device="cpu")
    got = trast.rasterize(v, f, *args, height=48, width=64, clip_near=True,
                          tri_ids=perm, backend="tile", device="cpu")[0]
    want = jrast.rasterize(v, f, *args, height=48, width=64, clip_near=True,
                           tri_ids=perm, backend="xla")[0]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert bool((got >= 0).any())
