"""Property tests of the port's rasterizers (semantic_meshes_torch.rasterize
on the CPU, the kernels' plain versions): both backends, tile and dense,
agree with a brute-force z-buffer oracle across random scenes and
cameras, cull a triangle crossing z = 0 alike, and keep 1e8 coordinates
from poisoning a near triangle. Mirror of tests/test_rasterize_property.py
(which runs the JAX package's xla, pallas and dense backends), with the
oracle on the port's own projection and barycentrics.
"""

import numpy as np
import pytest
import torch

from semantic_meshes_torch import geometry, rasterize
from semantic_meshes_torch.rasterize import tiles

BACKENDS = ("tile", "dense")


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float32))


def brute_force(vertices, faces, rot, trans, fl, pp, h, w):
    """Per pixel centre, the nearest triangle (every vertex in front of
    Z_NEAR, nonzero area) that covers it: (ids (h, w) -1 empty, depth)."""
    pix, z = tiles.project_vertices(_t(vertices), _t(rot), _t(trans),
                                    _t(fl), _t(pp))
    pix, z = pix.numpy(), z.numpy()
    best_z = np.full((h, w), np.inf, np.float32)
    best_i = np.full((h, w), -1, np.int64)
    ys, xs = np.mgrid[0:h, 0:w]
    pts = torch.from_numpy(np.stack([xs + 0.5, ys + 0.5], -1).astype(
        np.float32))
    for t, f in enumerate(faces):
        if np.any(z[f] <= tiles.Z_NEAR):
            continue
        a, b, c = (torch.from_numpy(pix[v]) for v in f)
        if float(geometry.signed_area2(a, b, c)) == 0:
            continue
        bary = geometry.barycentric_2d(pts, a, b, c).numpy()
        inside = np.all(bary >= 0, axis=-1)
        inv_z = bary @ (1.0 / z[f])
        with np.errstate(divide="ignore"):
            zz = 1.0 / inv_z
        ok = inside & (inv_z > 0) & (zz < best_z)
        best_z = np.where(ok, zz, best_z)
        best_i = np.where(ok, t, best_i)
    return best_i, best_z


def random_camera(rng, w, h):
    # a random orientation looking roughly at the origin from 4-6 units
    direction = rng.normal(size=3)
    direction /= np.linalg.norm(direction)
    eye = -direction * rng.uniform(4, 6)
    up = rng.normal(size=3)
    rot, trans = geometry.look_at(eye, [0, 0, 0], up)
    f = rng.uniform(30, 90)
    return (np.asarray(rot, np.float32), np.asarray(trans, np.float32),
            np.array([f, f * rng.uniform(0.8, 1.2)], np.float32),
            np.array([w / 2 + rng.uniform(-5, 5),
                      h / 2 + rng.uniform(-5, 5)], np.float32))


def _render(backend, vertices, faces, cam, h, w):
    tri, depth, _ = rasterize.rasterize(vertices, faces, *cam, height=h,
                                        width=w, backend=backend,
                                        device="cpu")
    return tri.numpy(), depth.numpy()


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_backends_match_bruteforce(seed, backend):
    rng = np.random.default_rng(seed)
    h, w = 64, 128
    V = 50
    vertices = (rng.normal(size=(V, 3)) * rng.uniform(0.1, 2)).astype(
        np.float32)
    faces = rng.integers(0, V, size=(35, 3)).astype(np.int32)
    cam = random_camera(rng, w, h)
    ref_i, ref_z = brute_force(vertices, faces, *cam, h, w)
    tri, depth = _render(backend, vertices, faces, cam, h, w)
    mismatch = tri != ref_i
    # a tiny fraction of edge pixels may round the other way
    assert mismatch.mean() < 0.003, f"{backend}: {mismatch.sum()} pixels"
    both = (tri >= 0) & ~mismatch
    assert both.any()
    np.testing.assert_allclose(depth[both], ref_z[both], rtol=2e-4)


def _near_scene(far):
    first = ([[-1e8, -1e8, 1e8], [1e8, -1e8, 1e8], [0, 1e8, 1e8]] if far
             else [[-1, -1, 2], [1, -1, 2], [0, 1, -1]])
    second = ([[-0.5, -0.5, 2], [0.5, -0.5, 2], [0, 0.75, 2]] if far
              else [[-1, -1, 3], [1, -1, 3], [0, 1, 3]])
    vertices = np.array(first + second, np.float32)
    faces = np.array([[0, 1, 2], [3, 4, 5]], np.int32)
    cam = (np.eye(3, dtype=np.float32), np.zeros(3, np.float32),
           np.array([40.0, 40.0], np.float32),
           np.array([64.0, 32.0], np.float32))
    return vertices, faces, cam


def test_near_plane_crossing_consistent():
    """A triangle crossing z = 0 is culled alike by both backends."""
    vertices, faces, cam = _near_scene(far=False)
    results = [_render(b, vertices, faces, cam, 64, 128)[0]
               for b in BACKENDS]
    for tri in results:
        assert not (tri == 0).any()  # the crossing triangle is culled
        assert (tri == 1).any()  # the one in front is rendered
    np.testing.assert_array_equal(results[0], results[1])


@pytest.mark.parametrize("backend", BACKENDS)
def test_huge_coordinates_no_nan_poisoning(backend):
    """Geometry at 1e8 does not poison the near triangle through inf or
    NaN."""
    vertices, faces, cam = _near_scene(far=True)
    tri, depth = _render(backend, vertices, faces, cam, 64, 128)
    assert (tri == 1).any()  # the near triangle is still rendered
    assert np.isfinite(depth[tri == 1]).all()
