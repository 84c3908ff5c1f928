"""Parity of semantic_meshes_torch's geometry, scene and IO helpers with
the JAX package, on the CPU. Inputs are made with numpy from a seed and fed
to both sides."""

import numpy as np
import pytest
import torch

from semantic_meshes import geometry as jgeo
from semantic_meshes import testing as jtesting
from semantic_meshes import utils as jutils
from semantic_meshes.io import colmap as jcolmap
from semantic_meshes.io import ply as jply
from semantic_meshes_torch import data, geometry, testing, utils
from semantic_meshes_torch.io import colmap, ply

RTOL = 1e-6  # one f32 rounding per op; the JAX side may contract to FMA


def _rotation(rng):
    q = rng.normal(size=4)
    return np.array(jgeo.quaternion_to_rotation(q), np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rigid_transform_matches_jax(seed):
    rng = np.random.default_rng(seed)
    rot = _rotation(rng)
    trans = rng.normal(size=3).astype(np.float32)
    pts = rng.normal(size=(50, 3)).astype(np.float32)
    want = np.asarray(jgeo.rigid_transform(rot, trans, pts))
    got = geometry.rigid_transform(
        torch.from_numpy(rot), torch.from_numpy(trans), torch.from_numpy(pts)
    ).numpy()
    # coordinates that cancel to ~0 get an absolute floor of a few ulp of
    # the operands (|R p| + |t| ~ 4)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=4e-6)


@pytest.mark.parametrize("seed", [0, 1])
def test_pinhole_project_matches_jax(seed):
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(40, 3)).astype(np.float32)
    pts[:, 2] = np.abs(pts[:, 2]) + 1.0
    fl = np.array([500.0, 480.0], np.float32)
    pp = np.array([320.0, 240.0], np.float32)
    want = np.asarray(jgeo.pinhole_project(fl, pp, pts))
    got = geometry.pinhole_project(
        torch.from_numpy(fl), torch.from_numpy(pp), torch.from_numpy(pts)
    ).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL)


def test_look_at_and_quaternion_match_jax():
    rng = np.random.default_rng(3)
    for _ in range(5):
        eye = rng.normal(size=3) * 3
        r1, t1 = jgeo.look_at(eye, [0, 0, 0], [0, 1, 0])
        r2, t2 = geometry.look_at(eye, [0, 0, 0], [0, 1, 0])
        np.testing.assert_array_equal(r1, r2)
        np.testing.assert_array_equal(t1, t2)
        q = rng.normal(size=4)
        np.testing.assert_allclose(
            geometry.quaternion_to_rotation(q),
            np.asarray(jgeo.quaternion_to_rotation(q)), rtol=RTOL, atol=1e-7,
        )


def test_scene_helpers_match_jax():
    v1, f1 = jtesting.make_cube(4)
    v2, f2 = testing.make_cube(4)
    np.testing.assert_array_equal(v1, v2)
    np.testing.assert_array_equal(f1, f2)
    for c1, c2 in zip(jtesting.make_ring_cameras(3, 64, 48),
                      testing.make_ring_cameras(3, 64, 48)):
        for k in ("rotation", "translation", "focal_lengths",
                  "principal_point", "distortion"):
            np.testing.assert_array_equal(getattr(c1, k), getattr(c2, k))
        assert c1.resolution == c2.resolution
    p1 = jtesting.random_probs(np.random.default_rng(0), 8, 6, 4, 0.3)
    p2 = testing.random_probs(np.random.default_rng(0), 8, 6, 4, 0.3)
    np.testing.assert_array_equal(p1, p2)
    np.testing.assert_array_equal(utils.distinct_colors(11),
                                  jutils.distinct_colors(11))


def test_ply_round_trip_both_ways(tmp_path):
    v, f = testing.make_cube(2)
    colors = (np.arange(len(f))[:, None] * [3, 5, 7] % 256).astype(np.uint8)
    ply.write_mesh(tmp_path / "a.ply", v, f, colors)
    jply.write_mesh(tmp_path / "b.ply", v, f, colors, binary=False)
    for p in ("a.ply", "b.ply"):
        mesh = data.Ply(tmp_path / p)
        np.testing.assert_array_equal(mesh.vertices, v)
        np.testing.assert_array_equal(mesh.faces, f)
        jv, jf = jply.read_mesh(tmp_path / p)
        np.testing.assert_array_equal(jv, mesh.vertices)
        np.testing.assert_array_equal(jf, mesh.faces)
    mesh.save(tmp_path / "c.ply", torch.from_numpy(colors))
    face = ply.read_ply(tmp_path / "c.ply")["face"].data
    np.testing.assert_array_equal(
        np.stack([face["red"], face["green"], face["blue"]], -1), colors
    )
    with pytest.raises(ValueError):
        mesh.save(tmp_path / "d.ply", colors[:-1])


def _write_colmap_bin(root, cams, images):
    import struct

    with open(root / "cameras.bin", "wb") as fh:
        fh.write(struct.pack("<Q", len(cams)))
        for cid, (model, w, h, params) in cams.items():
            fh.write(struct.pack("<iiQQ", cid, model, w, h))
            fh.write(np.asarray(params, "<f8").tobytes())
    with open(root / "images.bin", "wb") as fh:
        fh.write(struct.pack("<Q", len(images)))
        for iid, (q, t, cid, name) in images.items():
            fh.write(struct.pack("<i", iid))
            fh.write(np.asarray(q, "<f8").tobytes())
            fh.write(np.asarray(t, "<f8").tobytes())
            fh.write(struct.pack("<i", cid))
            fh.write(name.encode() + b"\x00")
            fh.write(struct.pack("<Q", 1))
            fh.write(np.zeros(3, "<f8").tobytes())  # one (x, y, id) point


@pytest.mark.parametrize("fmt", ["bin", "txt"])
def test_colmap_workspace_matches_jax(tmp_path, fmt):
    rng = np.random.default_rng(5)
    images = {
        i + 1: (rng.normal(size=4), rng.normal(size=3), 1 + i % 2,
                f"img_{3 - i}.jpg")
        for i in range(3)
    }
    if fmt == "bin":
        _write_colmap_bin(tmp_path, {
            1: (1, 64, 48, [50.0, 52.0, 32.0, 24.0]),  # PINHOLE
            2: (2, 64, 48, [51.0, 30.0, 20.0, 0.01]),  # SIMPLE_RADIAL
        }, images)
    else:
        jcams = {
            1: jcolmap.ColmapCamera(1, "PINHOLE", 64, 48,
                                    np.array([50.0, 52.0]),
                                    np.array([32.0, 24.0])),
            2: jcolmap.ColmapCamera(2, "SIMPLE_RADIAL", 64, 48,
                                    np.array([51.0, 51.0]),
                                    np.array([30.0, 20.0]),
                                    np.array([0.01, 0, 0, 0])),
        }
        jcolmap.write_cameras_txt(tmp_path / "cameras.txt", jcams)
        jcolmap.write_images_txt(tmp_path / "images.txt", {
            i: jcolmap.ColmapImage(i, q, t, c, n)
            for i, (q, t, c, n) in images.items()
        })
    from semantic_meshes.data import Colmap as JColmap

    want = JColmap(str(tmp_path))
    got = data.Colmap(str(tmp_path))
    assert got.getImageNum() == want.getImageNum() == 3
    for i in range(3):
        assert got.getImageName(i) == want.getImageName(i)
        c1, c2 = want.getCamera(i), got.getCamera(i)
        np.testing.assert_allclose(c2.rotation, c1.rotation, rtol=RTOL,
                                   atol=1e-7)
        for k in ("translation", "focal_lengths", "principal_point",
                  "distortion"):
            np.testing.assert_array_equal(getattr(c2, k), getattr(c1, k))
        assert c2.resolution == c1.resolution
    assert got.getImageIndex("some/dir/img_1.jpg") == 0
    with pytest.raises(KeyError):
        got.getCamera("missing.jpg")
    with pytest.raises(colmap.ColmapError):
        data.Colmap(str(tmp_path / "nowhere"))
