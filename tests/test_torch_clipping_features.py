"""The clip_near=True cases of tests/test_feature_matrix.py and
tests/test_bucketing.py for semantic_meshes_torch, against the JAX package
on the CPU: both rasterizers and texel mode under clipping equal JAX's xla
oracle, and bucketing changes no output.

Ids compare exactly with JAX run op by op (under jit XLA's FMAs move a
few edge pixels of triangles that cross the near plane), depths at rtol
2e-5; texel ids may differ on at most 1e-3 of the covered pixels, each
inside the same triangle (tests/test_torch_texels.py).
"""

import jax
import numpy as np
import pytest
import torch

import semantic_meshes
from semantic_meshes import testing as jtesting
from semantic_meshes_torch import convert, data, render, testing
from semantic_meshes_torch.io.ply import write_mesh

H, W = 64, 128
DEPTH_RTOL = 2e-5
MISMATCH = 1e-3
BG = 0xFFFFFFFF


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
def cube3(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cube3")
    vertices, faces = testing.make_cube(3)
    write_mesh(tmp / "c.ply", vertices, faces)
    cams = testing.make_ring_cameras(num_views=2, width=W, height=H)
    jcams = jtesting.make_ring_cameras(num_views=2, width=W, height=H)
    return (data.Ply(str(tmp / "c.ply")),
            semantic_meshes.data.Ply(str(tmp / "c.ply")), cams, jcams)


@pytest.mark.parametrize("backend", [None, "dense"])
def test_texels_feature_stack(cube3, backend):
    """tests/test_feature_matrix.py's texel stack under clipping: the port
    (tile or dense, bucketed) against JAX's xla
    oracle, on the cube's well-conditioned texels."""
    mesh, jmesh, cams, jcams = cube3
    base = semantic_meshes.render.texels(jmesh, jcams, 1.5, backend="xla",
                                         clip_near=True, bucket=False)
    full = render.texels(mesh, cams, 1.5, backend=backend, clip_near=True,
                         bucket=True, device="cpu")
    assert base.getPrimitivesNum() == full.getPrimitivesNum()
    first = np.asarray(base.first_texel_index)
    tri_r = render.triangles(convert.ply(jmesh), clip_near=True,
                             backend=backend, device="cpu")
    for cam, jcam in zip(cams, jcams):
        i0, _ = base.render(jcam)
        i1, _ = full.render(cam)
        # the texel renderer's faces are reordered, its triangle ids not
        tri = tri_r.render(cam)[0].view(torch.int32).numpy()
        _assert_texels_match(_u32(i1), np.asarray(i0), first, tri)


def _random_scene(tmp_path, seed, t=60):
    rng = np.random.default_rng(seed)
    vertices = (rng.normal(size=(t, 3)) * 1.5).astype(np.float32)
    faces = rng.integers(0, t, size=(t, 3)).astype(np.int32)
    write_mesh(tmp_path / f"s{seed}.ply", vertices, faces)
    path = str(tmp_path / f"s{seed}.ply")
    return data.Ply(path), semantic_meshes.data.Ply(path)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_triangles_feature_stack(tmp_path, seed):
    """tests/test_feature_matrix.py's triangle stack under clipping: both
    port backends equal JAX's xla oracle run op by op (ids exactly; under
    jit FMAs move a few edge pixels of the straddlers) and each other (ids
    and depth bits) on random scenes."""
    mesh, jmesh = _random_scene(tmp_path, seed)
    cams = testing.make_ring_cameras(num_views=2, width=128, height=64)
    jcams = jtesting.make_ring_cameras(num_views=2, width=128, height=64)
    base = semantic_meshes.render.triangles(jmesh, backend="xla",
                                            clip_near=True, bucket=False)
    ports = [render.triangles(mesh, backend=b, clip_near=True, device="cpu")
             for b in (None, "dense")]
    for cam, jcam in zip(cams, jcams):
        with jax.disable_jit():
            i0, d0 = (np.asarray(x) for x in base.render(jcam))
        (ia, da), (ib, db) = (r.render(cam) for r in ports)
        fin = np.isfinite(d0)
        np.testing.assert_allclose(da.numpy()[fin], d0[fin], rtol=DEPTH_RTOL)
        np.testing.assert_array_equal(_u32(ia), i0, err_msg=f"seed {seed}")
        assert torch.equal(ia, ib)
        assert torch.equal(da.view(torch.int32), db.view(torch.int32))


def test_bucketed_clip_renders_and_sizing_match(cube3):
    """tests/test_bucketing.py's clip cases: JAX's bucket=True equals its
    bucket=False under clipping, and the port equals both: ids, depths at
    rtol 2e-5, texel resolutions (the bucketed port pads as JAX does: its
    resolutions equal JAX's over the padded rows, 0 on the padding)."""
    mesh, jmesh, cams, jcams = cube3
    want = [semantic_meshes.render.triangles(
        jmesh, clip_near=True, bucket=b).render(jcams[0]) for b in (False,
                                                                    True)]
    np.testing.assert_array_equal(np.asarray(want[0][0]),
                                  np.asarray(want[1][0]))
    ids, depth = render.triangles(mesh, clip_near=True,
                                  device="cpu").render(cams[0])
    np.testing.assert_array_equal(_u32(ids), np.asarray(want[1][0]))
    np.testing.assert_allclose(depth.numpy(), np.asarray(want[1][1]),
                               rtol=DEPTH_RTOL)
    jr = semantic_meshes.render.texels(jmesh, jcams, 1.5, bucket=True,
                                       clip_near=True)
    n = len(mesh.faces)
    for bucket in (False, True):
        r = render.texels(mesh, cams, 1.5, bucket=bucket, clip_near=True,
                          device="cpu")
        np.testing.assert_array_equal(
            r.resolutions.numpy(),
            np.asarray(jr.resolutions)[:None if bucket else n])
