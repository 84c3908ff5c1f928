"""The `faces` mesh axis of semantic_meshes_torch's make_sharded_fuse in a
4-rank gloo world on the CPU: each rank rasterizes a block of T / faces
triangles and the blocks' winners merge per pixel by (z bits, global id)
with int32 MIN all-reduces. Mirrors tests/test_end_to_end.py's
TestFacesAxisSharding (:430, :470, :515) at 4 ranks, against the JAX
package's make_sharded_fuse at the same layout on 4 virtual devices and
the port's fuse_views / fuse_views_texels (rtol 2e-5, atol 1e-5). The
merged ids of every band equal one device's full render exactly."""

import jax.numpy as jnp
import numpy as np
import pytest

import _torch_sharded as ts
from semantic_meshes import geometry as jgeo
from semantic_meshes import rasterize as jrast
from semantic_meshes import testing as jtesting
from semantic_meshes.data import stack_cameras
from semantic_meshes_torch import distributed
from semantic_meshes_torch import rasterize as rast

RTOL, ATOL = 2e-5, 1e-5
H, W, C = 128, 160, 3
ARGS = ("vertices", "faces", "rot", "trans", "fl", "pp", "probs", "iew")
WARGS = ARGS + ("weights",)
LAYOUTS = [(2, 1, 2), (1, 2, 2), (1, 1, 4)]


def scene():
    vertices, faces = jtesting.make_cube(subdivisions=5)
    cams = jtesting.make_ring_cameras(num_views=4, width=W, height=H)
    rng = np.random.default_rng(11)
    probs = np.stack([jtesting.random_probs(rng, H, W, C) for _ in cams])
    rot, trans, fl, pp = stack_cameras(cams)
    weights = np.random.default_rng(17).uniform(
        0.25, 1.75, size=(len(cams), H, W)).astype(np.float32)
    return dict(vertices=vertices, faces=faces, rot=rot, trans=trans, fl=fl,
                pp=pp, probs=probs, iew=np.float32(0.5), weights=weights)


INPUTS = scene()
T = len(INPUTS["faces"])
KW = dict(num_primitives=T, aggregator="sum", height=H, width=W)


def texel_tables():
    """6 texels a face (resolution 3) on the texel-reordered faces; P =
    1800 divides by the 4 ranks."""
    faces_t = np.asarray(jgeo.reorder_faces_for_texels(
        jnp.asarray(INPUTS["vertices"]), jnp.asarray(INPUTS["faces"])))
    return dict(INPUTS, faces=faces_t, res=np.full((T,), 3, np.int32),
                first=(np.arange(T) * 6).astype(np.int32))


def name(layout):
    return "tri_" + "".join(map(str, layout))


@pytest.fixture(scope="module")
def texels():
    return texel_tables()


@pytest.fixture(scope="module")
def world(tmp_path_factory, texels):
    tmp = tmp_path_factory.mktemp("sharded_faces")
    np.savez(tmp / "tri.npz", **INPUTS)
    np.savez(tmp / "texels.npz", **texels)
    np.savez(tmp / "odd.npz", **dict(INPUTS, faces=INPUTS["faces"][:T - 1]))
    cases = [ts.case(name(layout), layout, tmp / "tri.npz", WARGS,
                     with_weights=True, repeat=True, face_ids=True, **KW)
             for layout in LAYOUTS]
    cases += [
        ts.case("texels_122", (1, 2, 2), tmp / "texels.npz", ARGS,
                num_primitives=6 * T, aggregator="mul", height=H, width=W,
                texel_params=["res", "first"], shard_primitives=True),
        ts.case("odd_114", (1, 1, 4), tmp / "odd.npz", ARGS,
                num_primitives=T - 1, aggregator="sum", height=H, width=W),
    ]
    w = ts.World(tmp, cases)
    yield w
    w.close()


@pytest.mark.parametrize("layout", LAYOUTS, ids=name)
def test_triangles_matches_single_chip(world, layout):
    args = [INPUTS[k] for k in WARGS]
    ref, ref_ov = ts.jax_sharded(layout, *args, with_weights=True, **KW)
    got, ov = world.replicated(name(layout))
    one, one_ov = distributed.fuse_views(*args, device="cpu", **KW)
    assert ov == ref_ov == int(one_ov) == 0
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, one.numpy(), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("layout", LAYOUTS, ids=name)
def test_merged_face_ids_equal_one_device(world, layout):
    """merge_face_blocks on every rank's band: the same ids on every
    block of a (view, band), and together one device's full render, the
    port's and the JAX package's, exactly."""
    n_views, n_pixels, n_faces = layout
    band, nloc = H // n_pixels, 4 // n_views
    ids = np.full((4, H, W), -2, np.int32)
    for out in world.ranks(name(layout)):
        v, p, f = out["coords"]
        got = out["face_ids"]
        assert got.shape == (nloc, band, W)
        blk = ids[v * nloc:(v + 1) * nloc, p * band:(p + 1) * band]
        if f == 0:
            blk[...] = got
        else:
            np.testing.assert_array_equal(got, blk)
    for i in range(4):
        cam = [INPUTS[k][i] for k in ("rot", "trans", "fl", "pp")]
        one, _, _ = rast.rasterize(INPUTS["vertices"], INPUTS["faces"], *cam,
                                   height=H, width=W, device="cpu")
        jids, _, _ = jrast.rasterize(INPUTS["vertices"], INPUTS["faces"],
                                     *cam, height=H, width=W)
        np.testing.assert_array_equal(ids[i], one.numpy())
        np.testing.assert_array_equal(ids[i], np.asarray(jids))
    assert (ids >= 0).mean() > 0.05


def test_texels_and_shard_primitives_combo(world, texels):
    """Texel mode on a faces axis (the winner's owner shades it, a third
    MIN hands its texel ids to the other block) with shard_primitives:
    rank (v, p, f) holds the P / 4 rows from ((v * 2 + p) * 2 + f) * P /
    4."""
    args = [texels[k] for k in ARGS]
    P = 6 * T
    kw = dict(num_primitives=P, aggregator="mul", height=H, width=W)
    ref, ref_ov = ts.jax_sharded(
        (1, 2, 2), *args, texel_params=(texels["res"], texels["first"]),
        shard_primitives=True, **kw)
    ranks = world.ranks("texels_122")
    for r, out in enumerate(ranks):
        v, p, f = out["coords"]
        assert (v * 2 + p) * 2 + f == r
        assert out["acc0"].shape == (P // 4, C)
        assert int(out["overflow0"]) == ref_ov == 0
    got = np.concatenate([out["acc0"] for out in ranks])
    one, _ = distributed.fuse_views_texels(
        texels["vertices"], texels["faces"], texels["res"], texels["first"],
        *(texels[k] for k in ("rot", "trans", "fl", "pp", "probs", "iew")),
        device="cpu", **kw)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, one.numpy(), rtol=RTOL, atol=ATOL)


def test_indivisible_faces_raise(world):
    """299 faces on a faces axis of 4: every rank raises the JAX
    package's ValueError before any collective."""
    args = [INPUTS[k] for k in ARGS]
    args[1] = INPUTS["faces"][:T - 1]
    with pytest.raises(ValueError, match="faces"):
        ts.jax_sharded((1, 1, 4), *args, num_primitives=T - 1,
                       aggregator="sum", height=H, width=W)
    for out in world.ranks("odd_114"):
        assert "acc0" not in out
        assert "face count 299 must divide by the 'faces' axis 4" in str(
            out["error"])
