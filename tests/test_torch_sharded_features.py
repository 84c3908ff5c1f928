"""semantic_meshes_torch's make_sharded_fuse in texel mode, with and
without near-plane clipping, in a 4-rank gloo world on the CPU, against
the JAX package's make_sharded_fuse at the same layout on 4 virtual
devices and the port's fuse_views_texels (rtol 2e-5, atol 1e-5). Mirrors
tests/test_distributed_texels.py:108 and tests/test_clipping.py:258,
both on (2, 2). The scenes take the JAX renderer's tables, as both
packages' sharded fuses do. The lens cases are in
tests/test_torch_sharded_lenses.py."""

import numpy as np
import pytest

import _torch_sharded as ts
import semantic_meshes
from semantic_meshes import distributed as jdist
from semantic_meshes import geometry as jgeo
from semantic_meshes import testing as jtesting
from semantic_meshes.data import Camera, stack_cameras
from semantic_meshes.io.ply import write_mesh
from semantic_meshes_torch import distributed

RTOL, ATOL = 2e-5, 1e-5
ARGS = ("vertices", "faces", "rot", "trans", "fl", "pp", "probs", "iew")
TEXEL_KEYS = ("vertices", "faces", "res", "first", "rot", "trans", "fl",
              "pp", "probs", "iew")


def texel_inputs(renderer, cams, probs):
    rot, trans, fl, pp = stack_cameras(cams)
    return dict(vertices=np.asarray(renderer.vertices),
                faces=np.asarray(renderer.faces),
                res=np.asarray(renderer.resolutions),
                first=np.asarray(renderer.first_texel_index), rot=rot,
                trans=trans, fl=fl, pp=pp, probs=probs, iew=np.float32(0.5),
                P=renderer.getPrimitivesNum())


def texel_scene(tmp):
    """test_distributed_texels.py's cube s=3 at 1.5 texels per pixel,
    its first 2 views of 128x96."""
    vertices, faces = jtesting.make_cube(subdivisions=3)
    write_mesh(tmp / "cube.ply", vertices, faces)
    mesh = semantic_meshes.data.Ply(str(tmp / "cube.ply"))
    cams = jtesting.make_ring_cameras(num_views=3, width=128, height=96)
    renderer = semantic_meshes.render.texels(mesh, cams, 1.5)
    rng = np.random.default_rng(9)
    probs = np.stack([jtesting.random_probs(rng, 96, 128, 3)
                      for _ in cams[:2]])
    return texel_inputs(renderer, cams[:2], probs)


def room_scene(tmp):
    """test_clipping.py's 4 m room (cube s=2) seen from 2 cameras inside
    it at 128x64, texels at 1.0 per pixel with clip_near."""
    vertices, faces = jtesting.make_cube(2, size=4.0)
    write_mesh(tmp / "room.ply", vertices, faces)
    mesh = semantic_meshes.data.Ply(str(tmp / "room.ply"))

    def cam_pose(eye, tgt):
        rot, trans = jgeo.look_at(eye, tgt, [0, 1, 0])
        return Camera(rot, trans, np.array([128, 64]),
                      np.array([50.0, 50.0]), np.array([64.0, 32.0]))

    cams = [cam_pose([1.7, 0.0, 0.0], [1.7, 0.05, 1.0]),
            cam_pose([0.0, -1.6, 0.0], [0.3, -1.55, 1.0])]
    renderer = semantic_meshes.render.texels(mesh, cams, 1.0, clip_near=True)
    rng = np.random.default_rng(7)
    probs = np.stack([jtesting.random_probs(rng, 64, 128, 3) for _ in cams])
    return texel_inputs(renderer, cams, probs)


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded_scenes")
    return {"texels": texel_scene(tmp), "room": room_scene(tmp)}


def kw_of(inputs, aggregator="sum"):
    return dict(num_primitives=int(inputs.get("P", len(inputs["faces"]))),
                aggregator=aggregator, height=inputs["probs"].shape[1],
                width=inputs["probs"].shape[2])


@pytest.fixture(scope="module")
def world(tmp_path_factory, scenes):
    tmp = tmp_path_factory.mktemp("sharded_features")
    paths = {}
    for name, arrays in scenes.items():
        paths[name] = tmp / f"{name}.npz"
        np.savez(paths[name], **arrays)
    tex = ["res", "first"]
    cases = [
        ts.case("texels_22", (2, 2), paths["texels"], ARGS, repeat=True,
                texel_params=tex, **kw_of(scenes["texels"])),
        ts.case("clip_22", (2, 2), paths["room"], ARGS, repeat=True,
                texel_params=tex, clip_near=True, **kw_of(scenes["room"])),
    ]
    w = ts.World(tmp, cases)
    yield w
    w.close()


def texel_one_device(inputs, **kw):
    acc, ov = distributed.fuse_views_texels(
        *(inputs[k] for k in TEXEL_KEYS), device="cpu", **kw)
    assert int(ov) == 0
    return acc.numpy()


def test_sharded_texels_matches_single_chip(world, scenes):
    """Texel mode on (2, 2): each band's texel shader samples its global
    rows (y_offset = row0)."""
    inputs = scenes["texels"]
    kw = kw_of(inputs)
    ref, ref_ov = ts.jax_sharded(
        (2, 2), *(inputs[k] for k in ARGS),
        texel_params=(inputs["res"], inputs["first"]), **kw)
    got, ov = world.replicated("texels_22")
    assert ov == ref_ov == 0
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, texel_one_device(inputs, **kw),
                               rtol=RTOL, atol=ATOL)


def test_sharded_clip_matches_single_chip(world, scenes):
    """Texel mode with clip_near on (2, 2), an indoor scene whose
    triangles straddle the near plane (the camera-space ray form of the
    shader). Jitted, XLA contracts the JAX shader's products into FMAs,
    which moves pixels across texel lines: both packages' one-device
    fusions differ on 153 of 26704 texels here, while JAX op by op equals
    the port exactly (its sharded fuse op by op takes ~15 minutes, so the
    op-by-op reference is JAX's one-device fuse). So: the port's sharded
    result equals JAX op by op and the port's one device; it equals JAX's
    jitted sharded result on every texel where the two packages' jitted
    and op-by-op one-device results agree (all but 1%), and on the rest
    each sharded result equals its own package's one-device result."""
    import jax

    inputs = scenes["room"]
    kw = kw_of(inputs)
    ref, ref_ov = ts.jax_sharded(
        (2, 2), *(inputs[k] for k in ARGS),
        texel_params=(inputs["res"], inputs["first"]), clip_near=True, **kw)
    got, ov = world.replicated("clip_22")
    assert ov == ref_ov == 0
    one = texel_one_device(inputs, clip_near=True, **kw)
    np.testing.assert_allclose(got, one, rtol=RTOL, atol=ATOL)
    args = [inputs[k] for k in TEXEL_KEYS]
    with jax.disable_jit():
        op_by_op = np.asarray(jdist.fuse_views_texels(
            *args, clip_near=True, **kw)[0])
    np.testing.assert_allclose(got, op_by_op, rtol=RTOL, atol=ATOL)
    jitted = np.asarray(jdist.fuse_views_texels(*args, clip_near=True,
                                                **kw)[0])
    same = np.isclose(jitted, op_by_op, rtol=RTOL, atol=ATOL).all(-1)
    assert same.mean() > 0.99
    np.testing.assert_allclose(got[same], ref[same], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ref[~same], jitted[~same], rtol=RTOL,
                               atol=ATOL)
