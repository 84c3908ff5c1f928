"""semantic_meshes_torch's make_sharded_fuse with lens distortion in a
4-rank gloo world on the CPU, against the JAX package's make_sharded_fuse
at the same layout on 4 virtual devices and the port's fuse_views (rtol
2e-5, atol 1e-5). Mirrors tests/test_distortion.py:525 and :561 (a
`pixels` axis raises) and tests/test_lens_models.py:784 (a shared
fisheye lens, whose grid each rank computes once)."""

import numpy as np
import pytest

import _torch_sharded as ts
from semantic_meshes import geometry as jgeo
from semantic_meshes import testing as jtesting
from semantic_meshes.data import Camera, stack_cameras, stack_distortions
from semantic_meshes_torch import distributed

RTOL, ATOL = 2e-5, 1e-5
DARGS = ("vertices", "faces", "rot", "trans", "fl", "pp", "probs", "iew",
         "dists")


def two_triangles():
    vertices = np.array(
        [[-2.0, -2.0, 4.0], [2.5, -2.0, 4.0], [0.0, 2.5, 4.0],
         [-1.0, -1.5, 3.0], [1.5, -0.5, 3.0], [-0.5, 1.5, 3.0]], np.float32)
    return vertices, np.array([[0, 1, 2], [3, 4, 5]], np.int32)


def lens_inputs(lenses, width, height, f, seed):
    vertices, faces = two_triangles()
    cams = [Camera(np.eye(3, dtype=np.float32), np.zeros(3, np.float32),
                   (width, height), [f, f], [width / 2, height / 2],
                   distortion=d) for d in lenses]
    rng = np.random.default_rng(seed)
    probs = np.stack([jtesting.random_probs(rng, height, width, 3)
                      for _ in cams])
    rot, trans, fl, pp = stack_cameras(cams)
    return dict(vertices=vertices, faces=faces, rot=rot, trans=trans, fl=fl,
                pp=pp, probs=probs, iew=np.float32(0.5),
                dists=stack_distortions(cams))


def fisheye_wire():
    d = np.zeros(9, np.float32)
    d[:4] = [0.03, -0.011, 0.002, -0.0005]  # test_lens_models.py FISH_K4
    d[8] = jgeo.LENS_FISHEYE
    return d


# test_distortion.py's _scene_and_cams (a zero lens among them) at 64x48,
# and test_lens_models.py's shared fisheye at 96x72
DISTORTED = lens_inputs([[0.12], [-0.08, 0.01], None, [0.05]], 64, 48, 40.0,
                        7)
SHARED = lens_inputs([fisheye_wire()] * 4, 96, 72, 60.0, 21)


def kw_of(inputs):
    return dict(num_primitives=len(inputs["faces"]), aggregator="sum",
                height=inputs["probs"].shape[1],
                width=inputs["probs"].shape[2])


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded_lenses")
    np.savez(tmp / "distorted.npz", **DISTORTED)
    np.savez(tmp / "shared.npz", **SHARED)
    cases = [
        ts.case("distorted_41", (4, 1), tmp / "distorted.npz", DARGS,
                repeat=True, with_distortion=True, **kw_of(DISTORTED)),
        ts.case("distorted_22", (2, 2), tmp / "distorted.npz", DARGS,
                with_distortion=True, **kw_of(DISTORTED)),
        ts.case("shared_41", (4, 1), tmp / "shared.npz", DARGS, repeat=True,
                with_distortion=True, shared_lens=True, **kw_of(SHARED)),
    ]
    w = ts.World(tmp, cases)
    yield w
    w.close()


@pytest.mark.parametrize("name", ["distorted", "shared"])
def test_sharded_distorted_matches_single_chip(world, name):
    """Views with lenses on (4, 1): per-view grids (a zero lens among
    them), and one shared fisheye lens whose grid each rank computes
    once."""
    inputs = DISTORTED if name == "distorted" else SHARED
    shared = name == "shared"
    kw = kw_of(inputs)
    args = [inputs[k] for k in DARGS]
    ref, _ = ts.jax_sharded((4, 1), *args, with_distortion=True,
                            shared_lens=shared, **kw)
    got, ov = world.replicated(f"{name}_41")
    one, one_ov = distributed.fuse_views(*args[:-1], distortions=args[-1],
                                         shared_lens=shared, device="cpu",
                                         **kw)
    assert ov == int(one_ov) == 0
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, one.numpy(), rtol=RTOL, atol=ATOL)


def test_sharded_distortion_rejects_pixel_axis(world):
    kw = dict(num_primitives=2, aggregator="sum", height=48, width=64)
    with pytest.raises(ValueError, match="pixels"):
        ts.jax_sharded((1, 2), with_distortion=True, **kw)
    for out in world.ranks("distorted_22"):
        assert "acc0" not in out
        assert "incompatible with a 'pixels' mesh axis" in str(out["error"])
