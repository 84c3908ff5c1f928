"""make_sharded_fuse of semantic_meshes_torch over (views, pixels) meshes
of a 4-rank gloo world on the CPU, against the JAX package's
make_sharded_fuse at the same layout on 4 of the 8 virtual devices and
against the port's own fuse_views. Mirrors tests/test_end_to_end.py's
TestShardedPipeline (:189, :226, :320, :368) and the sharded overflow
report (:588). Not mirrored: :275 `exact16`, the JAX package's TPU
segment-sum route, which the port leaves out (fusion.py, ROADMAP Queue 1
item 7).

All cases run in one world per module (the `world` fixture); every rank
runs each replicated case twice, and the runs must be bit-identical
(World.replicated). Accumulators compare at rtol 2e-5, atol 1e-5 (the
sums merge in gloo's order, not one device's); overflow counts are
exact."""

import numpy as np
import pytest

import _torch_sharded as ts
from semantic_meshes import distributed as jdist
from semantic_meshes import testing as jtesting
from semantic_meshes.data import stack_cameras
from semantic_meshes.rasterize import dense as jdense
from semantic_meshes_torch import distributed

RTOL, ATOL = 2e-5, 1e-5
ARGS = ("vertices", "faces", "rot", "trans", "fl", "pp", "probs", "iew")
H, W, C = 128, 160, 3


def cube_inputs(seed, weights=False, iew=0.5):
    """tests/test_end_to_end.py's cube scene (s=5, 300 triangles, 4 ring
    views of 160x128) with probabilities from `seed`."""
    vertices, faces = jtesting.make_cube(subdivisions=5)
    cams = jtesting.make_ring_cameras(num_views=4, width=W, height=H)
    rng = np.random.default_rng(seed)
    probs = np.stack([jtesting.random_probs(rng, H, W, C) for _ in cams])
    rot, trans, fl, pp = stack_cameras(cams)
    out = dict(vertices=vertices, faces=faces, rot=rot, trans=trans, fl=fl,
               pp=pp, probs=probs, iew=np.float32(iew))
    if weights:
        out["weights"] = rng.uniform(0.2, 2.0, (len(cams), H, W)).astype(
            np.float32)
    return out


def micro_split_inputs():
    """:226's scene: cube s=40 (19200 triangles, sub-pixel at 128x96),
    faces in the dense rasterizer's uni-first order and a 4-tuple budget
    (pairs, 0, None, split_k)."""
    vertices, faces = jtesting.make_cube(40)
    nv, h, w = 4, 96, 128
    cams = jtesting.make_ring_cameras(num_views=nv, width=w, height=h)
    rot, trans, fl, pp = stack_cameras(cams)
    rng = np.random.default_rng(0)
    probs = np.stack([jtesting.random_probs(rng, h, w, 5) for _ in range(nv)])
    perm, k = jdense.uni_order(vertices, faces, rot, trans, fl, pp,
                               height=h, width=w)
    fp = np.asarray(faces)[np.asarray(perm)]
    pairs = max(int(jdense.candidate_count(
        vertices, fp, rot[i], trans[i], fl[i], pp[i], height=h, width=w,
        micro_split=int(k))) for i in range(nv))
    return dict(vertices=vertices, faces=fp, rot=rot, trans=trans, fl=fl,
                pp=pp, probs=probs, iew=np.float32(0.5)), \
        (2 * pairs, 0, None, int(k))


INPUTS = {"sum": cube_inputs(3), "weighted": cube_inputs(11, weights=True),
          "weighted_iew0": cube_inputs(11, weights=True, iew=0.0),
          "blocks": cube_inputs(4), "dropped": cube_inputs(19)}
KW = dict(num_primitives=300, aggregator="sum", height=H, width=W)
WARGS = ARGS + ("weights",)


@pytest.fixture(scope="module")
def micro():
    return micro_split_inputs()


@pytest.fixture(scope="module")
def world(tmp_path_factory, micro):
    tmp = tmp_path_factory.mktemp("sharded_pipeline")
    paths = {}
    for name, arrays in dict(INPUTS, micro=micro[0]).items():
        paths[name] = tmp / f"{name}.npz"
        np.savez(paths[name], **arrays)
    cases = [
        ts.case("sum_41", (4, 1), paths["sum"], ARGS, repeat=True, **KW),
        ts.case("sum_22", (2, 2), paths["sum"], ARGS, repeat=True, **KW),
        ts.case("micro_split_22", (2, 2), paths["micro"], ARGS, repeat=True,
                num_primitives=19200, aggregator="sum", height=96,
                width=128, backend="dense", dense_e_cap=list(micro[1])),
        ts.case("weighted_22", (2, 2), paths["weighted"], WARGS,
                with_weights=True, **KW),
        ts.case("unweighted_22", (2, 2), paths["weighted"], ARGS, **KW),
        ts.case("weighted_iew0_22", (2, 2), paths["weighted_iew0"], WARGS,
                with_weights=True, **KW),
        ts.case("blocks_22", (2, 2), paths["blocks"], ARGS,
                shard_primitives=True, **KW),
        ts.case("blocks_41", (4, 1), paths["blocks"], ARGS,
                shard_primitives=True, **KW),
        ts.case("dropped_22", (2, 2), paths["dropped"], ARGS,
                max_tris_per_tile=1, **KW),
    ]
    w = ts.World(tmp, cases)
    yield w
    w.close()


def one_device(inputs, args=ARGS, **kw):
    acc, ov = distributed.fuse_views(*(inputs[k] for k in args),
                                     device="cpu", **kw)
    return acc.numpy(), int(ov)


@pytest.mark.parametrize("layout", [(4, 1), (2, 2)])
def test_sharded_matches_single_chip(world, layout):
    inputs = INPUTS["sum"]
    ref, ref_ov = ts.jax_sharded(layout, *(inputs[k] for k in ARGS), **KW)
    got, ov = world.replicated(f"sum_{layout[0]}{layout[1]}")
    one, one_ov = one_device(inputs, **KW)
    assert ov == ref_ov == one_ov == 0
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, one, rtol=RTOL, atol=ATOL)


def test_sharded_micro_split_matches_single_chip(world, micro, monkeypatch):
    """The dense backend's uni-slot prefix (a 4-tuple dense_e_cap) on a
    (2, 2) mesh: each band rasterizes its rows through the split."""
    monkeypatch.setenv("SM_RASTERIZER", "dense")
    inputs, cap = micro
    kw = dict(num_primitives=19200, aggregator="sum", height=96, width=128,
              dense_e_cap=cap)
    ref, ref_ov = ts.jax_sharded((2, 2), *(inputs[k] for k in ARGS), **kw)
    got, ov = world.replicated("micro_split_22")
    one, one_ov = one_device(inputs, backend="dense", **kw)
    assert ov == ref_ov == one_ov == 0
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, one, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", ["weighted", "weighted_iew0"])
def test_sharded_weighted_matches_single_chip(world, name):
    """Per-pixel weights through the (views, pixels) path, with
    images_equal_weight 0.5 and 0 (no pixels-per-face term): the weights
    must matter."""
    inputs = INPUTS[name]
    ref, _ = ts.jax_sharded((2, 2), *(inputs[k] for k in WARGS),
                            with_weights=True, **KW)
    got, ov = world.replicated(f"{name}_22")
    one, _ = one_device(inputs, WARGS, **KW)
    assert ov == 0
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, one, rtol=RTOL, atol=ATOL)
    unweighted, _ = world.replicated("unweighted_22")
    assert np.abs(got - unweighted).max() > 1e-3


@pytest.mark.parametrize("layout", [(2, 2), (4, 1)])
def test_sharded_primitives_output(world, layout):
    """shard_primitives: each view's delta is reduce-scattered over
    `views`, so each rank holds a distinct P / 4-row block, rank (v, p)
    the rows from (v * pixels_axis + p) * P / 4; the blocks in rank order
    are the unsharded accumulator, on a views x pixels mesh and on a
    views-only mesh."""
    inputs = INPUTS["blocks"]
    ref, _ = ts.jax_sharded(layout, *(inputs[k] for k in ARGS),
                            shard_primitives=True, **KW)
    ranks = world.ranks(f"blocks_{layout[0]}{layout[1]}")
    for r, out in enumerate(ranks):
        v, p = out["coords"]
        assert (v * layout[1] + p) == r
        assert out["acc0"].shape == (300 // 4, C)
        assert int(out["overflow0"]) == 0
    got = np.concatenate([out["acc0"] for out in ranks])
    one, _ = one_device(inputs, **KW)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, one, rtol=RTOL, atol=ATOL)


def test_sharded_fuse_reports_dropped_candidates(world):
    """A 1-candidate-per-tile budget drops candidates in every band; the
    count, summed over every rank, equals the JAX package's at the same
    layout (band tiles start at row0, so it differs from one device's
    count of the full image)."""
    inputs = INPUTS["dropped"]
    _, ref_ov = ts.jax_sharded((2, 2), *(inputs[k] for k in ARGS),
                               max_tris_per_tile=1, **KW)
    _, ov = world.replicated("dropped_22")
    assert ov == ref_ov > 0
