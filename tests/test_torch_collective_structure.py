"""The collectives of semantic_meshes_torch's make_sharded_fuse, as its
MeshAxis records them (make_sharded_fuse(collectives=[...])), in gloo
worlds of 4 and 2 ranks on the CPU. Mirrors
tests/test_collective_structure.py (which reads the JAX package's jaxpr)
and tests/test_weak_scaling.py:124 (worlds of 8, 16 and 32 virtual
devices there, 2 and 4 ranks here):

- per view, exactly one all-reduce over `pixels` of the (P, C+1) segment
  sums, and nothing over `views`;
- per call, one (P, C) all-reduce over `views` and one scalar overflow
  all-reduce over every mesh dimension; no other collective;
- shard_primitives: one (P, C) reduce-scatter over `views` per view and
  no (P, C) all-reduce; P % ranks != 0 raises "chip count";
- a `faces` axis adds two (H_band, W) MIN all-reduces per view, three in
  texel mode;
- across world sizes the inventory is the same, the reduce-scatter's
  output rows halve, and the pixels payload does not change.

A collective over a mesh dimension of size 1 moves nothing and is
skipped, and the record says so (skipped=True): the JAX jaxpr keeps such
a psum too. Every rank records the same sequence."""

import jax.numpy as jnp
import numpy as np
import pytest

import _torch_sharded as ts
from semantic_meshes import geometry as jgeo
from semantic_meshes import testing as jtesting
from semantic_meshes.data import stack_cameras

H, W, C = 32, 64, 5
ARGS = ("vertices", "faces", "rot", "trans", "fl", "pp", "probs", "iew")
WEAK_P = 1344


def scene(n_views):
    """test_collective_structure.py's scene: cube s=3, views of 64x32,
    5 classes."""
    vertices, faces = jtesting.make_cube(subdivisions=3)
    cams = jtesting.make_ring_cameras(num_views=n_views, width=W, height=H)
    rng = np.random.default_rng(0)
    probs = rng.random((n_views, H, W, C), np.float32)
    rot, trans, fl, pp = stack_cameras(cams)
    faces_t = np.asarray(jgeo.reorder_faces_for_texels(
        jnp.asarray(vertices), jnp.asarray(faces)))
    T = len(faces)
    return dict(vertices=vertices, faces=faces, rot=rot, trans=trans, fl=fl,
                pp=pp, probs=probs, iew=np.float32(0.5), faces_t=faces_t,
                res=np.full((T,), 3, np.int32),
                first=(np.arange(T) * 6).astype(np.int32))


T = 108  # cube s=3
KW = dict(aggregator="sum", height=H, width=W)
TEXEL_ARGS = ("vertices", "faces_t") + ARGS[2:]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    tmp4 = tmp_path_factory.mktemp("structure4")
    np.savez(tmp4 / "in.npz", **scene(4))
    path = tmp4 / "in.npz"
    cases = [
        ts.case("vp_22", (2, 2), path, ARGS, num_primitives=T, **KW),
        ts.case("v_41", (4, 1), path, ARGS, num_primitives=T, **KW),
        ts.case("mul_22", (2, 2), path, ARGS, num_primitives=T,
                aggregator="mul", height=H, width=W),
        ts.case("rs_22", (2, 2), path, ARGS, num_primitives=112,
                shard_primitives=True, **KW),
        ts.case("chip_count", (2, 2), path, ARGS, num_primitives=8 * T + 1,
                shard_primitives=True, **KW),
        ts.case("faces_122", (1, 2, 2), path, ARGS, num_primitives=T, **KW),
        ts.case("texel_faces_122", (1, 2, 2), path, TEXEL_ARGS,
                num_primitives=6 * T, texel_params=["res", "first"], **KW),
        ts.case("weak", (2, 2), path, ARGS, num_primitives=WEAK_P,
                shard_primitives=True, **KW),
    ]
    tmp2 = tmp_path_factory.mktemp("structure2")
    np.savez(tmp2 / "in.npz", **scene(2))
    w4 = ts.World(tmp4, cases)
    w2 = ts.World(tmp2, [ts.case("weak", (1, 2), tmp2 / "in.npz", ARGS,
                                 num_primitives=WEAK_P,
                                 shard_primitives=True, **KW)], n=2)
    yield {4: w4, 2: w2}
    w4.close()
    w2.close()


def recorded(world, name):
    """(op, axes, in_shape, out_shape, skipped) of every collective, the
    same on every rank."""
    seqs = [[(c["op"], tuple(c["axes"]), tuple(c["in_shape"]),
              tuple(c["out_shape"]), c["skipped"]) for c in
             world.collectives(name, r)] for r in range(world.n)]
    assert all(s == seqs[0] for s in seqs[1:]), seqs
    return seqs[0]


def pixels_sum(P, skipped=False):
    return ("all_reduce_sum", ("pixels",), (P, C + 1), (P, C + 1), skipped)


def views_sum(P, skipped=False):
    return ("all_reduce_sum", ("views",), (P, C), (P, C), skipped)


def overflow(axes=("views", "pixels")):
    return ("all_reduce_sum", axes, (), (), False)


def faces_min(band):
    return ("all_reduce_min", ("faces",), (band, W), (band, W), False)


@pytest.mark.parametrize("name", ["vp_22", "mul_22"])
def test_views_by_pixels_mesh(worlds, name):
    """Two views a rank: one (P, C+1) pixels all-reduce each, then the
    (P, C) views merge and the overflow, once (any aggregator)."""
    assert recorded(worlds[4], name) == [pixels_sum(T)] * 2 + [
        views_sum(T), overflow()]


def test_views_only_mesh_has_no_per_view_traffic(worlds):
    """(4, 1): the per-view pixels all-reduce is over one rank (skipped,
    nothing moves); the only traffic is the per-call views merge and the
    overflow."""
    assert recorded(worlds[4], "v_41") == [pixels_sum(T, skipped=True),
                                           views_sum(T), overflow()]


def test_shard_primitives_reduce_scatter_structure(worlds):
    """Each view's (P, C) delta is reduce-scattered over `views` to P / 2
    rows (the `pixels` block is a local slice); no (P, C) all-reduce
    remains, only the scalar overflow."""
    P = 112
    rs = ("reduce_scatter", ("views",), (P, C), (P // 2, C), False)
    assert recorded(worlds[4], "rs_22") == [pixels_sum(P), rs] * 2 + [
        overflow()]
    for r, out in enumerate(worlds[4].ranks("rs_22")):
        assert out["acc0"].shape == (P // 4, C)


def test_shard_primitives_requires_divisible_p(worlds):
    for out in worlds[4].ranks("chip_count"):
        assert "acc0" not in out
        assert "chip count 4" in str(out["error"])
    assert recorded(worlds[4], "chip_count") == []


@pytest.mark.parametrize("name,mins", [("faces_122", 2),
                                       ("texel_faces_122", 3)])
def test_faces_axis_adds_mins_per_view(worlds, name, mins):
    """(1, 2, 2): per view two (H / 2, W) MINs over `faces` (z bits, then
    the masked ids), a third in texel mode (the owner's texel ids), then
    the unchanged pixels all-reduce; the views merge (one rank: skipped)
    and the overflow over all three dimensions."""
    P = T if mins == 2 else 6 * T
    per_view = [faces_min(H // 2)] * mins + [pixels_sum(P)]
    assert recorded(worlds[4], name) == per_view * 4 + [
        views_sum(P, skipped=True), overflow(("views", "pixels", "faces"))]


def test_collective_count_flat_and_reduce_scatter_rows_halve(worlds):
    """Worlds of 2 ((1, 2)) and 4 ((2, 2)), two views a `views` rank,
    shard_primitives: the same inventory of (op, axes); the
    reduce-scatter's output rows halve from 2 ranks to 4 (over one
    `views` rank it keeps all P rows, skipped); the pixels payload is
    (P, C+1) in both."""
    seqs = {n: recorded(worlds[n], "weak") for n in (2, 4)}
    inventory = {n: sorted((op, axes) for op, axes, *_ in s)
                 for n, s in seqs.items()}
    assert inventory[2] == inventory[4]
    rows = {}
    for n, s in seqs.items():
        rs = [c for c in s if c[0] == "reduce_scatter"]
        assert len(rs) == 2 and all(c[2] == (WEAK_P, C) for c in rs)
        rows[n] = rs[0][3][0]
        pix = [c for c in s if c[1] == ("pixels",)]
        assert len(pix) == 2 and all(c[2] == (WEAK_P, C + 1) for c in pix)
    assert rows[2] == WEAK_P == 2 * rows[4]
    for n in (2, 4):
        blocks = [out["acc0"] for out in worlds[n].ranks("weak")]
        assert all(b.shape == (WEAK_P // n, C) for b in blocks)
