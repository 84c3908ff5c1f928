"""Near-plane clipping on the dense path of semantic_meshes_torch against
the JAX package on the CPU: the probes under clip_near, the global
bucket's overflow when n_global binds, and the plan of a clipped batch
(mirroring tests/test_dense_rasterizer.py's
test_fuse_views_split_clip_near_plans_compaction).

JAX runs op by op where ids and counts are compared (see
tests/test_torch_clipping.py); depths compare at rtol 2e-5 and fused
states at rtol 2e-5, atol 1e-5 (another summation order).
"""

import jax
import numpy as np
import pytest
import torch

from semantic_meshes import distributed as jdist
from semantic_meshes import geometry as jgeometry
from semantic_meshes import testing as jtesting
from semantic_meshes.rasterize import dense as jdense
from semantic_meshes_torch import distributed, testing
from semantic_meshes_torch.data import stack_cameras
from semantic_meshes_torch.rasterize import dense

H, W = 64, 128
DEPTH_RTOL = 2e-5
RTOL, ATOL = 2e-5, 1e-5


def _grazing_view():
    """A camera 0.1 m above the floor of a 4 m room (cube s=3), looking
    along it: big rows (spanning more than 2 x 2 dense tiles) on every
    wall, and floor triangles that straddle the near plane."""
    vertices, faces = jtesting.make_cube(3, size=4.0)
    rot, trans = jgeometry.look_at([0.3, -1.9, -1.0], [0.5, -1.95, 2.0],
                                   [0, 1, 0])
    cam = (rot, trans, np.array([50.0, 50.0], np.float32),
           np.array([W / 2, H / 2], np.float32))
    return vertices, faces, cam


def test_dense_probes_count_pieces_as_jax():
    """candidate_stats(_batch), routing_stats and uni_eligible under
    clip_near count the 2T piece rows as JAX's do (op by op); the port's
    third column, the big rows of the global bucket, is the
    classification's own count at every threshold."""
    vertices, faces, cam = _grazing_view()
    kw = dict(height=H, width=W, clip_near=True)
    with jax.disable_jit():
        want_stats = np.asarray(jdense.candidate_stats(vertices, faces, *cam,
                                                       **kw))
        want_curve = np.asarray(jdense.routing_stats(vertices, faces, *cam,
                                                     **kw))
        want_uni = np.asarray(jdense.uni_eligible(vertices, faces, *cam,
                                                  **kw))
    stats = dense.candidate_stats(vertices, faces, *cam, device="cpu", **kw)
    np.testing.assert_array_equal(stats.numpy()[:2], want_stats)
    batch = dense.candidate_stats_batch(
        vertices, faces, *(np.stack([c, c]) for c in cam), device="cpu", **kw)
    np.testing.assert_array_equal(batch.numpy(), stats.numpy())
    curve = dense.routing_stats(vertices, faces, *cam, device="cpu", **kw)
    np.testing.assert_array_equal(curve.numpy()[:, :2], want_curve)
    setup = dense.tiles.setup_inputs(vertices, faces, *cam, None, "cpu",
                                     True)
    big = int(dense._classify(setup, H, W, 0.0)[2].sum())
    assert big == 12 and (curve.numpy()[:, 2] == big).all()
    assert int(stats[2]) == big
    uni = dense.uni_eligible(vertices, faces, *cam, device="cpu", **kw)
    np.testing.assert_array_equal(uni.numpy(), want_uni)
    assert uni.shape[0] == 2 * len(faces) and want_stats[0] > 0
    rows = 2 * len(faces)
    assert dense.pick_route(curve.tolist(), rows) == jdense.pick_route(
        want_curve, rows)


@pytest.mark.parametrize("clip_near", [False, True])
def test_n_global_overflow_counted_as_jax(clip_near):
    """The global bucket's cap binds on a grazing view (12 big rows against
    an n_global of 4): the port counts the same overflow as JAX's dense
    rasterizer (op by op), with clipping and without, and its dropped
    rows leave pixels empty. JAX's kernel reads the bucket in whole rows
    of PACK candidates from an _ALIGN-aligned start, so it also tests the
    ids up to the end of its last row, though its overflow counts them as
    dropped (ROADMAP, dense range rounding); the port tests exactly the
    first n_global. So JAX's image is the port's at the n_global that
    JAX's rows sweep."""
    vertices, faces, cam = _grazing_view()
    n_global = 4
    kw = dict(height=H, width=W, clip_near=clip_near)
    with jax.disable_jit():
        want = [np.asarray(x) for x in jdense.rasterize(
            vertices, faces, *cam, n_global=n_global, **kw)]
    ids, _, overflow = dense.rasterize(vertices, faces, *cam,
                                       n_global=n_global, device="cpu", **kw)
    assert int(overflow) == int(want[2]) == 8
    full = dense.rasterize(vertices, faces, *cam, device="cpu", **kw)
    assert int(full[2]) == 0
    assert int((ids < 0).sum()) > int((full[0] < 0).sum())
    starts = dense.resolve_inputs(vertices, faces, *cam, device="cpu",
                                  **kw)[0][2]
    B = starts.numel() - 2
    lead = int(starts[B]) % jdense._ALIGN
    swept = min(-(-(lead + n_global) // jdense.PACK) * jdense.PACK - lead,
                int(starts[B + 1] - starts[B]))
    assert n_global < swept < 12
    ids, depth, _ = dense.rasterize(vertices, faces, *cam, n_global=swept,
                                    device="cpu", **kw)
    np.testing.assert_array_equal(ids.numpy(), want[0])
    fin = np.isfinite(want[1])
    np.testing.assert_array_equal(np.isfinite(depth.numpy()), fin)
    np.testing.assert_allclose(depth.numpy()[fin], want[1][fin],
                               rtol=DEPTH_RTOL)


def test_fuse_views_split_clip_near_plans_compaction(monkeypatch):
    """Clipping cannot ride the uni prefix (it permutes faces, not clip
    pieces): plan_fuse(clip_near=True) plans compaction with a budget of
    piece rows, and fuse_views_split equals fuse_views and JAX's."""
    vertices, faces = testing.make_cube(20)
    cams = testing.make_ring_cameras(num_views=2, width=128, height=96)
    rot, trans, fl, pp = stack_cameras(cams)
    plan = distributed.plan_fuse(vertices, faces, rot, trans, fl, pp,
                                 height=96, width=128, backend="dense",
                                 clip_near=True, device="cpu")
    assert plan.remap is None and plan.dense_e_cap.split_k == 0
    assert plan.dense_e_cap.micro_max is not None
    rng = np.random.default_rng(2)
    probs = np.stack([jtesting.random_probs(rng, 96, 128, 4)
                      for _ in range(2)])
    kw = dict(num_primitives=len(faces), aggregator="sum", height=96,
              width=128, clip_near=True, backend="dense", device="cpu")
    a0, ov0 = distributed.fuse_views(vertices, faces, rot, trans, fl, pp,
                                     probs, 0.5, **kw)
    a1, ov1 = distributed.fuse_views_split(vertices, faces, rot, trans, fl,
                                           pp, probs, 0.5, **kw)
    assert int(ov0) == 0 and int(ov1) == 0
    assert torch.equal(a0, a1)
    monkeypatch.setenv("SM_RASTERIZER", "dense")  # JAX's test does so too
    want, _ = jdist.fuse_views(vertices, faces, rot, trans, fl, pp, probs,
                               np.float32(0.5), num_primitives=len(faces),
                               aggregator="sum", height=96, width=128,
                               clip_near=True)
    np.testing.assert_allclose(a0.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
