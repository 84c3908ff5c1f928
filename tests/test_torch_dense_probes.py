"""Parity of the dense rasterizer's integer machinery with the JAX package,
on the CPU: classification, sort binning, micro compaction, the budget and
routing probes, and the routing pick. Every compared value is an integer
(or a bool) and must be equal.

The JAX side runs op by op, fed the same setup where a function takes
one (see tests/_torch_dense_scenes.py: under jit, XLA's FMA contraction
can move a bbox across a tile boundary). The routing pick is compared
with the JAX package's own coefficients passed to the port, whose defaults
are H100 numbers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dense_scenes as sc
from semantic_meshes import render as jrender
from semantic_meshes import testing as jtesting
from semantic_meshes.data import stack_cameras
from semantic_meshes.rasterize import dense as jdense
from semantic_meshes_torch import rasterize as trast
from semantic_meshes_torch.rasterize import dense

JAX_ROUTE = dict(alpha=jdense.ROUTE_ALPHA, beta=jdense.ROUTE_BETA,
                 gamma=jdense.ROUTE_GAMMA)

BIN_CASES = {
    # (scene, camera, height, width, y_offset, e_cap, n_global, micro_max,
    #  micro_split)
    "mixed": lambda: (*sc.mixed_scene(), sc.simple_cam(256, 96), 96, 256,
                      0.0, 512, 1024, None, None),
    "undersized": lambda: (*sc.random_scene(4)[:2], sc.random_scene(4)[2],
                           64, 256, 0.0, 256, 1024, None, None),
    "n_global_1": lambda: (*sc.stacked_big_scene(), sc.simple_cam(256, 96),
                           96, 256, 0.0, 256, 1, 2, None),
    "band_m4": lambda: (*jtesting.make_cube(4), sc.ring_cam(128, 96), 32,
                        128, 32.0, 768, 1024, 4, None),
    "uni_split": lambda: (*sc.uni_scene(), sc.ring_cam(256, 96), 96, 256,
                          0.0, 512, 1024, 3, 30),
}


@pytest.mark.parametrize("name", sorted(BIN_CASES))
def test_build_sorted_bins_matches_jax(name):
    v, f, cam, h, w, y_offset, e_cap, n_global, mm, split = BIN_CASES[name]()
    setup = sc.jax_setup(v, f, cam)
    with jax.disable_jit():
        tri_sorted, starts, overflow, micro = jdense._build_sorted_bins(
            setup, h, w, jnp.float32(y_offset), e_cap, n_global, mm, split)
        count = int(jdense.count_pairs(setup, h, w, jnp.float32(y_offset),
                                       mm, split))
    tsetup = sc.torch_setup(setup)
    sorted_ids, tstarts, toverflow, tmicro = dense._build_sorted_bins(
        tsetup, h, w, y_offset, e_cap, n_global, mm, split)
    np.testing.assert_array_equal(tstarts.numpy(), np.asarray(starts))
    np.testing.assert_array_equal(tmicro.numpy(), np.asarray(micro))
    assert int(toverflow) == int(overflow)
    n = sorted_ids.numel()
    # the JAX array is padded past the budget with the sentinel id T
    np.testing.assert_array_equal(sorted_ids.numpy(),
                                  np.asarray(tri_sorted)[:n])
    assert int(dense.count_pairs(tsetup, h, w, y_offset, mm, split)) == count
    if name in ("undersized", "n_global_1"):
        assert int(toverflow) > 0


@pytest.mark.parametrize("cap", [8, 32, 64])
def test_compact_micro_matches_jax(cap):
    v, f = sc.compaction_scene()
    setup = sc.jax_setup(v, f, sc.simple_cam(256, 96))
    with jax.disable_jit():
        micro = jdense._classify(setup, 96, 256, jnp.float32(0), 4)[0]
        sub, take, valid, dropped = jdense._compact_micro(setup, micro, cap)
    tsetup = sc.torch_setup(setup)
    tsub, ttake, tvalid, tdropped = dense._compact_micro(
        tsetup, torch.from_numpy(np.array(micro)), cap)
    np.testing.assert_array_equal(ttake.numpy(), np.asarray(take))
    np.testing.assert_array_equal(tvalid.numpy(), np.asarray(valid))
    assert int(tdropped) == int(dropped)
    for k in sub:
        np.testing.assert_array_equal(tsub[k].numpy(), np.asarray(sub[k]))
    assert (int(tdropped) > 0) == (cap == 8)  # 30 micro triangles


def _views(n, w, h, **kw):
    return stack_cameras(jtesting.make_ring_cameras(num_views=n, width=w,
                                                    height=h, **kw))


PROBE_KW = {
    "auto": {},
    "m4": dict(micro_max=4),
    "split": dict(micro_split=40, micro_max=2),
}


@pytest.mark.parametrize("kw", sorted(PROBE_KW))
def test_candidate_probes_match_jax(kw):
    """candidate_count / candidate_stats, single view and batched; the
    port's third column (big rows) is held to a direct count in
    tests/test_torch_global_cap.py."""
    kw = PROBE_KW[kw]
    v, f = sc.uni_scene()
    rot, trans, fl, pp = _views(4, 256, 96)
    dims = dict(height=96, width=256)
    with jax.disable_jit():
        want_batch = np.asarray(jdense.candidate_stats_batch(
            v, f, rot, trans, fl, pp, **dims, **kw))
        want_count_batch = int(jdense.candidate_count_batch(
            v, f, rot, trans, fl, pp, **dims, **kw))
        want = [np.asarray(jdense.candidate_stats(
            v, f, rot[i], trans[i], fl[i], pp[i], **dims, **kw))
            for i in range(4)]
        want_count = int(jdense.candidate_count(
            v, f, rot[1], trans[1], fl[1], pp[1], **dims, **kw))
    for i in range(4):
        got = dense.candidate_stats(v, f, rot[i], trans[i], fl[i], pp[i],
                                    device="cpu", **dims, **kw)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy()[:2], want[i])
    got = dense.candidate_stats_batch(v, f, rot, trans, fl, pp,
                                      device="cpu", **dims, **kw)
    np.testing.assert_array_equal(got.numpy()[:2], want_batch)
    np.testing.assert_array_equal(want_batch, np.max(want, axis=0))
    assert int(dense.candidate_count_batch(
        v, f, rot, trans, fl, pp, device="cpu", **dims, **kw)) == \
        want_count_batch
    assert int(dense.candidate_count(
        v, f, rot[1], trans[1], fl[1], pp[1], device="cpu", **dims,
        **kw)) == want_count
    assert want_batch[0] > 0 and want_batch[1] > 0


def test_uni_probes_match_jax():
    """uni_eligible (per view), uni_eligible_batch (AND over views) and
    uni_order (the stable eligible-first permutation) match exactly."""
    v, f = jtesting.make_cube(40)
    rot, trans, fl, pp = _views(3, 128, 96)
    dims = dict(height=96, width=128)
    with jax.disable_jit():
        want = [np.asarray(jdense.uni_eligible(v, f, rot[i], trans[i],
                                               fl[i], pp[i], **dims))
                for i in range(3)]
        want_batch = np.asarray(jdense.uni_eligible_batch(
            v, f, rot, trans, fl, pp, **dims))
        want_perm, want_k = jdense.uni_order(v, f, rot, trans, fl, pp,
                                             **dims)
    for i in range(3):
        got = dense.uni_eligible(v, f, rot[i], trans[i], fl[i], pp[i],
                                 device="cpu", **dims)
        np.testing.assert_array_equal(got.numpy(), want[i])
    got = dense.uni_eligible_batch(v, f, rot, trans, fl, pp, device="cpu",
                                   **dims)
    np.testing.assert_array_equal(got.numpy(), want_batch)
    perm, k = dense.uni_order(v, f, rot, trans, fl, pp, device="cpu", **dims)
    np.testing.assert_array_equal(perm, want_perm)
    assert k == want_k and 100 < k < len(f)


def test_routing_probes_match_jax():
    """routing_stats (one view), its batched form (the probe of
    dense.probe_budget) against the JAX renderer's routing probe, and
    each row of the curve against candidate_stats at that threshold."""
    v, f = sc.routing_scene()
    rot, trans, fl, pp = _views(3, 256, 96, radius=2.5)
    dims = dict(height=96, width=256)
    fv = v[f]
    with jax.disable_jit():
        want_one = np.asarray(jdense.routing_stats(
            v, f, rot[0], trans[0], fl[0], pp[0], **dims))
        want_batch = np.asarray(jrender._dense_routing_probe(
            jnp.asarray(v), jnp.asarray(f), jnp.asarray(fv), rot, trans, fl,
            pp, clip_near=False, **dims))
    got_one = dense.routing_stats(v, f, rot[0], trans[0], fl[0], pp[0],
                                  device="cpu", **dims)
    np.testing.assert_array_equal(got_one.numpy()[:, :2], want_one)
    got = dense.routing_stats_batch(None, None, rot, trans, fl, pp,
                                    face_vertices=torch.from_numpy(fv),
                                    device="cpu", **dims)
    np.testing.assert_array_equal(got.numpy()[:, :2], want_batch)
    for i, m in enumerate(dense.ROUTING_THRESHOLDS):
        row = dense.candidate_stats(v, f, rot[0], trans[0], fl[0], pp[0],
                                    micro_max=m, device="cpu", **dims)
        np.testing.assert_array_equal(got_one[i].numpy(), row.numpy())
    stats = dense.candidate_stats_batch(None, None, rot, trans, fl, pp,
                                        face_vertices=torch.from_numpy(fv),
                                        micro_max=3, device="cpu", **dims)
    np.testing.assert_array_equal(stats.numpy()[:2], want_batch[1])


CURVES = [
    ([(10**6, 0), (5 * 10**5, 0), (0, 100), (0, 100)], 2000, 0),
    ([(0, 499392)] * 4, 499392, 0),
    ([(106714, 8701), (39412, 66810), (2504, 97360), (0, 99372)], 99372, 0),
    ([(106727, 18799), (44160, 66810), (11975, 97360), (623, 99372)], 99372,
     0),
    ([(1000, 0), (500, 200000), (0, 100000), (0, 100000)], 10**6, 0),
    ([(1000, 0), (500, 200000), (0, 100000), (0, 100000)], 10**6, 256),
]


@pytest.mark.parametrize("i", range(len(CURVES)))
def test_routing_pick_matches_jax_with_its_coefficients(i):
    curve, rows, floor = CURVES[i]
    want = jdense.pick_micro_max(curve, rows, min_pairs_budget=floor)
    assert dense.pick_micro_max(curve, rows, min_pairs_budget=floor,
                                **JAX_ROUTE) == want
    assert dense.pick_route(curve, rows, min_pairs_budget=floor,
                            **JAX_ROUTE) == jdense.pick_route(
        curve, rows, min_pairs_budget=floor)
    # the port's own (H100) coefficients still pick a probed threshold
    assert dense.pick_micro_max(curve, rows) in dense.ROUTING_THRESHOLDS


def test_split_gate_and_margins_match_jax():
    for k, rows, micro, m in [(411_600, 500_000, 500_000, 2),
                              (0, 99_372, 8_700, 2), (0, 500_000, 500_000, 2),
                              (10, 100, 30, 2), (10, 100, 80, 3),
                              (50, 100, 10, 4)]:
        assert dense.split_frag_rows(k, rows, m) == \
            jdense.split_frag_rows(k, rows, m)
        assert dense.compact_frag_rows(micro, rows, m) == \
            jdense.compact_frag_rows(micro, rows, m)
        assert dense.split_wins(k, rows, micro, m) == \
            jdense.split_wins(k, rows, micro, m)
    assert dense.BUDGET_MARGIN == jdense.BUDGET_MARGIN
    assert (dense.TILE_H, dense.TILE_W, dense.K_SPAN) == (
        jdense.TILE_H, jdense.TILE_W, jdense.K_SPAN)
    assert dense.ROUTING_THRESHOLDS == jdense.ROUTING_THRESHOLDS


@pytest.mark.parametrize("form", ["int", "pair", "triple", "quad"])
def test_dense_e_cap_forms_match_jax(form):
    """rasterize(..., backend="dense", dense_e_cap=...) in each of the
    budget forms, against the JAX facade; the four-tuple is the uni-slot
    prefix with faces permuted eligible-first."""
    from semantic_meshes import rasterize as jrast

    v, f = sc.uni_scene()
    cam = sc.ring_cam(256, 96)
    perm, k = sc.uni_perm(v, f, cam, 96, 256)
    with jax.disable_jit():
        stats = {m: [int(x) for x in np.asarray(jdense.candidate_stats(
            v, f, *cam, height=96, width=256, micro_max=m))] for m in (2, 3)}
        pairs_s = int(jdense.candidate_count(
            v, f[perm], *cam, height=96, width=256, micro_split=k))
    faces = f[perm] if form == "quad" else f
    (p2, m2), (p3, m3) = stats[2], stats[3]
    cap = {"int": 2 * p2, "pair": (2 * p2, 2 * m2),
           "triple": (2 * p3, 2 * m3, 3),
           "quad": (2 * pairs_s, 0, None, k)}[form]
    with jax.disable_jit():
        want = jrast.rasterize(v, faces, *cam, height=96, width=256,
                               backend="dense", dense_e_cap=cap)
    got = trast.rasterize(v, faces, *cam, height=96, width=256,
                          backend="dense", dense_e_cap=cap, device="cpu")
    sc.assert_images_match(tuple(np.asarray(x) for x in want), got)
    assert int(got[2]) == 0
