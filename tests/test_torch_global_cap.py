"""The dense global bucket's cap sized from the set-up probe, on the CPU.

The probes count the big rows of a view (the triangles that span more
than 2x2 dense tiles, tested by every tile); the renderers and plan_fuse
size `n_global` from the largest count, at least dense.N_GLOBAL (the JAX
package's fixed cap, which a direct dense.rasterize call keeps). On a
scene of 1485 big rows the renderer drops nothing and gives the uncapped
plain chain's image, the float64 reference's owners, and the planned
batch's fusion; a breach found after the probe grows the cap, never
shrinks it.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark.reference import raster as reference
from semantic_meshes_torch import distributed, fusion, profiling, render
from semantic_meshes_torch import testing
from semantic_meshes_torch.data import Camera, stack_cameras
from semantic_meshes_torch.rasterize import dense, dense_kernel

H, W = 64, 128
K_BIG = dense.K_SPAN  # pairs a row in a budget: no pair can spill


def _mesh(v, f):
    return SimpleNamespace(vertices=v, faces=f)


def _args(cam):
    return (cam.rotation, cam.translation, cam.focal_lengths,
            cam.principal_point)


def _bucket(v, f, cam, height, width, **kw):
    """Big rows of one view as the binning lays them out: the global
    bucket's length in the starts the z-resolve reads, under budgets that
    bind nothing."""
    args, _, overflow = dense.resolve_inputs_plain(
        v, f, *_args(cam), height=height, width=width, n_global=2**30,
        e_cap_factor=K_BIG, device="cpu", **kw)
    starts = args[2]
    B = starts.numel() - 2
    assert int(overflow) == 0
    return int(starts[B + 1] - starts[B])


def _room_views(n=3, width=160, height=120):
    """Views inside a 4 m room of 432 triangles at the room cell's
    INDOOR_RING pose, small frames: the floor and walls beside the eye
    span many tiles."""
    v, f = testing.make_cube(6, size=4.0)
    cams = testing.make_ring_cameras(n, width, height, radius=0.8,
                                     elevation=-0.625, focal=0.9 * height,
                                     target=(0.0, -0.9, 0.0))
    return v, f, cams


@pytest.mark.parametrize("scene", ["big_rows", "room"])
def test_probe_counts_the_global_bucket(scene):
    """The probes' third column is the global bucket's length before the
    cap, at every routing threshold, and its batched form is the max over
    the views."""
    if scene == "big_rows":
        v, f, cam = testing.big_rows_scene()
        cams, h, w = [cam], H, W
    else:
        v, f, cams = _room_views()
        h, w = 120, 160
    want = [_bucket(v, f, c, h, w) for c in cams]
    assert max(want) > 0
    for m in dense.ROUTING_THRESHOLDS:
        for c, n in zip(cams, want):
            stats = dense.candidate_stats(v, f, *_args(c), height=h,
                                          width=w, micro_max=m, device="cpu")
            assert int(stats[2]) == n == _bucket(v, f, c, h, w, micro_max=m)
    for c, n in zip(cams, want):
        curve = dense.routing_stats(v, f, *_args(c), height=h, width=w,
                                    device="cpu")
        assert curve.shape == (len(dense.ROUTING_THRESHOLDS), 3)
        assert (curve[:, 2] == n).all()
    rot, trans, fl, pp = stack_cameras(cams)
    batch = dense.candidate_stats_batch(v, f, rot, trans, fl, pp, height=h,
                                        width=w, device="cpu")
    curve = dense.routing_stats_batch(v, f, rot, trans, fl, pp, height=h,
                                      width=w, device="cpu")
    assert int(batch[2]) == max(want) and (curve[:, 2] == max(want)).all()


def test_global_budget_floor_and_margin():
    assert dense.global_budget(0) == dense.N_GLOBAL
    assert dense.global_budget(300) == dense.N_GLOBAL
    assert dense.global_budget(1485) == 2 * 1485
    assert dense.global_budget(10, floor=5000) == 5000


def _owners_agree(ids, view):
    """Every pixel the program owns differently from the float64
    reference is fragile there, with the program's owner among its
    possible owners."""
    ids = ids.reshape(-1).long()
    differ = torch.nonzero(ids != view.ids).reshape(-1).tolist()
    allowed = set(zip(view.fragile_pix.tolist(), view.fragile_ids.tolist()))
    for p in differ:
        q = int(ids[p])
        assert q < 0 or (p, q) in allowed, (p, q)


def test_renderer_holds_every_big_row():
    """1485 big rows in one view: a direct dense.rasterize call drops the
    rows past N_GLOBAL, as the JAX package does; the renderer sizes its
    cap from the probe, drops nothing, and its ids and depths equal the
    plain chain's at a cap over the bucket, whose owners are the float64
    reference's."""
    v, f, cam = testing.big_rows_scene()
    bucket = _bucket(v, f, cam, H, W)
    assert bucket > dense.N_GLOBAL
    capped = dense.rasterize(v, f, *_args(cam), height=H, width=W,
                             device="cpu")
    assert int(capped[2]) == bucket - dense.N_GLOBAL

    r = render.triangles(_mesh(v, f), backend="dense", device="cpu")
    r.prepare([cam])
    ids, depth = r.render(cam)
    assert r.overflow_total() == 0
    assert r.dense_cap_policy._cap[(H, W)].n_global == 2 * bucket
    counters = profiling.counters()
    assert counters["dense.global_rows"] >= bucket
    assert counters["dense.n_global"] >= 2 * bucket

    args, _, overflow = dense.resolve_inputs_plain(
        v, f, *_args(cam), height=H, width=W, n_global=bucket,
        e_cap_factor=K_BIG, device="cpu")
    assert int(overflow) == 0
    want_z, want_ids = dense_kernel.resolve_dense_plain(*args)
    got_ids = ids.view(torch.int32).t()
    assert torch.equal(got_ids, want_ids)
    assert torch.equal(depth.t().view(torch.int32),
                       want_z.view(torch.int32))
    assert not torch.equal(got_ids, capped[0])  # the cap mattered

    view = reference.rasterize(torch.as_tensor(v), torch.as_tensor(f).long(),
                               *(torch.as_tensor(a) for a in _args(cam)),
                               height=H, width=W)
    _owners_agree(got_ids, view)


def test_plan_fuse_carries_the_cap_to_the_batched_path():
    """plan_fuse sizes the same cap from the same probe; the planned batch
    drops nothing and fuses what the per-view render -> add path fuses."""
    v, f, cam = testing.big_rows_scene()
    cams = [cam, Camera(cam.rotation, [0.5, -0.2, 1.0], cam.resolution,
                        cam.focal_lengths, cam.principal_point)]
    rot, trans, fl, pp = stack_cameras(cams)
    rng = np.random.default_rng(3)
    probs = np.stack([testing.random_probs(rng, H, W, 4) for _ in cams])

    plan = distributed.plan_fuse(v, f, rot, trans, fl, pp, height=H,
                                 width=W, backend="dense", device="cpu")
    bucket = max(_bucket(v, f, c, H, W) for c in cams)
    assert plan.dense_e_cap.n_global == 2 * bucket
    acc, overflow = distributed.fuse_views_planned(
        plan, v, rot, trans, fl, pp, probs, 0.5, num_primitives=len(f),
        aggregator="sum", height=H, width=W, backend="dense", device="cpu")
    assert int(overflow) == 0

    r = render.triangles(_mesh(v, f), backend="dense", device="cpu")
    r.prepare(cams)
    agg = fusion.MeshAggregator(len(f), 4, "sum", 0.5, device="cpu")
    for k, c in enumerate(cams):
        agg.add(r.render(c)[0], torch.as_tensor(probs[k]).transpose(0, 1))
    assert r.overflow_total() == 0
    assert r.dense_cap_policy._cap[(H, W)].n_global == \
        plan.dense_e_cap.n_global
    torch.testing.assert_close(acc, agg.state, rtol=1e-6, atol=1e-6)


def test_breach_regrows_n_global_and_never_shrinks_it():
    """A single render probes only its own view: a later view with more
    big rows than that cap breaches it, the overflow policy finds the
    breach, and the next render re-probes with a cap grown past the
    bucket. Further re-probes, even on a view with few big rows, keep a
    cap at least as large."""
    v, f, cam = testing.big_rows_scene()
    bucket = _bucket(v, f, cam, H, W)
    far = Camera(cam.rotation, [0.0, 0.0, 40.0], cam.resolution,
                 cam.focal_lengths, cam.principal_point)
    assert _bucket(v, f, far, H, W) < dense.N_GLOBAL // 2
    r = render.triangles(_mesh(v, f), backend="dense", device="cpu")
    policy = r.dense_cap_policy
    key = (H, W)
    r.render(far)
    caps = [policy._cap[key].n_global]
    assert caps[0] == dense.N_GLOBAL and r.overflow_total() == 0
    r.render(cam)  # the breach, found at the policy's second check
    dropped = r.overflow_total()
    assert dropped > 0 and key not in policy._cap
    assert policy._floor[key].n_global == 2 * caps[0]
    r.render(cam)  # re-probes
    caps.append(policy._cap[key].n_global)
    assert caps[-1] >= 2 * bucket and r.overflow_total() == dropped
    for _ in range(2):
        policy.invalidate(key)
        r.render(far)
        caps.append(policy._cap[key].n_global)
    assert caps == sorted(caps) and caps[-1] > caps[1]
    r.render(cam)
    assert r.overflow_total() == dropped
