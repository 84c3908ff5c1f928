"""The dense rasterizer's host side against the JAX package, on the CPU: the
overflow policy's schedule, the cap policy, the renderer's probes and
budget regrowth, plan_fuse's budget tuple and face permutation, and the
batched fusion under a plan.

Policies replay the same call sequences on both packages and must agree
call by call (returns, warnings, totals). Plans and budgets are integers
and must be equal; the port is given the JAX package's routing
coefficients (its own defaults are H100 numbers). plan_fuse runs op by op
on the JAX side (see tests/_torch_dense_scenes.py); the renderers and the
fusion run jitted, as the JAX package's users call them, and agree on
these scenes. Fused accumulators compare at rtol 1e-5, atol 1e-6 (another
summation order).
"""

import logging
from dataclasses import replace
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_meshes import distributed as jdist
from semantic_meshes import render as jrender
from semantic_meshes import testing as jtesting
from semantic_meshes.data import stack_cameras
from semantic_meshes.rasterize import dense as jdense
from semantic_meshes_torch import data, distributed, render, testing
from semantic_meshes_torch.rasterize import dense

JAX_ROUTE = dict(alpha=jdense.ROUTE_ALPHA, beta=jdense.ROUTE_BETA,
                 gamma=jdense.ROUTE_GAMMA)
RTOL, ATOL = 1e-5, 1e-6
EVERY = render._OverflowPolicy.RECHECK_EVERY


def _steps(n, value, key="a", **kw):
    return [(value, key, kw)] * n


SCHEDULES = {
    "first_frame_warns_per_key": ("first", [(5, "a", {}), (3, "b", {})]),
    "no_warning_when_zero": ("first", [(0, "a", {})]),
    "post_first_frames_stay_async": ("first", _steps(1, 0) + _steps(10, 7)),
    "recheck_reports_only_new_drops": (
        "first", _steps(1, 5, recheck=True) + _steps(1, 2, recheck=True)),
    "recheck_silent_when_nothing_new": (
        "first", _steps(1, 5, recheck=True) + _steps(1, 0, recheck=True)),
    "recheck_power_of_two_schedule": (
        "first", _steps(3, 0, recheck=True) + _steps(2, 1, recheck=True)),
    "dropped_key_rechecks_at_duty_cycle": (
        "first", _steps(1, 0, recheck=True) + _steps(1, 1, recheck=True)
        + _steps(2 * EVERY, 0, recheck=True) + _steps(EVERY, 1, recheck=True)),
    "hot_key_bounded_detection": (
        "first", _steps(2 * EVERY + 2, 0, recheck=True, hot=True)
        + _steps(EVERY, 1, recheck=True, hot=True)),
    "undropped_key_async_between_ticks": (
        "first", _steps(127, 0, recheck=True)),
    "keys_do_not_cross_contaminate": (
        "first", [(0, "a", dict(recheck=True)), (100, "b", {}),
                  (0, "a", dict(recheck=True))]),
    "dense_knob_message": ("first", [(3, "a", dict(dense=True))]),
    "always_mode_warns_every_breach": (
        "always", [(4, "a", {}), (0, "a", {}), (6, "a", {})]),
    "never_mode": ("never", [(9, "a", {})]),
    "total_sums_across_keys": (
        "first", [(1, "a", {}), (2, "b", {}), (3, "a", {})]),
}


class _Records(logging.Handler):
    def __init__(self):
        super().__init__(logging.WARNING)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def _replay(policy, logger_name, steps, scalar):
    handler = _Records()
    log = logging.getLogger(logger_name)
    log.addHandler(handler)
    try:
        trace = []
        for value, key, kw in steps:
            before = len(handler.messages)
            got = policy.check(scalar(value), (key,), 8, **kw)
            trace.append((got, handler.messages[before:],
                          len(policy._pending.get((key,), []))))
        return trace, policy.total(), dict(policy._calls)
    finally:
        log.removeHandler(handler)


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_overflow_policy_schedule_matches_jax(name):
    mode, steps = SCHEDULES[name]
    want = _replay(jrender._OverflowPolicy(mode), "semantic_meshes",
                   steps, lambda n: jnp.asarray(n, jnp.int32))
    got = _replay(render._OverflowPolicy(mode), "semantic_meshes_torch",
                  steps, lambda n: torch.tensor(n, dtype=torch.int32))
    assert got == want
    if name == "dropped_key_rechecks_at_duty_cycle":
        assert sum(r for r, _, _ in got[0][-EVERY:]) > 0
    if name == "undropped_key_async_between_ticks":
        assert got[0][-1][2] == 62  # pending, unsynced since the n=64 tick


def _policy_state(pol):
    """A cap policy's budgets and floors in one form for both packages:
    budgets as records without the global bucket's cap (the JAX package
    has none), floors as (pairs, micro)."""
    caps = {k: dense.DenseBudget.of(c) if isinstance(c, tuple)
            else replace(c, n_global=dense.N_GLOBAL)
            for k, c in pol._cap.items()}
    floors = {k: f if isinstance(f, tuple) else (f.pairs, f.micro)
              for k, f in pol._floor.items()}
    return caps, floors


def test_cap_policy_matches_jax():
    """lookup (2x margin, micro_max carried unscaled), floor and the
    grow-only doubling of invalidate, step by step: the port's policy
    budgets the JAX policy's probed counts with DenseBudget.from_counts."""
    pols = (jrender._DenseCapPolicy(), render._DenseCapPolicy())
    key = (64, 128)

    def budget(counts):
        return lambda floor: dense.DenseBudget.from_counts(
            *(counts + (None,))[:3], 0, floor)

    for probe in [(10, 3, 2), (500, 0), (0, 7, 4), (40, 40, 3)]:
        for pol in pols:
            pol.invalidate(key)
        pols[0].lookup(key, lambda: probe)
        pols[0].lookup(key, lambda: (10**9, 10**9))  # cached, not probed
        pols[1].lookup(key, budget(probe))
        pols[1].lookup(key, budget((10**9, 10**9)))
        assert _policy_state(pols[1]) == _policy_state(pols[0])
        assert pols[0].floor(key) == _policy_state(pols[1])[1].get(key,
                                                                    (0, 0))
    # doubled three times, n_global too; micro_max and split_k kept
    assert pols[1]._floor[key] == dense.DenseBudget(4000, 1024, 4, 0,
                                                    8 * dense.N_GLOBAL)


def _regrow_scene():
    vertices, faces = testing.make_cube(subdivisions=5)  # 300 faces
    cams = {name: testing.make_ring_cameras(num_views=1, width=128,
                                            height=64, radius=dist)[0]
            for name, dist in (("far", 14.0), ("near", 2.2))}
    return SimpleNamespace(vertices=vertices, faces=faces), cams


def _renderers(mesh, **kw):
    return (jrender.TrianglesRenderer(mesh, backend="dense"),
            render.TrianglesRenderer(mesh, backend="dense", route=JAX_ROUTE,
                                     device="cpu", **kw))


def _state(r):
    return (*_policy_state(r.dense_cap_policy), r.overflow_total())


def _ids(out):
    return np.asarray(out[0]).view(np.int32)


def test_dense_cap_regrow_matches_jax():
    """A far probe frame under-sizes the budget for a near view: the breach
    is found at the duty-cycle re-check, the cap invalidated and regrown
    from a doubled floor, then nothing more drops, on both packages."""
    mesh, cams = _regrow_scene()
    jr, tr = _renderers(mesh)
    for step, name in enumerate(["far", "near", "near", "near"]):
        want = jr.render(cams[name])
        got = tr.render(cams[name])
        np.testing.assert_array_equal(_ids(got), _ids(want))
        assert _state(tr) == _state(jr), step
    cap, floor, dropped = _state(tr)
    assert dropped > 0 and floor and cap  # it did breach, and regrew


def test_alternating_cameras_converge_as_jax():
    mesh, cams = _regrow_scene()
    jr, tr = _renderers(mesh)
    for _ in range(12):
        for name in ("far", "near"):
            tr.render(cams[name])
            jr.render(cams[name])
    settled = tr.overflow_total()
    assert settled > 0 and settled == jr.overflow_total()
    for _ in range(3):
        tr.render(cams["far"])
        tr.render(cams["near"])
    assert tr.overflow_total() == settled
    assert _state(tr)[:2] == _state(jr)[:2]


def test_zero_budget_recheck_warns_and_regrows(caplog):
    """An all-micro probe frame pins the pair budget to 0; a later view
    with pairs warns at its frame-2 re-check, counts every dropped pair,
    and the next render re-probes with a nonzero budget."""
    vertices, faces = testing.make_cube(subdivisions=4)
    mesh = SimpleNamespace(vertices=vertices, faces=faces)
    far = testing.make_ring_cameras(1, 256, 128, radius=80.0)[0]
    close = testing.make_ring_cameras(1, 256, 128, radius=2.0)[0]
    jr, tr = _renderers(mesh)
    with caplog.at_level(logging.WARNING, logger="semantic_meshes_torch"):
        tr.render(far)
        assert tr.dense_cap_policy._cap[(128, 256)].pairs == 0
        assert not any("overflow" in m for m in caplog.messages)
        tr.render(close)
    assert any("re-probe" in m for m in caplog.messages), caplog.messages
    jr.render(far)
    jr.render(close)
    dropped = tr.overflow_total()
    assert dropped > 0 and dropped == jr.overflow_total()
    assert (128, 256) not in tr.dense_cap_policy._cap
    tr.render(close)
    assert tr.dense_cap_policy._cap[(128, 256)].pairs > 0
    assert tr.overflow_total() == dropped


def test_renderer_probes_once_and_auto_matches_fixed():
    v, f = testing.make_cube(8)
    mesh = SimpleNamespace(vertices=v, faces=f)
    cams = testing.make_ring_cameras(num_views=2, width=128, height=96)
    jr, tr = _renderers(mesh)
    ids = tr.render(cams[0])[0]
    want = jr.render(cams[0])
    np.testing.assert_array_equal(_ids((ids,)), _ids(want))
    key = (96, 128)
    cap = tr.dense_cap_policy._cap[key]
    assert _state(tr)[0] == _state(jr)[0]
    assert cap.split_k == 0 and cap.micro_max in (2, 3, 4, 5)
    assert cap.pairs >= 2
    tr.render(cams[1])
    assert tr.dense_cap_policy._cap[key] == cap  # cached: no re-probe
    for m in (2, 5):
        fixed = render.TrianglesRenderer(mesh, backend="dense", micro_max=m,
                                         device="cpu")
        assert torch.equal(fixed.render(cams[0])[0], ids)
        assert fixed.dense_cap_policy._cap[key].micro_max == m
    assert tr.overflow_total() == 0


def test_render_many_and_prepare():
    """render_many probes the max over its batch and equals per-view
    renders; after prepare() single renders never breach."""
    v, f = testing.make_cube(20)
    mesh = SimpleNamespace(vertices=v, faces=f)
    cams = testing.make_ring_cameras(num_views=3, width=128, height=64)
    cams += testing.make_ring_cameras(num_views=2, width=128, height=64,
                                      radius=1.8)
    r = render.TrianglesRenderer(mesh, backend="dense", device="cpu")
    ids, depth = r.render_many(cams)
    assert ids.shape == (5, 128, 64) and depth.shape == (5, 128, 64)
    r2 = render.TrianglesRenderer(mesh, backend="dense", device="cpu")
    r2.prepare(cams)
    for k, cam in enumerate(cams):
        i, d = r2.render(cam)
        assert torch.equal(i, ids[k]) and torch.equal(d, depth[k])
    assert r.dense_cap_policy._cap == r2.dense_cap_policy._cap
    assert r.overflow_total() == 0 and r2.overflow_total() == 0


@pytest.mark.parametrize("lens", ["pinhole", "simple_radial"])
@pytest.mark.parametrize("micro_max", [None, 3])
def test_renderer_and_plan_share_one_budget(micro_max, lens):
    """TrianglesRenderer.prepare and plan_fuse(allow_split=False) budget
    the same cameras through one probe function: equal records, the
    global bucket's cap past N_GLOBAL included (1485 big rows). A breach's
    floor doubles pairs and micro (at least 256) and n_global and keeps
    micro_max and split_k; the re-probe holds every budget at its floor."""
    v, f, cam = testing.big_rows_scene()
    dist = np.array([-0.12, 0, 0, 0], np.float32) \
        if lens == "simple_radial" else None
    cams = [data.Camera(cam.rotation, t, cam.resolution, cam.focal_lengths,
                        cam.principal_point, distortion=dist)
            for t in ([0.0, 0.0, 0.0], [0.5, -0.2, 1.0])]
    lenses = data.stack_distortions(cams) if lens == "simple_radial" \
        else None
    r = render.TrianglesRenderer(SimpleNamespace(vertices=v, faces=f),
                                 backend="dense", micro_max=micro_max,
                                 device="cpu")
    r.prepare(cams)
    key = (cam.resolution[1], cam.resolution[0])
    budget = r.dense_cap_policy._cap[key]
    plan = distributed.plan_fuse(
        v, f, *data.stack_cameras(cams), height=key[0], width=key[1],
        backend="dense", micro_max=micro_max, distortions=lenses,
        allow_split=False, device="cpu")
    assert plan.dense_e_cap == budget
    assert budget.n_global > dense.N_GLOBAL and budget.split_k == 0
    assert micro_max is None or budget.micro_max == micro_max

    r.dense_cap_policy.invalidate(key)
    floor = r.dense_cap_policy._floor[key]
    assert floor == dense.DenseBudget(
        max(2 * budget.pairs, 256), max(2 * budget.micro, 256),
        budget.micro_max, 0, 2 * budget.n_global)
    r.render(cams[0])
    again = r.dense_cap_policy._cap[key]
    assert (again.pairs >= floor.pairs and again.micro >= floor.micro
            and again.n_global >= floor.n_global)
    assert r.overflow_total() == 0


PLAN_CASES = {
    # (subdivisions, views, width, height, plan keywords)
    "split": (40, 3, 128, 96, {}),
    "no_split": (40, 3, 128, 96, dict(allow_split=False)),
    "fixed_m3": (40, 3, 128, 96, dict(micro_max=3)),
    "compaction_wins": (3, 2, 160, 96, {}),
}


def _plans(name, monkeypatch):
    sub, n, w, h, kw = PLAN_CASES[name]
    v, f = jtesting.make_cube(sub)
    cams = jtesting.make_ring_cameras(num_views=n, width=w, height=h)
    rot, trans, fl, pp = stack_cameras(cams)
    monkeypatch.setenv("SM_RASTERIZER", "dense")
    with jax.disable_jit():
        jplan = jdist.plan_fuse(v, f, rot, trans, fl, pp, height=h, width=w,
                                **kw)
    tplan = distributed.plan_fuse(v, f, rot, trans, fl, pp, height=h,
                                  width=w, backend="dense", route=JAX_ROUTE,
                                  device="cpu", **kw)
    return (v, f, rot, trans, fl, pp, h, w), jplan, tplan


@pytest.mark.parametrize("name", sorted(PLAN_CASES))
def test_plan_fuse_matches_jax(name, monkeypatch):
    _, jplan, tplan = _plans(name, monkeypatch)
    assert tplan.dense_e_cap == dense.DenseBudget.of(jplan.dense_e_cap)
    assert tplan.dense_e_cap.split_k == jplan.split_k
    assert tplan.dense_e_cap.micro_max == jplan.micro_max
    np.testing.assert_array_equal(tplan.faces.numpy(),
                                  np.asarray(jplan.faces))
    if jplan.remap is None:
        assert tplan.remap is None
    else:
        np.testing.assert_array_equal(tplan.remap.numpy(),
                                      np.asarray(jplan.remap))
    assert (tplan.dense_e_cap.split_k > 0) == (name in ("split", "fixed_m3"))


@pytest.mark.parametrize("name", ["split", "compaction_wins"])
def test_fuse_views_planned_matches_jax(name, monkeypatch):
    (v, f, rot, trans, fl, pp, h, w), jplan, tplan = _plans(name,
                                                            monkeypatch)
    rng = np.random.default_rng(3)
    probs = np.stack([jtesting.random_probs(rng, h, w, 5)
                      for _ in range(len(rot))])
    kw = dict(num_primitives=len(f), aggregator="sum", height=h, width=w)
    want, jov = jdist.fuse_views_planned(
        jplan, v, rot, trans, fl, pp, jnp.asarray(probs), np.float32(0.5),
        **kw)
    got, ov = distributed.fuse_views_planned(
        tplan, v, rot, trans, fl, pp, probs, 0.5, device="cpu", **kw)
    assert int(ov) == int(jov) == 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    assert float(got.abs().sum()) > 0


@pytest.mark.parametrize("agg", ["sum", "summax", "mul"])
def test_fuse_views_split_equals_fuse_views(agg):
    """plan -> permute -> fuse in original face order reproduces the
    unplanned fusion bit for bit, for every aggregator."""
    v, f = testing.make_cube(40)
    cams = testing.make_ring_cameras(num_views=3, width=128, height=96)
    rot, trans, fl, pp = stack_cameras(cams)
    rng = np.random.default_rng(0)
    probs = np.stack([testing.random_probs(rng, 96, 128, 5)
                      for _ in range(3)])
    kw = dict(num_primitives=len(f), aggregator=agg, height=96, width=128,
              backend="dense", device="cpu")
    a0, ov0 = distributed.fuse_views(v, f, rot, trans, fl, pp, probs, 0.5,
                                     **kw)
    a1, ov1 = distributed.fuse_views_split(v, f, rot, trans, fl, pp, probs,
                                           0.5, **kw)
    assert int(ov0) == 0 and int(ov1) == 0
    assert torch.equal(a0, a1)
