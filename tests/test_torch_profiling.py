"""The port's spans (semantic_meshes_torch.profiling.span and the `smt.*`
ranges of the fusion path), on the CPU: off without a profiler, one of
each layer's range a view inside its top range under one, set-up ranges
once per set-up call, and results bit-identical either way.

Scenes are a cube of 108 faces forced onto the dense rasterizer (its
plain version), 2 views of 64x48, one torch thread."""

import json

import numpy as np
import pytest
import torch

from semantic_meshes_torch import data, distributed, fusion, profiling
from semantic_meshes_torch import render, testing
from semantic_meshes_torch.data import stack_cameras
from semantic_meshes_torch.io.ply import write_mesh

W, H, C, VIEWS = 64, 48, 5, 2
TOPS = ("smt.render", "smt.add", "smt.fuse_views")
LAYERS = ("smt.dense_prep", "smt.texel_shader", "smt.fusion")
SETUP = ("smt.setup.budgets", "smt.setup.texel_sizing")
MODES = ("triangles", "texels", "planned", "planned_texels")

# mode -> (per-view {layer: its top span}, top spans a run,
#          set-up spans a run)
EXPECTED = {
    "triangles": ({"smt.dense_prep": "smt.render",
                   "smt.fusion": "smt.add"},
                  {"smt.render": VIEWS, "smt.add": VIEWS},
                  {"smt.setup.budgets": 1}),
    "texels": ({"smt.dense_prep": "smt.render",
                "smt.texel_shader": "smt.render", "smt.fusion": "smt.add"},
               {"smt.render": VIEWS, "smt.add": VIEWS},
               {"smt.setup.budgets": 1, "smt.setup.texel_sizing": 1}),
    "planned": ({"smt.dense_prep": "smt.fuse_views",
                 "smt.fusion": "smt.fuse_views"},
                {"smt.fuse_views": 1, "smt.add": 1},
                {"smt.setup.budgets": 1}),
    "planned_texels": ({"smt.dense_prep": "smt.fuse_views",
                        "smt.texel_shader": "smt.fuse_views",
                        "smt.fusion": "smt.fuse_views"},
                       {"smt.fuse_views": 1, "smt.add": 1},
                       {"smt.setup.budgets": 1,
                        "smt.setup.texel_sizing": 1}),
}


@pytest.fixture(scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("spans")
    vertices, faces = testing.make_cube(subdivisions=3)
    write_mesh(tmp / "cube.ply", vertices, faces)
    cams = testing.make_ring_cameras(num_views=VIEWS, width=W, height=H)
    rng = np.random.default_rng(7)
    probs = np.stack([testing.random_probs(rng, H, W, C, 0.1)
                      for _ in range(VIEWS)])  # (N, H, W, C)
    return data.Ply(str(tmp / "cube.ply")), cams, probs


def _run(mode, mesh, cams, probs):
    """Set-up and the views of `mode`: [(name, tensor)] of every result."""
    texels = mode in ("texels", "planned_texels")
    if texels:
        renderer = render.texels(mesh, cams, 1.0, backend="dense",
                                 device="cpu")
    else:
        renderer = render.triangles(mesh, backend="dense", device="cpu")
    agg = fusion.MeshAggregator(renderer.getPrimitivesNum(), C, "mul",
                                device="cpu")
    out = []
    if mode in ("triangles", "texels"):
        renderer.prepare(cams)
        for k, cam in enumerate(cams):
            ids, depth = renderer.render(cam)
            agg.add(ids, probs[k].transpose(1, 0, 2))
            out += [(f"ids{k}", ids), (f"depth{k}", depth)]
        return out + [("acc", agg.state)]
    plan = distributed.plan_fuse(
        renderer.vertices, renderer.faces, *stack_cameras(cams), height=H,
        width=W, backend="dense", allow_split=not texels, device="cpu")
    kw = dict(num_primitives=renderer.getPrimitivesNum(), aggregator="mul",
              height=H, width=W, device="cpu")
    if texels:
        acc, overflow = distributed.fuse_views_texels(
            renderer.vertices, plan.faces, renderer.resolutions,
            renderer.first_texel_index, *stack_cameras(cams), probs, 0.5,
            dense_e_cap=plan.dense_e_cap, backend="dense", **kw)
    else:
        acc, overflow = distributed.fuse_views_planned(
            plan, renderer.vertices, *stack_cameras(cams), probs, 0.5, **kw)
    agg.merge(acc)
    return [("acc", agg.state), ("overflow", overflow)]


@pytest.fixture(scope="module")
def runs(one_thread, scene, tmp_path_factory):
    """mode -> (results untraced, results traced, the trace's smt.*
    ranges as (start, end, name, tid))."""
    out = {}
    for mode in MODES:
        plain = _run(mode, *scene)
        log_dir = tmp_path_factory.mktemp(f"trace_{mode}")
        with profiling.trace_to(log_dir, device="cpu"):
            traced = _run(mode, *scene)
        events = json.loads(
            (log_dir / profiling.TRACE_FILE).read_text())["traceEvents"]
        ranges = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                   e["name"], e.get("tid"))
                  for e in events if e.get("ph") == "X"
                  and e.get("cat") == "user_annotation"
                  and str(e.get("name", "")).startswith("smt.")]
        out[mode] = (plain, traced, ranges)
    return out


def _inside(inner, outer):
    return (outer[0] <= inner[0] and inner[1] <= outer[1]
            and inner[3] == outer[3] and inner is not outer)


@pytest.mark.parametrize("name", TOPS + LAYERS + SETUP)
def test_span_without_profiler_is_the_shared_null_context(name):
    assert not torch.autograd._profiler_enabled()
    before = profiling.timings()
    s = profiling.span(name)
    assert s is profiling.span("another")
    with s:
        pass
    assert profiling.timings() == before


@pytest.mark.parametrize("mode", ["triangles", "planned"])
def test_untraced_hot_path_reads_no_clock_and_opens_no_range(
        one_thread, scene, mode, monkeypatch):
    """After set-up, the fusion path runs with the global timers and
    record_function both made to raise: no span reached either."""
    mesh, cams, probs = scene
    renderer = render.triangles(mesh, backend="dense", device="cpu")
    agg = fusion.MeshAggregator(renderer.getPrimitivesNum(), C, "mul",
                                device="cpu")
    plan = None
    if mode == "triangles":
        renderer.prepare(cams)
    else:
        plan = distributed.plan_fuse(
            renderer.vertices, renderer.faces, *stack_cameras(cams),
            height=H, width=W, backend="dense", device="cpu")

    def boom(*_a, **_k):
        raise AssertionError("a span read the clock or opened a range")

    monkeypatch.setattr(profiling._global_timers, "phase", boom)
    monkeypatch.setattr(profiling, "record_function", boom)
    if plan is None:
        for k, cam in enumerate(cams):
            agg.add(renderer.render(cam)[0], probs[k].transpose(1, 0, 2))
    else:
        acc, _ = distributed.fuse_views_planned(
            plan, renderer.vertices, *stack_cameras(cams), probs, 0.5,
            num_primitives=renderer.getPrimitivesNum(), aggregator="mul",
            height=H, width=W, device="cpu")
        agg.merge(acc)
    assert torch.isfinite(agg.state).all()


@pytest.mark.parametrize("mode", MODES)
def test_each_layer_span_once_a_view_inside_its_top_span(runs, mode):
    _, _, ranges = runs[mode]
    per_view, tops, setups = EXPECTED[mode]
    count = {}
    for r in ranges:
        count[r[2]] = count.get(r[2], 0) + 1
    for layer in LAYERS:
        assert count.get(layer, 0) == (VIEWS if layer in per_view else 0)
    for top in TOPS:
        assert count.get(top, 0) == tops.get(top, 0)
    for name in SETUP:
        assert count.get(name, 0) == setups.get(name, 0)
    for r in ranges:
        outer = [o[2] for o in ranges if _inside(r, o)]
        if r[2] in per_view:
            # inside exactly its top span, and in no other layer span
            assert outer == [per_view[r[2]]], (r, outer)
        elif r[2] in TOPS + SETUP:
            assert outer == [], (r, outer)


@pytest.mark.parametrize("mode", MODES)
def test_results_bit_identical_with_and_without_the_profiler(runs, mode):
    plain, traced, _ = runs[mode]
    assert [n for n, _ in plain] == [n for n, _ in traced]
    for (name, a), (_, b) in zip(plain, traced):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.equal(a, b), name


@pytest.mark.parametrize("profiler", [False, True])
def test_phase_opens_a_range_only_under_a_profiler(tmp_path, monkeypatch,
                                                   profiler):
    opened = []
    real = profiling.record_function

    def recording(name):
        opened.append(name)
        return real(name)

    monkeypatch.setattr(profiling, "record_function", recording)
    t = profiling.PhaseTimers()
    if profiler:
        with profiling.trace_to(tmp_path, device="cpu"):
            with t.phase("alpha"):
                pass
    else:
        with t.phase("alpha"):
            pass
    assert opened == (["alpha"] if profiler else [])
    assert t.counts["alpha"] == 1 and t.totals["alpha"] >= 0.0


def test_set_up_spans_are_timed_without_a_profiler(scene):
    mesh, cams, _ = scene
    before = profiling.timings()
    render.texels(mesh, cams, 1.0, backend="dense",
                  device="cpu").prepare(cams)
    after = profiling.timings()
    for name in SETUP:
        calls = before.get(name, {"calls": 0})["calls"]
        assert after[name]["calls"] == calls + 1
