"""The `scannet-simplified.triangles` cell loads with its configuration and
traffic and routes to the tile rasterizer, and the readers of kernel A's
and the tile preparation's metrics read the trace and the program's
counter, or nothing where there is none."""

from types import SimpleNamespace

import pytest

from benchmark import scene, spec, tracing
from benchmark.tests.test_bench_metrics import canned_trace
from semantic_meshes_torch import profiling, rasterize, render

CELL = "scannet-simplified.triangles"
METRICS = {"raster_tile.device_ms_per_view", "raster_tile.roofline_pct",
           "tile_prep.max_tile_rows"}


def test_the_simplified_cell_loads_and_takes_the_tile_route():
    b = spec.load()
    cell = spec.cell(b, CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "scannet-simplified", "eval-triangles", 1)
    (entry,) = [c for c in b["configs"] if c["name"] == "scannet-simplified"]
    assert entry["reduced"] == []
    config = spec.config(b, "scannet-simplified")
    eval_config = spec.config(b, "scannet-eval")
    # scannet-eval in everything but the mesh
    for key in ("width", "height", "classes", "aggregator",
                "images_equal_weight", "mesh_size", "frames", "pool_frames",
                "intrinsics", "ring", "reduced"):
        assert config[key] == eval_config[key], key
    assert config["subdivisions"] == 29
    vertices, faces = scene.make_cube(config["subdivisions"],
                                      config["mesh_size"])
    assert len(faces) == 10092
    padded = render._face_bucket(len(faces))
    assert padded == 10240 and not rasterize.uses_dense(None, padded)
    traffic = spec.traffic(cell["traffic"])
    assert (traffic["entry"], traffic["mode"], traffic["views_per_batch"]) \
        == ("per_view", "triangles", 1)
    assert {m["name"] for m in spec.metrics_of(b, CELL, "per_layer")} == \
        METRICS
    assert {m["name"] for m in spec.metrics_of(b, CELL, "end_to_end")} == {
        "fuse_mpix_s", "setup_s"}
    for m in b["per_layer"]:
        assert (CELL in m["workloads"]) == (m["name"] in METRICS)
        if m["name"] in METRICS:
            assert m["workloads"] == [CELL] and m["moves"] == "fuse_mpix_s"


def _tile_trace():
    """The canned trace with two launches of kernel A inside the traced
    batches (3 and 5 us) and one after them."""
    def x(name, ts, dur):
        return dict(ph="X", cat="kernel", name=name, ts=ts, dur=dur)

    name = ("(anonymous namespace)::raster_tile_kernel(float4 const*, int "
            "const*, int const*, float*, int*, unsigned long long*, int, "
            "int, int, int, float)")
    return canned_trace() + [x(name, 160, 3), x(name, 250, 5),
                             x("raster_tile_kernel_other", 255, 9),
                             x(name, 320, 50)]


def test_kernel_a_time_a_view_reads_the_trace():
    read = spec.reader("raster_tile.device_ms_per_view")
    ctx = SimpleNamespace(trace=tracing.TraceSummary(_tile_trace()),
                          traced_views=4)
    assert read(ctx) == pytest.approx(8.0 / 1e3 / 4)
    assert read(SimpleNamespace(trace=None, traced_views=0)) is None
    dense_only = SimpleNamespace(trace=tracing.TraceSummary(canned_trace()),
                                 traced_views=4)
    assert read(dense_only) is None


def test_kernel_a_roofline_holds_it_to_kernel_b_bytes():
    read = spec.reader("raster_tile.roofline_pct")
    ctx = SimpleNamespace(trace=tracing.TraceSummary(_tile_trace()),
                          traced_views=4, width=1296, height=968,
                          vertices=5400, faces=10092)
    least_s = (1296 * 968 * 8 + 5400 * 12 + 10092 * 12) / 3.35e12
    assert read(ctx) == pytest.approx(100 * least_s / 4e-6)
    assert read(SimpleNamespace(trace=None)) is None
    ctx.trace = tracing.TraceSummary(canned_trace())
    assert read(ctx) is None


def test_max_tile_rows_reads_the_counter(monkeypatch):
    read = spec.reader("tile_prep.max_tile_rows")
    ctx = SimpleNamespace(trace=None)
    monkeypatch.setattr(profiling, "_counters", {})
    assert read(ctx) is None  # the probe never ran
    profiling.counter_max("tiles.max_tile_rows", 396)
    profiling.counter_max("tiles.max_tile_rows", 311)
    assert read(ctx) == 396.0
    monkeypatch.delattr(profiling, "counters")
    assert read(ctx) is None  # a program without counters
