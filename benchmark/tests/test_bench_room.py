"""The `scannet-room.triangles` cell loads with its configuration and
traffic, and the readers of the global bucket's metrics read the
program's counter and the trace, or nothing where there is none."""

from types import SimpleNamespace

import numpy as np
import pytest

from benchmark import scene, spec, tracing
from benchmark.tests.test_bench_metrics import canned_trace
from semantic_meshes_torch import profiling

CELL = "scannet-room.triangles"


def test_the_room_cell_loads():
    b = spec.load()
    cell = spec.cell(b, CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "scannet-room", "eval-triangles", 1)
    config = spec.config(b, "scannet-room")
    assert (config["width"], config["height"], config["classes"],
            config["aggregator"], config["images_equal_weight"]) == (
        1296, 968, 40, "mul", 0.5)
    assert config["reduced"] == [] and config["frames"] == 1650
    traffic = spec.traffic(cell["traffic"])
    assert (traffic["entry"], traffic["views_per_batch"]) == ("per_view", 1)
    per_layer = {m["name"] for m in spec.metrics_of(b, CELL, "per_layer")}
    assert per_layer == {"dense_prep.global_rows",
                         "raster_dense.device_ms_per_view"}
    assert {m["name"] for m in spec.metrics_of(b, CELL, "end_to_end")} == {
        "fuse_mpix_s", "setup_s"}
    # every eye lies inside the room, above its floor
    rot, trans = scene.trajectory(config, 2**31 + 5)[:2]
    eyes = -np.einsum("nji,nj->ni", rot, trans)
    half = config["mesh_size"] / 2
    assert (np.abs(eyes) < 0.5 * half).all() and (eyes[:, 1] > -half).all()


def test_global_rows_reads_the_counter(monkeypatch):
    read = spec.reader("dense_prep.global_rows")
    ctx = SimpleNamespace(trace=None)
    monkeypatch.setattr(profiling, "_counters", {})
    assert read(ctx) is None  # the probe never ran
    profiling.counter_max("dense.global_rows", 1722)
    profiling.counter_max("dense.global_rows", 616)
    assert read(ctx) == 1722.0
    monkeypatch.delattr(profiling, "counters")
    assert read(ctx) is None  # a program without counters


def test_kernel_b_time_a_view_reads_the_trace():
    read = spec.reader("raster_dense.device_ms_per_view")
    t = tracing.TraceSummary(canned_trace())
    ctx = SimpleNamespace(trace=t, traced_views=8)
    assert read(ctx) == pytest.approx(20.0 / 1e3 / 8)
    assert read(SimpleNamespace(trace=None, traced_views=0)) is None
    empty = tracing.TraceSummary([dict(ph="X", cat="user_annotation",
                                       name=tracing.SPAN, ts=0, dur=10)])
    assert read(SimpleNamespace(trace=empty, traced_views=8)) is None
