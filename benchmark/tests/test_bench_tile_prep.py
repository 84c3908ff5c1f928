"""The reader of the tile preparation's device time a view sums the
preparation kernels' device time over the traced views, and reads nothing
where none ran."""

from types import SimpleNamespace

import pytest

from benchmark import spec, tracing
from benchmark.tests.test_bench_metrics import canned_trace


def _x(name, ts, dur):
    return dict(ph="X", cat="kernel", name=name, ts=ts, dur=dur)


def test_tile_prep_time_a_view_reads_the_kernels():
    read = spec.reader("tile_prep.device_ms_per_view")
    events = canned_trace() + [
        _x("(anonymous namespace)::tile_setup_kernel(sm_tile_prep::Params)",
           160, 3),
        _x("(anonymous namespace)::tile_bins_kernel(sm_tile_prep::Params)",
           170, 5),
        _x("tile_bins_kernel_other", 250, 9),
        _x("(anonymous namespace)::tile_bins_kernel(sm_tile_prep::Params)",
           320, 50),  # after the traced batches
    ]
    ctx = SimpleNamespace(trace=tracing.TraceSummary(events), traced_views=4)
    assert read(ctx) == pytest.approx(8.0 / 1e3 / 4)


def test_tile_prep_time_reads_nothing_without_its_kernels():
    read = spec.reader("tile_prep.device_ms_per_view")
    assert read(SimpleNamespace(trace=None, traced_views=0)) is None
    ctx = SimpleNamespace(trace=tracing.TraceSummary(canned_trace()),
                          traced_views=4)
    assert read(ctx) is None  # the parent's torch chain


def test_tile_prep_time_is_declared_for_the_simplified_cell():
    b = spec.load()
    (m,) = [m for m in b["per_layer"]
            if m["name"] == "tile_prep.device_ms_per_view"]
    assert (m["layer"], m["moves"], m["source"], m["better"], m["unit"]) == (
        "tile preparation", "fuse_mpix_s", "device_trace", "lower", "ms")
    assert m["workloads"] == ["scannet-simplified.triangles"]
