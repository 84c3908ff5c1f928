"""The reader of fusion's device time a view sums the fusion kernels'
device time over the traced views, and reads nothing where none ran."""

from types import SimpleNamespace

import pytest

from benchmark import spec, tracing
from benchmark.tests.test_bench_metrics import canned_trace


def _x(name, ts, dur):
    return dict(ph="X", cat="kernel", name=name, ts=ts, dur=dur)


def test_fusion_time_a_view_reads_the_kernels():
    read = spec.reader("fusion.device_ms_per_view")
    events = canned_trace() + [
        _x("void (anonymous namespace)::fusion_keys_kernel<int>("
           "sm_fusion::Params)", 160, 4),
        _x("void (anonymous namespace)::fusion_rows_kernel<2, 2>("
           "sm_fusion::Params)", 170, 30),
        _x("(anonymous namespace)::fusion_carry_kernel(sm_fusion::Params)",
           205, 2),
        _x("fusion_rows_kernel_other", 250, 9),
        _x("void (anonymous namespace)::fusion_rows_kernel<0, 1>("
           "sm_fusion::Params)", 320, 50),  # after the traced batches
    ]
    ctx = SimpleNamespace(trace=tracing.TraceSummary(events), traced_views=4)
    assert read(ctx) == pytest.approx(36.0 / 1e3 / 4)


def test_fusion_time_reads_nothing_without_its_kernels():
    read = spec.reader("fusion.device_ms_per_view")
    assert read(SimpleNamespace(trace=None, traced_views=0)) is None
    ctx = SimpleNamespace(trace=tracing.TraceSummary(canned_trace()),
                          traced_views=4)
    assert read(ctx) is None  # the parent's torch chain


def test_fusion_time_is_declared_for_the_triangle_and_texel_cells():
    b = spec.load()
    (m,) = [m for m in b["per_layer"]
            if m["name"] == "fusion.device_ms_per_view"]
    assert (m["layer"], m["moves"], m["source"], m["better"]) == (
        "fusion", "fuse_mpix_s", "device_trace", "lower")
    assert {"scannet-eval.triangles", "cityscapes-demo.triangles",
            "scannet-eval.texels"} <= set(m["workloads"])
