"""The metric arithmetic, from canned inputs: the trace reduction, the
launch count, the kernels' byte counts and the window's end-to-end
metrics."""

from types import SimpleNamespace

import pytest

from benchmark import spec, tracing
from benchmark.metrics import _roofline


def _x(cat, name, ts, dur, **kw):
    return dict(ph="X", cat=cat, name=name, ts=ts, dur=dur, **kw)


def canned_trace():
    """Two traced batches over [100, 300] us; device work on two
    streams overlapping in [150, 160]; a launch and a memcpy per batch,
    one runtime call that launches nothing, events outside the span."""
    return [
        _x("user_annotation", tracing.SPAN, 100, 90),
        _x("user_annotation", tracing.SPAN, 200, 100),
        _x("cpu_op", "aten::sort", 95, 60),
        _x("cpu_op", "aten::cat", 250, 40),
        _x("cuda_runtime", "cudaLaunchKernel", 110, 2),
        _x("cuda_runtime", "cudaMemcpyAsync", 120, 2),
        _x("cuda_runtime", "cudaStreamSynchronize", 180, 5),
        _x("cuda_runtime", "cudaLaunchKernel", 210, 2),
        _x("cuda_driver", "cuLaunchKernel", 220, 2),
        _x("cuda_runtime", "cudaLaunchKernel", 400, 2),
        _x("kernel", "(anonymous namespace)::raster_dense_kernel(float4 "
           "const*, int const*)", 140, 20),
        _x("kernel", "void at::native::sort_kernel<float>(float*)", 150, 20),
        _x("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 230, 10),
        _x("kernel", "raster_dense_kernel_other", 270, 10),
        _x("kernel", "early", 50, 60),
        _x("kernel", "late", 290, 50),
    ]


def test_trace_union_idle_and_launches():
    t = tracing.TraceSummary(canned_trace())
    assert t.batches == 2
    assert (t.start, t.end, t.window_us) == (100.0, 300.0, 200.0)
    # busy: [100,110] (early, clipped) + [140,170] + [230,240] + [270,280]
    # + [290,300] (late, clipped) = 10 + 30 + 10 + 10 + 10
    assert t.busy_us == pytest.approx(70.0)
    assert t.idle_share() == pytest.approx(1 - 70 / 200)
    assert t.launches == 4  # not the sync, not the launch after the span
    assert t.kernel("raster_dense_kernel") == (20.0, 1)
    assert t.kernel("sort_kernel") == (20.0, 1)
    assert t.kernel("missing") == (0.0, 0)
    assert t.top_device_ops(2)[0][1] == pytest.approx(60e-6)
    gaps = t.idle_gaps(10)
    assert gaps[:3] == [["no host op", pytest.approx(60e-6)],  # [170, 230]
                        ["aten::sort", pytest.approx(30e-6)],  # [110, 140]
                        ["aten::cat", pytest.approx(30e-6)]]  # [240, 270]
    assert sum(g[1] for g in gaps) == pytest.approx(130e-6)


def test_trace_without_device_work_reads_nothing():
    t = tracing.TraceSummary([_x("user_annotation", tracing.SPAN, 0, 10)])
    assert t.idle_share() is None
    ctx = SimpleNamespace(trace=t, traced_views=8, width=8, height=8,
                          vertices=3, faces=1)
    for name in ("device.idle_pct", "pipeline.launches_per_view",
                 "raster_dense.roofline_pct"):
        assert spec.reader(name)(ctx) is None


@pytest.mark.parametrize("config,subdivisions,megabytes", [
    ("scannet-eval", None, 11.838096),
    ("cityscapes-demo", None, 17.671240),
    ("scannet-eval", 29, 10.222128),
])
def test_z_resolve_bytes_at_the_configurations(config, subdivisions,
                                               megabytes):
    c = spec.config(spec.load(), config)
    s = subdivisions or c["subdivisions"]
    vertices, faces = 6 * (s + 1) ** 2, 12 * s * s
    assert _roofline.z_resolve_bytes(c["width"], c["height"], vertices,
                                     faces) == round(megabytes * 1e6)


def test_roofline_share_from_the_trace():
    t = tracing.TraceSummary(canned_trace())
    ctx = SimpleNamespace(trace=t, traced_views=8, width=1296,
                          height=968, vertices=50784, faces=99372)
    least = 11838096 / 3.35e12
    assert spec.reader("raster_dense.roofline_pct")(ctx) == pytest.approx(
        100 * least / 20e-6)
    assert spec.reader("pipeline.launches_per_view")(ctx) == 4 / (2 * 4)
    assert spec.reader("device.idle_pct")(ctx) == pytest.approx(65.0)


def _window(batch_s, views):
    return SimpleNamespace(window={
        "completed": len(batch_s), "wall_s": sum(batch_s),
        "pixels_per_batch": views * 1296 * 968})


@pytest.mark.parametrize("views", [1, 4])
def test_a_stalled_batch_moves_the_rate(views):
    """fuse_mpix_s is over all the work and all the time of the window:
    one stalled batch lowers it."""
    steady = [0.05 + 0.001 * (i % 3) for i in range(10)]
    stalled = steady[:5] + [2.0] + steady[6:]
    rate = spec.reader("fuse_mpix_s")
    assert rate(_window(steady, views)) == pytest.approx(
        10 * views * 1296 * 968 / 1e6 / sum(steady))
    assert rate(_window(stalled, views)) < 0.5 * rate(_window(steady, views))
