"""The span attribution (benchmark/spans.py) on a canned trace with
correlation ids and nested `smt.*` ranges, the fusion's byte count at
the configurations, the set-up readers, and one traced run on the CPU
with the trace's events kept."""

import pytest

from benchmark import spans, spec, tracing
from benchmark.tests.test_bench_metrics import canned_trace as plain_trace

VIEWS = 2


def _x(cat, name, ts, dur, corr=None, tid=1):
    e = dict(ph="X", cat=cat, name=name, ts=ts, dur=dur, tid=tid)
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def canned_trace():
    """One traced batch over [100, 300] us: a render holding the dense
    preparation (a kernel, and a copy's memcpy and wait) and a launch of
    its own, an add holding the fusion (a `cudaLaunchKernel` and a
    `cuLaunchKernel`), then the harness's own launch and final
    synchronize; a render after the batch."""
    return [
        _x("user_annotation", tracing.SPAN, 100, 200),
        _x("user_annotation", "smt.render", 110, 90),
        _x("user_annotation", "smt.dense_prep", 120, 40),
        _x("cuda_runtime", "cudaLaunchKernel", 125, 2, corr=1),
        _x("kernel", "setup_kernel", 130, 10, corr=1, tid=7),
        _x("cpu_op", "aten::copy_", 133, 16),
        _x("cuda_runtime", "cudaMemcpyAsync", 135, 2, corr=2),
        _x("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 136, 5,
           corr=2, tid=7),
        _x("cuda_runtime", "cudaStreamSynchronize", 140, 8, corr=3),
        _x("cuda_runtime", "cudaLaunchKernel", 170, 2, corr=4),
        _x("kernel", "raster_dense_kernel", 172, 20, corr=4, tid=7),
        _x("user_annotation", "smt.add", 210, 70),
        _x("user_annotation", "smt.fusion", 215, 55),
        _x("cuda_runtime", "cudaLaunchKernel", 220, 2, corr=5),
        _x("kernel", "kernelHistogram1D", 222, 30, corr=5, tid=7),
        _x("cuda_driver", "cuLaunchKernel", 230, 2, corr=6),
        _x("kernel", "segment_kernel", 260, 4, corr=6, tid=7),
        _x("cuda_runtime", "cudaLaunchKernel", 285, 2, corr=7),
        _x("kernel", "harness_kernel", 286, 5, corr=7, tid=7),
        _x("cuda_runtime", "cudaDeviceSynchronize", 290, 9, corr=8),
        _x("user_annotation", "smt.render", 400, 50),
        _x("cuda_runtime", "cudaLaunchKernel", 410, 2, corr=9),
        _x("kernel", "late_kernel", 412, 5, corr=9, tid=7),
    ]


def test_device_work_goes_to_the_subtree_of_its_launching_span():
    s = spans.Spans(canned_trace())
    assert s.launches == {"smt.render": 3, "smt.dense_prep": 2,
                          "smt.add": 2, "smt.fusion": 2}
    assert s.device_us == pytest.approx({
        "smt.render": 35.0, "smt.dense_prep": 15.0, "smt.add": 34.0,
        "smt.fusion": 34.0})


def test_only_the_programs_syncs_are_host_waits():
    s = spans.Spans(canned_trace())
    # not the harness's final synchronize, and nothing after the batch
    assert (s.waits, s.wait_us) == (1, 8.0)
    assert s.waits_by_op == {"smt.dense_prep > aten::copy_": (1, 8.0)}


def test_self_times_and_idle_by_span():
    s = spans.Spans(canned_trace())
    assert s.self_us == pytest.approx({
        "smt.render": 50.0, "smt.dense_prep": 40.0, "smt.add": 15.0,
        "smt.fusion": 55.0})
    assert s.top_us == pytest.approx(160.0)
    # busy 130-141, 172-192, 222-252, 260-264, 286-291 in [100, 300]
    assert s.idle_by_span() == pytest.approx({
        "smt.render": 30e-6, "smt.dense_prep": 31e-6,
        spans.NO_SPAN: 39e-6, "smt.fusion": 8e-6, "smt.add": 22e-6})


def test_the_span_metrics():
    m = spans.metrics(spans.Spans(canned_trace()), VIEWS, 1296, 968, 40,
                      99372)
    assert m == pytest.approx({
        "dense_prep.device_ms_per_view": 0.015 / VIEWS,
        "dense_prep.launches_per_view": 2 / VIEWS,
        "fusion.device_ms_per_view": 0.034 / VIEWS,
        "fusion.launches_per_view": 2 / VIEWS,
        "fusion.roofline_pct": 100 * 221642112 / 3.35e12 / (17e-6),
        "pipeline.host_waits_per_view": 1 / VIEWS,
        "pipeline.host_wait_ms_per_view": 0.008 / VIEWS,
        "pipeline.host_self_ms_per_view": 0.152 / VIEWS})


def test_no_fusion_span_no_fusion_metrics():
    trace = [e for e in canned_trace() if e["name"] != "smt.fusion"]
    m = spans.metrics(spans.Spans(trace), VIEWS, 1296, 968, 40, 99372)
    assert "fusion.roofline_pct" not in m
    assert "fusion.device_ms_per_view" not in m
    assert m["dense_prep.launches_per_view"] == 1.0


def test_a_trace_without_spans_reads_nothing_and_keeps_the_old_numbers():
    plain = plain_trace()
    s = spans.Spans(plain)
    assert spans.metrics(s, VIEWS, 1296, 968, 40, 99372) == {}
    t = tracing.TraceSummary(plain)
    assert (s.summary.busy_us, s.summary.launches, s.summary.idle_gaps()) \
        == (t.busy_us, t.launches, t.idle_gaps())
    assert s.idle_by_span() == pytest.approx(
        {spans.NO_SPAN: sum(b - a for a, b in t.gaps()) / 1e6})


@pytest.mark.parametrize("config,megabytes,microseconds", [
    ("scannet-eval", 221.642112, 66.16),
    ("cityscapes-demo", 171.507712, 51.20),
])
def test_fusion_bytes_at_the_configurations(config, megabytes,
                                            microseconds):
    c = spec.config(spec.load(), config)
    faces = 12 * c["subdivisions"] ** 2
    least = spans.fusion_bytes(c["width"], c["height"], c["classes"], faces)
    assert least == round(megabytes * 1e6)
    assert least / 3.35e12 * 1e6 == pytest.approx(microseconds, abs=0.01)


@pytest.mark.parametrize("name", ["setup.budgets_s", "setup.texel_sizing_s"])
def test_setup_readers_read_nothing_without_the_programs_timers(
        name, monkeypatch):
    from semantic_meshes_torch import profiling

    monkeypatch.delattr(profiling, "timings")
    assert spec.reader(name)(None) is None


@pytest.mark.parametrize("name,span", [
    ("setup.budgets_s", "smt.setup.budgets"),
    ("setup.texel_sizing_s", "smt.setup.texel_sizing")])
def test_setup_readers_read_the_programs_timer(name, span, monkeypatch):
    from semantic_meshes_torch import profiling

    monkeypatch.setattr(profiling, "timings", lambda: {
        span: {"total_s": 1.25, "calls": 1, "median_s": 1.25}})
    assert spec.reader(name)(None) == 1.25


def test_a_traced_run_on_the_cpu_keeps_its_events():
    from benchmark.tests.test_bench_harness import SHORT, SMALL

    load = tracing.load
    out = spans.collect("scannet-eval.triangles", 2**31 + 11, device="cpu",
                        config_overrides=SMALL, traffic_overrides=SHORT)
    assert tracing.load is load
    assert out["result"]["correct"] and out["views"] == 2
    assert out["result"]["metrics"]["setup.budgets_s"]["value"] > 0
    # no card: no launch and no wait, but every span of the frame
    assert out["metrics"]["pipeline.host_waits_per_view"] == 0
    assert out["metrics"]["pipeline.host_self_ms_per_view"] > 0
    assert {"smt.render", "smt.dense_prep", "smt.add",
            "smt.fusion"} <= set(out["self_ms_per_view"])
