"""semantic_meshes_torch.bench against the repository's bench.py: the same
CLI, JSON lines, presets and scene sizes (tests/test_driver_entry.py's
bench tests, on the port), on the CPU."""

import json
import os
import subprocess
import sys

import pytest
import torch

from semantic_meshes_torch import bench

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the detail keys bench.py prints (bench.py:278-297)
BENCH_PY_KEYS = {"region_seconds_per_batch", "preset", "triangles",
                 "primitives", "views", "resolution", "classes",
                 "seconds_per_batch", "split_k", "micro_max", "overflow",
                 "device"}


@pytest.fixture(autouse=True)
def one_torch_thread(monkeypatch):
    """Beside other test workers on the same cores, a pool of intra-op
    threads per op waits on the scheduler at every op, so each test runs
    on one thread, and the processes it starts on one too."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    yield
    torch.set_num_threads(threads)


def _import_jax_bench():
    sys.path.insert(0, REPO)
    try:
        import bench as jax_bench
    finally:
        sys.path.pop(0)
    return jax_bench


def _run_main(monkeypatch, capsys, argv, measure):
    monkeypatch.setattr(bench, "measure_preset", measure)
    bench.main(argv + ["--device", "cpu"])
    out = capsys.readouterr().out
    return [json.loads(line) for line in out.splitlines() if line.strip()]


def _fake_detail(preset):
    return {"preset": preset, "overflow": 0, "seconds_per_batch": 0.1,
            "launches": {"raster_tile": 0, "raster_dense": 0}}


def test_bench_emits_headline_first_then_incremental(monkeypatch, capsys):
    """The headline line comes right after the default preset; each
    sub-preset re-prints it with the detail grown, and a failing
    sub-preset is isolated and recorded."""
    def fake_measure(preset, repeats, device):
        assert device == "cpu"
        if preset == "texels":
            raise RuntimeError("boom")
        return 42.0, _fake_detail(preset)

    recs = _run_main(monkeypatch, capsys,
                     ["--preset", "default", "--budget", "1e9"], fake_measure)
    assert len(recs) == 5
    assert all(r["value"] == 42.0 for r in recs)
    assert all(r["metric"] == "rasterize_fuse_throughput" for r in recs)
    assert all(r["vs_baseline"] == 4.2 for r in recs)
    assert "dense_MPix_s" not in recs[0]["detail"]
    last = recs[-1]["detail"]
    assert last["dense_MPix_s"] == 42.0
    assert last["scannet_MPix_s"] == 42.0
    assert last["texels01_MPix_s"] == 42.0
    assert last["dense_seconds_per_batch"] == 0.1
    assert last["scannet_launches"] == {"raster_tile": 0, "raster_dense": 0}
    assert last["skipped"] == ["texels"]


def test_bench_budget_skips_sub_presets(monkeypatch, capsys):
    recs = _run_main(monkeypatch, capsys,
                     ["--preset", "default", "--budget", "0"],
                     lambda preset, repeats, device: (
                         7.0, _fake_detail(preset)))
    assert len(recs) == 2
    assert recs[0]["value"] == 7.0
    assert "skipped" not in recs[0]["detail"]
    assert recs[-1]["detail"]["skipped"] == list(bench.SUB_PRESETS)


def test_bench_small_preset_prints_one_json_line():
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    out = subprocess.run(
        [sys.executable, "-m", "semantic_meshes_torch.bench", "--preset",
         "small", "--repeats", "1", "--no-extra", "--device", "cpu"],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = [line for line in out.stdout.splitlines() if line.strip()]
    assert len(lines) == 1, out.stdout
    rec = json.loads(lines[0])
    assert rec["metric"] == "rasterize_fuse_throughput"
    assert rec["unit"] == "MPix/s"
    assert rec["value"] > 0
    assert rec["vs_baseline"] == round(rec["value"] / 10.0, 3)
    det = rec["detail"]
    assert BENCH_PY_KEYS <= set(det)
    assert det["overflow"] == 0
    assert det["device"] == "cpu"
    assert len(det["region_seconds_per_batch"]) == 3
    _, views, width, height, _ = bench.PRESETS["small"]
    assert rec["value"] == round(
        views * width * height / 1e6 / det["seconds_per_batch"], 3)
    assert det["launches"] == {"raster_tile": 0, "raster_dense": 0}


def test_bench_without_a_card_exits_without_running(monkeypatch, capsys):
    """--device cuda (the default) on a machine without a card prints why
    and exits 2; nothing runs on the CPU in its place."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def never(*args):
        raise AssertionError("measured without a card")

    monkeypatch.setattr(bench, "measure_preset", never)
    monkeypatch.setattr(bench, "bench_e2e", never)
    for argv in ([], ["--preset", "e2e"], ["--device", "cuda:0"]):
        with pytest.raises(SystemExit) as exc:
            bench.main(argv)
        assert exc.value.code == 2
        captured = capsys.readouterr()
        assert "is_available" in captured.err and captured.out == ""


def test_tables_equal_bench_py():
    jax_bench = _import_jax_bench()
    assert bench.PRESETS == jax_bench.PRESETS
    assert bench.TPP == jax_bench.TPP
    assert bench.SUB_PRESETS == jax_bench.SUB_PRESETS
    assert bench.parse_args([]).repeats == 5
    assert bench.parse_args([]).device == "cuda"


def test_small_preset_scene_equals_bench_py():
    """The port's measured scene at `small` is bench.py's: triangles,
    primitives, the plan's split and routing, overflow."""
    jax_bench = _import_jax_bench()
    _, want = jax_bench.measure_preset("small", 1)
    value, got = bench.measure_preset("small", 1, "cpu")
    assert value > 0
    for key in ("triangles", "primitives", "split_k", "micro_max",
                "overflow", "views", "resolution", "classes"):
        assert got[key] == want[key], key


def test_bench_e2e_prints_the_e2e_line(monkeypatch, capsys):
    """bench_e2e at a shrunk scene (a narrow UNet, 2 views of 64x32): one
    e2e_image_time line, the minimum batch over the views."""
    monkeypatch.setitem(bench.E2E, "subdivisions", 2)
    monkeypatch.setitem(bench.E2E, "views", 2)
    monkeypatch.setitem(bench.E2E, "width", 64)
    monkeypatch.setitem(bench.E2E, "height", 32)
    monkeypatch.setitem(bench.E2E, "widths", (8, 16))
    ms = bench.bench_e2e(1, "cpu")
    lines = [json.loads(line) for line in
             capsys.readouterr().out.splitlines() if line.strip()]
    assert len(lines) == 1
    rec = lines[0]
    assert rec["metric"] == "e2e_image_time"
    assert rec["unit"] == "ms/image"
    det = rec["detail"]
    assert len(det["batch_ms"]) == 3
    assert ms == min(det["batch_ms"]) / 2 == det["ms_per_image"]
    assert rec["value"] == round(ms, 3)
    assert rec["vs_baseline"] == round(2000.0 / ms, 2)
    assert det["overflow"] == 0
    assert det["triangles"] == 48 and det["resolution"] == [64, 32]
    assert det["classes"] == 19 and det["texels"] > 0
