"""The port's bench_cityscapes, bench_eval and resume_killtest modules on the
CPU at small sizes, through the branches their defaults do not take.

- bench_cityscapes over a top-k store with distorted cameras in chunks of
  2, and over a u8 store per view: the child demo's PLY equals an
  in-process run of colorize_cityscapes_mesh on the bench's scene.
- bench_eval over two scenes of probability maps in texel mode, with the
  graph script after it: the steady time sums only the phases run once a
  frame.
- resume_killtest through `--cpu`: the resumed metrics equal the
  uninterrupted run's.

Each runs its children as processes on the CPU (`--device cpu`).
"""

import json

import numpy as np
import pytest

from semantic_meshes_torch.scripts import (bench_cityscapes, bench_eval,
                                           colorize_cityscapes_mesh,
                                           resume_killtest)

from _torch_scripts import face_colors

CITYSCAPES = ["--views", "3", "--subdivisions", "4", "--width", "128",
              "--height", "64", "--device", "cpu"]


def _json_line(out):
    return json.loads([ln for ln in out.splitlines()
                       if ln.startswith("{")][-1])


@pytest.mark.parametrize("store,cam_model,chunk", [
    ("topk2", "SIMPLE_RADIAL", "2"), ("u8", "THIN_PRISM_FISHEYE", "1")])
def test_bench_cityscapes_smoke(tmp_path, capsys, store, cam_model, chunk):
    assert bench_cityscapes.main(CITYSCAPES + [
        "--probs_store", store, "--cam_model", cam_model, "--chunk", chunk,
        "--keep", str(tmp_path)]) == 0
    line = _json_line(capsys.readouterr().out)
    assert line["metric"] == "cityscapes_demo_s_per_image"
    assert line["value"] > 0
    detail = line["detail"]
    assert detail["cam_model"] == cam_model and detail["views"] == 3
    assert detail["probs_store"] == store and detail["triangles"] == 192
    assert 0 < detail["steady_s_per_image"] <= line["value"]
    wire = "u8" if store == "u8" else "f16"
    assert detail["probs_dtype"] == wire
    want = colorize_cityscapes_mesh.run(colorize_cityscapes_mesh.parse_args([
        "--colmap", str(tmp_path / "ws"),
        "--input_ply", str(tmp_path / "mesh.ply"),
        "--images", str(tmp_path / "images"),
        "--output_ply", str(tmp_path / "want.ply"),
        "--probs", str(tmp_path / f"probs-{store}"), "--probs_dtype", wire,
        "--chunk", chunk, "--device", "cpu"]))
    cols = face_colors(tmp_path / "colorized.ply")
    assert cols.any()
    np.testing.assert_array_equal(cols, want["colors"])


def test_bench_eval_smoke(tmp_path, capsys):
    assert bench_eval.main([
        "--subdivisions", "4", "--frames", "3", "--width", "64",
        "--height", "48", "--model", "probs", "--texels", "--scenes", "2",
        "--graphs", "--keep", str(tmp_path), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    built = json.loads(out.splitlines()[0])["scenes_built"]
    assert [b["scene"] for b in built] == ["scene0000_00", "scene0001_00"]
    line = _json_line(out)
    assert line["scenes"] == 2 and line["frames"] == 3
    timers = line["timers"]
    per_frame = {k for k, v in timers.items() if v["calls"] > 2}
    assert {"render", "fuse", "render_fused"} <= per_frame
    assert "get" in set(timers) - per_frame  # once a scene
    steady = sum(timers[k].get("ms_median", timers[k]["ms_per_call"])
                 for k in per_frame)
    assert line["steady_ms_per_frame"] == round(steady, 1)
    scene_ms = 1e3 * sum(v["total_s"] for k, v in timers.items()
                         if k not in per_frame) / 6
    assert line["scene_ms_per_frame"] == round(scene_ms, 1)
    assert "aggregators.csv" in line["graphs"]["files"]
    assert (tmp_path / "results" / "aggregators.csv").exists()


def test_resume_killtest_smoke(tmp_path, capsys):
    assert resume_killtest.main([
        "--workdir", str(tmp_path), "--subdivisions", "2", "--views", "4",
        "--width", "64", "--height", "48", "--cpu"]) == 0
    line = _json_line(capsys.readouterr().out)
    assert line["killtest"] == "PASS" and line["mismatches"] == []
    assert line["device"] == "cpu" and line["model"] == "jax-unet"
