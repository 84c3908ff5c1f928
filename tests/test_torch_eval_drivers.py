"""The port's ScanNet drivers against the JAX repository's.

Mirrors tests/test_colmap_driver.py (run_colmap_on_scannet against its
stub `colmap` binary: the known-pose model, the database id realignment,
the cleanup, the skip of an existing workspace and of a failing scene;
simplify_scannet_meshes against a stub meshlabserver) and
tests/test_eval_graphs.py (create_scannet_eval_graphs: merges, drops,
plots, the aggregator CSV, the duplicate-offset guard; make_paper_graphs'
smoke grid, here through the port only). The port's cameras.txt /
images.txt and aggregators.csv equal the JAX scripts' on the same inputs,
byte for byte. COLMAP and MeshLab are exercised only through the stubs.
"""

import io
import os
import shutil
import stat
import zlib

import numpy as np
import pytest
import yaml

from semantic_meshes_torch import testing
from semantic_meshes_torch.data2.scannet import write_sens
from semantic_meshes_torch.scripts import (create_scannet_eval_graphs,
                                           make_paper_graphs,
                                           run_colmap_on_scannet,
                                           simplify_scannet_meshes)

from _torch_scripts import jax_script
from test_colmap_driver import STUB
from test_eval_graphs import _run_yaml, base_params


def _scannet_with_stub(root):
    """test_colmap_driver.py's scene: one .sens stream of 3 ring views of
    32x24 black JPEG frames, and the stub colmap binary."""
    from semantic_meshes_torch.io.image import imwrite

    scene = root / "scans" / "scene0000_00"
    os.makedirs(scene)
    H, W = 24, 32
    buf = io.BytesIO()
    imwrite(buf, np.zeros((H, W, 3), np.uint8), format="jpeg")
    depth = zlib.compress(np.zeros(H * W, "<u2").tobytes())
    frames = []
    for i, cam in enumerate(testing.make_ring_cameras(num_views=3, width=W,
                                                      height=H)):
        w2c = np.eye(4, dtype=np.float32)
        w2c[:3, :3] = cam.rotation
        w2c[:3, 3] = cam.translation
        frames.append(dict(camera_to_world=np.linalg.inv(w2c),
                           timestamp_color=i, timestamp_depth=i,
                           color_data=buf.getvalue(), depth_data=depth))
    intr = np.eye(4, dtype=np.float32)
    intr[0, 0] = intr[1, 1] = 20.0
    intr[0, 2], intr[1, 2] = W / 2, H / 2
    write_sens(str(scene / "scene0000_00.sens"), "s", intr,
               np.eye(4, dtype=np.float32), intr,
               np.eye(4, dtype=np.float32), (H, W), (H, W), 1000.0, frames)
    stub = root / "colmap"
    stub.write_text(STUB)
    stub.chmod(stub.stat().st_mode | stat.S_IEXEC)
    return stub


GRAPH_RUNS = [
    _run_yaml(base_params(mode="texels", texel_resolution=0.1), 0.80),
    _run_yaml(base_params(mode="texels", texel_resolution=0.2), 0.82),
    _run_yaml(base_params(), 0.78),
    _run_yaml(base_params(images_equal_weight=0.0), 0.70),
    _run_yaml(base_params(aggregator="sum", num=50, offset=0), 0.60),
    _run_yaml(base_params(aggregator="sum", num=50, offset=50), 0.70),
    _run_yaml(base_params(aggregator="summax", num=10), 0.99),
    _run_yaml(base_params(frames_step=10), 0.66),
]


def _write_yamls(path, runs):
    os.makedirs(path, exist_ok=True)
    for i, r in enumerate(runs, 1):
        with open(path / f"run-{i}.yaml", "w") as f:
            yaml.dump(r, f)


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """The JAX colmap driver on its own copy of the scene and the JAX
    graph script on its own copy of the YAMLs, started in the
    background."""
    root = tmp_path_factory.mktemp("drivers")
    colmap_root = root / "colmap_scene"
    stub = _scannet_with_stub(colmap_root)
    graphs = root / "graphs"
    _write_yamls(graphs, GRAPH_RUNS)
    jax = {
        "colmap": jax_script("run_colmap_on_scannet", [
            "--scannet", colmap_root, "--colmap_bin", stub],
            root / "colmap.log"),
        "graphs": jax_script("create_scannet_eval_graphs", [
            "--path", graphs], root / "graphs.log"),
    }
    done = {}

    def wait(name):
        if name not in done:
            done[name] = jax[name].wait()
        return {"colmap": colmap_root, "graphs": graphs}[name], done[name]

    yield wait
    for proc in jax.values():
        if proc.proc.poll() is None:
            proc.proc.kill()
            proc.proc.wait()


def test_colmap_driver_end_to_end(jax_runs, tmp_path, capsys):
    stub = _scannet_with_stub(tmp_path)
    args = ["--scannet", str(tmp_path), "--colmap_bin", str(stub)]
    assert run_colmap_on_scannet.main(args) == 0
    ws = tmp_path / "scans" / "scene0000_00" / "colmap"
    assert (ws / "mesh.ply").exists()
    images_txt = (ws / "sparse" / "images.txt").read_text()
    lines = [ln for ln in images_txt.splitlines() if len(ln.split()) == 10]
    assert len(lines) == 3
    # the stub's database numbers the images in reverse name order
    by_name = {ln.split()[9]: int(ln.split()[0]) for ln in lines}
    assert by_name["0.jpg"] == 3 and by_name["2.jpg"] == 1
    q = np.asarray([float(x) for x in lines[0].split()[1:5]])
    assert abs(np.linalg.norm(q) - 1.0) < 1e-5
    assert not (ws / "images").exists()
    assert not (ws / "database.db").exists()
    jax_root, _ = jax_runs("colmap")
    jax_ws = jax_root / "scans" / "scene0000_00" / "colmap"
    for name in ("cameras.txt", "images.txt", "points3D.txt"):
        assert (ws / "sparse" / name).read_bytes() == \
            (jax_ws / "sparse" / name).read_bytes(), name
    capsys.readouterr()
    assert run_colmap_on_scannet.main(args) == 0
    assert "Skipping" in capsys.readouterr().out


def test_colmap_driver_skips_failed_scene(tmp_path, capsys):
    stub = _scannet_with_stub(tmp_path)
    stub.write_text("#!/usr/bin/env python3\nimport sys; sys.exit(1)\n")
    assert run_colmap_on_scannet.main(
        ["--scannet", str(tmp_path), "--colmap_bin", str(stub)]) == 0
    assert "failed" in capsys.readouterr().out
    assert not (tmp_path / "scans" / "scene0000_00" / "colmap").exists()


def test_simplify_driver_with_stub(tmp_path):
    """The target face count, the filter script and the output name,
    against a stub meshlabserver."""
    from semantic_meshes_torch.io.ply import write_mesh

    scene = tmp_path / "scans" / "scene0000_00"
    os.makedirs(scene)
    vertices, faces = testing.make_cube(3)  # 108 faces
    write_mesh(scene / "scene0000_00_vh_clean_2.labels.ply", vertices, faces)
    stub = tmp_path / "meshlabserver"
    stub.write_text(r'''#!/usr/bin/env python3
import re, sys
opts = dict(zip(sys.argv[1::2], sys.argv[2::2]))
script = open(opts["-s"]).read()
n = re.search(r'value="(\d+)" name="TargetFaceNum"', script).group(1)
with open(opts["-o"], "w") as f:
    f.write(f"stub simplified to {n} faces from {opts['-i']}\n")
''')
    stub.chmod(stub.stat().st_mode | stat.S_IEXEC)
    assert simplify_scannet_meshes.main([
        "--scannet", str(tmp_path), "--factor", "0.5", "--factor", "0.25",
        "--meshlabserver", str(stub)]) == 0
    for factor, n in (("0.5", 54), ("0.25", 27)):
        out = scene / f"scene0000_00_vh_clean_2.labels_simplified-{factor}.ply"
        assert f"simplified to {n} faces" in out.read_text()


def test_graphs_end_to_end(jax_runs, tmp_path, capsys):
    _write_yamls(tmp_path, GRAPH_RUNS)
    assert create_scannet_eval_graphs.main(["--path", str(tmp_path)]) == 0
    assert "Merging" in capsys.readouterr().out
    produced = set(os.listdir(tmp_path))
    assert {"aggregators.csv", "texelres_to_accuracy.png",
            "imagesequalweight_to_accuracy.png",
            "framesstep_to_accuracy.png"} <= produced
    csv = (tmp_path / "aggregators.csv").read_text()
    jax_dir, _ = jax_runs("graphs")
    assert csv == (jax_dir / "aggregators.csv").read_text()
    rows = {ln.split(",")[0]: ln for ln in csv.splitlines()[1:]}
    assert csv.splitlines()[0] == "aggregator,accuracy_w_i,accuracy_w_p"
    # the merged sum run: accuracy from the summed matrices
    assert abs(float(rows["sum"].split(",")[1]) - 0.65) < 1e-6
    assert "summax" not in rows  # num=10 < 100 scenes: dropped
    assert {f for f in os.listdir(jax_dir) if f.endswith(".png")} == \
        {f for f in produced if f.endswith(".png")}


def test_graphs_same_offset_guard(tmp_path, capsys):
    r = _run_yaml(base_params(num=50, offset=0), 0.5)
    _write_yamls(tmp_path, [r, r])
    with pytest.raises(SystemExit) as e:
        create_scannet_eval_graphs.main(["--path", str(tmp_path)])
    assert e.value.code != 0
    assert "Same offset" in capsys.readouterr().out


def test_make_paper_graphs_end_to_end(tmp_path, monkeypatch):
    """The smoke grid through the port's eval CLI and graph script (its
    children, processes on the CPU): the plots and the table exist, the
    noise degraded the network and fusion beat it."""
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    assert make_paper_graphs.main([
        "--out", str(tmp_path), "--grid", "smoke", "--scenes", "1",
        "--views", "4", "--subdivisions", "4", "--width", "128",
        "--height", "96", "--device", "cpu"]) == 0
    results = tmp_path / "results"
    for artifact in ("texelres_to_accuracy.png",
                     "imagesequalweight_to_accuracy.png",
                     "simplify_to_accuracy.png", "framesstep_to_accuracy.png",
                     "aggregators.csv"):
        assert (results / artifact).is_file(), artifact
    yamls = sorted(results.glob("run-*.yaml"))
    assert len(yamls) == 3
    for y in yamls:
        d = yaml.safe_load(y.read_text())
        net = d["metrics"]["image_network"]["accuracy"]
        fused = d["metrics"]["image_fused"]["accuracy"]
        assert net < 0.9
        assert fused > net + 0.05
    csv = (results / "aggregators.csv").read_text().splitlines()
    assert csv[0] == "aggregator,accuracy_w_i,accuracy_w_p"
    assert {r.split(",")[0] for r in csv[1:]} == {"sum", "mul"}
    shutil.rmtree(tmp_path / "scannet")
