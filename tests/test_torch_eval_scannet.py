"""The port's ScanNet eval entry point (`python -m
semantic_meshes_torch.eval_scannet --device cpu`) end to end on synthetic
scenes, as tests/test_eval_scannet.py runs the JAX package's.

Mirrors its five tests (end to end with the skip rerun, texels mode,
checkpoint resume, SIGKILL resume, the tfcv stub under tests/_tfcv_stub),
on scenes built by the port's testing.build_synthetic_scannet_scene (the
port's own render, on the CPU), and adds parity: the JAX package's CLI
and the port's on one noisy scene (--model probs, sum) give equal
confusion matrices in all three groups, and the scene builders of both
packages write the same files. The subprocesses of the port never import
JAX.
"""

import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import yaml

from semantic_meshes_torch import eval_scannet, testing

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLASSES = 40


def _env(extra_path=None):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (extra_path, REPO, env.get("PYTHONPATH")) if p)
    env["OMP_NUM_THREADS"] = "2"
    env.pop("XLA_FLAGS", None)
    return env


def _cmd(scannet_dir, out, extra, model="probs"):
    cmd = [sys.executable, "-m", "semantic_meshes_torch.eval_scannet",
           "--scannet", str(scannet_dir), "--model", model,
           "--aggregator", "sum", "--output", str(out), "--device", "cpu"]
    if model == "probs":
        cmd += ["--probs_dir", str(scannet_dir / "probs")]
    return cmd + extra


def _run(scannet_dir, out, extra=(), model="probs", env=None, timeout=600):
    return subprocess.run(_cmd(scannet_dir, out, list(extra), model),
                          env=env or _env(), capture_output=True, text=True,
                          timeout=timeout, cwd=REPO)


def _yaml(path):
    with open(path) as f:
        return yaml.safe_load(f)


@pytest.fixture(scope="module")
def scannet_dir(tmp_path_factory):
    """test_eval_scannet.py's two scenes: cube s=3 (108 triangles), 4 ring
    views of 128x96 at radius 3.0 and 3.1, one-hot probabilities."""
    root = tmp_path_factory.mktemp("scannet")
    testing.write_scannet_label_tsv(root / "scannetv2-labels.combined.tsv")
    os.makedirs(root / "scans")
    testing.build_synthetic_scannet_scene(root, "scene0000_00", radius=3.0)
    testing.build_synthetic_scannet_scene(root, "scene0001_00", radius=3.1)
    return root


def _assert_same_results(got, ref):
    assert got["params"] == ref["params"]
    for group in ("vertex", "image_network", "image_fused"):
        for key in ("accuracy", "mean_iou"):
            assert got["metrics"][group][key] == pytest.approx(
                ref["metrics"][group][key], abs=1e-6), (group, key)
        np.testing.assert_allclose(
            np.asarray(got["metrics"][group]["confusion_matrix"]),
            np.asarray(ref["metrics"][group]["confusion_matrix"]), atol=1e-3)


# ------------------------------------------- mirrors of test_eval_scannet.py

def test_eval_scannet_end_to_end(scannet_dir, tmp_path):
    out = tmp_path / "results"
    proc = _run(scannet_dir, out)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    files = [f for f in os.listdir(out) if f.endswith(".yaml")]
    assert files == ["run-1.yaml"]
    result = _yaml(out / files[0])
    # schema parity with the reference (ref: eval_scannet.py:332-352)
    assert set(result["metrics"]) == {"vertex", "image_network",
                                      "image_fused"}
    assert result["params"]["aggregator"] == "sum"
    assert result["params"]["num"] == 2  # metrics aggregated across scenes
    for group in ("image_network", "image_fused", "vertex"):
        m = result["metrics"][group]
        assert set(m) == {"accuracy", "mean_iou", "confusion_matrix"}
        assert np.asarray(m["confusion_matrix"]).shape == (CLASSES, CLASSES)
    # perfect predictions -> perfect network metrics; the fused re-render
    # of the same geometry is perfect too
    assert result["metrics"]["image_network"]["accuracy"] > 0.999
    assert result["metrics"]["image_fused"]["accuracy"] > 0.999
    # the ring sees 5 of 6 cube sides: the unseen side's vertices are
    # don't-care predictions, counted as errors -> 5/6
    assert abs(result["metrics"]["vertex"]["accuracy"] - 5 / 6) < 0.02

    # a second run of the same parametrization is skipped
    proc2 = _run(scannet_dir, out)
    assert proc2.returncode == 0
    assert "already exists" in proc2.stdout


def test_eval_scannet_texels_mode(scannet_dir, tmp_path):
    """Texel mode with the f16 wire: the renderer is built from every
    frame's camera, texels are fused, the YAML carries
    texel_resolution."""
    out = tmp_path / "results_texels"
    proc = _run(scannet_dir, out, ["--probs_dtype", "f16", "--mode",
                                   "texels", "--texel_resolution", "2.0",
                                   "--num", "1"])
    assert proc.returncode == 0, proc.stdout + proc.stderr
    result = _yaml(out / "run-1.yaml")
    assert result["params"]["mode"] == "texels"
    assert result["params"]["texel_resolution"] == 2.0
    assert result["metrics"]["image_fused"]["accuracy"] > 0.99
    # vertex metrics are skipped in texel mode (reference parity)
    assert result["metrics"]["vertex"]["accuracy"] == 0.0


def test_eval_checkpoint_resume(scannet_dir, tmp_path):
    """Interrupting mid-fusion (--crash_after) twice and resuming with the
    same --checkpoint directory gives the uninterrupted run's results: no
    frame is counted twice."""
    ref_out = tmp_path / "ref"
    proc = _run(scannet_dir, ref_out)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    ref = _yaml(ref_out / "run-1.yaml")

    ck, out = tmp_path / "ckpt", tmp_path / "resumed"
    every = ["--checkpoint", str(ck), "--checkpoint_every", "2"]
    proc = _run(scannet_dir, out, every + ["--crash_after", "3"])
    assert proc.returncode == 3, proc.stdout + proc.stderr
    assert (ck / "manifest.npz").is_file()
    assert not (out / "run-1.yaml").exists()
    proc = _run(scannet_dir, out, every + ["--crash_after", "2"])
    assert proc.returncode == 3, proc.stdout + proc.stderr
    proc = _run(scannet_dir, out, every)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "Resuming" in proc.stdout
    _assert_same_results(_yaml(out / "run-1.yaml"), ref)
    # completed scenes retired their aggregator snapshots
    assert not list(ck.glob("agg-*.npz"))


def test_eval_checkpoint_sigkill_resume(scannet_dir, tmp_path):
    """A SIGKILL as soon as the first manifest is on disk, then a resume:
    the uninterrupted run's results (crash-safe write ordering under a
    real kill)."""
    ref_out = tmp_path / "ref"
    proc = _run(scannet_dir, ref_out)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    ref = _yaml(ref_out / "run-1.yaml")

    ck, out = tmp_path / "ckpt", tmp_path / "resumed"
    every = ["--checkpoint", str(ck), "--checkpoint_every", "1"]
    child = subprocess.Popen(_cmd(scannet_dir, out, every), env=_env(),
                             cwd=REPO, stdout=subprocess.DEVNULL,
                             stderr=subprocess.DEVNULL)
    deadline = time.time() + 600
    try:
        while not (ck / "manifest.npz").is_file():
            if child.poll() is not None:
                pytest.fail(f"eval exited (rc={child.returncode}) before "
                            "the first checkpoint was written")
            if time.time() > deadline:
                pytest.fail("no checkpoint appeared within 600 s")
            time.sleep(0.01)
        child.send_signal(signal.SIGKILL)
        child.wait(timeout=60)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait(timeout=60)
    assert child.returncode == -signal.SIGKILL
    assert not (out / "run-1.yaml").exists()

    proc = _run(scannet_dir, out, every)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "Resuming" in proc.stdout
    _assert_same_results(_yaml(out / "run-1.yaml"), ref)


def test_eval_tfcv_stub_backend(scannet_dir, tmp_path):
    """--model tfcv through the numpy tensorflow / tfcv stubs of
    tests/_tfcv_stub: the run completes with a schema-correct YAML (the
    stub's probabilities carry no meaning)."""
    out = tmp_path / "results_tfcv"
    env = _env(os.path.join(REPO, "tests", "_tfcv_stub"))
    proc = _run(scannet_dir, out, ["--num", "1"], model="tfcv", env=env)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    result = _yaml(out / "run-1.yaml")
    assert set(result["metrics"]) == {"vertex", "image_network",
                                      "image_fused"}
    for group in ("image_network", "image_fused"):
        m = result["metrics"][group]
        assert 0.0 <= m["accuracy"] <= 1.0
        cm = np.asarray(m["confusion_matrix"])
        assert cm.shape == (CLASSES, CLASSES)
        assert cm.sum() > 0  # the stub predictor actually ran


# ------------------------------------------------------------------- parity

@pytest.fixture(scope="module")
def noisy_dir(tmp_path_factory):
    """One scene with imperfect predictions (prob_noise 0.5), so the
    network, fused and vertex matrices all have off-diagonal counts, and
    both CLIs' results: the JAX package's once, the port's once."""
    root = tmp_path_factory.mktemp("noisy")
    testing.write_scannet_label_tsv(root / "scannetv2-labels.combined.tsv")
    os.makedirs(root / "scans")
    testing.build_synthetic_scannet_scene(root, "scene0000_00",
                                          prob_noise=0.5, noise_seed=3)
    env = _env()
    env["JAX_PLATFORMS"] = env["SM_PLATFORM"] = "cpu"
    jax_cmd = [sys.executable, os.path.join(REPO, "eval-scannet",
                                            "eval_scannet.py"),
               "--scannet", str(root), "--model", "probs", "--probs_dir",
               str(root / "probs"), "--aggregator", "sum", "--output",
               str(root / "jax")]
    proc = subprocess.run(jax_cmd, env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    proc = _run(root, root / "port")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return root, _yaml(root / "jax" / "run-1.yaml"), _yaml(
        root / "port" / "run-1.yaml")


@pytest.mark.parametrize("group", ["vertex", "image_network",
                                   "image_fused"])
def test_cli_matches_the_jax_cli(noisy_dir, group):
    _, jax_result, port_result = noisy_dir
    assert port_result["params"] == jax_result["params"]
    want = np.asarray(jax_result["metrics"][group]["confusion_matrix"])
    got = np.asarray(port_result["metrics"][group]["confusion_matrix"])
    np.testing.assert_array_equal(got, want)
    assert want.sum() > 0
    if group == "image_network":  # the noise reaches the network's matrix
        assert np.trace(want) < want.sum()
    for key in ("accuracy", "mean_iou"):
        assert port_result["metrics"][group][key] == pytest.approx(
            jax_result["metrics"][group][key], abs=1e-6)


def test_scene_builders_write_the_same_files(noisy_dir, tmp_path):
    """The port's build_synthetic_scannet_scene and the JAX package's
    write the same mesh, labels, .sens stream and probability maps from
    the same arguments (the gt labels come from each package's own
    render)."""
    from semantic_meshes import testing as jtesting

    root, _, _ = noisy_dir
    jtesting.write_scannet_label_tsv(tmp_path / "labels.tsv")
    assert (tmp_path / "labels.tsv").read_bytes() == (
        root / "scannetv2-labels.combined.tsv").read_bytes()
    jtesting.build_synthetic_scannet_scene(tmp_path, "scene0000_00",
                                           prob_noise=0.5, noise_seed=3)
    mine, theirs = root / "scans" / "scene0000_00", \
        tmp_path / "scans" / "scene0000_00"
    names = sorted(p.relative_to(theirs) for p in theirs.rglob("*")
                   if p.is_file())
    assert names == sorted(p.relative_to(mine) for p in mine.rglob("*")
                           if p.is_file())
    for name in names:
        assert (mine / name).read_bytes() == (theirs / name).read_bytes(), \
            name
    for i in range(4):
        np.testing.assert_array_equal(
            np.load(root / "probs" / "scene0000_00" / f"{i}.npy"),
            np.load(tmp_path / "probs" / "scene0000_00" / f"{i}.npy"))


def test_vertex_to_faces_matches_the_reference_loop():
    """The vectorised face -> vertex adjacency equals the reference's
    dict-of-lists loop, repeated corners and unused vertices included."""
    rng = np.random.default_rng(0)
    faces = rng.integers(0, 30, (50, 3))
    faces[3] = [5, 5, 7]  # a degenerate face lists vertex 5 twice
    got = eval_scannet.vertex_to_faces(faces, 33)
    lists = {v: [] for v in range(33)}
    for f, vs in enumerate(faces):
        for v in vs:
            lists[v].append(f)
    want = np.full((33, max(len(v) for v in lists.values())), -1)
    for v, fs in lists.items():
        want[v, :len(fs)] = fs
    np.testing.assert_array_equal(got, want)


def test_read_label_map(tmp_path):
    path = tmp_path / "labels.tsv"
    path.write_text("id\traw_category\tcategory\tnyu40id\n"
                    "1\ta\ta\t3\n4\tb\tb\t0\n")
    np.testing.assert_array_equal(eval_scannet.read_label_map(path),
                                  [-1, 2, -1, -1, -1])


def test_help_names_the_flags_that_do_nothing():
    text = " ".join(eval_scannet.build_parser().format_help().split())
    for flag in ("--compile_cache", "--no_face_buckets", "--device"):
        assert flag in text
    assert text.count("does nothing") == 2
    assert eval_scannet.parse_args(["--scannet", "x"]).device == "cuda"


def test_evaluate_scene_in_process_equals_the_cli(scannet_dir, tmp_path):
    """One scene through evaluate_scene with decoded frames held in memory
    (the chip run's way, no CLI file IO inside the core): the CLI's
    results for that scene, and the re-render pass sees the fuse pass's
    ids bit for bit."""
    import torch

    from semantic_meshes_torch import data, probs_io
    from semantic_meshes_torch.data2 import SensFile

    proc = _run(scannet_dir, tmp_path / "cli", ["--num", "1"])
    assert proc.returncode == 0, proc.stdout + proc.stderr
    want = _yaml(tmp_path / "cli" / "run-1.yaml")

    name = "scene0000_00"
    scene = scannet_dir / "scans" / name
    args = eval_scannet.parse_args(
        ["--scannet", str(scannet_dir), "--model", "probs", "--aggregator",
         "sum", "--num", "1", "--device", "cpu"])
    label_map = eval_scannet.read_label_map(
        scannet_dir / "scannetv2-labels.combined.tsv")
    sens = SensFile(str(scene / f"{name}.sens"))
    _, frame_camera = eval_scannet.scene_cameras(sens)
    cameras = [(i, frame_camera(f)) for i, f in enumerate(sens.frames)]
    frames = [(i, cam, None, None,
               eval_scannet.load_gt_labels(scene, i, label_map),
               probs_io.load(str(scannet_dir / "probs" / name / str(i)),
                             wire="f32", device="cpu"))
              for i, cam in cameras]
    seen = {"fuse": [], "fused": []}

    def on_ids(kind, index, ids):
        seen[kind].append((index, ids.view(torch.int32).clone()))

    session = eval_scannet.Session(eval_scannet.result_params(args), "cpu")
    mesh_file = scene / f"{name}_vh_clean_2.labels.ply"
    result = eval_scannet.evaluate_scene(
        name, data.Ply(mesh_file), cameras, lambda start: frames[start:],
        None, session, args, labels=lambda i: frames[i][4],
        vertex_gt=eval_scannet.read_vertex_gt(mesh_file), on_ids=on_ids)
    assert result["overflow"] == 0 and result["primitives"] == 108
    assert [i for i, _ in seen["fuse"]] == [0, 1, 2, 3]
    for (i, a), (j, b) in zip(seen["fuse"], seen["fused"]):
        assert i == j and torch.equal(a, b)
    got = {"metrics": session.results(),
           "params": eval_scannet.result_params(args)}
    _assert_same_results(got, want)
