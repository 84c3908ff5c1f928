"""The port's render_annotations module against the JAX repository's
script, on tests/test_scripts.py's scene.

Mirrors test_scripts.py's three render_annotations tests (consistent
views and the --fused_npz reuse path, texel mode, mul with nested COLMAP
image names) and pins the reference's uint8 label fault (ROADMAP Queue
3). Each JAX run starts once, in the background, per module fixture; the
port runs in-process on the CPU. Label and colour images must equal the
JAX run's, fused distributions agree within rtol 1e-5 / atol 1e-6.
"""

import os

import numpy as np
import pytest

from semantic_meshes_torch.io.image import imread, imwrite
from semantic_meshes_torch.scripts import render_annotations

from _torch_scripts import build_scene, jax_script, near_ties

FUSED_RTOL, FUSED_ATOL = 1e-5, 1e-6


def _args(scene, out, *extra, ws="ws"):
    return ["--colmap", str(scene / ws), "--input_ply",
            str(scene / "mesh.ply"), "--classes", "19", "--output_dir",
            str(out), *extra]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from semantic_meshes_torch.io import colmap as cio

    root = tmp_path_factory.mktemp("annotations")
    scene = root / "scene"
    tri_class, views = build_scene(scene)
    masks, nested, wide = (root / "masks", root / "nested" / "cam0",
                           root / "wide")
    for d in (masks, nested, wide):
        os.makedirs(d)
    for i, (cov, cls) in views.items():
        imwrite(masks / f"v{i}.png", cls)
        imwrite(nested / f"v{i}.png", cls)
        # class 256 on every covered pixel: a 16-bit mask
        imwrite(wide / f"v{i}.png", np.where(cov, 256, 0).astype(np.uint16))
    # the same poses under nested image names ('cam0/v1.png')
    ws2 = scene / "ws_nested"
    os.makedirs(ws2)
    images = cio.read_images(str(scene / "ws"))
    for im in images.values():
        im.name = "cam0/" + im.name
    cio.write_cameras_txt(ws2 / "cameras.txt",
                          cio.read_cameras(str(scene / "ws")))
    cio.write_images_txt(ws2 / "images.txt", images)
    jax = {
        "tri": jax_script("render_annotations", _args(
            scene, root / "jax_tri", "--masks", masks, "--save_fused",
            root / "jax_tri.npz"), root / "jax_tri.log"),
        "texels": jax_script("render_annotations", _args(
            scene, root / "jax_texels", "--masks", masks,
            "--texels_per_pixel", "0.05"), root / "jax_texels.log"),
        "mul": jax_script("render_annotations", _args(
            scene, root / "jax_mul", "--masks", root / "nested",
            "--aggregator", "mul", "--save_fused", root / "jax_mul.npz",
            ws="ws_nested"), root / "jax_mul.log"),
        "wide": jax_script("render_annotations", [
            "--colmap", scene / "ws", "--input_ply", scene / "mesh.ply",
            "--classes", "300", "--masks", wide, "--output_dir",
            root / "jax_wide"], root / "jax_wide.log"),
    }
    done = set()

    def jax_out(name):
        if name not in done:
            jax[name].wait()
            done.add(name)
        return root / f"jax_{name}"

    yield dict(root=root, scene=scene, tri_class=tri_class, views=views,
               masks=masks, nested=root / "nested", wide=wide, jax=jax_out)
    for proc in jax.values():
        if proc.proc.poll() is None:
            proc.proc.kill()
            proc.proc.wait()


def _assert_same_images(got_dir, want_dir, names):
    for name in names:
        for kind in ("labels", "color"):
            np.testing.assert_array_equal(
                imread(got_dir / kind / name), imread(want_dir / kind / name),
                err_msg=f"{kind}/{name}")


def test_render_annotations_consistent_views(runs, tmp_path):
    """Fused label masks re-rendered per view: every covered pixel of
    every view carries its triangle's class (consistent by
    construction), 255 and black elsewhere; images equal the JAX run's,
    the saved distributions agree; --fused_npz reproduces the images
    without masks."""
    from semantic_meshes_torch.utils import class_palette

    scene, out = runs["scene"], tmp_path / "ann"
    fused_npz = tmp_path / "fused.npz"
    assert render_annotations.main(_args(
        scene, out, "--masks", str(runs["masks"]), "--save_fused",
        str(fused_npz), "--device", "cpu")) == 0
    want = runs["jax"]("tri")
    _assert_same_images(out, want, [f"v{i}.png" for i in range(1, 4)])
    fused = np.load(fused_npz)["fused"]
    np.testing.assert_allclose(
        fused, np.load(runs["root"] / "jax_tri.npz")["fused"],
        rtol=FUSED_RTOL, atol=FUSED_ATOL)
    assert near_ties(fused) == 0
    palette = class_palette(19)
    for i, (cov, cls) in runs["views"].items():
        labels = imread(out / "labels" / f"v{i}.png")
        color = imread(out / "color" / f"v{i}.png")
        np.testing.assert_array_equal(labels[cov], cls[cov])
        assert (labels[~cov] == 255).all()
        np.testing.assert_array_equal(color[cov], palette[cls[cov]])
        assert not color[~cov].any()
    out2 = tmp_path / "ann2"
    assert render_annotations.main(_args(
        scene, out2, "--fused_npz", str(fused_npz), "--device", "cpu")) == 0
    _assert_same_images(out2, out, [f"v{i}.png" for i in range(1, 4)])


def test_render_annotations_texels_mode(runs, tmp_path):
    """--texels_per_pixel 0.05: the JAX run's images, and covered pixels
    carry the fused class (texel edges quantize a little differently
    from triangle ids: 99% of the covered pixels)."""
    scene, out = runs["scene"], tmp_path / "ann_tex"
    assert render_annotations.main(_args(
        scene, out, "--masks", str(runs["masks"]), "--texels_per_pixel",
        "0.05", "--device", "cpu")) == 0
    _assert_same_images(out, runs["jax"]("texels"),
                        [f"v{i}.png" for i in range(1, 4)])
    hits = total = 0
    for i, (cov, cls) in runs["views"].items():
        labels = imread(out / "labels" / f"v{i}.png")
        lab_cov = labels != 255
        hits += (labels[cov & lab_cov] == cls[cov & lab_cov]).sum()
        total += (cov & lab_cov).sum()
        assert (cov & lab_cov).sum() > 0.9 * cov.sum()
    assert hits / total > 0.99, hits / total


def test_render_annotations_mul_and_nested_names(runs, tmp_path):
    """--aggregator mul keeps never-observed primitives at zero (its
    untouched rows would normalize to uniform), and nested image names
    ('cam0/v1.png') fuse and write nested outputs; the JAX run's images
    and distributions."""
    scene, out = runs["scene"], tmp_path / "ann_mul"
    fused_npz = tmp_path / "fused_mul.npz"
    assert render_annotations.main(_args(
        scene, out, "--masks", str(runs["nested"]), "--aggregator", "mul",
        "--save_fused", str(fused_npz), "--device", "cpu",
        ws="ws_nested")) == 0
    _assert_same_images(out, runs["jax"]("mul"),
                        [f"cam0/v{i}.png" for i in range(1, 4)])
    fused = np.load(fused_npz)["fused"]
    np.testing.assert_allclose(
        fused, np.load(runs["root"] / "jax_mul.npz")["fused"],
        rtol=FUSED_RTOL, atol=FUSED_ATOL)
    observed = fused.any(-1)
    assert not observed.all()  # the cube's far faces are never seen
    assert fused[observed].sum(-1).min() > 0.5
    for i, (cov, cls) in runs["views"].items():
        labels = imread(out / "labels" / "cam0" / f"v{i}.png")
        np.testing.assert_array_equal(labels[cov], cls[cov])
        assert (labels[~cov] == 255).all()


def test_render_annotations_stores_labels_as_uint8(runs, tmp_path):
    """The reference stores labels as uint8 (scripts/render_annotations.py
    :185-186): with --classes 300 a fused class of 256 is written as 0,
    as the JAX script writes it."""
    scene, out = runs["scene"], tmp_path / "ann_wide"
    assert render_annotations.main([
        "--colmap", str(scene / "ws"), "--input_ply", str(scene / "mesh.ply"),
        "--classes", "300", "--masks", str(runs["wide"]), "--output_dir",
        str(out), "--device", "cpu"]) == 0
    want = runs["jax"]("wide")
    for i, (cov, _) in runs["views"].items():
        labels = imread(out / "labels" / f"v{i}.png")
        assert labels.dtype == np.uint8
        assert (labels[cov] == 0).all() and (labels[~cov] == 255).all()
        np.testing.assert_array_equal(
            labels, imread(want / "labels" / f"v{i}.png"))
        np.testing.assert_array_equal(
            imread(out / "color" / f"v{i}.png"),
            imread(want / "color" / f"v{i}.png"))
