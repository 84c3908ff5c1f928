"""The port's image codec (semantic_meshes_torch.io.image, on Pillow)
against imageio, and the port's CLIs on a Python where imageio cannot be
imported.

imread must give imageio.v2.imread's arrays (dtype, shape, values) and
imwrite its files byte for byte, on 8-bit grey, RGB and RGBA PNG,
16-bit grey PNG, palette PNG and JPEG, from paths, file objects and
bytes. A `sitecustomize` on PYTHONPATH that sets
`sys.modules["imageio"] = None` stands in for a machine without imageio:
the eval CLI and the Cityscapes demo run there on the CPU.
"""

import io
import os
import subprocess
import sys

import imageio.v2 as imageio
import numpy as np
import pytest

from semantic_meshes_torch import testing
from semantic_meshes_torch.io import image

from _torch_scripts import REPO, build_scene


def _arrays():
    rng = np.random.default_rng(0)
    return {
        "grey8": rng.integers(0, 256, (37, 53), np.uint8),
        "rgb8": rng.integers(0, 256, (37, 53, 3), np.uint8),
        "rgba8": rng.integers(0, 256, (29, 31, 4), np.uint8),
        "grey16": rng.integers(0, 65536, (37, 53), np.uint16),
        "labels16": np.where(rng.random((24, 32)) < 0.5, 0, 40).astype(
            np.uint16),
    }


CASES = [(name, ext) for name in _arrays() for ext in ("png", "jpg")
         if not (ext == "jpg" and (name.endswith("16") or name == "rgba8"))]


@pytest.mark.parametrize("name,ext", CASES,
                         ids=[f"{n}-{e}" for n, e in CASES])
def test_files_and_arrays_equal_imageio(tmp_path, name, ext):
    array = _arrays()[name]
    ours, theirs = tmp_path / f"ours.{ext}", tmp_path / f"theirs.{ext}"
    image.imwrite(ours, array)
    imageio.imwrite(theirs, array)
    assert ours.read_bytes() == theirs.read_bytes()
    got, want = image.imread(theirs), imageio.imread(theirs)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    if ext == "png":
        np.testing.assert_array_equal(got, array)  # lossless round trip
    # bytes and file objects decode the same
    data = theirs.read_bytes()
    np.testing.assert_array_equal(image.imread(data), want)
    with open(theirs, "rb") as f:
        np.testing.assert_array_equal(image.imread(f), want)


@pytest.mark.parametrize("fmt", ["png", "jpeg"])
def test_buffers_equal_imageio(fmt):
    array = _arrays()["rgb8"]
    ours, theirs = io.BytesIO(), io.BytesIO()
    image.imwrite(ours, array, format=fmt)
    imageio.imwrite(theirs, array, format=fmt)
    assert ours.getvalue() == theirs.getvalue()
    np.testing.assert_array_equal(image.imread(ours.getvalue()),
                                  imageio.imread(theirs.getvalue()))
    with pytest.raises(ValueError, match="format="):
        image.imwrite(io.BytesIO(), array)


def test_palette_png_decodes_as_imageio(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(1)
    pal = Image.fromarray(rng.integers(0, 256, (20, 30, 3), np.uint8)
                          ).convert("P", palette=Image.Palette.ADAPTIVE,
                                    colors=16)
    pal.save(tmp_path / "p.png")
    got, want = image.imread(tmp_path / "p.png"), imageio.imread(
        tmp_path / "p.png")
    assert got.dtype == want.dtype and got.shape == want.shape == (20, 30, 3)
    np.testing.assert_array_equal(got, want)


def test_the_scannet_readers_decode_through_io_image(tmp_path):
    """RGBDFrame's JPEG decode and the .sens exporters (16-bit depth PNG,
    JPEG colour) on io.image: imageio reads back what they wrote."""
    from semantic_meshes_torch.data2 import SensFile

    root = tmp_path / "scannet"
    testing.build_synthetic_scannet_scene(root, "scene0000_00",
                                          num_views=2)
    sens = SensFile(str(root / "scans" / "scene0000_00" /
                        "scene0000_00.sens"))
    color = sens.frames[0].decompress_color(sens.color_compression_type)
    np.testing.assert_array_equal(
        color, imageio.imread(bytes(sens.frames[0].color_data)))
    sens.export_depth_images(str(tmp_path / "depth"))
    sens.export_color_images(str(tmp_path / "color"))
    depth = imageio.imread(tmp_path / "depth" / "0.png")
    assert depth.dtype == np.uint16
    np.testing.assert_array_equal(depth, sens.depth_image(sens.frames[0]))
    assert imageio.imread(tmp_path / "color" / "1.jpg").shape == color.shape


SITECUSTOMIZE = """import sys
sys.modules["imageio"] = None  # stands in for a machine without imageio
"""


def test_the_clis_run_without_imageio(tmp_path):
    """The eval CLI (PNG labels, JPEG colour) and the Cityscapes demo (PNG
    images) in processes where `import imageio` fails."""
    block = tmp_path / "block"
    os.makedirs(block)
    (block / "sitecustomize.py").write_text(SITECUSTOMIZE)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(block), REPO]),
               OMP_NUM_THREADS="2")
    env.pop("XLA_FLAGS", None)
    probe = subprocess.run([sys.executable, "-c", "import imageio"],
                           env=env, capture_output=True, text=True)
    assert probe.returncode != 0 and "imageio" in probe.stderr

    root = tmp_path / "scannet"
    testing.build_synthetic_scannet_scene(root, "scene0000_00")
    testing.write_scannet_label_tsv(root / "scannetv2-labels.combined.tsv")
    out = tmp_path / "results"
    proc = subprocess.run(
        [sys.executable, "-m", "semantic_meshes_torch.eval_scannet",
         "--scannet", str(root), "--model", "probs", "--probs_dir",
         str(root / "probs"), "--aggregator", "sum", "--output", str(out),
         "--debug", str(tmp_path / "debug"), "--device", "cpu"],
        env=env, capture_output=True, text=True, timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert (out / "run-1.yaml").is_file()
    assert (tmp_path / "debug" / "0_pred.png").is_file()

    scene = tmp_path / "scene"
    build_scene(scene)
    proc = subprocess.run(
        [sys.executable, "-m",
         "semantic_meshes_torch.scripts.colorize_cityscapes_mesh",
         "--colmap", str(scene / "ws"), "--input_ply",
         str(scene / "mesh.ply"), "--images", str(scene / "images"),
         "--output_ply", str(tmp_path / "out.ply"), "--probs",
         str(scene / "probs"), "--device", "cpu"],
        env=env, capture_output=True, text=True, timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert (tmp_path / "out.ply").is_file()
