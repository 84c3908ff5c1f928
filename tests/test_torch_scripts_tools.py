"""The port's precompute_probs, demo_cube and debug_render_texels modules
and its mask colour helpers against the JAX repository's.

- precompute_probs reads a flax msgpack written by the JAX package's
  SegmentationTrainer.save (full width, the script's default model) and
  its maps agree with the JAX script's within tests/_torch_models.py's
  bounds; its float16, uint8 and top-k stores have the layout the JAX
  package's probs_io.load reads.
- demo_cube and debug_render_texels write the JAX scripts' files: PLYs
  and annotation / texel images byte for byte. demo_cube's depth images
  differ from the JAX script's by at most one level on a few pixels:
  jitted XLA contracts the depth setup into FMAs (depths within rtol
  2e-5, ROADMAP), which moves a pixel across a level.
- utils.remap_mask_colors and palette_from_color_map equal the JAX
  package's on seeded random masks.

The JAX runs start in the background once per module fixture; the port
runs in-process on the CPU.
"""

import os
import sys

import numpy as np
import pytest

from semantic_meshes_torch.io.image import imread, imwrite
from semantic_meshes_torch.scripts import (debug_render_texels, demo_cube,
                                           precompute_probs)

from _torch_models import assert_probs_close
from _torch_scripts import REPO, Background

DEMO = ["--size", "96", "--views", "2", "--subdivisions", "3"]
TEXELS = ["--size", "200", "--texels_per_pixel", "0.1"]
DEPTH_LEVELS_OFF = 0.01  # share of depth pixels one level off the JAX run

TRAIN_AND_PREDICT = """
import runpy, sys
from semantic_meshes.models import training
trainer = training.SegmentationTrainer(
    classes=19, input_hw=(32, 32), widths=(64, 128, 256, 512))
trainer.save(sys.argv[1])
script = sys.argv[2]
sys.argv = [script] + sys.argv[3:]
runpy.run_path(script, run_name="__main__")
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("tools")
    images = root / "images"
    os.makedirs(images)
    rng = np.random.default_rng(0)
    imwrite(images / "a.png", rng.integers(0, 256, (48, 64, 3), np.uint8))
    params = root / "params.msgpack"
    jax = {
        "probs": Background(
            [sys.executable, "-c", TRAIN_AND_PREDICT, str(params),
             os.path.join(REPO, "scripts", "precompute_probs.py"),
             "--images", str(images), "--out", str(root / "jax_probs"),
             "--params", str(params), "--dtype", "float32"],
            root / "jax_probs.log"),
        "demo": Background(
            [sys.executable, os.path.join(REPO, "scripts", "demo_cube.py"),
             "--out", str(root / "jax_demo")] + DEMO, root / "jax_demo.log"),
        "texels": Background(
            [sys.executable,
             os.path.join(REPO, "scripts", "debug_render_texels.py"),
             "--output", str(root / "jax_texels")] + TEXELS,
            root / "jax_texels.log"),
    }
    logs = {}

    def jax_out(name):
        if name not in logs:
            logs[name] = jax[name].wait()
        return root / f"jax_{name}", logs[name]

    yield dict(root=root, images=images, params=params, jax=jax_out)
    for proc in jax.values():
        if proc.proc.poll() is None:
            proc.proc.kill()
            proc.proc.wait()


def _precompute(runs, out, *extra):
    runs["jax"]("probs")  # the msgpack is written first
    assert precompute_probs.main([
        "--images", str(runs["images"]), "--out", str(out),
        "--params", str(runs["params"]), "--device", "cpu", *extra]) == 0


def test_precompute_probs_reads_a_jax_trainer_msgpack(runs, tmp_path):
    """The JAX trainer's full-width UNet weights (flax msgpack) give the
    port's maps within the frameworks' bounds of the JAX script's."""
    out = tmp_path / "f32"
    _precompute(runs, out, "--dtype", "float32")
    got = np.load(out / "a.npy")
    want = np.load(runs["jax"]("probs")[0] / "a.npy")
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape == (48, 64, 19)
    assert_probs_close(got, want)


@pytest.mark.parametrize("store", ["float16", "uint8", "topk3"])
def test_precompute_probs_stores(runs, tmp_path, store):
    """float16 and uint8 maps are the float32 map cast and quantized;
    a top-3 store holds the 3 largest classes, descending; the JAX
    package's probs_io.load reads each file and densifies it to within
    the store's rounding of the float32 map."""
    from semantic_meshes import probs_io as jprobs

    f32 = tmp_path / "f32"
    _precompute(runs, f32, "--dtype", "float32")
    probs = np.load(f32 / "a.npy")
    out = tmp_path / store
    if store.startswith("topk"):
        _precompute(runs, out, "--topk", store[4:])
        with np.load(out / "a.npz") as z:
            vals, idx, classes = z["values"], z["indices"], int(z["classes"])
        assert vals.dtype == np.float16 and idx.dtype == np.uint8
        assert classes == 19 and vals.shape == idx.shape == (48, 64, 3)
        assert (np.diff(vals.astype(np.float32), axis=-1) <= 0).all()
        np.testing.assert_array_equal(
            vals, np.take_along_axis(probs, idx.astype(np.int64),
                                     -1).astype(np.float16))
        np.testing.assert_array_equal(
            np.sort(vals.astype(np.float32), -1)[..., ::-1],
            np.sort(probs, -1)[..., ::-1][..., :3].astype(np.float16))
        loaded = jprobs.load(str(out / "a"))
        dense = np.asarray(jprobs.densify(loaded))
        np.testing.assert_array_equal(dense.argmax(-1), probs.argmax(-1))
    else:
        _precompute(runs, out, "--dtype", store)
        stored = np.load(out / "a.npy")
        assert stored.dtype == np.dtype(store)
        np.testing.assert_array_equal(
            stored, precompute_probs.store(probs, store))
        if store == "uint8":
            np.testing.assert_array_equal(
                stored, np.rint(probs * np.float32(255)).astype(np.uint8))
        dense = np.asarray(jprobs.densify(jprobs.load(str(out / "a"),
                                                      wire="f32")))
        np.testing.assert_allclose(dense, probs, atol=1 / 510 + 1e-6)


def test_demo_cube_outputs_equal_the_jax_scripts(runs, tmp_path, capsys):
    out = tmp_path / "demo"
    assert demo_cube.main(["--out", str(out), "--device", "cpu"] + DEMO) == 0
    stats = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("triangles=")]
    want, log = runs["jax"]("demo")
    assert stats and stats[0].split(", out=")[0] in log
    files = sorted(os.listdir(want))
    assert files == sorted(os.listdir(out))
    assert {"cube.ply", "cube_colorized.ply", "view0_annotation.png",
            "view1_depth.png"} <= set(files)
    off = total = 0
    for name in files:
        if name.endswith("_depth.png"):
            a = imread(out / name).astype(np.int16)
            b = imread(want / name).astype(np.int16)
            assert np.abs(a - b).max() <= 1, name
            off, total = off + int((a != b).sum()), total + a.size
            continue
        with open(out / name, "rb") as f, open(want / name, "rb") as g:
            assert f.read() == g.read(), name
    assert off <= DEPTH_LEVELS_OFF * total, (off, total)


def test_debug_render_texels_outputs_equal_the_jax_scripts(runs, tmp_path,
                                                           capsys):
    out = tmp_path / "texels"
    assert debug_render_texels.main(
        ["--output", str(out), "--device", "cpu"] + TEXELS) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("Has ")]
    want, log = runs["jax"]("texels")
    assert len(lines) == 6
    assert lines == [ln for ln in log.splitlines() if ln.startswith("Has ")]
    files = sorted(os.listdir(want))
    assert files == sorted(os.listdir(out)) and len(files) == 18
    for name in files:
        with open(out / name, "rb") as f, open(want / name, "rb") as g:
            assert f.read() == g.read(), name


@pytest.mark.parametrize("seed,channels", [(0, 3), (1, 3), (2, 1), (3, 0)])
def test_remap_helpers_equal_jax(seed, channels):
    """remap_mask_colors over a sequence of masks (the colour -> class map
    carried across them) and palette_from_color_map, on colour, one
    channel and grey masks."""
    from semantic_meshes import utils as jutils
    from semantic_meshes_torch import utils

    rng = np.random.default_rng(seed)
    colors = rng.integers(0, 256, (7, max(channels, 1)), np.uint8)
    got_map, want_map = {}, {}
    for _ in range(3):
        pick = rng.integers(0, len(colors), (9, 11))
        mask = colors[pick] if channels else colors[pick][..., 0]
        got = utils.remap_mask_colors(mask, got_map)
        want = jutils.remap_mask_colors(mask, want_map)
        np.testing.assert_array_equal(got, want)
        assert got_map == want_map
    np.testing.assert_array_equal(
        utils.palette_from_color_map(got_map, 9),
        jutils.palette_from_color_map(want_map, 9))


@pytest.mark.parametrize("dtype,channels", [(np.uint8, 4), (np.uint16, 3),
                                            (np.uint16, 1)])
def test_remap_helpers_equal_jax_wide_masks(dtype, channels):
    """RGBA masks (packed into one key a pixel) and 16-bit masks (a row
    sort for colours, one key for grey): the JAX package's class map."""
    from semantic_meshes import utils as jutils
    from semantic_meshes_torch import utils

    rng = np.random.default_rng(channels)
    colors = rng.integers(0, np.iinfo(dtype).max, (9, channels), dtype)
    got_map, want_map = {}, {}
    for _ in range(2):
        mask = colors[rng.integers(0, len(colors), (13, 8))]
        np.testing.assert_array_equal(
            utils.remap_mask_colors(mask, got_map),
            jutils.remap_mask_colors(mask, want_map))
        assert got_map == want_map
