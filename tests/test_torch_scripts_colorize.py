"""The port's colorize_cityscapes_mesh and colorize_mesh modules against the
JAX repository's scripts, on tests/test_scripts.py's scene.

Mirrors every test_scripts.py test of the two scripts: the probs backend
(f32, f16 and u8 wires and a top-2 store), chunks 1, 2 (a ragged tail)
and auto, the three distorted camera models through chunks of 2,
`--model jax-unet` with and without `--sliding` / `--multi_scale`, the
tfcv stub (tests/_tfcv_stub) and colorize_mesh `--remap`; and pins the
reference's mul observed-mask fault (ROADMAP Queue 3). Each JAX script
runs once, in the background, per module fixture; every port case runs
in-process on the CPU and must give the JAX run's face colours exactly
(the fixture's maps are one-hot, so every wire and chunking fuses to the
same classes, with no near-tie face).

The jax-unet leg runs on weights that the JAX package's
SegmentationTrainer learns in the fixture (colour -> class on the
scene's views, coloured by class; saved as a flax msgpack that both
scripts read through `--params`). Its fused rows agree within
tests/_torch_models.py's bounds between the frameworks (bf16 convs), and
the colours are equal on every face whose JAX top-two margin exceeds
twice the largest fused difference, which a face must have to flip; the
others are counted and held to NEAR_TIE_SHARE of the seen faces.
"""

import json
import os
import sys

import numpy as np
import pytest

from semantic_meshes_torch.scripts import (colorize_cityscapes_mesh,
                                           colorize_mesh)
from semantic_meshes_torch.utils import CLASS_TO_COLOR

from _torch_models import PROB_ATOL, PROB_MEAN
from _torch_scripts import (DISTORTED, REPO, STUB, Background, build_scene,
                            face_colors, jax_env, jax_script, near_ties)

# distinct mask colours per class (test_scripts.py's remap palette)
REMAP_PALETTE = np.stack([np.arange(19) * 13 % 256, np.arange(19) * 29 % 256,
                          np.arange(19) * 53 % 256], -1).astype(np.uint8)
REMAP_PALETTE[0] = [7, 7, 7]

# the jax-unet leg: a UNet(8, 16) that the JAX trainer fits to the scene
UNET = ["--model", "jax-unet", "--widths", "8", "16"]
UNET_LEGS = {
    "unet": ["--input_hw", "48", "64"],
    "sliding": ["--input_hw", "32", "32", "--sliding", "32", "32",
                "--sliding_overlap", "0.2", "--multi_scale", "0.75", "1.0"],
}
NEAR_TIE_SHARE = 0.05  # seen faces whose margin may let a colour flip
DONT_CARE = 0.9  # the scripts' fused mass below which a face is unseen

# JAX side: train (400 AdamW steps on 32x32 crops of the views at full
# and half resolution), save the msgpack, run the JAX script on each leg
# and keep its fused rows
TRAIN_AND_COLORIZE = """
import json, runpy, sys
import numpy as np
from semantic_meshes.models import training
root, script, legs = sys.argv[1], sys.argv[2], json.loads(sys.argv[3])
data = np.load(root + "/train.npz")
pyramid = [(data["images"][:, ::k, ::k], data["labels"][:, ::k, ::k])
           for k in (1, 2)]
rng = np.random.default_rng(0)
trainer = training.SegmentationTrainer(
    classes=19, input_hw=(32, 32), widths=(8, 16), learning_rate=1e-2)
for _ in range(400):
    crops = []
    for _ in range(16):
        images, labels = pyramid[rng.integers(2)]
        v = rng.integers(len(images))
        y = rng.integers(images.shape[1] - 31)
        x = rng.integers(images.shape[2] - 31)
        crops.append((images[v, y:y + 32, x:x + 32],
                      labels[v, y:y + 32, x:x + 32]))
    trainer.train_step({
        "image": np.stack([c[0] for c in crops]).astype(np.float32) / 255,
        "labels": np.stack([c[1] for c in crops])})
trainer.save(root + "/params.msgpack")
for name, args in legs.items():
    sys.argv = [script] + args
    fused = runpy.run_path(script, run_name="__main__")["primitive_annotations"]
    np.save(root + "/jax_" + name + "_fused.npy", np.asarray(fused))
"""


def _demo_args(root, out, *extra, images=None):
    return ["--colmap", str(root / "ws"), "--input_ply",
            str(root / "mesh.ply"), "--images", str(images or root / "images"),
            "--output_ply", str(out), *extra]


def _mesh_args(root, masks, out, *extra):
    return ["--colmap", str(root / "ws"), "--input_ply",
            str(root / "mesh.ply"), "--masks", str(masks), "--output_ply",
            str(out), *extra]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The scene, the distorted scenes and the masks, and the JAX runs
    every port case compares with (started together, read when a test
    needs one)."""
    from semantic_meshes_torch.io.image import imwrite

    root = tmp_path_factory.mktemp("colorize")
    scene = root / "scene"
    tri_class, views = build_scene(scene)
    remap = root / "remap_masks"
    zero = root / "zero_masks"
    os.makedirs(remap)
    os.makedirs(zero)
    for i, (cov, cls) in views.items():
        img = np.zeros(cls.shape + (3,), np.uint8)
        img[cov] = REMAP_PALETTE[cls[cov]]
        imwrite(remap / f"v{i}.png", img)
        imwrite(zero / f"v{i}.png", np.zeros_like(cls))
    cimages = root / "class_images"  # each seen pixel its class's colour
    os.makedirs(cimages)
    train = {"images": [], "labels": []}
    for i, (cov, cls) in views.items():
        img = np.zeros(cls.shape + (3,), np.uint8)
        img[cov] = CLASS_TO_COLOR[cls[cov]]
        imwrite(cimages / f"v{i}.png", img)
        train["images"].append(img)
        train["labels"].append(np.where(cov, cls.astype(np.int32), -1))
    np.savez(root / "train.npz", **{k: np.stack(v) for k, v in train.items()})
    distorted = {}
    for name, (model, wire) in DISTORTED.items():
        distorted[name] = root / name
        build_scene(distorted[name], model, wire)
    jax = {
        "probs": jax_script("colorize_cityscapes_mesh", _demo_args(
            scene, root / "jax_probs.ply", "--probs", scene / "probs"),
            root / "jax_probs.log"),
        "tfcv": jax_script("colorize_cityscapes_mesh", _demo_args(
            scene, root / "jax_tfcv.ply", "--model", "tfcv"),
            root / "jax_tfcv.log", env=jax_env(STUB)),
        "remap": jax_script("colorize_mesh", _mesh_args(
            scene, remap, root / "jax_remap.ply", "--classes", "24",
            "--remap"), root / "jax_remap.log"),
        "mul": jax_script("colorize_mesh", _mesh_args(
            scene, zero, root / "jax_mul.ply", "--classes", "1",
            "--aggregator", "mul"), root / "jax_mul.log"),
    }
    for name, path in distorted.items():
        jax[name] = jax_script("colorize_cityscapes_mesh", _demo_args(
            path, root / f"jax_{name}.ply", "--probs", path / "probs",
            "--chunk", "2"), root / f"jax_{name}.log")
    legs = {name: _demo_args(scene, root / f"jax_{name}.ply", *UNET,
                             "--params", str(root / "params.msgpack"),
                             *extra, images=cimages)
            for name, extra in UNET_LEGS.items()}
    jax["unet"] = jax["sliding"] = Background(
        [sys.executable, "-c", TRAIN_AND_COLORIZE, str(root),
         os.path.join(REPO, "scripts", "colorize_cityscapes_mesh.py"),
         json.dumps(legs)], root / "jax_unet.log")
    done = {}

    def jax_colors(name):
        if jax[name] not in done:
            done[jax[name]] = jax[name].wait()
        return face_colors(root / f"jax_{name}.ply")

    yield dict(root=root, scene=scene, tri_class=tri_class,
               distorted=distorted, remap=remap, zero=zero, cimages=cimages,
               jax=jax_colors)
    for proc in jax.values():
        if proc.proc.poll() is None:
            proc.proc.kill()
            proc.proc.wait()


def _demo(args):
    result = colorize_cityscapes_mesh.run(
        colorize_cityscapes_mesh.parse_args(args + ["--device", "cpu"]))
    assert result["overflow"] == 0
    assert near_ties(result["fused"]) == 0
    return result


def _assert_palette(cols, tri_class, share=0.5):
    colored = cols.any(-1)
    assert colored.sum() > len(cols) * share
    np.testing.assert_array_equal(cols[colored],
                                  CLASS_TO_COLOR[tri_class][colored])


def _topk_store(src, dst, k):
    from semantic_meshes_torch.probs_io import quantize_u8
    from semantic_meshes_torch.scripts.precompute_probs import top_k

    os.makedirs(dst)
    for f in sorted(os.listdir(src)):
        vals, idx = top_k(np.load(src / f), k)
        np.savez(dst / (os.path.splitext(f)[0] + ".npz"),
                 values=quantize_u8(vals), indices=idx,
                 classes=np.int32(19))


@pytest.mark.parametrize("probs_dtype", ["f32", "f16", "u8", "topk2"])
def test_colorize_cityscapes_mesh_probs_backend(runs, tmp_path, probs_dtype):
    """Every wire of one-hot maps (a top-2 store keeps the argmax) gives
    the JAX run's colours, the known class's Cityscapes colour on every
    seen face and black elsewhere."""
    scene = runs["scene"]
    probs = scene / "probs"
    wire = probs_dtype
    if probs_dtype.startswith("topk"):
        probs = tmp_path / "probs_topk"
        _topk_store(scene / "probs", probs, int(probs_dtype[4:]))
        wire = "f16"  # a top-k store ships as stored
    out = tmp_path / "colorized.ply"
    result = _demo(_demo_args(scene, out, "--probs", str(probs),
                              "--probs_dtype", wire))
    cols = face_colors(out)
    np.testing.assert_array_equal(cols, result["colors"])
    np.testing.assert_array_equal(cols, runs["jax"]("probs"))
    _assert_palette(cols, runs["tri_class"])


@pytest.mark.parametrize("chunk", [1, 2, 0])
def test_colorize_cityscapes_mesh_chunked(runs, tmp_path, chunk):
    """--chunk 1 is the per-view render -> add path, 2 the batched path
    with a ragged tail (3 views: the last chunk padded by a zero view,
    which adds nothing), 0 auto (one chunk of 3): the JAX run's colours."""
    scene = runs["scene"]
    out = tmp_path / f"colorized_chunk{chunk}.ply"
    _demo(_demo_args(scene, out, "--probs", str(scene / "probs"),
                     "--chunk", str(chunk)))
    cols = face_colors(out)
    np.testing.assert_array_equal(cols, runs["jax"]("probs"))
    _assert_palette(cols, runs["tri_class"])


@pytest.mark.parametrize("name", sorted(DISTORTED))
def test_colorize_cityscapes_mesh_chunked_distorted(runs, tmp_path, name):
    """A distorted workspace (SIMPLE_RADIAL, and the extended lens wire of
    the two fisheye models) through chunks of 2: the JAX run's colours."""
    from semantic_meshes_torch import data

    path = runs["distorted"][name]
    assert np.any(data.Colmap(str(path / "ws")).getCamera(0).distortion)
    out = tmp_path / f"colorized_{name}.ply"
    _demo(_demo_args(path, out, "--probs", str(path / "probs"),
                     "--chunk", "2"))
    cols = face_colors(out)
    np.testing.assert_array_equal(cols, runs["jax"](name))
    _assert_palette(cols, runs["tri_class"], share=0.4)


def _unet_leg(runs, out, name, *extra):
    """Run the jax-unet leg `name` through the port on the JAX trainer's
    msgpack and hold it to the JAX script's run. Returns the port's
    run() result."""
    root = runs["root"]
    args = _demo_args(runs["scene"], out, *UNET, "--params",
                      str(root / "params.msgpack"), *UNET_LEGS[name], *extra,
                      "--device", "cpu", images=runs["cimages"])
    want_cols = runs["jax"](name)  # waits for the msgpack too
    got = colorize_cityscapes_mesh.run(colorize_cityscapes_mesh.parse_args(
        args))
    assert got["overflow"] == 0
    cols = face_colors(out)
    np.testing.assert_array_equal(cols, got["colors"])
    want = np.load(root / f"jax_{name}_fused.npy")
    err = np.abs(got["fused"] - want)
    assert err.max() <= PROB_ATOL and err.mean() <= PROB_MEAN, (
        err.max(), err.mean())
    seen = want.sum(-1) >= DONT_CARE
    np.testing.assert_array_equal(seen, got["fused"].sum(-1) >= DONT_CARE)
    top = np.sort(want, -1)[:, -2:]
    tie = seen & (top[:, 1] - top[:, 0] <= 2 * err.max())
    assert tie.sum() <= NEAR_TIE_SHARE * seen.sum(), (tie.sum(), seen.sum())
    np.testing.assert_array_equal(cols[~tie], want_cols[~tie])
    np.testing.assert_array_equal(cols[seen & ~tie],
                                  CLASS_TO_COLOR[want.argmax(-1)][seen & ~tie])
    assert not cols[~seen].any()
    return got


def test_colorize_cityscapes_mesh_jax_unet(runs, tmp_path):
    """--model jax-unet --params (the flax msgpack of the JAX trainer),
    resized to --input_hw 48 64: the JAX run's fused rows within the
    frameworks' bounds and its colours outside near ties."""
    _unet_leg(runs, tmp_path / "unet.ply", "unet")


def test_colorize_cityscapes_mesh_jax_sliding(runs, tmp_path):
    """--model jax-unet with --sliding and --multi_scale (the reference
    demo's sliding window and scales) on the JAX trainer's weights: the
    JAX run's fused rows and colours as above, and the same colours
    through the batched and the per-view path."""
    batched = _unet_leg(runs, tmp_path / "sliding.ply", "sliding")
    per_view = _unet_leg(runs, tmp_path / "per_view.ply", "sliding",
                         "--chunk", "1")
    np.testing.assert_array_equal(batched["colors"], per_view["colors"])


def test_colorize_cityscapes_mesh_tfcv_stub(runs, tmp_path, monkeypatch):
    """--model tfcv against the numpy tensorflow / tfcv stubs: the JAX
    run's colours (the stub predicts the same maps for both)."""
    import sys

    monkeypatch.syspath_prepend(STUB)
    for mod in ("tensorflow", "tfcv"):
        monkeypatch.delitem(sys.modules, mod, raising=False)
    scene = runs["scene"]
    out = tmp_path / "colorized_tfcv.ply"
    _demo(_demo_args(scene, out, "--model", "tfcv"))
    for mod in ("tensorflow", "tfcv"):
        monkeypatch.delitem(sys.modules, mod, raising=False)
    cols = face_colors(out)
    assert len(cols) == len(runs["tri_class"]) and cols.any()
    np.testing.assert_array_equal(cols, runs["jax"]("tfcv"))


def test_colorize_mesh_remap_backend(runs, tmp_path, capsys):
    """colorize_mesh --remap: colour masks -> classes on first sight ->
    the discovered palette; the JAX run's colours, each a mask colour."""
    out = tmp_path / "remap.ply"
    assert colorize_mesh.main(_mesh_args(
        runs["scene"], runs["remap"], out, "--classes", "24", "--remap",
        "--device", "cpu")) == 0
    assert "distinct mask colors" in capsys.readouterr().out
    cols = face_colors(out)
    np.testing.assert_array_equal(cols, runs["jax"]("remap"))
    colored = cols.any(-1)
    assert colored.sum() > len(cols) * 0.5
    valid = {tuple(c) for c in REMAP_PALETTE} | {(0, 0, 0)}
    assert {tuple(c) for c in np.unique(cols[colored], axis=0)} <= valid


def test_colorize_mesh_mul_paints_an_all_zero_state_black(runs, tmp_path):
    """The reference's observed mask (scripts/colorize_mesh.py:120-123)
    takes an all-zero raw state for never observed. With one class every
    observation is certain, log(1) = 0, so under mul every face's state
    stays zero and the whole mesh is painted black, seen or not, as the
    JAX script paints it; sum colours the seen faces of the same masks."""
    from semantic_meshes_torch.utils import class_palette

    args = ("--classes", "1", "--device", "cpu")
    mul = tmp_path / "mul.ply"
    assert colorize_mesh.main(_mesh_args(
        runs["scene"], runs["zero"], mul, *args, "--aggregator", "mul")) == 0
    cols = face_colors(mul)
    assert not cols.any()
    np.testing.assert_array_equal(cols, runs["jax"]("mul"))
    summed = tmp_path / "sum.ply"
    assert colorize_mesh.main(_mesh_args(
        runs["scene"], runs["zero"], summed, *args,
        "--aggregator", "sum")) == 0
    seen = face_colors(summed)
    assert seen.any(-1).sum() > len(seen) * 0.5
    assert {tuple(c) for c in seen[seen.any(-1)]} == {
        tuple(class_palette(1)[0])}
