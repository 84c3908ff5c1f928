"""Structure of semantic_meshes_torch: it imports neither JAX nor the JAX
package, its default device is the card with no CPU fallback, and its
CUDA kernels are built from the sources in the package."""

import ast
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import semantic_meshes_torch
from semantic_meshes_torch import _build, data, fusion, render, testing
from semantic_meshes_torch.io.ply import write_mesh

PKG = pathlib.Path(semantic_meshes_torch.__file__).resolve().parent
ROOT = PKG.parent
FORBIDDEN = ("jax", "jaxlib", "semantic_meshes", "flax", "msgpack")


def test_import_pulls_in_no_jax():
    code = (
        "import sys, semantic_meshes_torch\n"
        "import semantic_meshes_torch.rasterize.tile_kernel\n"
        "import semantic_meshes_torch.rasterize.dense_kernel\n"
        "import semantic_meshes_torch.native\n"
        "import semantic_meshes_torch.data2.scannet\n"
        "import semantic_meshes_torch.models\n"
        "from semantic_meshes_torch.models import segmentation, "
        "serialization, training\n"
        "from semantic_meshes_torch import eval_scannet\n"
        "lazy = [m for m in ('yaml', 'imageio') if m in "
        "sys.modules]\n"
        "assert not lazy, lazy\n"
        "from semantic_meshes_torch import (checkpoint, metrics, probs_io,\n"
        "                                   profiling)\n"
        "from semantic_meshes_torch.distributed import (\n"
        "    MeshAxis, initialize_multihost, make_device_mesh,\n"
        "    make_sharded_fuse, merge_face_blocks, view_accumulate)\n"
        "import torch.distributed.device_mesh\n"
        "semantic_meshes_torch.native.load()\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r}]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize(
    "path", sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)),
)
def test_no_jax_import_in_source(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


@pytest.mark.parametrize(
    "path", sorted(p for p in PKG.rglob("*")
                   if p.suffix in (".py", ".cu", ".cuh", ".cpp"))
    + [ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)),
)
def test_no_source_reaches_the_jax_packages_native_library(path):
    """The port builds its own host IO library into build/torch_kernels/
    (_build.build_host); no source names the repository's native/
    directory, its Makefile or its libsens_io.so."""
    text = path.read_text()
    for needle in ("native/", "libsens_io.so", "make -C"):
        assert needle not in text, f"{path} names {needle!r}"


def test_new_modules_are_exported():
    for name in ("checkpoint", "data2", "metrics", "models", "probs_io",
                 "profiling"):
        assert hasattr(semantic_meshes_torch, name), name
    assert hasattr(semantic_meshes_torch.models, "training")


def test_default_device_is_the_card_without_fallback(tmp_path):
    vertices, faces = testing.make_cube(1)
    write_mesh(tmp_path / "m.ply", vertices, faces)
    mesh = data.Ply(tmp_path / "m.ply")
    from semantic_meshes_torch import eval_scannet
    from semantic_meshes_torch.models import segmentation, training

    if torch.cuda.is_available():
        assert render.triangles(mesh).device.type == "cuda"
        predict = segmentation.load_predictor(classes=3, widths=(8, 16))
        assert next(predict.model.parameters()).is_cuda
        rgbd = segmentation.load_rgbd_predictor(classes=3, widths=(8, 16))
        assert next(rgbd.model.parameters()).is_cuda
        trainer = training.SegmentationTrainer(3, widths=(8, 16))
        assert next(trainer.model.parameters()).is_cuda
        cams = testing.make_ring_cameras(1, 128, 32)
        assert render.texels(mesh, cams, 1.0).device.type == "cuda"
        assert fusion.MeshAggregator(12, 3).device.type == "cuda"
        ann = np.zeros((12, 3), np.float32)
        assert fusion.ModelRenderer(ann).annotations.is_cuda
        return
    with pytest.raises(RuntimeError, match="is_available"):
        render.triangles(mesh)
    with pytest.raises(RuntimeError, match="is_available"):
        fusion.MeshAggregator(12, 3)
    with pytest.raises(RuntimeError, match="is_available"):
        fusion.ModelRenderer(np.zeros((12, 3), np.float32))
    with pytest.raises(RuntimeError, match="is_available"):
        segmentation.load_predictor(classes=3, widths=(8, 16))
    with pytest.raises(RuntimeError, match="is_available"):
        segmentation.load_rgbd_predictor(classes=3, widths=(8, 16))
    with pytest.raises(RuntimeError, match="is_available"):
        training.SegmentationTrainer(3, widths=(8, 16))
    args = eval_scannet.parse_args(["--scannet", str(tmp_path)])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="is_available"):
        eval_scannet.run(args)
    with pytest.raises(RuntimeError, match="is_available"):
        eval_scannet.Session({}, "cuda")
    cam = testing.make_ring_cameras(1, 128, 32)[0]
    with pytest.raises(RuntimeError, match="is_available"):
        semantic_meshes_torch.rasterize.rasterize(
            vertices, faces, cam.rotation, cam.translation,
            cam.focal_lengths, cam.principal_point, height=32, width=128,
        )
    with pytest.raises(RuntimeError, match="is_available"):
        render.texels(mesh, [cam], 1.0)
    arrays = data.stack_cameras([cam])
    with pytest.raises(RuntimeError, match="is_available"):
        semantic_meshes_torch.distributed.fuse_views_texels(
            vertices, faces, np.ones(12, np.int32), np.arange(12), *arrays,
            np.zeros((1, 32, 128, 3), np.float32), 0.5, num_primitives=12,
            aggregator="sum", height=32, width=128)


def test_kernel_sources_and_build_paths():
    src = (_build.CSRC / "raster_tile.cu").read_text()
    assert 'extern "C" int sm_raster_tile(' in src
    assert "cudaGetLastError" in src
    path = _build.library_path("raster_tile")
    assert path.parent == ROOT / "build" / "torch_kernels"
    assert path.name.startswith("libraster_tile-") and path.suffix == ".so"
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert "--use_fast_math" not in _build.NVCC_FLAGS


@pytest.mark.parametrize("name", ["raster_tile", "raster_dense"])
def test_an_edited_header_changes_the_library_path(monkeypatch, tmp_path,
                                                   name):
    """Both kernels include csrc/raster_common.cuh, so its hash is part of
    each library's path: an edited header never loads a stale library."""
    src = (_build.CSRC / f"{name}.cu").read_text()
    assert '#include "raster_common.cuh"' in src
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = _build.library_path(name)
    assert before == _build.library_path(name)  # stable
    header = csrc / "raster_common.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    edited = _build.library_path(name)
    assert edited != before and edited.name.startswith(f"lib{name}-")
    (csrc / f"{name}.cu").write_text(src + "\n// edited\n")
    assert _build.library_path(name) not in (before, edited)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build("raster_tile")
    assert not list((tmp_path / "build").glob("*.so"))


def test_pinhole_only_cameras_pass_the_lens_check():
    cams = testing.make_ring_cameras(2, 64, 32)
    assert not render._has_distortion(cams)  # all-zero lens: pinhole
    assert np.all(cams[0].distortion == 0)


def test_dense_kernel_source_and_build_path():
    src = (_build.CSRC / "raster_dense.cu").read_text()
    assert 'extern "C" int sm_raster_dense(' in src
    assert "cudaGetLastError" in src and "__fdiv_rn" in src
    path = _build.library_path("raster_dense")
    assert path.parent == ROOT / "build" / "torch_kernels"
    assert path.name.startswith("libraster_dense-") and path.suffix == ".so"
    assert path != _build.library_path("raster_tile")


def test_dense_size_meshes_render_while_unported_features_raise(tmp_path):
    """A mesh of DENSE_THRESHOLD faces or more goes to the dense
    rasterizer (it raised before it was ported), through a lens too (equal
    to the JAX package's distorted render, its dense path op by op), and
    with near-plane clipping (ported), equal to the culled render from
    outside the mesh."""
    vertices, faces = testing.make_cube(37)  # 16428 faces
    assert len(faces) >= semantic_meshes_torch.rasterize.DENSE_THRESHOLD
    write_mesh(tmp_path / "m.ply", vertices, faces)
    mesh = data.Ply(tmp_path / "m.ply")
    cam = testing.make_ring_cameras(1, 128, 96)[0]
    renderer = render.triangles(mesh, device="cpu")
    ids, depth = renderer.render(cam)
    assert ids.dtype == torch.uint32 and tuple(ids.shape) == (128, 96)
    assert bool((ids.view(torch.int32) >= 0).any())
    assert renderer.overflow_total() == 0
    # clipping (ported): from outside the mesh, the clipped dense render is
    # the culled one bit for bit (JAX's test_clip_matches_cull_when_all_in_
    # front), with budgets probed over the 2T piece rows
    clipped = render.triangles(mesh, clip_near=True, device="cpu")
    cids, cdepth = clipped.render(cam)
    assert torch.equal(cids, ids) and torch.equal(cdepth, depth)
    assert clipped.overflow_total() == 0
    lens = data.Camera(cam.rotation, cam.translation, cam.resolution,
                       cam.focal_lengths, cam.principal_point,
                       distortion=np.array([0.1, 0, 0, 0], np.float32))
    ids, _ = renderer.render(lens)
    assert renderer.overflow_total() == 0
    import jax

    import semantic_meshes

    jlens = semantic_meshes.data.Camera(
        cam.rotation, cam.translation, cam.resolution, cam.focal_lengths,
        cam.principal_point, distortion=lens.distortion)
    with jax.disable_jit():
        jids, _ = semantic_meshes.render.triangles(
            semantic_meshes.data.Ply(str(tmp_path / "m.ply")),
            backend="dense").render(jlens)
    np.testing.assert_array_equal(
        ids.view(torch.int32).numpy().view(np.uint32), np.asarray(jids))


def test_package_data_ships_every_kernel_source():
    """An installed port builds its kernels and host library from
    csrc/ at first use, so the wheel carries every source and header
    there (both kernels include raster_common.cuh)."""
    import fnmatch
    import tomllib

    config = tomllib.loads((ROOT / "pyproject.toml").read_text())
    globs = config["tool"]["setuptools"]["package-data"][
        "semantic_meshes_torch"]
    sources = [p.relative_to(PKG).as_posix() for p in _build.CSRC.iterdir()]
    assert {"csrc/raster_common.cuh", "csrc/sens_io.cpp"} <= set(sources)
    for src in sources:
        assert any(fnmatch.fnmatch(src, g) for g in globs), src


SCRIPTS = {
    "colorize_mesh": ["--colmap", "ws", "--input_ply", "m.ply", "--masks",
                      "masks", "--classes", "3", "--output_ply", "o.ply"],
    "render_annotations": ["--colmap", "ws", "--input_ply", "m.ply",
                           "--classes", "3", "--output_dir", "out"],
    "precompute_probs": ["--images", "images", "--out", "out"],
    "colorize_cityscapes_mesh": ["--colmap", "ws", "--input_ply", "m.ply",
                                 "--images", "images", "--output_ply",
                                 "o.ply"],
    "demo_cube": ["--out", "out"],
    "debug_render_texels": ["--output", "out"],
    "make_paper_graphs": ["--out", "out"],
    "bench_cityscapes": [],
    "bench_eval": [],
    "resume_killtest": [],
}
# drivers whose own work is on the host: they take no --device
HOST_SCRIPTS = {
    "create_scannet_eval_graphs": ["--path", "results"],
    "run_colmap_on_scannet": ["--scannet", "scannet"],
    "simplify_scannet_meshes": ["--scannet", "scannet", "--factor", "0.5"],
}


def test_every_module_imports_without_jax_or_imageio():
    """Every module of the port, the scripts included, imports in a
    process where JAX, the JAX package and imageio cannot be imported."""
    import pkgutil

    names = sorted(m.name for m in pkgutil.walk_packages(
        [str(PKG)], prefix="semantic_meshes_torch."))
    assert {f"semantic_meshes_torch.scripts.{s}"
            for s in {**SCRIPTS, **HOST_SCRIPTS}} | {
        "semantic_meshes_torch.io.image"} <= set(names)
    code = (
        "import importlib, sys\n"
        f"for m in {FORBIDDEN + ('imageio',)!r}:\n"
        "    sys.modules[m] = None\n"
        f"for name in {names!r}:\n"
        "    importlib.import_module(name)\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
    for path in PKG.rglob("*.py"):
        assert "imageio" not in [m.split(".")[0] for m in _imports(path)], \
            path


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_scripts_default_to_the_card_without_fallback(tmp_path, monkeypatch,
                                                      name):
    """Each script's --device defaults to cuda; its main raises without a
    card unless asked for the CPU."""
    import importlib

    module = importlib.import_module(f"semantic_meshes_torch.scripts.{name}")
    assert module.parse_args(SCRIPTS[name]).device == "cuda"
    assert module.parse_args(SCRIPTS[name] + ["--device", "cpu"]).device \
        == "cpu"
    if torch.cuda.is_available():
        return
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="is_available"):
        module.main(SCRIPTS[name])
    assert not os.listdir(tmp_path)  # nothing was written


@pytest.mark.parametrize("name", sorted(HOST_SCRIPTS))
def test_host_drivers_take_no_device_flag(name):
    """The COLMAP, MeshLab and graph drivers work on the host only: they
    parse their JAX script's flags and refuse --device."""
    import importlib

    module = importlib.import_module(f"semantic_meshes_torch.scripts.{name}")
    assert not hasattr(module.parse_args(HOST_SCRIPTS[name]), "device")
    with pytest.raises(SystemExit):
        module.parse_args(HOST_SCRIPTS[name] + ["--device", "cpu"])


def test_graph_script_fails_without_matplotlib(tmp_path, monkeypatch):
    """Without matplotlib the graph script fails before it reads or
    writes anything, as the JAX script (which imports it at the top)
    does."""
    from semantic_meshes_torch.scripts import create_scannet_eval_graphs

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError):
        create_scannet_eval_graphs.main(["--path", str(tmp_path)])
    assert not os.listdir(tmp_path)
