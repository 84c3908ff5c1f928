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
FORBIDDEN = ("jax", "jaxlib", "semantic_meshes", "flax")


def test_import_pulls_in_no_jax():
    code = (
        "import sys, semantic_meshes_torch\n"
        "import semantic_meshes_torch.rasterize.tile_kernel\n"
        "import semantic_meshes_torch.rasterize.dense_kernel\n"
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


def test_default_device_is_the_card_without_fallback(tmp_path):
    vertices, faces = testing.make_cube(1)
    write_mesh(tmp_path / "m.ply", vertices, faces)
    mesh = data.Ply(tmp_path / "m.ply")
    if torch.cuda.is_available():
        assert render.triangles(mesh).device.type == "cuda"
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
    cam = testing.make_ring_cameras(1, 128, 32)[0]
    with pytest.raises(RuntimeError, match="is_available"):
        semantic_meshes_torch.rasterize.rasterize(
            vertices, faces, cam.rotation, cam.translation,
            cam.focal_lengths, cam.principal_point, height=32, width=128,
        )


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
    render.check_pinhole(cams)  # all-zero lens: no error
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
    rasterizer (it raised before it was ported); near-plane clipping and
    lens distortion still raise."""
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
    with pytest.raises(NotImplementedError, match="clipping"):
        render.triangles(mesh, clip_near=True, device="cpu")
    lens = data.Camera(cam.rotation, cam.translation, cam.resolution,
                       cam.focal_lengths, cam.principal_point,
                       distortion=np.array([0.1, 0, 0, 0], np.float32))
    with pytest.raises(NotImplementedError, match="lens distortion"):
        renderer.render(lens)
