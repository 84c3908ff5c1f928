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
