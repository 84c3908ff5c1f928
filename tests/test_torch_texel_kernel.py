"""The host side of the texel shader's CUDA route (texel_kernel.py), on the
CPU: the argument struct against csrc/texel_shader.cu, the library that
builds it, and the CPU dispatch to the plain chain. The kernels themselves
are tested on the card (tests/test_torch_texel_shader_kernel.py)."""

import ctypes
import re
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from semantic_meshes_torch import _build, render, texel_kernel, testing
from semantic_meshes_torch import rasterize as rast


def test_params_struct_matches_the_cuda_source():
    """texel_kernel._Params holds csrc/texel_shader.cu's `struct Params`
    field for field: the same names in the same order, each of the C
    type's size, so the kernels read the view as the wrapper wrote it."""
    src = (_build.CSRC / "texel_shader.cu").read_text()
    body = re.search(r"struct Params \{(.*?)\n\};", src, re.S).group(1)
    fields = []
    for line in body.splitlines():
        line = line.split("//")[0].strip()
        if not line:
            continue
        m = re.fullmatch(r"(.+?)\s*\b(\w+)(\[\d+\])?;", line)
        fields.append((m.group(2), m.group(1).strip(), m.group(3)))
    py_fields = texel_kernel._Params._fields_
    assert [f[0] for f in fields] == [f[0] for f in py_fields]
    sizes = {"float": 4, "int": 4, "long long": 8}
    for (name, ctype, count), (_, pytype) in zip(fields, py_fields):
        size = 8 if "*" in ctype else sizes[ctype]
        if count:
            size *= int(count[1:-1])
        assert ctypes.sizeof(pytype) == size, name


def test_texel_shader_is_a_library_of_its_own():
    """texel_shader.cu builds into a library of its own: an edit to it
    leaves the z-resolve and fusion libraries as they were; its entry
    points are the two the wrapper binds."""
    assert [p.name for p in _build.sources("texel_shader")] == [
        "texel_shader.cu"]
    for name in ("raster_dense", "raster_tile", "fusion"):
        assert "texel_shader.cu" not in [p.name for p in _build.sources(name)]
    text = (_build.CSRC / "texel_shader.cu").read_text()
    for name in ("sm_texel_table", "sm_texel_shade"):
        assert f"int {name}(" in text
    for name in ("texel_table_kernel", "texel_shade_kernel"):
        assert re.search(rf"\b{name}\(const Params p\)", text)


def test_the_kernels_take_only_cuda_ids():
    with pytest.raises(ValueError, match="CUDA tensor"):
        texel_kernel.texel_ids(
            np.zeros((3, 3), np.float32), np.zeros((1, 3), np.int64),
            (np.eye(3), np.zeros(3), np.ones(2), np.zeros(2)),
            torch.zeros((4, 4), dtype=torch.int32), np.ones(1, np.int32),
            np.zeros(1, np.int32), -1)


def _cube(tpp, clip_near):
    if clip_near:
        v, f = testing.make_cube(8, size=4.0)
        cams = testing.make_ring_cameras(2, 96, 64, radius=0.8,
                                         elevation=-0.625,
                                         target=(0, -0.9, 0))
    else:
        v, f = testing.make_cube(6)
        cams = testing.make_ring_cameras(2, 96, 64)
    r = render.texels(SimpleNamespace(vertices=v, faces=f), cams, tpp,
                      clip_near=clip_near, device="cpu")
    return r, cams


@pytest.mark.parametrize("clip_near", [False, True])
@pytest.mark.parametrize("tpp", [0.1, 2.0])
def test_cpu_dispatch_is_the_plain_chain(tpp, clip_near):
    """On the CPU, _texel_prim_image is the plain chain (its ids equal
    _texel_prim_image_plain's, for either none value and a band with its
    y_offset, and the kernels' counters do not move)."""
    r, cams = _cube(tpp, clip_near)
    launches, views = texel_kernel.launches, texel_kernel.views
    P = r.getPrimitivesNum()
    for c in cams:
        cam = (c.rotation, c.translation, c.focal_lengths, c.principal_point)
        tri = rast.rasterize(r.vertices, r.faces, *cam, height=64, width=96,
                             clip_near=clip_near, device="cpu")[0]
        assert bool((tri >= 0).any())
        for none, band in ((P, slice(0, 64)), (-1, slice(20, 41))):
            args = (r.vertices, r.faces, *cam, tri[band], r.resolutions,
                    r.first_texel_index, none)
            kw = dict(y_offset=band.start, clip_near=clip_near)
            got = render._texel_prim_image(*args, **kw)
            assert torch.equal(got, render._texel_prim_image_plain(*args,
                                                                   **kw))
    assert (texel_kernel.launches, texel_kernel.views) == (launches, views)


@pytest.mark.parametrize("clip_near", [False, True])
def test_renderer_shades_no_texel_to_minus_one(clip_near):
    """TexelsRenderer._shade passes -1 as the shader's none id: its ids are
    the P-filled shade with every id past the texels mapped to -1, as the
    renderer's extra select gave them before."""
    r, cams = _cube(2.0, clip_near)
    P = r.getPrimitivesNum()
    for c in cams:
        cam = (c.rotation, c.translation, c.focal_lengths, c.principal_point)
        tri = rast.rasterize(r.vertices, r.faces, *cam, height=64, width=96,
                             clip_near=clip_near, device="cpu")[0]
        prim = render._texel_prim_image_plain(
            r.vertices, r.faces, *cam, tri, r.resolutions,
            r.first_texel_index, P, clip_near=clip_near)
        want = torch.where(prim < P, prim, torch.full_like(prim, -1))
        got = r._shade(cam, tri)
        assert torch.equal(got, want)
        assert bool((got >= 0).any())
        # outside the cube the frame has background; inside it none
        assert bool((got == -1).any()) != clip_near
