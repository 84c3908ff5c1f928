"""The host side of the tile preparation's CUDA route
(rasterize/tile_prep.py), on the CPU: the argument struct against
csrc/tile_prep.cu, the library that builds it, the CPU dispatch to the
plain chain, and the wrapper's refusals. The kernels themselves are tested
on the card (tests/test_torch_tile_prep_kernel.py)."""

import ctypes
import re
import shutil

import numpy as np
import pytest
import torch

from semantic_meshes_torch import _build, testing
from semantic_meshes_torch.rasterize import tile_kernel, tile_prep


def test_params_struct_matches_the_cuda_source():
    """tile_prep._Params holds csrc/tile_prep.cu's `struct Params` field
    for field: the same names in the same order, each of the C type's
    size, so the kernels read the view as the wrapper wrote it."""
    src = (_build.CSRC / "tile_prep.cu").read_text()
    body = re.search(r"struct Params \{(.*?)\n\};", src, re.S).group(1)
    fields = []
    for line in body.splitlines():
        line = line.split("//")[0].strip()
        if not line:
            continue
        m = re.fullmatch(r"(.+?)\s*\b(\w+)(\[\d+\])?;", line)
        fields.append((m.group(2), m.group(1).strip(), m.group(3)))
    py_fields = tile_prep._Params._fields_
    assert [f[0] for f in fields] == [f[0] for f in py_fields]
    sizes = {"float": 4, "int": 4, "long long": 8}
    for (name, ctype, count), (_, pytype) in zip(fields, py_fields):
        size = 8 if "*" in ctype else sizes[ctype]
        if count:
            size *= int(count[1:-1])
        assert ctypes.sizeof(pytype) == size, name


def test_tile_prep_source_is_part_of_the_raster_tile_library(monkeypatch,
                                                             tmp_path):
    """The preparation's kernels build into kernel A's library (one nvcc
    build for the tile route), so an edited tile_prep.cu gives that
    library a new path and leaves raster_dense's as it was; the source
    holds the entry points and kernels the wrapper and the benchmark's
    reader name."""
    assert [p.name for p in _build.sources("raster_tile")] == [
        "raster_tile.cu", "tile_prep.cu"]
    for name in ("raster_dense", "texel_shader", "fusion"):
        assert "tile_prep.cu" not in [p.name for p in _build.sources(name)]
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    tile_before = _build.library_path("raster_tile")
    dense_before = _build.library_path("raster_dense")
    src = csrc / "tile_prep.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    assert _build.library_path("raster_tile") != tile_before
    assert _build.library_path("raster_dense") == dense_before
    text = src.read_text()
    for name in ("sm_tile_setup", "sm_tile_bins", "sm_tile_prep_row_align"):
        assert f"int {name}(" in text
    for name in ("tile_setup_kernel", "tile_bins_kernel"):
        assert re.search(rf"\b{name}\(const Params p\)", text)


def _view(subdivisions=5, width=256, height=96, k=1):
    v, f = testing.make_cube(subdivisions)
    c = testing.make_ring_cameras(2, width, height)[k]
    cam = (c.rotation, c.translation, c.focal_lengths, c.principal_point)
    return v, f, cam


# every form resolve_inputs takes: face vertices or the gather path (int32
# and int64 faces), clip_near, a row band, a cap that drops (overflow) and
# one past the row count (N = T)
FORMS = {
    "face_vertices": dict(fv=True),
    "gather_int64": dict(),
    "gather_int32": dict(faces=np.int32),
    "clip_near": dict(fv=True, clip_near=True),
    "clip_near_gather": dict(clip_near=True),
    "band": dict(fv=True, y_offset=32.0, height=48),
    "cap_drops": dict(fv=True, max_tris_per_tile=8),
    "cap_past_rows": dict(fv=True, max_tris_per_tile=4096),
}


@pytest.mark.parametrize("form", FORMS)
def test_cpu_dispatch_is_the_plain_chain(form):
    """On the CPU, resolve_inputs is the plain chain: its outputs equal
    resolve_inputs_plain's and the old composition's (setup_inputs,
    _bin_triangles, candidate_table), the tile_prep kernels' counters do
    not move and tile_kernel.views counts the view."""
    from semantic_meshes_torch.rasterize import tiles

    kw = dict(FORMS[form])
    use_fv = kw.pop("fv", False)
    faces_dtype = kw.pop("faces", np.int64)
    v, f, cam = _view()
    f = f.astype(faces_dtype)
    kw = {"height": 96, "width": 256, **kw}
    fv = torch.as_tensor(v[f.astype(np.int64)]) if use_fv else None
    verts, faces = (None, None) if use_fv else (v, f)
    launches, views = tile_prep.launches, tile_prep.views
    tile_views = tile_kernel.views
    got, ov = tile_kernel.resolve_inputs(verts, faces, *cam,
                                         face_vertices=fv, device="cpu",
                                         **kw)
    want, ov_want = tile_kernel.resolve_inputs_plain(
        verts, faces, *cam, face_vertices=fv, device="cpu", **kw)
    assert (tile_prep.launches, tile_prep.views) == (launches, views)
    assert tile_kernel.views == tile_views + 1
    y_offset = float(kw.get("y_offset", 0.0))
    setup = tiles.setup_inputs(verts, faces, *cam, fv, "cpu",
                               kw.get("clip_near", False))
    cand, counts, overflow = tiles._bin_triangles(
        setup, kw["height"], kw["width"], kw.get("max_tris_per_tile", 256),
        y_offset)
    old = (tile_kernel.candidate_table(setup), cand, counts, y_offset,
           tiles._cdiv(kw["width"], tiles.TILE_W), kw["height"],
           kw["width"])
    for a, b, c in zip(got, want, old):
        if torch.is_tensor(a):
            assert a.dtype == b.dtype == c.dtype and a.shape == b.shape
            assert torch.equal(a, b) and torch.equal(a, c)
        else:
            assert a == b == c
    assert ov.dtype == torch.int32 and ov.shape == ()
    assert int(ov) == int(ov_want) == int(overflow)
    rows = len(f) * (2 if kw.get("clip_near") else 1)
    assert got[0].shape == (rows + 1, 16)
    assert got[1].shape[1] == min(kw.get("max_tris_per_tile", 256), rows)
    assert (int(ov) > 0) == (form == "cap_drops")


def test_cuda_device_without_a_card_raises(monkeypatch):
    """device="cuda" never falls back to the plain chain: without a card
    resolve_inputs raises before any work."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    v, f, cam = _view()
    launches = tile_prep.launches
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        tile_kernel.resolve_inputs(v, f, *cam, height=96, width=256,
                                   device="cuda")
    assert tile_prep.launches == launches


def _fv(v, f):
    return torch.as_tensor(v[f], dtype=torch.float32).contiguous()


@pytest.mark.parametrize("case", [
    "fv_on_cpu", "fv_float64", "fv_strided", "fv_shape", "fv_numpy",
    "vertices_on_cpu", "vertices_float64", "vertices_strided"])
def test_the_wrapper_takes_only_contiguous_typed_cuda_tensors(case):
    """tile_prep.prepare raises ValueError, naming the array and what is
    wrong with it, on any input that is not a contiguous CUDA tensor of the
    kernels' type and shape; it computes nothing on the CPU instead (the
    card tests refuse CUDA tensors of the wrong type or strides)."""
    v, f, cam = _view(3)
    fv = _fv(v, f)
    vt = torch.as_tensor(v, dtype=torch.float32)
    ft = torch.as_tensor(f)
    inputs = {
        "fv_on_cpu": (fv, None, "face_vertices", "on cpu"),
        "fv_float64": (fv.double(), None, "face_vertices", "float64"),
        "fv_strided": (torch.cat([fv, fv], 2)[..., ::2], None,
                       "face_vertices", "contiguous=False"),
        "fv_shape": (fv.reshape(-1, 9), None, "face_vertices",
                     r"\(\?, 3, 3\)"),
        "fv_numpy": (v[f], None, "face_vertices", "ndarray"),
        "vertices_on_cpu": (None, vt, "vertices", "on cpu"),
        "vertices_float64": (None, vt.double(), "vertices", "float64"),
        "vertices_strided": (None, torch.cat([vt, vt], 1)[:, ::2],
                             "vertices", "contiguous=False"),
    }
    fv_in, v_in, name, detail = inputs[case]
    launches, views = tile_prep.launches, tile_prep.views
    with pytest.raises(ValueError, match=f"^{name} must be") as err:
        tile_prep.prepare(fv_in, v_in, None if v_in is None else ft, cam,
                          height=96, width=256, y_offset=0.0,
                          max_tris_per_tile=256, clip_near=False)
    assert re.search(detail, str(err.value))
    assert (tile_prep.launches, tile_prep.views) == (launches, views)


def test_image_past_the_packed_rectangles_is_refused(monkeypatch):
    """A tile grid wider than the rectangles' 16-bit bounds is refused
    before any launch (checked past the tensor checks, so with the tensor
    check passed by a stand-in)."""
    monkeypatch.setattr(tile_prep, "_check", lambda *a: None)
    v, f, cam = _view(2)
    fv = _fv(v, f)
    with pytest.raises(ValueError, match="packed tile rectangles"):
        tile_prep.prepare(fv, None, None, cam, height=96,
                          width=128 * (tile_prep.MAX_TILES_A_SIDE + 1),
                          y_offset=0.0, max_tris_per_tile=256,
                          clip_near=False)
