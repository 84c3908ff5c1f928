"""The host side of the dense preparation's CUDA route
(rasterize/dense_prep.py), on the CPU: the camera packed into the kernels'
by-value arguments, the argument struct against csrc/dense_prep.cu, the
library that builds it, and the CPU dispatch to the plain chain. The
kernels themselves are tested on the card
(tests/test_torch_dense_prep_kernel.py)."""

import ctypes
import re
import shutil

import numpy as np
import pytest
import torch

from semantic_meshes_torch import _build, testing
from semantic_meshes_torch.rasterize import dense, dense_prep

# float64 values that round to float32 at a half-way or near-half-way
# point, a denormal and values that overflow float32's range
_AWKWARD = np.array([1.0 + 2.0**-24, 1.0 + 3 * 2.0**-24, -(1.0 + 2.0**-24),
                     1e-40, 3.4e38 * 2, -1e39, 0.1, 1170.187988, -0.0],
                    np.float64)


def _cameras():
    c = testing.make_ring_cameras(1, 256, 192)[0]
    yield c.rotation, c.translation, c.focal_lengths, c.principal_point
    yield (_AWKWARD.reshape(3, 3), _AWKWARD[:3][::-1].copy(), _AWKWARD[3:5],
           _AWKWARD[7:])
    yield (torch.as_tensor(_AWKWARD.reshape(3, 3)).t(),
           [0.1, 0.2, 1e-45], (1170.187988, 1170.187988),
           torch.tensor([647.75, 483.75], dtype=torch.float64))
    yield (np.asfortranarray(c.rotation.astype(np.float64) / 3),
           c.translation.astype(np.float16), [2262.52, 2265.30],
           np.array([1096.98, 513.137]))


@pytest.mark.parametrize("k", range(4))
def test_pack_camera_equals_the_plain_chains_f32(k):
    """Every packed float equals, bit for bit, the f32 tensor the plain
    chain builds from the same input (tiles.setup_inputs' torch.as_tensor(
    x, dtype=torch.float32)), rotation row-major."""
    cam = list(_cameras())[k]
    values, on_device = dense_prep.pack_camera(*cam)
    assert values.dtype == np.float32 and values.shape == (16,)
    assert on_device == (None,) * 4
    plain = torch.cat([torch.as_tensor(x, dtype=torch.float32).reshape(-1)
                       for x in cam])
    assert np.array_equal(values.view(np.int32), plain.numpy().view(np.int32))


def test_pack_camera_refuses_wrong_sizes():
    c = testing.make_ring_cameras(1, 64, 32)[0]
    with pytest.raises(ValueError, match="camera array 0 has 6 values"):
        dense_prep.pack_camera(np.zeros((2, 3)), c.translation,
                               c.focal_lengths, c.principal_point)
    with pytest.raises(ValueError, match="camera array 2 has 1 values"):
        dense_prep.pack_camera(c.rotation, c.translation, [500.0],
                               c.principal_point)


def test_params_struct_matches_the_cuda_source():
    """dense_prep._Params holds csrc/dense_prep.cu's `struct Params` field
    for field: the same names in the same order, each of the C type's
    size, so the kernels read the view as the wrapper wrote it."""
    src = (_build.CSRC / "dense_prep.cu").read_text()
    body = re.search(r"struct Params \{(.*?)\n\};", src, re.S).group(1)
    fields = []
    for line in body.splitlines():
        line = line.split("//")[0].strip()
        if not line:
            continue
        m = re.fullmatch(r"(.+?)\s*\b(\w+)(\[\d+\])?;", line)
        fields.append((m.group(2), m.group(1).strip(), m.group(3)))
    assert [f[0] for f in fields] == [f[0] for f in dense_prep._Params._fields_]
    sizes = {"float": 4, "int": 4, "long long": 8}
    for (name, ctype, count), (_, pytype) in zip(fields,
                                                 dense_prep._Params._fields_):
        size = 8 if "*" in ctype else sizes[ctype]
        if count:
            size *= int(count[1:-1])
        assert ctypes.sizeof(pytype) == size, name


def test_dense_prep_source_is_part_of_the_raster_dense_library(
        monkeypatch, tmp_path):
    """The preparation's kernels build into raster_dense's library (one
    nvcc build for the dense route), so an edited dense_prep.cu gives that
    library a new path and leaves raster_tile's as it was."""
    assert [p.name for p in _build.sources("raster_dense")] == [
        "raster_dense.cu", "dense_prep.cu"]
    assert [p.name for p in _build.sources("raster_tile")] == [
        "raster_tile.cu", "tile_prep.cu"]
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    dense_before = _build.library_path("raster_dense")
    tile_before = _build.library_path("raster_tile")
    src = csrc / "dense_prep.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    assert _build.library_path("raster_dense") != dense_before
    assert _build.library_path("raster_tile") == tile_before
    text = src.read_text()
    for name in ("sm_dense_setup", "sm_dense_bins", "sm_dense_micro",
                 "sm_dense_prep_rows_per_block"):
        assert f"int {name}(" in text


@pytest.mark.parametrize("kw", [
    dict(), dict(e_cap_rows=0), dict(micro_cap_rows=40, micro_max=3),
    dict(micro_split=50, tri_ids=np.arange(300)[::-1].astype(np.int32)),
    dict(clip_near=True, y_offset=16.0, height=48)])
def test_cpu_dispatch_is_the_plain_chain(kw):
    """On the CPU, resolve_inputs is the plain chain (its outputs equal
    resolve_inputs_plain's, and the kernels' counters do not move)."""
    v, f = testing.make_cube(5)
    c = testing.make_ring_cameras(2, 256, 96)[1]
    cam = (c.rotation, c.translation, c.focal_lengths, c.principal_point)
    kw = {"height": 96, "width": 256, **kw}
    launches, views = dense_prep.launches, dense_prep.views
    args, key, ov = dense.resolve_inputs(v, f, *cam, device="cpu", **kw)
    pargs, pkey, pov = dense.resolve_inputs_plain(v, f, *cam, device="cpu",
                                                  **kw)
    assert (dense_prep.launches, dense_prep.views) == (launches, views)
    assert torch.equal(key, pkey) and int(ov) == int(pov)
    assert (args is None) == (pargs is None) == (kw.get("e_cap_rows") == 0)
    for a, b in zip(args or (), pargs or ()):
        assert torch.equal(a, b) if torch.is_tensor(a) else a == b


@pytest.mark.parametrize("rows,factor,e_cap_rows,want", [
    (0, 3, None, 256), (99372, 3, None, 298240), (10, 3, 1, 256),
    (10, 3, 257, 512), (10, 3, 0, 256)])
def test_pair_budget_rounds_up_to_chunks(rows, factor, e_cap_rows, want):
    assert dense._e_cap(rows, factor, e_cap_rows) == want


@pytest.mark.parametrize("budget,rows,want", [
    (None, 100, None), (100, 100, None), (150, 100, None), (0, 100, 8),
    (9, 100, 16), (99, 100, 100), (3, 4, 4), (5, 4, None)])
def test_micro_cap_rounds_up_to_eights(budget, rows, want):
    assert dense._micro_cap(budget, rows) == want
