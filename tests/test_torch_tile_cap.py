"""The tile route's per-tile list sized from the set-up probe, on the CPU.

`tiles.tile_counts` counts each tile's candidates with a difference array
over the tiles and prefix sums, and `tiles.max_tile_rows` takes the
largest over a camera batch; both must equal what `_bin_triangles` counts
before its cap. `TrianglesRenderer.prepare` sizes the list length from
that probe (a multiple of 32, at least max_tris_per_tile, grow-only); a
renderer never prepared and a direct `tile_kernel.rasterize` keep the JAX
package's fixed 256 and drop the pairs past it.

The scene: a cube of 3072 triangles in a 256 x 128 frame, seen almost
along a face's normal, so that its side faces lie edge-on as slivers;
every one of its 8 tiles lists 430-470 candidates. One torch thread.
"""

import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark.reference import raster as reference
from semantic_meshes_torch import profiling, render, testing
from semantic_meshes_torch.data import Camera, stack_cameras
from semantic_meshes_torch.geometry import look_at
from semantic_meshes_torch.rasterize import tile_kernel, tiles

H, W = 128, 256
CAP = 256  # the JAX package's fixed list length


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _mesh(v, f):
    return SimpleNamespace(vertices=v, faces=f)


def _args(cam):
    return (cam.rotation, cam.translation, cam.focal_lengths,
            cam.principal_point)


def _cams(angles_deg, radius=2.0, elevation=0.05, focal=180.0):
    out = []
    for a in np.deg2rad(angles_deg):
        eye = [radius * np.sin(a), elevation, -radius * np.cos(a)]
        rot, trans = look_at(eye, [0.0, 0.0, 0.0], [0.0, 1.0, 0.0])
        out.append(Camera(rot, trans, np.array([W, H]),
                          np.array([focal, focal], np.float32),
                          np.array([W / 2, H / 2], np.float32)))
    return out


def _scene(n=4, seed=11):
    """The cube and n views within a few degrees of a face's normal, the
    angles drawn from the seed."""
    v, f = testing.make_cube(16)
    rng = np.random.default_rng(seed)
    return v, f, _cams(rng.uniform(-4.0, 4.0, n))


def _counts(v, f, cam, clip_near=False, y_offset=0.0):
    """_bin_triangles' per-tile counts of one view with no cap."""
    setup = tiles.setup_inputs(v, f, *_args(cam), device="cpu",
                               clip_near=clip_near)
    _, counts, overflow = tiles._bin_triangles(setup, H, W, 2 * len(f),
                                               y_offset)
    assert int(overflow) == 0
    return setup, counts


@pytest.mark.parametrize("clip_near", [False, True])
def test_probe_equals_the_binning(clip_near):
    """tile_counts equals the binning's count on every tile of every view
    (and of a row band), and max_tile_rows is their largest, over 256."""
    v, f, cams = _scene()
    want = []
    for cam in cams:
        setup, counts = _counts(v, f, cam, clip_near)
        assert torch.equal(tiles.tile_counts(setup, H, W), counts.long())
        band, band_counts = _counts(v, f, cam, clip_near, y_offset=37.0)
        assert torch.equal(tiles.tile_counts(band, H, W, 37.0),
                           band_counts.long())
        want.append(int(counts.max()))
    fv = torch.as_tensor(v)[torch.as_tensor(f).long()]
    got = tiles.max_tile_rows(fv, *stack_cameras(cams), height=H, width=W,
                              clip_near=clip_near, device="cpu")
    assert int(got) == max(want) > CAP


def test_probe_chunks_and_empty_views(monkeypatch):
    """The chunking over cameras changes nothing, and a view that sees no
    triangle lists none."""
    v, f, cams = _scene(n=5)
    behind = Camera(cams[0].rotation, [0.0, 0.0, -5.0], cams[0].resolution,
                    cams[0].focal_lengths, cams[0].principal_point)
    cams = [behind] + cams
    fv = torch.as_tensor(v)[torch.as_tensor(f).long()]
    batch = stack_cameras(cams)
    whole = tiles.max_tile_rows(fv, *batch, height=H, width=W, device="cpu")
    monkeypatch.setattr(tiles, "PROBE_CHUNK", 2)
    assert int(tiles.max_tile_rows(fv, *batch, height=H, width=W,
                                   device="cpu")) == int(whole)
    assert int(tiles.max_tile_rows(fv, *stack_cameras([behind]), height=H,
                                   width=W, device="cpu")) == 0
    assert int(_counts(v, f, behind)[1].max()) == 0


def _owners_agree(ids, view):
    """Every pixel the program owns differently from the float64
    reference is fragile there, with the program's owner among its
    possible owners."""
    ids = ids.reshape(-1).long()
    differ = torch.nonzero(ids != view.ids).reshape(-1).tolist()
    allowed = set(zip(view.fragile_pix.tolist(), view.fragile_ids.tolist()))
    for p in differ:
        q = int(ids[p])
        assert q < 0 or (p, q) in allowed, (p, q)


def test_prepared_renderer_holds_every_list(monkeypatch):
    """prepare sizes the list from the probe: nothing drops, and each
    view's ids and depths equal the uncapped plain resolve's, whose owners
    are the float64 reference's; the counters record the probe and the
    cap."""
    monkeypatch.setattr(profiling, "_counters", {})
    v, f, cams = _scene()
    r = render.triangles(_mesh(v, f), backend="tile", device="cpu")
    r.prepare(cams)
    rows = max(int(_counts(v, f, c)[1].max()) for c in cams)
    cap = -(-rows // 32) * 32
    assert r.tile_caps[(H, W)] == cap > CAP
    assert profiling.counters() == {"tiles.max_tile_rows": rows,
                                    "tiles.cap": cap}
    for cam in cams:
        ids, depth = r.render(cam)
        args, overflow = tile_kernel.resolve_inputs(
            v, f, *_args(cam), height=H, width=W,
            max_tris_per_tile=2 * len(f), device="cpu")
        assert int(overflow) == 0
        want_z, want_ids = tile_kernel.resolve_tiles_plain(*args)
        got_ids = ids.view(torch.int32).t()
        assert torch.equal(got_ids, want_ids)
        assert torch.equal(depth.t().view(torch.int32),
                           want_z.view(torch.int32))
        view = reference.rasterize(
            torch.as_tensor(v), torch.as_tensor(f).long(),
            *(torch.as_tensor(a) for a in _args(cam)), height=H, width=W)
        _owners_agree(got_ids, view)
    assert r.overflow_total() == 0


def test_unprepared_and_direct_calls_keep_256():
    """A renderer never prepared and a direct tile_kernel.rasterize list
    256 candidates a tile, as the JAX package does, and count every pair
    past them."""
    v, f, cams = _scene(n=1)
    cam = cams[0]
    dropped = int((_counts(v, f, cam)[1].long() - CAP).clamp(min=0).sum())
    assert dropped > 0
    ids, _, overflow = tile_kernel.rasterize(v, f, *_args(cam), height=H,
                                             width=W, device="cpu")
    assert int(overflow) == dropped
    r = render.triangles(_mesh(v, f), backend="tile", device="cpu")
    got, _ = r.render(cam)
    assert r.tile_caps == {} and r.overflow_total() == dropped
    assert torch.equal(got.view(torch.int32).t(), ids)


def test_the_list_only_grows(monkeypatch):
    """A second prepare over lighter views keeps the list; a constructor
    length above the probe is kept; each resolution has its own."""
    monkeypatch.setattr(profiling, "_counters", {})
    v, f, cams = _scene()
    # the cube behind these cameras: no tile lists anything
    behind = [Camera(c.rotation, [0.0, 0.0, -5.0], c.resolution,
                     c.focal_lengths, c.principal_point) for c in cams]
    r = render.triangles(_mesh(v, f), backend="tile", device="cpu")
    r.prepare(behind)
    light = r.tile_caps[(H, W)]
    assert light == CAP  # at least the constructor's
    r.prepare(cams)
    heavy = r.tile_caps[(H, W)]
    assert heavy > light
    r.prepare(behind)
    assert r.tile_caps[(H, W)] == heavy
    counters = profiling.counters()
    assert counters["tiles.cap"] == heavy
    assert counters["tiles.max_tile_rows"] > CAP

    wide = render.triangles(_mesh(v, f), max_tris_per_tile=2048,
                            backend="tile", device="cpu")
    wide.prepare(cams)
    assert wide.tile_caps[(H, W)] == 2048
    small = Camera(cams[0].rotation, cams[0].translation, np.array([64, 32]),
                   cams[0].focal_lengths, [32.0, 16.0])
    r.prepare([small])
    assert r.tile_caps[(H, W)] == heavy and (32, 64) in r.tile_caps


def test_the_dense_route_sizes_no_tile_list():
    v, f, cams = _scene(n=1)
    r = render.triangles(_mesh(v, f), backend="dense", device="cpu")
    r.prepare(cams)
    assert r.tile_caps == {} and (H, W) in r.dense_cap_policy._cap


def test_tile_prep_span_and_view_counter(tmp_path):
    """Each tile-route render counts one prepared view and, under a
    profiler, opens one smt.tile_prep range inside its smt.render."""
    v, f, cams = _scene(n=2)
    r = render.triangles(_mesh(v, f), backend="tile", device="cpu")
    r.prepare(cams)
    before = tile_kernel.views
    with profiling.trace_to(tmp_path, device="cpu"):
        for cam in cams:
            r.render(cam)
    assert tile_kernel.views == before + len(cams)
    events = json.loads(
        (tmp_path / profiling.TRACE_FILE).read_text())["traceEvents"]
    ranges = {name: [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                     for e in events if e.get("ph") == "X"
                     and e.get("cat") == "user_annotation"
                     and e.get("name") == name]
              for name in ("smt.tile_prep", "smt.render")}
    assert len(ranges["smt.tile_prep"]) == len(ranges["smt.render"]) == 2
    for (a, b), (c, d) in zip(sorted(ranges["smt.tile_prep"]),
                              sorted(ranges["smt.render"])):
        assert c <= a and b <= d
