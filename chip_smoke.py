#!/usr/bin/env python3
"""Chip smoke run of semantic_meshes_torch on one CUDA card (sm_90a).

    python3 chip_smoke.py [--against DIR ...]

Drives the port's main paths through their public entry points, at six
of bench.py's presets, their distorted variants and their indoor
variants (random probabilities from a seed, made on the card), in phases;
each phase prints a line and raises on failure:

1. the card's name and power limit (nvidia-smi);
2. build of both CUDA kernels from csrc/ (one nvcc per source, all
   started together, those of --against too) and their -Xptxas -v
   register / shared-memory reports;
3. every kernel against its plain PyTorch version on the card: raster_tile
   on every view of `default` and `large` and on the hand-binned scenes of
   testing.TILE_SCENES, raster_dense on every view of
   `scannet` (twice, bit-identical) and of `default` forced through the
   dense rasterizer (ids equal, depths bit-equal, overflow 0), at the
   budgets the main path probes, on the hand-binned scenes of
   testing.DENSE_SCENES, and on every view of `texels` (its reordered
   faces, its probed budget); on clipped piece rows (clip_near=True):
   both kernels (raster_dense forced) on tests/test_clipping.py's random
   straddling scene at 1296x968, raster_tile on every view of `large`
   indoor and raster_dense on every view of `scannet` indoor (twice,
   bit-identical);
4. the main paths, each with every launch counter set to 0 just before it
   and read just after:
   - `large` (cube s=16, 3072 triangles, 8 views of 2048x1536, 19
     classes; the tile rasterizer): render -> MeshAggregator (sum, summax,
     mul) -> get -> palette colours -> Ply.save -> reload; overflow 0;
     raster_tile launches == views rasterized; fuse_views_planned equals
     the per-view path; a repeated fusion is bit-identical;
   - `scannet` (cube s=91, 99372 triangles, 8 views of 1296x968, 40
     classes; the dense rasterizer by auto dispatch): the same chain, plus
     prepare and render_many; raster_dense launches == views rendered with
     a nonzero pair budget;
   - `dense` (cube s=204, 499392 triangles, 4 views of 1024x768, 19
     classes): plan_fuse splits (uni-slot prefix), and fuse_views_planned
     in original face order equals the unsplit plan's fusion;
   - texel mode: reorder_faces_for_texels and _texel_resolutions on the
     card equal the CPU's on every face at `texels` and `texels01`; at
     `texels` (cube s=64, 49152 triangles, 4 views of 1024x768, 19
     classes, 2.0 texels per pixel: 809984 texels) and `texels01` (cube
     s=91, 8 views of 1296x968, 40 classes, 0.1: 99372 texels, one per
     triangle) texels -> prepare -> render -> render_many ->
     MeshAggregator sum/summax/mul -> get -> colours, then
     fuse_views_texels under plan_fuse(allow_split=False) == the per-view
     path, twice bit-identical; overflow 0; raster_dense launches == views
     rasterized with pairs, none of raster_tile; every texel id < P; the
     card's texel shader == the CPU's on every view, from the card's
     triangle ids; at `texels01` each id == first_texel_index[face]; a
     texel renderer at `default` (2.0 texels per pixel) through
     raster_tile, one launch a view;
   - lens distortion (bench.py has no distorted preset; the lenses are
     RADIAL_SCANNET, FISHEYE and RADIAL_LARGE below, nothing cut):
     `scannet` + SIMPLE_RADIAL on all 8 views (kernel B): prepare ->
     render -> render_many -> MeshAggregator sum/summax/mul -> get -> PLY,
     plan_fuse(distortions=) with lens_shared + fuse_views_planned twice
     == per-view, bit-identical, == the same batch with
     shared_lens=False; `large` with mixed lenses (fisheye on views 0-3
     on the 9-wide wire, zero lenses on 4-5, SIMPLE_RADIAL on 6-7; kernel
     A): render_many == render on one view of each nonzero lens, the
     zero-lens views == their pinhole renders bit for bit,
     fuse_views(distortions=) == per-view; the `default` texel renderer
     under `large`'s lenses through raster_tile and forced through
     raster_dense (fuse_views_texels(backend="dense")):
     fuse_views_texels == per-view, every id < P; overflow 0 and each
     kernel once per view rasterized everywhere; the undistortion grid
     on the card against the CPU at full size (one view per lens: the
     classic wire bit for bit, the extended wire's differences, and its
     ids after the resample on at most 1e-4 of the pixels);
   - near-plane clipping (bench.py has no indoor preset; ROOM_SIZE and
     INDOOR_RING below move a preset's cameras inside its cube, nothing
     cut): `scannet` indoor (kernel B) and `large` indoor (kernel A) with
     clip_near=True: prepare -> render -> render_many -> MeshAggregator
     sum/summax/mul -> get -> PLY, plan_fuse(clip_near=True) with split_k
     0 and no remap, fuse_views_planned twice == per-view,
     bit-identical, fuse_views_split == fuse_views, overflow 0, every
     pixel covered, the kernel once per view rasterized with pairs;
     `texels01` indoor: the card's clipped texel sizing == the CPU's on
     every face, the same chain in texel mode, fuse_views_texels ==
     per-view, every id < P, the card's ray-form shader == the CPU's bit
     for bit on every view; `scannet` indoor + SIMPLE_RADIAL: render_many
     == render, clipped under the virtual focal;
5. times with CUDA events (medians after warm-up): each kernel's time
   per view both as `ms`, from replays of a CUDA graph of its launches
   (the device's own time), and as `launched_ms`, with Python launching
   the views one by one as the main path does; its plain version; the
   bound of its work from this run's inputs (the (candidate, warp) tests
   its cull left, as the kernel counts them, against the bytes); each
   kernel also on each view's heaviest tile alone and with the share of
   (candidate, warp) tests its cull skipped; raster_tile with every tile
   empty, raster_dense with its work items; the pieces of a dense view at
   `scannet`, the routing cost model's coefficients they give, one
   fuse_views_planned batch per preset as `rasterize_fuse_throughput`,
   and one traced batch per preset (idle share, top device kernels); at
   the texel presets the pieces of a view (setup + dense binning,
   raster_dense, the texel shader, fusion), one fuse_views_texels batch
   as `rasterize_fuse_throughput` and one traced batch; the lens pieces
   (the classic grid once per batch, the extended grid per view,
   _resample_wh launched and in graph replays with its byte bound) and
   one batch (timed in phase 4 where the lenses are extended) and one
   traced batch of each distorted variant, and
   `scannet` + SIMPLE_RADIAL against `scannet` in turns; one batch and
   one traced batch per indoor variant, the clipped `scannet` indoor
   batch against the culled one of the same cameras in turns, and the
   clipper and the clipped setup per view (launched and in graph
   replays) against the culled setup. The kernel line's `launches`
   counts `large` and `scannet`; `launches_by_path` every path's run.

--against DIR (repeatable) names a checkout of an earlier commit, e.g.
    mkdir -p build/parent && git archive <rev> semantic_meshes_torch |
        tar -x -C build/parent
whose package is loaded beside this one; its kernels are built with this
one's and timed in turns with them (DIR, ..., this, this, ..., DIR) on
the same inputs, and the kernel line gains an "against" entry per DIR.

The line before the last is the kernel table as one JSON object; the last
line is {"ok": true, "device": {...}}. Without a CUDA card, or without the
repository beside it, the script exits non-zero and prints no result.
"""

import argparse
import importlib
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import numpy as np
import torch

# (subdivisions, views, width, height, classes) as in bench.py's PRESETS
SCENES = {
    "default": (9, 8, 1024, 768, 19),
    "large": (16, 8, 2048, 1536, 19),
    "dense": (204, 4, 1024, 768, 19),
    "scannet": (91, 8, 1296, 968, 40),
    "texels": (64, 4, 1024, 768, 19),
    "texels01": (91, 8, 1296, 968, 40),
}
# texels_per_pixel of bench.py's texel presets (bench.py:67), and of the
# texel check at `default`
TPP = {"texels": 2.0, "texels01": 0.1, "default": 2.0}
# texel primitives the sizing gives at the texel presets' cameras
TEXEL_P = {"texels": 809984, "texels01": 99372}
IEW = 0.5
SEED = 0
# lens wires of the distorted variants (bench.py has no distorted preset):
# SIMPLE_RADIAL (COLMAP's default model) on all of `scannet`'s views, one
# physical camera; at f = 0.9 * 968 its corner radius is 0.93 and its fold
# 1.83, so the lens inverts over the whole frame. `large` mixes the
# 9-wide OPENCV_FISHEYE wire of tests/test_lens_models.py, zero lenses and
# SIMPLE_RADIAL k1 = 0.1 (LARGE_LENSES).
RADIAL_SCANNET = (-0.1, 0.0, 0.0, 0.0)
RADIAL_LARGE = (0.1, 0.0, 0.0, 0.0)
FISHEYE = (0.03, -0.011, 0.002, -0.0005, 0.0, 0.0, 0.0, 0.0, 1.0)
LARGE_LENSES = [FISHEYE] * 4 + [None] * 2 + [RADIAL_LARGE] * 2
# indoor variants (bench.py has none): a preset's mesh, views and classes
# with the cameras moved inside, rendered with clip_near=True, nothing cut:
# the cube at ROOM_SIZE (a 4 m room; `scannet`'s s=91 gives 4.4 cm
# triangles), the views on a ring of radius 0.8 m at eye height 1.5 m above
# the floor (0.625 x the radius below the room's centre), looking at
# (0, -0.9, 0), at the preset's focal (0.9 x height)
ROOM_SIZE = 4.0
INDOOR_RING = dict(radius=0.8, elevation=-0.625, target=(0.0, -0.9, 0.0))
# H100 SXM peaks (NVIDIA data sheet): non-tensor fp32 and HBM3 bandwidth.
# The 67 TFLOP/s counts an FMA as two operations; the kernels round every
# multiply and add on its own (-fmad=false), one per lane and clock, so
# their operations run at half that rate.
PEAK_FP32_FLOPS = 67e12
PEAK_FP32_OPS = PEAK_FP32_FLOPS / 2
PEAK_BYTES_S = 3.35e12
# fp32 operations per (candidate, pixel): four affine forms a*px + b*py +
# c, a multiply and two adds each once a*px is taken out of the pixel loop
# (a thread's pixels share a column)
FLOPS_PER_TEST = 12
HERE = os.path.dirname(os.path.abspath(__file__))


_START = time.monotonic()


def phase(msg):
    """Print one phase line, with the seconds since the script started."""
    print(f"{msg} [{time.monotonic() - _START:.1f} s]", flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


def scene(name):
    from semantic_meshes_torch import testing

    sub, views, width, height, classes = SCENES[name]
    vertices, faces = testing.make_cube(subdivisions=sub)
    cams = testing.make_ring_cameras(num_views=views, width=width,
                                     height=height)
    return vertices, faces, cams


def device_probs(views, height, width, classes, device):
    """(N, H, W, C) softmax probabilities, made on the card from SEED."""
    gen = torch.Generator(device=device).manual_seed(SEED)
    logits = torch.randn((views, height, width, classes), generator=gen,
                         device=device)
    return torch.softmax(logits, dim=-1)


def face_vertices(vertices, faces, device):
    """(T, 3, 3) face-vertex positions on the card, as the renderer keeps
    them."""
    return torch.as_tensor(vertices[faces], dtype=torch.float32,
                           device=device)


def cam_kw(cam):
    return dict(height=cam.resolution[1], width=cam.resolution[0])


def cam_args(cam):
    return (cam.rotation, cam.translation, cam.focal_lengths,
            cam.principal_point)


def view_inputs(fv, cam, device, clip_near=False):
    """Setup + binning of one view for the tile kernel from device face
    vertices `fv`, as the renderer runs it: (resolve_tiles arguments,
    overflow). clip_near: of the 2T clipped piece rows."""
    from semantic_meshes_torch.rasterize import tile_kernel

    return tile_kernel.resolve_inputs(None, None, *cam_args(cam),
                                      face_vertices=fv, clip_near=clip_near,
                                      device=device, **cam_kw(cam))


def dense_budget(vertices, faces, cams, device, backend=None,
                 clip_near=False):
    """The dense budget tuple the renderer probes for this camera set."""
    import semantic_meshes_torch as smt
    from types import SimpleNamespace

    r = smt.render.TrianglesRenderer(
        SimpleNamespace(vertices=vertices, faces=faces), backend=backend,
        clip_near=clip_near, device=device)
    r.prepare(cams)
    return r.dense_cap_policy._cap[(cams[0].resolution[1],
                                    cams[0].resolution[0])]


def dense_view_inputs(fv, cam, cap, device, clip_near=False):
    """Everything of one dense view before the kernel, at budget `cap`:
    (resolve_dense arguments, micro key, overflow)."""
    from semantic_meshes_torch import rasterize as rast

    return rast.dense.resolve_inputs(None, None, *cam_args(cam),
                                     face_vertices=fv, clip_near=clip_near,
                                     device=device, **cam_kw(cam),
                                     **rast.dense_kwargs(cap))


def load_against(path, index):
    """The kernel wrappers of the package semantic_meshes_torch in the
    checkout at `path`, imported beside this one as module
    `_against<index>` (its kernels build into its own build/)."""
    pkg = os.path.join(os.path.abspath(path), "semantic_meshes_torch")
    name = f"_against{index}"
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    if spec is None:
        raise FileNotFoundError(f"--against {path}: no {pkg}/__init__.py")
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return SimpleNamespace(
        build=importlib.import_module(f"{name}._build"),
        tile=importlib.import_module(
            f"{name}.rasterize.tile_kernel").resolve_tiles_cuda,
        dense=importlib.import_module(
            f"{name}.rasterize.dense_kernel").resolve_dense_cuda)


def timed(fn):
    """(fn()'s result, its device time in ms from CUDA events)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def cuda_time_ms(fn, reps, warmup=2):
    """Median over `reps` of fn()'s device time in ms (CUDA events)."""
    for _ in range(warmup):
        fn()
    return statistics.median(timed(fn)[1] for _ in range(reps))


_capture_stream = []


def graph_time_ms(fn, reps):
    """Median over `reps` of the device time in ms of fn()'s launches:
    captured once in a CUDA graph and replayed, so the host's per-launch
    work does not enter the time. The warm-up runs on the stream of the
    capture, so the graph finds raster_dense's scratch for that stream
    already made."""
    if not _capture_stream:
        _capture_stream.append(torch.cuda.Stream())
    stream = _capture_stream[0]
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        fn()
    ms = cuda_time_ms(graph.replay, reps)
    del graph
    return ms


def assert_same_image(name, k, zk, ik, zp, ip):
    """Kernel vs plain version: ids equal, depths bit-equal. Returns the
    largest |depth difference| over finite pixels (0 when bit-equal)."""
    if not torch.equal(ik, ip):
        bad = int((ik != ip).sum())
        raise AssertionError(f"{name} view {k}: {bad} ids differ")
    fin = torch.isfinite(zp)
    if not torch.equal(fin, torch.isfinite(zk)):
        raise AssertionError(f"{name} view {k}: empty masks differ")
    if not torch.equal(zk.view(torch.int32), zp.view(torch.int32)):
        err = float((zk[fin] - zp[fin]).abs().max())
        raise AssertionError(
            f"{name} view {k}: depths not bit-equal (max |err| {err})")
    return float((zk[fin] - zp[fin]).abs().max()) if fin.any() else 0.0


def tile_vs_plain(device):
    """Phase 3, raster_tile at `default` and `large`, and on the hand-binned
    scenes of testing.TILE_SCENES (a tile at the 256 cap, slivers along
    the warps' rectangles, exact ties inside one rectangle and across two,
    ragged edges, a row band, an empty view)."""
    from semantic_meshes_torch import testing
    from semantic_meshes_torch.rasterize import tile_kernel

    max_err = 0.0
    for name in ("default", "large"):
        vertices, faces, cams = scene(name)
        fv = face_vertices(vertices, faces, device)
        for k, cam in enumerate(cams):
            args, _ = view_inputs(fv, cam, device)
            zk, ik = tile_kernel.resolve_tiles_cuda(*args)
            zp, ip = tile_kernel.resolve_tiles_plain(*args)
            torch.cuda.synchronize()
            max_err = max(max_err, assert_same_image(name, k, zk, ik, zp,
                                                     ip))
        phase(f"phase 3: raster_tile == plain at {name}: {len(cams)} views, "
              "ids equal, depths bit-equal")
    for name in testing.TILE_SCENES:
        args = testing.tile_resolve_scene(name, device)
        zk, ik = tile_kernel.resolve_tiles_cuda(*args)
        zp, ip = tile_kernel.resolve_tiles_plain(*args)
        torch.cuda.synchronize()
        max_err = max(max_err, assert_same_image(name, 0, zk, ik, zp, ip))
    phase(f"phase 3: raster_tile == plain on the hand-binned scenes "
          f"{list(testing.TILE_SCENES)}: ids equal, depths bit-equal")
    return max_err


def dense_inputs(name, device, backend=None):
    """(budget, [(resolve_dense arguments, overflow)] per view) of scene
    `name` at the budget the renderer probes."""
    vertices, faces, cams = scene(name)
    fv = face_vertices(vertices, faces, device)
    cap = dense_budget(vertices, faces, cams, device, backend)
    views = []
    for cam in cams:
        args, _, overflow = dense_view_inputs(fv, cam, cap, device)
        if args is None:
            raise AssertionError(f"{name}: zero pair budget {cap}")
        views.append((args, overflow))
    return cap, views


def dense_vs_plain(device):
    """Phase 3, raster_dense at `scannet` (auto dispatch) and at `default`
    forced dense, at the budgets the renderer probes, and on the
    hand-binned scenes of testing.DENSE_SCENES (work-item boundaries, ties
    across items and between a global and an own candidate, long global
    buckets, empty tiles, slivers and off-screen vertices). At `scannet`
    the kernel runs twice per view and the two runs must give the same
    bits."""
    from semantic_meshes_torch import testing
    from semantic_meshes_torch.rasterize import dense_kernel

    max_err = 0.0
    for name, backend in (("scannet", None), ("default", "dense")):
        cap, views = dense_inputs(name, device, backend)
        shapes = []
        for k, (args, overflow) in enumerate(views):
            zk, ik = dense_kernel.resolve_dense_cuda(*args)
            zp, ip = dense_kernel.resolve_dense_plain(*args)
            if name == "scannet":
                z2, i2 = dense_kernel.resolve_dense_cuda(*args)
                if not (torch.equal(i2, ik) and torch.equal(
                        z2.view(torch.int32), zk.view(torch.int32))):
                    raise AssertionError(f"scannet view {k}: two runs of "
                                         "raster_dense differ")
            torch.cuda.synchronize()
            if int(overflow) != 0:
                raise AssertionError(f"{name} view {k}: overflow "
                                     f"{int(overflow)}")
            max_err = max(max_err, assert_same_image(name, k, zk, ik, zp,
                                                     ip))
            starts = args[2].long()
            B = starts.numel() - 2
            shapes.append((int(starts[B + 1] - starts[B]),
                           int((starts[1:B + 1] - starts[:B]).max())))
        twice = ", two runs per view bit-identical" if name == "scannet" \
            else ""
        phase(f"phase 3: raster_dense == plain at {name} (budget {cap}): "
              f"{len(views)} views, ids equal, depths bit-equal, overflow 0"
              f"{twice}; (global bucket, heaviest own range) per view "
              f"{shapes}")
    for name in testing.DENSE_SCENES:
        args = testing.dense_resolve_scene(name, device)
        zk, ik = dense_kernel.resolve_dense_cuda(*args)
        zp, ip = dense_kernel.resolve_dense_plain(*args)
        torch.cuda.synchronize()
        max_err = max(max_err, assert_same_image(name, 0, zk, ik, zp, ip))
    phase(f"phase 3: raster_dense == plain on the hand-binned scenes "
          f"{list(testing.DENSE_SCENES)}: ids equal, depths bit-equal")
    return max_err


def reset_launches():
    from semantic_meshes_torch.rasterize import dense_kernel, tile_kernel

    tile_kernel.launches = 0
    dense_kernel.launches = 0


def read_launches():
    from semantic_meshes_torch.rasterize import dense_kernel, tile_kernel

    return {"raster_tile": tile_kernel.launches,
            "raster_dense": dense_kernel.launches}


def fuse_and_save(name, mesh, rendered, probs, classes, workdir, device,
                  texels=None):
    """MeshAggregator sum/summax/mul over rendered (W, H) id images ->
    get -> palette colours -> Ply.save -> reload. Returns the sum state.
    texels: the number of texel primitives of a texel renderer's images;
    their colours are per texel, so no PLY is written."""
    import semantic_meshes_torch as smt

    T = len(mesh.faces) if texels is None else texels
    palette = smt.utils.class_palette(classes)
    fused = None
    for agg_name in ("sum", "summax", "mul"):
        agg = smt.fusion.MeshAggregator(T, classes, agg_name, IEW,
                                        device=device)
        for k, ids in enumerate(rendered):
            agg.add(ids, probs[k].transpose(0, 1))
        out = agg.get()
        if tuple(out.shape) != (T, classes) or not torch.isfinite(out).all():
            raise AssertionError(f"{name} {agg_name}: bad fused output")
        seen = agg.state.abs().sum(-1) > 0
        sums = out[seen].sum(-1)
        if not seen.any() or not torch.allclose(
                sums, torch.ones_like(sums), atol=1e-5):
            raise AssertionError(f"{name} {agg_name}: rows not normalised")
        if agg_name == "sum":
            fused = agg.state.clone()
        colors = palette[out.argmax(-1).cpu().numpy()]
        colors[~seen.cpu().numpy()] = 0
        if texels is not None:
            continue
        out_path = os.path.join(workdir, f"{name}_{agg_name}.ply")
        mesh.save(out_path, colors)
        back = smt.io.ply.read_ply(out_path)["face"].data
        got = np.stack([back["red"], back["green"], back["blue"]], -1)
        if not np.array_equal(got, colors) or not np.array_equal(
                smt.data.Ply(out_path).faces, mesh.faces):
            raise AssertionError(f"{name} {agg_name}: PLY round trip differs")
    return fused


def planned_twice(name, plan, vertices, cams, probs, classes, device,
                  overflow=0, **kw):
    """Two fuse_views_planned batches (keywords `kw` passed on); both
    bit-identical, each with `overflow` dropped (0, or the big rows past
    the global bucket's cap: global_drops)."""
    import semantic_meshes_torch as smt

    width, height = cams[0].resolution
    rot, trans, fl, pp = smt.data.stack_cameras(cams)
    runs = []
    for _ in range(2):
        acc, ov = smt.distributed.fuse_views_planned(
            plan, vertices, rot, trans, fl, pp, probs, IEW,
            num_primitives=len(plan.faces), aggregator="sum", height=height,
            width=width, device=device, **kw)
        if int(ov) != overflow:
            raise AssertionError(f"{name}: fuse_views_planned overflow "
                                 f"{int(ov)}, expected {overflow}")
        runs.append(acc)
    if not torch.equal(runs[0], runs[1]):
        raise AssertionError(f"{name}: repeated fusion is not bit-identical")
    return runs[0]


def main_path(name, device, workdir):
    """Phase 4 at `large` (tile rasterizer) or `scannet` (dense
    rasterizer), through the public API, launch counters read around it.
    Returns what phase 5 reuses."""
    import semantic_meshes_torch as smt

    sub, n_views, width, height, classes = SCENES[name]
    vertices, faces = smt.testing.make_cube(subdivisions=sub)
    path = os.path.join(workdir, f"{name}.ply")
    smt.io.ply.write_mesh(path, vertices, faces)
    mesh = smt.data.Ply(path)
    cams = smt.testing.make_ring_cameras(num_views=n_views, width=width,
                                         height=height)
    probs = device_probs(n_views, height, width, classes, device)
    rot, trans, fl, pp = smt.data.stack_cameras(cams)
    dense = smt.rasterize.uses_dense(None, len(faces))

    reset_launches()
    rasterized = []  # the dense budget of every view rasterized
    renderer = smt.render.triangles(mesh, device=device)
    if dense:
        renderer.prepare(cams)
    rendered = [renderer.render(cam)[0] for cam in cams]
    cap = renderer.dense_cap_policy._cap.get((height, width))
    rasterized += [cap] * n_views
    for ids in rendered:
        if ids.dtype != torch.uint32 or tuple(ids.shape) != (width, height):
            raise AssertionError(f"render() gave {ids.dtype} {ids.shape}")
    if dense:
        many, _ = renderer.render_many(cams)
        rasterized += [cap] * n_views
        if not torch.equal(many, torch.stack(rendered)):
            raise AssertionError(f"{name}: render_many != render")
    overflow = renderer.overflow_total()
    if overflow != 0:
        raise AssertionError(f"overflow {overflow} at {name}")
    fused_sum = fuse_and_save(name, mesh, rendered, probs, classes, workdir,
                              device)
    plan = smt.distributed.plan_fuse(vertices, faces, rot, trans, fl, pp,
                                     height=height, width=width,
                                     device=device)
    acc = planned_twice(name, plan, vertices, cams, probs, classes, device)
    rasterized += [plan.dense_e_cap] * (2 * n_views)
    torch.cuda.synchronize()
    launches = read_launches()

    kernel = "raster_dense" if dense else "raster_tile"
    other = "raster_tile" if dense else "raster_dense"
    expect = sum(1 for c in rasterized
                 if not dense or (c is not None and c[0] > 0))
    if launches[kernel] != expect or launches[other] != 0:
        raise AssertionError(f"{name}: launches {launches} for {expect} "
                             f"views rasterized with pairs")
    if not torch.allclose(acc, fused_sum, rtol=1e-6, atol=0.0):
        err = float((acc - fused_sum).abs().max())
        raise AssertionError(f"{name}: planned != per-view (max |err| {err})")
    extra = (f"dense budget {cap} (render), plan {plan.dense_e_cap} split_k "
             f"{plan.split_k}; prepare + render + render_many, "
             if dense else "")
    phase(
        f"phase 4: main path at {name} ok: {n_views} views {width}x{height}, "
        f"{len(faces)} triangles, {classes} classes, {extra}sum/summax/mul "
        f"fused, PLY saved and reloaded, overflow 0, launches {launches} == "
        f"{expect} views rasterized with pairs, planned == per-view "
        f"(bit-equal: {torch.equal(acc, fused_sum)}), repeated fusion "
        "bit-identical"
    )
    return dict(vertices=vertices, faces=faces, cams=cams, probs=probs,
                plan=plan, rot=rot, trans=trans, fl=fl, pp=pp, cap=cap,
                launches=launches[kernel])


def dense_preset(device):
    """Phase 4 at `dense`: the split plan against the unsplit one."""
    import semantic_meshes_torch as smt

    sub, n_views, width, height, classes = SCENES["dense"]
    vertices, faces, cams = scene("dense")
    rot, trans, fl, pp = smt.data.stack_cameras(cams)
    probs = device_probs(n_views, height, width, classes, device)
    reset_launches()
    plans = {}
    accs = {}
    for split in (True, False):
        plans[split] = smt.distributed.plan_fuse(
            vertices, faces, rot, trans, fl, pp, height=height, width=width,
            allow_split=split, device=device)
        accs[split] = planned_twice("dense", plans[split], vertices, cams,
                                    probs, classes, device)
    torch.cuda.synchronize()
    launches = read_launches()
    if plans[True].split_k <= 0 or plans[False].split_k != 0:
        raise AssertionError(f"dense: split_k {plans[True].split_k} / "
                             f"{plans[False].split_k}")
    if not torch.allclose(accs[True], accs[False], rtol=1e-6, atol=0.0):
        err = float((accs[True] - accs[False]).abs().max())
        raise AssertionError(f"dense: split != unsplit (max |err| {err})")
    if launches["raster_tile"] != 0:
        raise AssertionError(f"dense: launches {launches}")
    phase(
        f"phase 4: dense preset ok: {n_views} views {width}x{height}, "
        f"{len(faces)} triangles; split plan {plans[True].dense_e_cap} "
        f"(split_k {plans[True].split_k} of {len(faces)}), unsplit plan "
        f"{plans[False].dense_e_cap}; split == unsplit in original face "
        f"order (bit-equal: {torch.equal(accs[True], accs[False])}), "
        f"overflow 0, repeated fusion bit-identical, launches {launches} "
        "(a zero pair budget runs no kernel)"
    )
    return dict(vertices=vertices, faces=faces, probs=probs, plan=plans[True],
                rot=rot, trans=trans, fl=fl, pp=pp, launches=launches)


def texel_renderer(name, device):
    """A TexelsRenderer of scene `name` at its texels_per_pixel, and the
    scene's cameras."""
    import semantic_meshes_torch as smt

    vertices, faces, cams = scene(name)
    mesh = SimpleNamespace(vertices=vertices, faces=faces)
    return smt.render.texels(mesh, cams, TPP[name], device=device), cams


def texel_dense_vs_plain(device):
    """Phase 3, raster_dense on every view of `texels` (its reordered
    faces, at the budget its renderer probes)."""
    from semantic_meshes_torch.rasterize import dense_kernel

    renderer, cams = texel_renderer("texels", device)
    renderer.prepare(cams)
    cap = renderer.dense_cap_policy._cap[(cams[0].height, cams[0].width)]
    max_err = 0.0
    for k, cam in enumerate(cams):
        args, _, overflow = dense_view_inputs(renderer.face_vertices, cam,
                                              cap, device)
        if args is None:
            raise AssertionError(f"texels: zero pair budget {cap}")
        zk, ik = dense_kernel.resolve_dense_cuda(*args)
        zp, ip = dense_kernel.resolve_dense_plain(*args)
        torch.cuda.synchronize()
        if int(overflow) != 0:
            raise AssertionError(f"texels view {k}: overflow {int(overflow)}")
        max_err = max(max_err, assert_same_image("texels", k, zk, ik, zp,
                                                 ip))
    phase(f"phase 3: raster_dense == plain at texels (reordered faces, "
          f"budget {cap}): {len(cams)} views, ids equal, depths bit-equal, "
          "overflow 0")
    return max_err


def texel_setup_check(device):
    """Phase 4: reorder_faces_for_texels and _texel_resolutions on the card
    against the same functions on the CPU at the texel presets, on every
    face. The card's reorder feeds every texel id: a difference fails the
    run."""
    from semantic_meshes_torch import geometry, render

    for name in ("texels", "texels01"):
        vertices, faces, cams = scene(name)
        out = []
        for d in (device, torch.device("cpu")):
            v = torch.as_tensor(vertices, device=d)
            f = torch.as_tensor(faces.astype(np.int64), device=d)
            out.append((geometry.reorder_faces_for_texels(v, f).cpu(),
                        render._texel_resolutions(v, f, cams,
                                                  TPP[name]).cpu()))
        (card_f, card_r), (cpu_f, cpu_r) = out
        moved = int((card_f != cpu_f).any(1).sum())
        resized = int((card_r != cpu_r).sum())
        if moved or resized:
            raise AssertionError(
                f"{name}: the card's texel setup differs from the CPU's: "
                f"{moved} faces reordered otherwise, {resized} resolutions")
        phase(f"phase 4: texel setup at {name}: reorder_faces_for_texels and "
              f"_texel_resolutions on the card equal the CPU's on all "
              f"{len(faces)} faces (0 differ)")


def texel_main_path(name, device, workdir):
    """Phase 4 at a texel preset, through the public API (texels ->
    prepare -> render -> render_many -> MeshAggregator sum/summax/mul ->
    get -> colours; fuse_views_texels under a texel plan, twice), launch
    counters read around it. Returns what phase 5 reuses."""
    import semantic_meshes_torch as smt

    sub, n_views, width, height, classes = SCENES[name]
    vertices, faces = smt.testing.make_cube(subdivisions=sub)
    path = os.path.join(workdir, f"{name}.ply")
    smt.io.ply.write_mesh(path, vertices, faces)
    mesh = smt.data.Ply(path)
    cams = smt.testing.make_ring_cameras(num_views=n_views, width=width,
                                         height=height)
    probs = device_probs(n_views, height, width, classes, device)
    rot, trans, fl, pp = smt.data.stack_cameras(cams)

    reset_launches()
    renderer = smt.render.texels(mesh, cams, TPP[name], device=device)
    P = renderer.getPrimitivesNum()
    renderer.prepare(cams)
    cap = renderer.dense_cap_policy._cap.get((height, width))
    rendered = [renderer.render(cam)[0] for cam in cams]
    many, _ = renderer.render_many(cams)
    rasterized = [cap] * (2 * n_views)
    for ids in rendered:
        if ids.dtype != torch.uint32 or tuple(ids.shape) != (width, height):
            raise AssertionError(f"render() gave {ids.dtype} {ids.shape}")
    if not torch.equal(many, torch.stack(rendered)):
        raise AssertionError(f"{name}: render_many != render")
    overflow = renderer.overflow_total()
    if overflow != 0:
        raise AssertionError(f"overflow {overflow} at {name}")
    fused_sum = fuse_and_save(name, mesh, rendered, probs, classes, workdir,
                              device, texels=P)
    plan = smt.distributed.plan_fuse(
        renderer.vertices, renderer.faces, rot, trans, fl, pp, height=height,
        width=width, allow_split=False, device=device)

    def batch():
        return smt.distributed.fuse_views_texels(
            renderer.vertices, plan.faces, renderer.resolutions,
            renderer.first_texel_index, rot, trans, fl, pp, probs, IEW,
            num_primitives=P, aggregator="sum", height=height, width=width,
            dense_e_cap=plan.dense_e_cap, device=device)

    runs = []
    for _ in range(2):
        acc, ov = batch()
        if int(ov) != 0:
            raise AssertionError(f"{name}: fuse_views_texels overflow "
                                 f"{int(ov)}")
        runs.append(acc)
    rasterized += [plan.dense_e_cap] * (2 * n_views)
    torch.cuda.synchronize()
    launches = read_launches()

    if not torch.equal(runs[0], runs[1]):
        raise AssertionError(f"{name}: repeated fusion is not bit-identical")
    expect = sum(1 for c in rasterized if c is not None and c[0] > 0)
    if launches["raster_dense"] != expect or launches["raster_tile"] != 0:
        raise AssertionError(f"{name}: launches {launches} for {expect} "
                             "views rasterized with pairs")
    if not torch.allclose(runs[0], fused_sum, rtol=1e-6, atol=0.0):
        err = float((runs[0] - fused_sum).abs().max())
        raise AssertionError(f"{name}: planned != per-view (max |err| {err})")
    if P != TEXEL_P[name]:
        raise AssertionError(f"{name}: {P} texels, expected {TEXEL_P[name]}")
    ids = many.view(torch.int32)
    covered = ids >= 0
    if int(ids.max()) >= P or not covered.any():
        raise AssertionError(f"{name}: texel ids out of [0, {P})")
    r = renderer.resolutions
    if name == "texels01" and not bool((r == 1).all()):
        raise AssertionError(f"texels01: resolutions {int(r.min())}-"
                             f"{int(r.max())}, expected 1 everywhere")
    tables = (renderer.vertices, renderer.faces, renderer.resolutions,
              renderer.first_texel_index)
    cpu_tables = [t.cpu() for t in tables]
    for k, cam in enumerate(cams):
        tri = smt.rasterize.rasterize(
            renderer.vertices, renderer.faces, *cam_args(cam),
            face_vertices=renderer.face_vertices, height=height, width=width,
            dense_e_cap=cap, device=device)[0]
        # the shader on the card against the same shader on the CPU, from
        # the card's triangle ids and the renderer's tables
        card = smt.render._texel_prim_image(*tables[:2], *cam_args(cam), tri,
                                            *tables[2:], P)
        cpu = smt.render._texel_prim_image(*cpu_tables[:2], *cam_args(cam),
                                           tri.cpu(), *cpu_tables[2:], P)
        if not torch.equal(card.cpu(), cpu):
            raise AssertionError(f"{name} view {k}: the card's texel shader "
                                 f"differs from the CPU's on "
                                 f"{int((card.cpu() != cpu).sum())} pixels")
        if name == "texels01":
            # r = 1 everywhere: a pixel's texel is its triangle's first
            want = torch.where(tri >= 0, renderer.first_texel_index[
                tri.clamp(min=0).long()], -1)
            if not torch.equal(ids[k], want.t()):
                raise AssertionError(f"texels01 view {k}: texel id != "
                                     "first_texel_index[face]")
    phase(
        f"phase 4: texel path at {name} ok: {n_views} views {width}x"
        f"{height}, {len(faces)} triangles, tpp {TPP[name]}, P {P} texels "
        f"(resolution {int(r.min())}-{int(r.max())}, "
        f"{int((r == 0).sum())} triangles without texels), {classes} "
        f"classes; dense budget {cap} (render), plan {plan.dense_e_cap} "
        f"split_k {plan.split_k}; prepare + render + render_many, "
        f"sum/summax/mul fused, colours, overflow 0, launches {launches} == "
        f"{expect} views rasterized with pairs, every texel id < P, the "
        f"card's shader == the CPU's on every view"
        f"{', each == first_texel_index[face]' if name == 'texels01' else ''}"
        f", fuse_views_texels == per-view (bit-equal: "
        f"{torch.equal(runs[0], fused_sum)}), repeated fusion bit-identical"
    )
    return dict(renderer=renderer, cams=cams, probs=probs, plan=plan,
                cap=cap, batch=batch, launches=launches, faces=faces,
                primitives=P)


def texel_tile_check(device):
    """Phase 4: a texel renderer at `default` (972 faces) rasterizes through
    raster_tile: one launch per view, none of raster_dense, ids within P,
    overflow 0."""
    reset_launches()
    renderer, cams = texel_renderer("default", device)
    P = renderer.getPrimitivesNum()
    ids = torch.stack([renderer.render(cam)[0] for cam in cams]).view(
        torch.int32)
    overflow = renderer.overflow_total()
    torch.cuda.synchronize()
    launches = read_launches()
    if launches != {"raster_tile": len(cams), "raster_dense": 0}:
        raise AssertionError(f"default texels: launches {launches}")
    if overflow != 0 or int(ids.max()) >= P or not (ids >= 0).any():
        raise AssertionError(f"default texels: overflow {overflow}, ids up "
                             f"to {int(ids.max())} of {P}")
    phase(f"phase 4: texel check at default ok: {len(cams)} views through "
          f"raster_tile, launches {launches}, P {P}, ids within P, "
          "overflow 0")
    return launches


def with_lenses(cams, lenses):
    """The cameras `cams` with lens wire lenses[k] (None: none) on view k."""
    import semantic_meshes_torch as smt

    return [smt.data.Camera(c.rotation, c.translation, c.resolution,
                            c.focal_lengths, c.principal_point,
                            distortion=lens)
            for c, lens in zip(cams, lenses)]


def expect_launches(name, launches, kernel, expect):
    other = "raster_tile" if kernel == "raster_dense" else "raster_dense"
    if launches[kernel] != expect or launches[other] != 0:
        raise AssertionError(f"{name}: launches {launches}, expected "
                             f"{expect} of {kernel} and none of {other}")


def per_view_sum(P, classes, rendered, probs, device):
    """The per-view path's sum state: MeshAggregator.add of each (W, H)
    id image."""
    import semantic_meshes_torch as smt

    agg = smt.fusion.MeshAggregator(P, classes, "sum", IEW, device=device)
    for k, ids in enumerate(rendered):
        agg.add(ids, probs[k].transpose(0, 1))
    return agg.state


def same_state(name, batched, per_view):
    """batched == per-view at rtol 1e-6; returns whether bit-equal."""
    if not torch.allclose(batched, per_view, rtol=1e-6, atol=0.0):
        err = float((batched - per_view).abs().max())
        raise AssertionError(f"{name}: batched != per-view (max |err| "
                             f"{err})")
    return torch.equal(batched, per_view)


def distorted_scannet(device, workdir):
    """Phase 4 at `scannet` + SIMPLE_RADIAL (one physical camera on all 8
    views; kernel B by auto dispatch): prepare -> render -> render_many ->
    MeshAggregator sum/summax/mul -> get -> PLY; plan_fuse(distortions=)
    (lens_shared) + fuse_views_planned twice, bit-identical, == per-view;
    the hoisted grid == shared_lens=False bit for bit; overflow 0;
    raster_dense once per view rendered."""
    import semantic_meshes_torch as smt

    sub, n_views, width, height, classes = SCENES["scannet"]
    vertices, faces = smt.testing.make_cube(subdivisions=sub)
    path = os.path.join(workdir, "scannet_radial.ply")
    smt.io.ply.write_mesh(path, vertices, faces)
    mesh = smt.data.Ply(path)
    cams = with_lenses(smt.testing.make_ring_cameras(
        num_views=n_views, width=width, height=height),
        [RADIAL_SCANNET] * n_views)
    probs = device_probs(n_views, height, width, classes, device)
    rot, trans, fl, pp = smt.data.stack_cameras(cams)
    dists = smt.data.stack_distortions(cams)

    reset_launches()
    renderer = smt.render.triangles(mesh, device=device)
    renderer.prepare(cams)
    cap = renderer.dense_cap_policy._cap[(height, width)]
    rendered = [renderer.render(cam)[0] for cam in cams]
    many, _ = renderer.render_many(cams)
    if not torch.equal(many, torch.stack(rendered)):
        raise AssertionError("scannet radial: render_many != render")
    if renderer.overflow_total() != 0:
        raise AssertionError("scannet radial: render overflow")
    fused_sum = fuse_and_save("scannet_radial", mesh, rendered, probs,
                              classes, workdir, device)
    plan = smt.distributed.plan_fuse(vertices, faces, rot, trans, fl, pp,
                                     height=height, width=width,
                                     distortions=dists, device=device)
    if not plan.lens_shared:
        raise AssertionError("scannet radial: plan.lens_shared is False")
    acc = planned_twice("scannet radial", plan, vertices, cams, probs,
                        classes, device, distortions=dists)
    unhoisted, ov = smt.distributed.fuse_views_planned(
        plan, vertices, rot, trans, fl, pp, probs, IEW,
        num_primitives=len(faces), aggregator="sum", height=height,
        width=width, distortions=dists, shared_lens=False, device=device)
    torch.cuda.synchronize()
    launches = read_launches()
    if int(ov) != 0 or not torch.equal(unhoisted, acc):
        raise AssertionError("scannet radial: hoisted grid != per-view "
                             f"grids (overflow {int(ov)})")
    caps = [cap] * (2 * n_views) + [plan.dense_e_cap] * (3 * n_views)
    expect_launches("scannet radial", launches, "raster_dense",
                    sum(1 for c in caps if c[0] > 0))
    bit = same_state("scannet radial", acc, fused_sum)
    phase(
        f"phase 4: scannet + SIMPLE_RADIAL k1 {RADIAL_SCANNET[0]} ok: "
        f"{n_views} views {width}x{height}, {len(faces)} triangles, dense "
        f"budget {cap} (render), plan {plan.dense_e_cap} lens_shared "
        f"{plan.lens_shared}; prepare + render + render_many, sum/summax/mul "
        f"fused, PLY saved and reloaded, overflow 0, launches {launches}, "
        f"planned == per-view (bit-equal: {bit}), repeated fusion "
        "bit-identical, hoisted grid == shared_lens=False bit for bit"
    )
    def batch():
        return smt.distributed.fuse_views_planned(
            plan, vertices, rot, trans, fl, pp, probs, IEW,
            num_primitives=len(faces), aggregator="sum", height=height,
            width=width, distortions=dists, device=device)

    # the same cameras and probabilities without the lens, for phase 5's
    # comparison in turns
    pinhole_plan = smt.distributed.plan_fuse(vertices, faces, rot, trans, fl,
                                             pp, height=height, width=width,
                                             device=device)

    def pinhole_batch():
        return smt.distributed.fuse_views_planned(
            pinhole_plan, vertices, rot, trans, fl, pp, probs, IEW,
            num_primitives=len(faces), aggregator="sum", height=height,
            width=width, device=device)

    return dict(faces=faces, cams=cams, plan=plan, batch=batch,
                pinhole_batch=pinhole_batch, entry="fuse_views_planned",
                launches=launches)


def distorted_large(device):
    """Phase 4 at `large` with mixed lenses (LARGE_LENSES; the tile
    rasterizer): render_many == render on one view of each nonzero lens
    (0: fisheye, 6: SIMPLE_RADIAL), the zero-lens views 4-5 of the
    distorted batch == their pinhole renders bit for bit, fuse_views
    (distortions=, no hoist) == the per-view path over render_many's
    views, overflow 0, raster_tile once per view rasterized. Every view
    of the batch, padded to the 9-wide wire, runs the extended Newton
    (~0.5-0.8 s of launches a view), so the fused batch is timed here
    once and phase 5 reuses that time."""
    import semantic_meshes_torch as smt

    sub, n_views, width, height, classes = SCENES["large"]
    vertices, faces, pinholes = scene("large")
    cams = with_lenses(pinholes, LARGE_LENSES)
    probs = device_probs(n_views, height, width, classes, device)
    rot, trans, fl, pp = smt.data.stack_cameras(cams)
    dists = smt.data.stack_distortions(cams)
    if dists.shape != (n_views, 9) or smt.distributed.lens_shared(
            fl, pp, dists):
        raise AssertionError(f"large lenses: wire {dists.shape}")

    def batch():
        return smt.distributed.fuse_views(
            vertices, faces, rot, trans, fl, pp, probs, IEW, None, dists,
            num_primitives=len(faces), aggregator="sum", height=height,
            width=width, device=device)

    reset_launches()
    renderer = smt.render.triangles(
        SimpleNamespace(vertices=vertices, faces=faces), device=device)
    single = {k: renderer.render(cams[k])[0] for k in (0, 6)}
    single.update({k: renderer.render(pinholes[k])[0] for k in (4, 5)})
    many, _ = renderer.render_many(cams)
    (acc, ov), batch_ms = timed(batch)
    launches = read_launches()
    for k, ids in single.items():
        if not torch.equal(many[k], ids):
            raise AssertionError(
                f"large lenses: view {k} of render_many != its "
                + ("pinhole render" if k in (4, 5) else "render"))
    if renderer.overflow_total() != 0 or int(ov) != 0:
        raise AssertionError(f"large lenses: overflow {int(ov)}")
    # the four single renders, render_many, the batch
    expect_launches("large lenses", launches, "raster_tile",
                    len(single) + 2 * n_views)
    bit = same_state("large lenses", acc,
                     per_view_sum(len(faces), classes, many, probs, device))
    phase(
        f"phase 4: large + lenses ok: {n_views} views {width}x{height} "
        f"(fisheye {FISHEYE[:4]} on views 0-3, zero 4-5, SIMPLE_RADIAL k1 "
        f"{RADIAL_LARGE[0]} 6-7; wire {dists.shape}, no hoist), "
        f"{len(faces)} triangles; render_many == render on views 0 and 6, "
        f"zero-lens views 4-5 == pinhole bit for bit, fuse_views == "
        f"per-view (bit-equal: {bit}), overflow 0, launches {launches}"
    )
    return dict(faces=faces, cams=cams, batch=batch, batch_ms=batch_ms,
                entry="fuse_views", renderer=renderer, launches=launches)


def distorted_texels(device):
    """Phase 4: the `default` texel renderer (2.0 texels per pixel) under
    `large`'s lens pattern: through raster_tile, and forced through
    raster_dense (backend="dense" on fuse_views_texels and the renderer):
    fuse_views_texels(distortions=) == the per-view path, every texel id
    < P, overflow 0, each kernel once per view rasterized and the other
    not at all. Each fused batch is timed here once (phase 5 reuses the
    time), as at `large` + lenses."""
    import semantic_meshes_torch as smt

    sub, n_views, width, height, classes = SCENES["default"]
    vertices, faces, pinholes = scene("default")
    mesh = SimpleNamespace(vertices=vertices, faces=faces)
    cams = with_lenses(pinholes, LARGE_LENSES)
    probs = device_probs(n_views, height, width, classes, device)
    rot, trans, fl, pp = smt.data.stack_cameras(cams)
    dists = smt.data.stack_distortions(cams)
    out = {}
    for backend in ("tile", "dense"):
        reset_launches()
        renderer = smt.render.texels(mesh, pinholes, TPP["default"],
                                     backend=backend, device=device)
        P = renderer.getPrimitivesNum()
        renderer.prepare(cams)
        rendered = [renderer.render(cam)[0] for cam in cams]
        plan = smt.distributed.plan_fuse(
            renderer.vertices, renderer.faces, rot, trans, fl, pp,
            height=height, width=width, backend=backend, allow_split=False,
            distortions=dists, device=device)

        def batch(renderer=renderer, plan=plan, backend=backend, P=P):
            return smt.distributed.fuse_views_texels(
                renderer.vertices, renderer.faces, renderer.resolutions,
                renderer.first_texel_index, rot, trans, fl, pp, probs, IEW,
                distortions=dists, num_primitives=P, aggregator="sum",
                height=height, width=width, backend=backend,
                dense_e_cap=plan.dense_e_cap, device=device)

        (acc, ov), batch_ms = timed(batch)
        launches = read_launches()
        ids = torch.stack(rendered).view(torch.int32)
        if int(ov) != 0 or renderer.overflow_total() != 0:
            raise AssertionError(f"default texels lenses {backend}: overflow")
        if int(ids.max()) >= P or not (ids >= 0).any():
            raise AssertionError(f"default texels lenses {backend}: ids up "
                                 f"to {int(ids.max())} of {P}")
        kernel = "raster_tile" if backend == "tile" else "raster_dense"
        expect_launches(f"default texels lenses {backend}", launches, kernel,
                        2 * n_views)
        bit = same_state(f"default texels lenses {backend}", acc,
                         per_view_sum(P, classes, rendered, probs, device))
        phase(
            f"phase 4: default texels + lenses through {kernel} ok: "
            f"{n_views} views {width}x{height}, tpp {TPP['default']}, P {P}, "
            f"lenses as at large, plan {plan.dense_e_cap}; "
            f"fuse_views_texels(distortions=, backend={backend!r}) == "
            f"per-view (bit-equal: {bit}), every texel id < P, overflow 0, "
            f"launches {launches}"
        )
        out[backend] = dict(batch=batch, batch_ms=batch_ms,
                            entry="fuse_views_texels", launches=launches,
                            primitives=P, faces=faces, plan=plan)
    return out


def grid_card_vs_cpu(device, card):
    """Phase 4: _undistort_grid on the card against the CPU, one view per
    lens, from the same inputs: the classic wire bit for bit (a gate);
    the extended wire's max |dn| and |ds|, and the card's own pinhole
    image resampled with the CPU grid against the card grid (ids may
    differ on at most 1e-4 of the pixels). The extended view is the
    fisheye grid of `default` texels + lenses at its full 1024x768:
    `large`'s 2048x1536 has the same lens and field of view (focal 0.9 x
    height, centred) and runs the same elementwise ops on 4x the pixels,
    where the CPU's Newton would take 4x the time printed here."""
    import semantic_meshes_torch as smt
    from semantic_meshes_torch import rasterize as rast, render

    views = [("scannet", SCENES["scannet"], RADIAL_SCANNET),
             ("large", SCENES["large"], RADIAL_LARGE),
             ("default", SCENES["default"], FISHEYE)]
    for label, (sub, n, width, height, _), lens in views:
        vertices, faces = smt.testing.make_cube(subdivisions=sub)
        cam = smt.testing.make_ring_cameras(num_views=n, width=width,
                                            height=height)[0]
        out = []
        for d in (device, torch.device("cpu")):
            fl, pp, dist = (torch.as_tensor(np.asarray(a, np.float32),
                                            device=d)
                            for a in (cam.focal_lengths,
                                      cam.principal_point, lens))
            t = time.monotonic()
            out.append(render._undistort_grid(fl, pp, dist, height=height,
                                              width=width))
        cpu_s = time.monotonic() - t
        (n_card, s_card), (n_cpu, s_cpu) = out
        bit = torch.equal(n_card.cpu(), n_cpu) and torch.equal(
            s_card.cpu(), s_cpu)
        fl_s = torch.as_tensor(cam.focal_lengths, device=device) * s_card
        pp = torch.as_tensor(cam.principal_point, device=device)
        tri, depth, _ = rast.rasterize(
            torch.as_tensor(vertices, device=device),
            torch.as_tensor(faces.astype(np.int64), device=device),
            cam.rotation, cam.translation, fl_s, pp, height=height,
            width=width, backend="dense" if len(faces) >= 16384 else "tile",
            device=device)
        ids_card, _ = render._resample_wh(tri.t(), depth.t(), n_card, fl_s,
                                          pp)
        ids_cpu, _ = render._resample_wh(tri.t(), depth.t(),
                                         n_cpu.to(device), fl_s, pp)
        differ = int((ids_card != ids_cpu).sum())
        dn = float((n_card.cpu() - n_cpu).abs().max())
        ds = abs(float(s_card) - float(s_cpu))
        classic = len(lens) == 4
        if (classic and not bit) or differ > 1e-4 * width * height:
            raise AssertionError(
                f"{label}: card grid != CPU grid (bit-equal {bit}, max |dn| "
                f"{dn}, |ds| {ds}, {differ} ids differ)")
        phase(f"phase 4 [{card}]: grid card vs CPU at {label} {width}x"
              f"{height}, lens {list(lens)}: bit-equal {bit}, max |dn| {dn}, "
              f"|ds| {ds} (s {float(s_card)}), ids differing after the "
              f"resample {differ} of {width * height}; the CPU grid took "
              f"{cpu_s:.3f} s")


def lens_times(large_ctx, scannet_ctx, device, card):
    """Phase 5 of the distorted paths, per view: the grid (classic at
    `scannet`, hoisted: once per batch; extended at `large`, per view),
    launched from Python; _resample_wh at `large` launched and in graph
    replays, with the bound of its bytes."""
    from semantic_meshes_torch import rasterize as rast, render

    def grid_args(cam, lens):
        return [torch.as_tensor(np.asarray(a, np.float32), device=device)
                for a in (cam.focal_lengths, cam.principal_point, lens)]

    cam = scannet_ctx["cams"][0]
    width, height = cam.resolution
    args = grid_args(cam, cam.distortion)
    classic_ms = cuda_time_ms(lambda: render._undistort_grid(
        *args, height=height, width=width), reps=5)
    cam = large_ctx["cams"][0]
    lw, lh = cam.resolution
    args = grid_args(cam, cam.distortion)
    # one run: phase 4 has run this grid's launches many times already
    (grid, s), ext_ms = timed(lambda: render._undistort_grid(
        *args, height=lh, width=lw))
    fl_s = args[0] * s
    renderer = large_ctx["renderer"]
    tri, depth, _ = rast.rasterize(
        renderer.vertices, renderer.faces, cam.rotation, cam.translation,
        fl_s, args[1], face_vertices=renderer.face_vertices, height=lh,
        width=lw, device=device)
    ids_wh, depth_wh = tri.t(), depth.t()

    def resample():
        return render._resample_wh(ids_wh, depth_wh, grid, fl_s, args[1])

    resample_ms = cuda_time_ms(resample, reps=20)
    resample_graph_ms = graph_time_ms(resample, reps=20)
    # each input read once (grid 8 B, id + depth 8 B a pixel), each output
    # written once (id + depth 8 B)
    nbytes = lw * lh * 24
    bound_ms = nbytes / PEAK_BYTES_S * 1e3
    n_views = len(scannet_ctx["cams"])
    phase(
        f"phase 5 [{card}]: lens pieces, launched from Python: the classic "
        f"grid (SIMPLE_RADIAL) at scannet {width}x{height} {classic_ms:.6f} "
        f"ms once per batch ({classic_ms / n_views:.6f} ms per view of "
        f"{n_views}, hoisted); the extended grid (fisheye) at large "
        f"{lw}x{lh} {ext_ms:.6f} ms per view; _resample_wh at large "
        f"{resample_ms:.6f} ms launched, {resample_graph_ms:.6f} ms in graph "
        f"replays, its bytes bound {bound_ms:.6f} ms for {nbytes} bytes"
    )


def indoor_scene(name):
    """Preset `name`'s mesh, views and classes with the cameras moved
    inside: the cube at ROOM_SIZE and the views on INDOOR_RING."""
    from semantic_meshes_torch import testing

    sub, views, width, height, _ = SCENES[name]
    vertices, faces = testing.make_cube(subdivisions=sub, size=ROOM_SIZE)
    cams = testing.make_ring_cameras(num_views=views, width=width,
                                     height=height, **INDOOR_RING)
    return vertices, faces, cams


def straddle_scene():
    """tests/test_clipping.py's random straddling scene at `scannet`'s
    1296x968: 40 vertices N(0, 1) x 2 and 30 faces from seed 8, many
    across the camera plane; the camera at the origin looking down +z,
    focal 0.9 x 968, centred."""
    from semantic_meshes_torch import data

    rng = np.random.default_rng(8)
    vertices = rng.normal(size=(40, 3)).astype(np.float32) * 2
    faces = rng.integers(0, 40, size=(30, 3)).astype(np.int32)
    cam = data.Camera(np.eye(3, dtype=np.float32), np.zeros(3, np.float32),
                      (1296, 968), np.full(2, 0.9 * 968, np.float32),
                      np.array([648.0, 484.0], np.float32))
    return vertices, faces, cam


def global_drops(vertices, faces, cams, device, lenses=None):
    """Per view, the big rows of the clipped setup past dense.N_GLOBAL:
    the rows the reference's capped global bucket drops and counts in
    overflow (a limit of its design, PERF.md), from the classification
    alone, independent of the kernel. lenses: per-view lens wires; the
    setup then runs under the virtual focal, as the render does."""
    from semantic_meshes_torch import render
    from semantic_meshes_torch.rasterize import dense, tiles

    fv = face_vertices(vertices, faces, device)
    out = []
    for k, cam in enumerate(cams):
        fl = torch.as_tensor(cam.focal_lengths, device=device)
        if lenses is not None:
            fl = fl * render._undistort_grid(
                fl, torch.as_tensor(cam.principal_point, device=device),
                torch.as_tensor(np.asarray(lenses[k], np.float32),
                                device=device),
                height=cam.height, width=cam.width)[1]
        setup = tiles.setup_inputs(None, None, cam.rotation, cam.translation,
                                   fl, cam.principal_point, face_vertices=fv,
                                   device=device, clip_near=True)
        big = dense._classify(setup, cam.height, cam.width, 0.0)[2]
        out.append(max(int(big.sum()) - dense.N_GLOBAL, 0))
    return out


def check_coverage(label, ids, drops):
    """Every pixel of every view without global-bucket drops is covered (a
    closed room); returns the coverage per view (W, H) id images."""
    cov = [float((i.view(torch.int32) >= 0).double().mean()) for i in ids]
    for k, (c, d) in enumerate(zip(cov, drops)):
        if d == 0 and c != 1.0:
            raise AssertionError(f"{label} view {k}: coverage {c} in a "
                                 "closed room")
    return cov


def clipped_vs_plain(device):
    """Phase 3 on the 2T clipped piece rows (pieces pinned at z = 1e-4
    project up to ~1e4 x the focal, so edge constants reach ~1e13): both
    kernels (raster_dense forced) on the straddling scene, raster_tile on
    every view of `large` indoor, raster_dense on every view of `scannet`
    indoor at the budget its clipped renderer probes (twice per view,
    bit-identical). Returns the largest |depth difference|."""
    from semantic_meshes_torch.rasterize import dense_kernel, tile_kernel

    max_err = 0.0
    vertices, faces, cam = straddle_scene()
    fv = face_vertices(vertices, faces, device)
    args, ov_t = view_inputs(fv, cam, device, clip_near=True)
    zk, ik = tile_kernel.resolve_tiles_cuda(*args)
    zp, ip = tile_kernel.resolve_tiles_plain(*args)
    dargs, _, ov_d = dense_view_inputs(fv, cam, None, device, clip_near=True)
    zd, idd = dense_kernel.resolve_dense_cuda(*dargs)
    zdp, idp = dense_kernel.resolve_dense_plain(*dargs)
    torch.cuda.synchronize()
    max_err = max(max_err, assert_same_image("straddle tile", 0, zk, ik, zp,
                                             ip),
                  assert_same_image("straddle dense", 0, zd, idd, zdp, idp))
    if not torch.equal(ik, idd) or int(ov_t) or int(ov_d):
        raise AssertionError("straddle: raster_tile and raster_dense differ "
                             f"(overflow {int(ov_t)}, {int(ov_d)})")
    phase(f"phase 3: raster_tile and raster_dense (forced) == plain on the "
          f"straddling scene ({len(faces)} faces, {args[0].shape[0] - 1} "
          f"piece rows, {cam.width}x{cam.height}, coverage "
          f"{float((ik >= 0).float().mean()):.6f}): ids equal, depths "
          "bit-equal, the two kernels' piece ids equal, overflow 0")

    vertices, faces, cams = indoor_scene("large")
    fv = face_vertices(vertices, faces, device)
    for k, cam in enumerate(cams):
        args, overflow = view_inputs(fv, cam, device, clip_near=True)
        zk, ik = tile_kernel.resolve_tiles_cuda(*args)
        zp, ip = tile_kernel.resolve_tiles_plain(*args)
        torch.cuda.synchronize()
        if int(overflow):
            raise AssertionError(f"large indoor view {k}: overflow")
        max_err = max(max_err, assert_same_image("large indoor", k, zk, ik,
                                                 zp, ip))
    phase(f"phase 3: raster_tile == plain at large indoor + clip: "
          f"{len(cams)} views, {2 * len(faces)} piece rows, ids equal, "
          "depths bit-equal, overflow 0")

    vertices, faces, cams = indoor_scene("scannet")
    fv = face_vertices(vertices, faces, device)
    cap = dense_budget(vertices, faces, cams, device, clip_near=True)
    drops = global_drops(vertices, faces, cams, device)
    shapes = []
    for k, cam in enumerate(cams):
        args, _, overflow = dense_view_inputs(fv, cam, cap, device,
                                              clip_near=True)
        if args is None:
            raise AssertionError(f"scannet indoor: zero pair budget {cap}")
        zk, ik = dense_kernel.resolve_dense_cuda(*args)
        z2, i2 = dense_kernel.resolve_dense_cuda(*args)
        zp, ip = dense_kernel.resolve_dense_plain(*args)
        torch.cuda.synchronize()
        if not (torch.equal(i2, ik) and torch.equal(z2.view(torch.int32),
                                                    zk.view(torch.int32))):
            raise AssertionError(f"scannet indoor view {k}: two runs of "
                                 "raster_dense differ")
        if int(overflow) != drops[k]:
            raise AssertionError(f"scannet indoor view {k}: overflow "
                                 f"{int(overflow)}, expected {drops[k]}")
        max_err = max(max_err, assert_same_image("scannet indoor", k, zk, ik,
                                                 zp, ip))
        starts = args[2].long()
        B = starts.numel() - 2
        shapes.append((int(starts[B + 1] - starts[B]),
                       int((starts[1:B + 1] - starts[:B]).max())))
    phase(f"phase 3: raster_dense == plain at scannet indoor + clip (budget "
          f"{cap}, {2 * len(faces)} piece rows): {len(cams)} views, ids "
          f"equal, depths bit-equal, two runs per view bit-identical, "
          f"overflow per view == big rows past n_global {drops}; (global "
          f"bucket, heaviest own range) per view {shapes}")
    return max_err


def indoor_main_path(name, device, workdir):
    """Phase 4 at `scannet` or `large` indoor, clip_near=True, through the
    public API, launch counters read around it: prepare -> render ->
    render_many -> MeshAggregator sum/summax/mul -> get -> colours -> PLY;
    plan_fuse(clip_near=True) compacts (split_k 0, remap None);
    fuse_views_planned twice, bit-identical, == per-view; fuse_views_split
    == fuse_views; overflow == the big rows past n_global (global_drops;
    0 for the tile rasterizer); every pixel covered in each view without
    such drops (a closed room); the kernel once per view rasterized with
    pairs. Returns what phase 5 reuses, with the same cameras' culled
    batch."""
    import semantic_meshes_torch as smt

    sub, n_views, width, height, classes = SCENES[name]
    label = f"{name} indoor + clip"
    vertices, faces, cams = indoor_scene(name)
    path = os.path.join(workdir, f"{name}_indoor.ply")
    smt.io.ply.write_mesh(path, vertices, faces)
    mesh = smt.data.Ply(path)
    probs = device_probs(n_views, height, width, classes, device)
    rot, trans, fl, pp = smt.data.stack_cameras(cams)
    dense = smt.rasterize.uses_dense(None, len(faces))
    kw = dict(num_primitives=len(faces), aggregator="sum", height=height,
              width=width, clip_near=True, device=device)
    drops = (global_drops(vertices, faces, cams, device) if dense
             else [0] * n_views)
    total = sum(drops)

    reset_launches()
    renderer = smt.render.triangles(mesh, clip_near=True, device=device)
    renderer.prepare(cams)
    cap = renderer.dense_cap_policy._cap.get((height, width))
    rendered = [renderer.render(cam)[0] for cam in cams]
    many, _ = renderer.render_many(cams)
    if not torch.equal(many, torch.stack(rendered)):
        raise AssertionError(f"{label}: render_many != render")
    if renderer.overflow_total() != 2 * total:
        raise AssertionError(f"{label}: render overflow "
                             f"{renderer.overflow_total()}, expected "
                             f"{2 * total}")
    coverage = check_coverage(label, many, drops)
    fused_sum = fuse_and_save(f"{name}_indoor", mesh, rendered, probs,
                              classes, workdir, device)
    plan = smt.distributed.plan_fuse(vertices, faces, rot, trans, fl, pp,
                                     height=height, width=width,
                                     clip_near=True, device=device)
    if plan.split_k != 0 or plan.remap is not None:
        raise AssertionError(f"{label}: plan split_k {plan.split_k}")
    acc = planned_twice(label, plan, vertices, cams, probs, classes, device,
                        overflow=total, clip_near=True)
    unplanned, ov = smt.distributed.fuse_views(vertices, faces, rot, trans,
                                               fl, pp, probs, IEW, **kw)
    split, ov_s = smt.distributed.fuse_views_split(vertices, faces, rot,
                                                   trans, fl, pp, probs, IEW,
                                                   **kw)
    torch.cuda.synchronize()
    launches = read_launches()
    if int(ov) != total or int(ov_s) != total or not torch.equal(
            split, unplanned):
        raise AssertionError(f"{label}: fuse_views_split != fuse_views "
                             f"(overflow {int(ov)}, {int(ov_s)})")
    # render, render_many, two planned batches, fuse_views (default
    # budgets: always binned), fuse_views_split (the plan's budgets)
    caps = ([cap] * (2 * n_views) + [plan.dense_e_cap] * (2 * n_views)
            + [None] * n_views + [plan.dense_e_cap] * n_views)
    kernel = "raster_dense" if dense else "raster_tile"
    expect_launches(label, launches, kernel, sum(
        1 for c in caps if not dense or c is None or c[0] > 0))
    bit = same_state(label, acc, fused_sum)
    if not torch.equal(unplanned, acc):
        raise AssertionError(f"{label}: fuse_views != fuse_views_planned")
    extra = (f"dense budget {cap} (render), plan {plan.dense_e_cap}"
             if dense else "tile rasterizer")
    phase(
        f"phase 4: {label} ok: {n_views} views {width}x{height} inside a "
        f"{ROOM_SIZE} m room, {len(faces)} triangles, {classes} classes, "
        f"{extra}, split_k {plan.split_k}; prepare + render + render_many, "
        f"coverage per view {coverage}, sum/summax/mul fused, PLY saved and "
        f"reloaded, overflow per batch {total} == the big rows past n_global "
        f"per view {drops}, launches {launches}, planned == per-view "
        f"(bit-equal: {bit}), repeated fusion bit-identical, "
        "fuse_views_split == fuse_views == planned"
    )

    def batch():
        return smt.distributed.fuse_views_planned(
            plan, vertices, rot, trans, fl, pp, probs, IEW, **kw)

    cull_plan = smt.distributed.plan_fuse(vertices, faces, rot, trans, fl,
                                          pp, height=height, width=width,
                                          device=device)

    def cull_batch():
        return smt.distributed.fuse_views_planned(
            cull_plan, vertices, rot, trans, fl, pp, probs, IEW,
            **dict(kw, clip_near=False))

    return dict(faces=faces, vertices=vertices, cams=cams, probs=probs,
                plan=plan, batch=batch, cull_batch=cull_batch,
                entry="fuse_views_planned", launches=launches, cap=cap,
                drops=drops)


def indoor_texels01(device):
    """Phase 4 at `texels01` indoor (`scannet` indoor's mesh, views and
    classes at 0.1 texels per pixel, clip_near=True): the clipped
    _texel_resolutions on the card == the CPU's on every face; texels ->
    prepare -> render -> render_many -> MeshAggregator sum/summax/mul ->
    get -> colours; fuse_views_texels(clip_near=True) under
    plan_fuse(allow_split=False, clip_near=True) twice, bit-identical,
    == per-view; every id < P; overflow == the big rows past n_global
    (global_drops); the card's ray-form shader ==
    the CPU's bit for bit on every view, from the card's triangle ids;
    raster_dense once per view rasterized with pairs."""
    import semantic_meshes_torch as smt
    from semantic_meshes_torch import render

    sub, n_views, width, height, classes = SCENES["texels01"]
    label = "texels01 indoor + clip"
    tpp = TPP["texels01"]
    vertices, faces, cams = indoor_scene("texels01")
    sizes = []
    for d in (device, torch.device("cpu")):
        v = torch.as_tensor(vertices, device=d)
        f = torch.as_tensor(faces.astype(np.int64), device=d)
        sizes.append(render._texel_resolutions(v, f, cams, tpp,
                                               clip_near=True).cpu())
    resized = int((sizes[0] != sizes[1]).sum())
    if resized:
        raise AssertionError(f"{label}: the card's clipped sizing differs "
                             f"from the CPU's on {resized} faces")
    mesh = SimpleNamespace(vertices=vertices, faces=faces)
    probs = device_probs(n_views, height, width, classes, device)
    rot, trans, fl, pp = smt.data.stack_cameras(cams)
    drops = global_drops(vertices, faces, cams, device)
    total = sum(drops)

    reset_launches()
    renderer = smt.render.texels(mesh, cams, tpp, clip_near=True,
                                 device=device)
    P = renderer.getPrimitivesNum()
    if not torch.equal(renderer.resolutions.cpu(), sizes[1]):
        raise AssertionError(f"{label}: renderer sizing != the CPU's")
    renderer.prepare(cams)
    cap = renderer.dense_cap_policy._cap[(height, width)]
    rendered = [renderer.render(cam)[0] for cam in cams]
    many, _ = renderer.render_many(cams)
    if not torch.equal(many, torch.stack(rendered)):
        raise AssertionError(f"{label}: render_many != render")
    if renderer.overflow_total() != 2 * total:
        raise AssertionError(f"{label}: render overflow "
                             f"{renderer.overflow_total()}, expected "
                             f"{2 * total}")
    fused_sum = fuse_and_save(label, mesh, rendered, probs, classes, None,
                              device, texels=P)
    plan = smt.distributed.plan_fuse(
        renderer.vertices, renderer.faces, rot, trans, fl, pp, height=height,
        width=width, allow_split=False, clip_near=True, device=device)

    def batch():
        return smt.distributed.fuse_views_texels(
            renderer.vertices, plan.faces, renderer.resolutions,
            renderer.first_texel_index, rot, trans, fl, pp, probs, IEW,
            num_primitives=P, aggregator="sum", height=height, width=width,
            clip_near=True, dense_e_cap=plan.dense_e_cap, device=device)

    runs = []
    for _ in range(2):
        acc, ov = batch()
        if int(ov) != total:
            raise AssertionError(f"{label}: fuse_views_texels overflow "
                                 f"{int(ov)}, expected {total}")
        runs.append(acc)
    torch.cuda.synchronize()
    launches = read_launches()
    if not torch.equal(runs[0], runs[1]):
        raise AssertionError(f"{label}: repeated fusion is not "
                             "bit-identical")
    caps = [cap] * (2 * n_views) + [plan.dense_e_cap] * (2 * n_views)
    expect_launches(label, launches, "raster_dense",
                    sum(1 for c in caps if c[0] > 0))
    bit = same_state(label, runs[0], fused_sum)
    ids = many.view(torch.int32)
    if int(ids.max()) >= P:
        raise AssertionError(f"{label}: texel ids out of [0, {P})")
    tables = (renderer.vertices, renderer.faces, renderer.resolutions,
              renderer.first_texel_index)
    cpu_tables = [t.cpu() for t in tables]
    for k, cam in enumerate(cams):
        tri = smt.rasterize.rasterize(
            renderer.vertices, renderer.faces, *cam_args(cam),
            face_vertices=renderer.face_vertices, height=height, width=width,
            clip_near=True, dense_e_cap=cap, device=device)[0]
        card = render._texel_prim_image(*tables[:2], *cam_args(cam), tri,
                                        *tables[2:], P, clip_near=True)
        cpu = render._texel_prim_image(*cpu_tables[:2], *cam_args(cam),
                                       tri.cpu(), *cpu_tables[2:], P,
                                       clip_near=True)
        if not torch.equal(card.cpu(), cpu):
            raise AssertionError(f"{label} view {k}: the card's ray-form "
                                 f"shader differs from the CPU's on "
                                 f"{int((card.cpu() != cpu).sum())} pixels")
    r = renderer.resolutions
    cull = render._texel_resolutions(
        torch.as_tensor(vertices, device=device),
        torch.as_tensor(faces.astype(np.int64), device=device), cams, tpp)
    phase(
        f"phase 4: {label} ok: {n_views} views {width}x{height}, "
        f"{len(faces)} triangles, tpp {tpp}, P {P} texels (culled sizing "
        f"{int(smt.geometry.texel_count(cull.long()).sum())}; resolution "
        f"{int(r.min())}-{int(r.max())}, {int((r == 0).sum())} triangles "
        f"without texels, {int((r > 0).sum() - (cull > 0).sum())} more "
        f"sized than by the culled rule), the card's clipped sizing == the "
        f"CPU's on every face; dense budget {cap} (render), plan "
        f"{plan.dense_e_cap}; prepare + render + render_many, sum/summax/mul "
        f"fused, texel coverage {float((ids >= 0).double().mean())}, every "
        f"id < P, overflow per batch {total} == the big rows past n_global "
        f"{drops}, launches {launches}, the card's ray-form "
        f"shader == the CPU's on every view, fuse_views_texels == per-view "
        f"(bit-equal: {bit}), repeated fusion bit-identical"
    )
    return dict(faces=faces, primitives=P, probs=probs, plan=plan,
                batch=batch, entry="fuse_views_texels", launches=launches)


def indoor_scannet_lens(device):
    """Phase 4 at `scannet` indoor + SIMPLE_RADIAL k1 = RADIAL_SCANNET[0]
    on all views (clip_near=True, kernel B): render_many == per-view
    render, clipped under the virtual focal; overflow == the big rows
    past n_global under that focal (global_drops); raster_dense once per
    view rendered with pairs."""
    import semantic_meshes_torch as smt

    label = "scannet indoor + clip + SIMPLE_RADIAL"
    vertices, faces, pinholes = indoor_scene("scannet")
    cams = with_lenses(pinholes, [RADIAL_SCANNET] * len(pinholes))
    drops = global_drops(vertices, faces, cams, device,
                         [RADIAL_SCANNET] * len(cams))
    reset_launches()
    renderer = smt.render.triangles(
        SimpleNamespace(vertices=vertices, faces=faces), clip_near=True,
        device=device)
    renderer.prepare(cams)
    cap = renderer.dense_cap_policy._cap[cams[0].height, cams[0].width]
    rendered = [renderer.render(cam)[0] for cam in cams]
    many, _ = renderer.render_many(cams)
    torch.cuda.synchronize()
    launches = read_launches()
    if not torch.equal(many, torch.stack(rendered)):
        raise AssertionError(f"{label}: render_many != render")
    if renderer.overflow_total() != 2 * sum(drops):
        raise AssertionError(f"{label}: overflow {renderer.overflow_total()}"
                             f", expected {2 * sum(drops)}")
    expect_launches(label, launches, "raster_dense",
                    2 * len(cams) if cap[0] > 0 else 0)
    coverage = [float((i.view(torch.int32) >= 0).double().mean())
                for i in many]
    phase(f"phase 4: {label} ok: {len(cams)} views, dense budget {cap} "
          f"under the virtual focal; render_many == render, coverage per "
          f"view {coverage}, overflow per batch {sum(drops)} == the big rows "
          f"past n_global {drops}, launches {launches}")
    return dict(launches=launches)


def clip_times(ctx, device, card):
    """Phase 5 at `scannet` indoor, per view: the near-plane clipper
    (geometry.clip_triangles_near) and the whole clipped setup
    (tiles.setup_clipped: rigid transform, clipper, projection, setup of
    the 2T rows) against the culled setup of the same cameras, each
    launched from Python and in CUDA-graph replays."""
    from semantic_meshes_torch import geometry
    from semantic_meshes_torch.rasterize import tiles

    cams, faces = ctx["cams"], ctx["faces"]
    fv = face_vertices(ctx["vertices"], faces, device)
    cam_t = [tuple(torch.as_tensor(np.asarray(a, np.float32), device=device)
                   for a in cam_args(c)) for c in cams]
    n = len(cams)

    def clipper():
        return [geometry.clip_triangles_near(
            geometry.rigid_transform(r, t, fv), tiles.CLIP_Z_NEAR)
            for r, t, _, _ in cam_t]

    def clipped():
        return [tiles.setup_clipped(fv, *c) for c in cam_t]

    def culled():
        return [tiles.setup_from_face_vertices(fv, *c) for c in cam_t]

    out = {}
    for label, fn in (("clipper", clipper), ("clipped setup", clipped),
                      ("culled setup", culled)):
        out[label] = (cuda_time_ms(fn, reps=10) / n,
                      graph_time_ms(fn, reps=10) / n)
    phase(
        f"phase 5 [{card}]: scannet indoor + clip ({n} views, {len(faces)} "
        f"faces), per view launched / in graph replays: "
        + "; ".join(f"{k} {a:.6f} / {b:.6f} ms" for k, (a, b) in out.items())
    )
    return out


def bound(ops, nbytes, ops_per_s=PEAK_FP32_OPS):
    ops_ms = ops / ops_per_s * 1e3
    bytes_ms = nbytes / PEAK_BYTES_S * 1e3
    return (max(ops_ms, bytes_ms), "operations" if ops_ms >= bytes_ms
            else "bytes", ops_ms, bytes_ms)


def in_turns(fns, inputs, reps):
    """Per-view ms of each function in `fns` (name -> function of one
    view's arguments) over all `inputs` back to back, timed in turns a, b,
    ..., ..., b, a: each turn takes `ms` (graph_time_ms) and `launched_ms`
    (CUDA events around Python launching the views one by one), medians
    of `reps`. Returns name -> {"ms": [two turns], "launched_ms": [...]}."""
    order = list(fns) + list(reversed(list(fns)))
    out = {name: {"ms": [], "launched_ms": []} for name in fns}
    for name in order:
        fn = fns[name]

        def all_views():
            return [fn(*a) for a in inputs]

        out[name]["ms"].append(graph_time_ms(all_views, reps) / len(inputs))
        out[name]["launched_ms"].append(cuda_time_ms(all_views, reps)
                                        / len(inputs))
    return out


def turn_means(turns, keys=("ms", "launched_ms")):
    return {k: statistics.mean(turns[k]) for k in keys}


def against_entry(against, *turn_sets):
    """The kernel line's "against" entry: per --against label, the means
    of its turns (one dict of turns per measurement)."""
    if not against:
        return {}
    return {"against": {label: dict(kv for t in turn_sets
                                    for kv in t(label).items())
                        for label in against}}


def tile_counts_only(args, keep):
    """resolve_tiles arguments of one view with every tile's count set to
    0, except the heaviest tile's when `keep`."""
    table, cand, counts, *rest = args
    new = torch.zeros_like(counts)
    if keep:
        b = int(counts.argmax())
        new[b] = counts[b]
    return (table, cand, new, *rest)


def rect_meets(args):
    """Per view, from the table: the (candidate, warp rectangle) pairs
    whose three edge forms pass the corner test at the rectangle (the
    kernel's cull without its depth test; a warp owns 16 columns x 8
    rows), and the most of them any one rectangle has. Forms are rounded
    op by op, as the kernels do."""
    cols, rows = 16, 8
    table, cand, counts, y_offset, nbx, _, _ = args
    B, N = cand.shape
    params = table[cand.long()]  # (B, N, 16)
    live = torch.arange(N, device=cand.device)[None, :] < counts[:, None]
    b = torch.arange(B, device=cand.device)
    r = torch.arange(32 * 128 // (cols * rows), device=cand.device)
    x0 = ((b % nbx) * 128)[:, None] + (r % (128 // cols)) * cols
    y0 = ((b // nbx) * 32)[:, None] + (r // (128 // cols)) * rows
    pxl = x0.to(torch.float32) + 0.5
    pxh = (x0 + cols - 1).to(torch.float32) + 0.5
    pyl = (y0.to(torch.float32) + 0.5) + y_offset
    pyh = ((y0 + rows - 1).to(torch.float32) + 0.5) + y_offset
    meets = live[:, :, None]
    for e in range(3):
        a = params[:, :, 3 * e, None]
        bb = params[:, :, 3 * e + 1, None]
        c = params[:, :, 3 * e + 2, None]
        px = torch.where(a >= 0, pxh[:, None, :], pxl[:, None, :])
        py = torch.where(bb >= 0, pyh[:, None, :], pyl[:, None, :])
        meets = meets & ~((a * px + bb * py) + c < 0)  # (B, N, R)
    return int(meets.sum()), int(meets.sum(1).max())


def tile_times(name, device, card, against, clip=False):
    """raster_tile and its plain version at scene `name` (clip: its indoor
    variant, clipped): ms per view (the kernel's in turns with each
    --against copy's, by in_turns, on the view, on its heaviest tile alone
    and with every tile empty; the plain version's by CUDA events around
    all views back to back), with the bound of one view's work computed
    from this run's inputs."""
    from semantic_meshes_torch.rasterize import tile_kernel

    vertices, faces, cams = (indoor_scene if clip else scene)(name)
    n_views = len(cams)
    width, height = cams[0].resolution
    fv = face_vertices(vertices, faces, device)
    inputs = [view_inputs(fv, cam, device, clip_near=clip)[0]
              for cam in cams]
    sum_counts = [int(a[2].sum()) for a in inputs]
    max_counts = [int(a[2].max()) for a in inputs]
    meets = [rect_meets(a) for a in inputs]

    fns = {**{label: a.tile for label, a in against.items()},
           "current": tile_kernel.resolve_tiles_cuda}
    turns = in_turns(fns, inputs, reps=20)
    heavy = in_turns(fns, [tile_counts_only(a, True) for a in inputs],
                     reps=20)
    empty = in_turns(fns, [tile_counts_only(a, False) for a in inputs],
                     reps=20)
    times = turn_means(turns["current"])
    heaviest_ms = statistics.mean(heavy["current"]["ms"])
    empty_ms = statistics.mean(empty["current"]["ms"])
    plain_ms = cuda_time_ms(
        lambda: [tile_kernel.resolve_tiles_plain(*a) for a in inputs],
        reps=5) / n_views
    # The bound of the mean view. Operations: 12 at each of a warp's 128
    # pixels for every (candidate, warp) test the kernel's cull leaves, as
    # the kernel counts them in this run. Bytes: the counts, the listed
    # candidate ids, one read of each table row they name, and one write
    # of the (H, W) depth + id images. bound_every_pair_ms keeps the
    # earlier count: every candidate at all 4096 pixels of its tile.
    run, view_bytes = [], []
    for a in inputs:
        table, cand, counts = a[:3]
        tested = torch.zeros(1, dtype=torch.int64, device=device)
        tile_kernel.resolve_tiles_cuda(*a, tested=tested)
        run.append(int(tested))
        slot = torch.arange(cand.shape[1], device=cand.device)
        live = slot < counts[:, None]
        rows = int(torch.unique(cand[live]).numel())
        view_bytes.append(counts.numel() * 4 + int(counts.sum()) * 4
                          + rows * table.shape[1] * 4 + width * height * 8)
    culled = [1 - r / (tile_kernel.WARPS * s) if s else 0.0
              for r, s in zip(run, sum_counts)]
    nbytes = statistics.mean(view_bytes)
    tile_pixels = tile_kernel.TILE_H * tile_kernel.TILE_W
    bound_ms, bound_by, ops_ms, bytes_ms = bound(
        statistics.mean(run) * (tile_pixels // tile_kernel.WARPS)
        * FLOPS_PER_TEST, nbytes)
    mean_counts = statistics.mean(sum_counts)
    every_ms = bound(mean_counts * tile_pixels * FLOPS_PER_TEST, nbytes)[0]
    phase(
        f"phase 5 [{card}]: {name}{' indoor + clip' if clip else ''} "
        f"({n_views} views {width}x{height}), per "
        f"view: raster_tile {times['ms']:.6f} ms (graph replays), "
        f"{times['launched_ms']:.6f} ms launched view by view; turns "
        f"{turns}; heaviest tile alone {heaviest_ms:.6f} ms (turns "
        f"{ {k: v['ms'] for k, v in heavy.items()} }); every tile empty "
        f"{empty_ms:.6f} ms (turns { {k: v['ms'] for k, v in empty.items()} }"
        f"); plain {plain_ms:.6f} ms; bound {bound_ms:.6f} ms ({bound_by}: "
        f"ops {ops_ms:.6f} ms for the (candidate, warp) tests run at "
        f"{PEAK_FP32_OPS / 1e12} T operations/s, bytes {bytes_ms:.6f} ms), "
        f"every candidate at every pixel of its tile {every_ms:.6f} ms; "
        f"culled share of (candidate, warp) tests "
        f"{statistics.mean(culled):.6f} (per view "
        f"{[round(c, 6) for c in culled]}); tests run per view {run}; "
        f"sum(counts) per view {sum_counts} (mean {mean_counts}), heaviest "
        f"tile per view {max_counts}; (candidate, 16x8 rectangle) pairs "
        f"past the edge test alone per view {[m[0] for m in meets]}, most "
        f"in one rectangle per view {[m[1] for m in meets]}"
    )
    return dict(times, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, bound_every_pair_ms=every_ms,
                heaviest_tile_ms=heaviest_ms, empty_ms=empty_ms,
                culled_share=statistics.mean(culled), tests_run=run,
                **against_entry(against,
                                lambda k: turn_means(turns[k]),
                                lambda k: {
                                    "heaviest_tile_ms":
                                        statistics.mean(heavy[k]["ms"]),
                                    "empty_ms":
                                        statistics.mean(empty[k]["ms"])}))


def heaviest_alone(args):
    """resolve_dense arguments of one view with every tile's own range
    emptied except the heaviest tile's (the global bucket kept)."""
    table, sorted_ids, starts, *rest = args
    s = starts.long()
    B = s.numel() - 2
    b = int((s[1:B + 1] - s[:B]).argmax())
    mine = sorted_ids[int(s[b]):int(s[b + 1])]
    ids = torch.cat([mine, sorted_ids[int(s[B]):int(s[B + 1])]])
    t = torch.arange(B + 2, device=s.device)
    new = torch.where(t <= b, 0, mine.numel())
    new[B + 1] = ids.numel()
    return (table, ids.contiguous(), new.to(torch.int32), *rest)


def dense_times(ctx, device, card, against):
    """Per-view pieces of the dense path at `scannet`: setup + classify +
    binning + table, the micro path, raster_dense (dense_kernel_row, and
    its plain version), fusion, and the routing cost model's coefficients
    these times give, each as launched from Python. Returns the kernel's
    row."""
    from semantic_meshes_torch import fusion
    from semantic_meshes_torch import rasterize as rast
    from semantic_meshes_torch.rasterize import (dense, dense_kernel,
                                                 tile_kernel, tiles)

    _, n_views, width, height, classes = SCENES["scannet"]
    vertices, faces, cams, cap = (ctx["vertices"], ctx["faces"], ctx["cams"],
                                  ctx["cap"])
    T = len(faces)
    fv = face_vertices(vertices, faces, device)
    kw = rast.dense_kwargs(cap)
    e_cap = dense._cdiv(max(kw["e_cap_rows"], dense.CHUNK),
                        dense.CHUNK) * dense.CHUNK
    micro_max = kw["micro_max"]
    micro_cap = min(dense._cdiv(max(kw["micro_cap_rows"], 8), 8) * 8, T)

    def setups():
        return [tiles.setup_inputs(None, None, *cam_args(c),
                                   face_vertices=fv, device=device)
                for c in cams]

    def bins(setup_list):
        out = []
        for s in setup_list:
            sorted_ids, starts, _, micro = dense._build_sorted_bins(
                s, height, width, 0.0, e_cap, dense.N_GLOBAL, micro_max)
            out.append((tile_kernel.candidate_table(s), sorted_ids, starts,
                        micro))
        return out

    setup_ms = cuda_time_ms(setups, reps=10) / n_views
    setup_list = setups()
    bin_ms = cuda_time_ms(lambda: bins(setup_list), reps=10) / n_views
    binned = bins(setup_list)
    micro_ms = cuda_time_ms(lambda: [
        dense._micro_key(s, b[3], height, width, 0.0, micro_max=micro_max,
                         micro_cap_rows=kw["micro_cap_rows"])
        for s, b in zip(setup_list, binned)], reps=10) / n_views
    inputs = []
    for s, (table, sorted_ids, starts, micro) in zip(setup_list, binned):
        key, _ = dense._micro_key(s, micro, height, width, 0.0,
                                  micro_max=micro_max,
                                  micro_cap_rows=kw["micro_cap_rows"])
        inputs.append((table, sorted_ids, starts, dense.N_GLOBAL, key, 0.0,
                       dense._cdiv(width, dense.TILE_W), height, width))

    kernel = dense_kernel_row("scannet", inputs, against, card)
    # one run of the 8 views: at ~1-1.5 s a view the plain version is
    # 10^4 times the kernel, and five runs took ~50 s of the script's time
    plain_ms = cuda_time_ms(lambda: [dense_kernel.resolve_dense_plain(*a)
                                     for a in inputs], reps=1,
                            warmup=0) / n_views
    ids = [dense_kernel.resolve_dense_cuda(*a)[1] for a in inputs]
    fusion_ms = cuda_time_ms(
        lambda: [fusion._accumulate_view(ids[k], ctx["probs"][k], None, IEW,
                                         num_primitives=T, aggregator="sum")
                 for k in range(n_views)],
        reps=10) / n_views
    frag_rows = micro_max * micro_max * micro_cap
    pairs = statistics.mean(kernel["pairs"])
    coeffs = dict(alpha=kernel["launched_ms"] * 1e6 / pairs,
                  beta=micro_ms * 1e6 / frag_rows,
                  gamma=bin_ms * 1e6 / (dense.K_SPAN * T))
    phase(
        f"phase 5 [{card}]: scannet ({n_views} views {width}x{height}, {T} "
        f"triangles, budget {cap}), per view: setup {setup_ms:.6f} ms, "
        f"classify + sort binning + table {bin_ms:.6f} ms, micro path "
        f"{micro_ms:.6f} ms ({frag_rows} fragment rows), raster_dense "
        f"{kernel['launched_ms']:.6f} ms launched view by view "
        f"({kernel['ms']:.6f} ms in graph replays), plain {plain_ms:.6f} "
        f"ms, fusion (sum, {classes} classes) {fusion_ms:.6f} ms"
    )
    phase(
        f"phase 5 [{card}]: routing cost model at scannet, ns, each from "
        f"times launched from Python: alpha (raster_dense per pair) "
        f"{coeffs['alpha']:.6f} ({kernel['ms'] * 1e6 / pairs:.6f} from "
        f"graph replays), beta (micro path per fragment row) "
        f"{coeffs['beta']:.6f}, gamma (classify + binning per sort row) "
        f"{coeffs['gamma']:.6f}; in use: alpha {dense.ROUTE_ALPHA}, beta "
        f"{dense.ROUTE_BETA}, gamma {dense.ROUTE_GAMMA}"
    )
    row = {k: v for k, v in kernel.items() if k != "pairs"}
    return dict(row, plain_ms=plain_ms)


def dense_kernel_row(label, inputs, against, card):
    """raster_dense on every view of `inputs` (resolve_dense arguments):
    ms per view, and on each view's heaviest tile alone, in turns with
    each --against copy; the bound of the mean view from this run's
    inputs; work items and the culled share of (candidate, warp) tests per
    view. Prints one line; returns the numbers."""
    from semantic_meshes_torch.rasterize import dense_kernel

    fns = {**{k: a.dense for k, a in against.items()},
           "current": dense_kernel.resolve_dense_cuda}
    turns = in_turns(fns, inputs, reps=20)
    heavy = in_turns(fns, [heaviest_alone(a) for a in inputs], reps=20)

    # The bound of the mean view. Operations: 12 at each of a warp's 256
    # pixels for every (candidate, warp) test the kernel's cull leaves, as
    # the kernel counts them in this run. Bytes: one read of the starts,
    # of the ids read (the global ids once, the own ranges once), of each
    # table row they name and of the micro key image, and one write of
    # the 8-byte-per-pixel image. bound_every_pair_ms keeps the earlier count:
    # every listed pair at all 2048 pixels of its tile at 67 TFLOP/s.
    warp_pixels = dense_kernel.TILE_H * dense_kernel.TILE_W // \
        dense_kernel.WARPS
    tests, run, view_bytes, pairs, items, heaviest = [], [], [], [], [], []
    for args in inputs:
        table, sorted_ids, starts, n_global, key, _, _, height, width = args
        s = starts.long()
        B = s.numel() - 2
        g = max(min(int(s[B + 1] - s[B]), n_global), 0)
        own_b = s[1:B + 1] - s[:B]
        own = int(own_b.sum())
        tests.append(B * g + own)
        pairs.append(int(s[B + 1] - s[0]))
        heaviest.append(int(own_b.max()))
        items.append(int(dense_kernel.work_items(starts, n_global).sum()))
        tested = torch.zeros(1, dtype=torch.int64, device=table.device)
        dense_kernel.resolve_dense_cuda(*args, tested=tested)
        run.append(int(tested))
        rows = torch.cat([sorted_ids[int(s[B]):int(s[B]) + g],
                          sorted_ids[:int(s[B])]])
        view_bytes.append((B + 2) * 4 + (g + own) * 4
                          + int(torch.unique(rows).numel()) * 64
                          + (0 if key is None else key.numel() * 8)
                          + width * height * 8)
    culled = [1 - r / (dense_kernel.WARPS * t) if t else 0.0
              for r, t in zip(run, tests)]
    nbytes = statistics.mean(view_bytes)
    bound_ms, bound_by, ops_ms, bytes_ms = bound(
        statistics.mean(run) * warp_pixels * FLOPS_PER_TEST, nbytes)
    every_ms = bound(statistics.mean(tests) * dense_kernel.TILE_H
                     * dense_kernel.TILE_W * FLOPS_PER_TEST, nbytes,
                     PEAK_FP32_FLOPS)[0]
    out = dict(
        turn_means(turns["current"]), bound_ms=bound_ms, bound_by=bound_by,
        bound_every_pair_ms=every_ms,
        heaviest_tile_ms=statistics.mean(heavy["current"]["ms"]),
        items_per_view=items, culled_share=statistics.mean(culled),
        **against_entry(against, lambda k: turn_means(turns[k]),
                        lambda k: {"heaviest_tile_ms":
                                   statistics.mean(heavy[k]["ms"])}),
        pairs=pairs)
    phase(
        f"phase 5 [{card}]: raster_dense at {label} ({len(inputs)} views), "
        f"per view: {out['ms']:.6f} ms (graph replays), "
        f"{out['launched_ms']:.6f} ms launched view by view; turns {turns}; "
        f"heaviest tile alone {out['heaviest_tile_ms']:.6f} ms (turns "
        f"{ {k: v['ms'] for k, v in heavy.items()} }); bound "
        f"{bound_ms:.6f} ms ({bound_by}: ops {ops_ms:.6f} ms for the "
        f"(candidate, warp) tests run at {PEAK_FP32_OPS / 1e12} T "
        f"operations/s, bytes {bytes_ms:.6f} ms), every pair at every "
        f"pixel at 67 TFLOP/s {every_ms:.6f} ms; culled share of "
        f"(candidate, warp) tests {out['culled_share']:.6f} (per view "
        f"{[round(c, 6) for c in culled]}); tests run per view {run}, "
        f"pairs per view {pairs}, candidate tests per view {tests}, "
        f"heaviest own range per view {heaviest}, work items per view "
        f"{items}"
    )
    return out


def device_busy(label, entry, fn, batch_ms, card):
    """One traced batch: the device's busy time (sum of the kernels' own
    device times, from torch.profiler), its share of the untraced batch
    time, and the kernels that take the most. Diagnostic only: a profiler
    that sees no device time reports "not measured". The trace records
    device activity alone: host ops would add an event to each of a
    distorted batch's ~10^5 launches, and the busy time reads none."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    try:
        prof = profile(activities=[ProfilerActivity.CUDA])
        prof.start()
    except RuntimeError as e:
        prof, why = None, e
    # outside every try: a failure of the batch itself ends the run
    fn()
    torch.cuda.synchronize()
    if prof is None:
        phase(f"phase 5 [{card}]: {label} device busy share: not measured "
              f"({why})")
        return
    try:
        prof.stop()
        kernels = device_times(prof)
    except (RuntimeError, AttributeError) as e:
        phase(f"phase 5 [{card}]: {label} device busy share: not measured "
              f"({e})")
        return
    if not kernels:
        phase(f"phase 5 [{card}]: {label} device busy share: not measured "
              "(the profiler saw no device time)")
        return
    busy_ms = sum(ms for ms, _ in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:8]
    phase(
        f"phase 5 [{card}]: {label}, one traced {entry} batch: "
        f"device busy {busy_ms:.6f} ms of the untraced {batch_ms:.6f} ms "
        f"(idle share {1 - busy_ms / batch_ms:.6f}); top device time: "
        + "; ".join(f"{name[:60]} {ms:.6f} ms x{n}"
                    for name, (ms, n) in top)
    )


def device_times(prof):
    """{name: [device ms, count]} of the kernels and copies of a stopped
    trace, summed from its raw events (key_averages() would first build
    an event per host op, about a minute for a distorted batch's ~10^5
    launches)."""
    out = {}
    for e in prof.profiler.kineto_results.events():
        if "CUDA" in str(e.device_type()):
            entry = out.setdefault(e.name(), [0.0, 0])
            entry[0] += e.duration_ns() / 1e6
            entry[1] += 1
    return out


def batch_throughput(name, ctx, device, card, label=None):
    """rasterize_fuse_throughput of one batch at preset `name`
    (fuse_views_planned, or ctx's own "batch" and "entry": a texel
    preset's fuse_views_texels, a distorted variant's fusion), and one
    traced batch. label: the variant's name (default `name`). The batch's
    time is the median of 5 after 2 warm-ups, or ctx's "batch_ms" where
    phase 4 timed a batch whose extended lenses make every run cost
    seconds."""
    import semantic_meshes_torch as smt

    _, n_views, width, height, classes = SCENES[name]
    label = label or name
    T = len(ctx["faces"])
    P = ctx.get("primitives", T)
    entry = ctx.get("entry", "fuse_views_texels" if "batch" in ctx
                    else "fuse_views_planned")

    def planned_batch():
        return smt.distributed.fuse_views_planned(
            ctx["plan"], ctx["vertices"], ctx["rot"], ctx["trans"],
            ctx["fl"], ctx["pp"], ctx["probs"], IEW, num_primitives=T,
            aggregator="sum", height=height, width=width, device=device)

    fused_batch = ctx.get("batch", planned_batch)
    batch_ms = ctx.get("batch_ms") or cuda_time_ms(fused_batch, reps=5)
    mpix_s = n_views * width * height / 1e6 / (batch_ms / 1e3)
    phase(f"phase 5 [{card}]: {label}, {entry} batch {batch_ms:.6f} ms for "
          f"{n_views} views")
    device_busy(label, entry, fused_batch, batch_ms, card)
    print(json.dumps({
        "metric": "rasterize_fuse_throughput", "value": mpix_s,
        "unit": "MPix/s", "card": card,
        "detail": {"preset": name, "variant": label, "views": n_views,
                   "resolution": [width, height], "triangles": T,
                   "primitives": P, "classes": classes,
                   "batch_ms": batch_ms, "entry": entry,
                   "dense_e_cap": getattr(ctx.get("plan"), "dense_e_cap",
                                          None)},
    }), flush=True)


def batches_in_turns(label_a, fn_a, label_b, fn_b, card):
    """Device-event times of two batches on the same scene in turns (a, b,
    b, a in each round, after one warm-up each), so the host's load
    reaches both alike: each one's median and spread, the ratio of the
    medians and the share of rounds b won."""
    rounds = 5
    fn_a(), fn_b()
    times = {label_a: [], label_b: []}
    for _ in range(rounds):
        for label, fn in ((label_a, fn_a), (label_b, fn_b), (label_b, fn_b),
                          (label_a, fn_a)):
            times[label].append(cuda_time_ms(fn, reps=1, warmup=0))
    a, b = times[label_a], times[label_b]
    wins = sum(b[2 * k] + b[2 * k + 1] < a[2 * k] + a[2 * k + 1]
               for k in range(rounds))
    med_a, med_b = statistics.median(a), statistics.median(b)
    phase(
        f"phase 5 [{card}]: in turns ({rounds} rounds of a b b a), batch ms: "
        f"a = {label_a} median {med_a:.6f} (min {min(a):.6f}, max "
        f"{max(a):.6f}), b = {label_b} median {med_b:.6f} (min {min(b):.6f}, "
        f"max {max(b):.6f}); throughput b / a {med_a / med_b:.6f}; b faster "
        f"in {wins} of {rounds} rounds"
    )


def large_times(ctx, device, card):
    """Setup + binning and fusion per view at `large` (tile rasterizer)."""
    from semantic_meshes_torch import fusion
    from semantic_meshes_torch.rasterize import tile_kernel

    _, n_views, width, height, classes = SCENES["large"]
    cams, probs = ctx["cams"], ctx["probs"]
    T = len(ctx["faces"])
    fv = face_vertices(ctx["vertices"], ctx["faces"], device)
    setup_ms = cuda_time_ms(
        lambda: [view_inputs(fv, cam, device) for cam in cams],
        reps=10) / n_views
    ids = [tile_kernel.resolve_tiles_cuda(*view_inputs(fv, cam, device)[0])[1]
           for cam in cams]
    fusion_ms = cuda_time_ms(
        lambda: [fusion._accumulate_view(ids[k], probs[k], None, IEW,
                                         num_primitives=T, aggregator="sum")
                 for k in range(n_views)],
        reps=10) / n_views
    phase(f"phase 5 [{card}]: large, per view: setup+binning "
          f"{setup_ms:.6f} ms, fusion (sum) {fusion_ms:.6f} ms")


def texel_times(name, ctx, device, card):
    """Per view at a texel preset, each as launched from Python (CUDA
    events, medians): setup + dense binning (setup, classify, sort
    binning, the micro path and the table: dense.resolve_inputs),
    raster_dense, the texel shader (also from graph replays, with the
    bound of its bytes) and fusion (sum over the texels)."""
    from semantic_meshes_torch import fusion, render
    from semantic_meshes_torch.rasterize import dense_kernel

    _, n_views, width, height, classes = SCENES[name]
    renderer, cams, cap = ctx["renderer"], ctx["cams"], ctx["cap"]
    P = renderer.getPrimitivesNum()
    fv = renderer.face_vertices
    setup_ms = cuda_time_ms(
        lambda: [dense_view_inputs(fv, cam, cap, device) for cam in cams],
        reps=5) / n_views
    inputs = [dense_view_inputs(fv, cam, cap, device)[0] for cam in cams]
    kernel_ms = cuda_time_ms(
        lambda: [dense_kernel.resolve_dense_cuda(*a) for a in inputs],
        reps=10) / n_views
    tris = [dense_kernel.resolve_dense_cuda(*a)[1] for a in inputs]
    # camera arrays on the card, so the shader's launches can be captured
    cam_t = [tuple(torch.as_tensor(a, device=device) for a in cam_args(c))
             for c in cams]

    def shade_all():
        return [render._texel_prim_image(
            renderer.vertices, renderer.faces, *ca, tri, renderer.resolutions,
            renderer.first_texel_index, P) for ca, tri in zip(cam_t, tris)]

    shader_ms = cuda_time_ms(shade_all, reps=10) / n_views
    shader_graph_ms = graph_time_ms(shade_all, reps=10) / n_views
    prims = shade_all()
    fusion_ms = cuda_time_ms(
        lambda: [fusion._accumulate_view(prims[k], ctx["probs"][k], None, IEW,
                                         num_primitives=P, aggregator="sum")
                 for k in range(n_views)], reps=5) / n_views
    # the shader's least bytes: each input read once (the triangle-id
    # image, the vertices, the int64 faces, the resolutions and first
    # texel indices) and the texel-id image written once
    nbytes = (width * height * 8 + renderer.vertices.numel() * 4
              + renderer.faces.numel() * 8 + len(renderer.faces) * 8)
    shader_bound = nbytes / PEAK_BYTES_S * 1e3
    phase(
        f"phase 5 [{card}]: {name} ({n_views} views {width}x{height}, "
        f"{len(renderer.faces)} triangles, {P} texels, budget {cap}), per "
        f"view: setup + dense binning + micro path + table {setup_ms:.6f} "
        f"ms, raster_dense {kernel_ms:.6f} ms, texel shader {shader_ms:.6f} "
        f"ms launched ({shader_graph_ms:.6f} ms in graph replays; its bytes "
        f"bound {shader_bound:.6f} ms for {nbytes} bytes), fusion (sum, "
        f"{classes} classes over {P} texels) "
        f"{fusion_ms:.6f} ms"
    )
    return dict(setup_ms=setup_ms, kernel_ms=kernel_ms, shader_ms=shader_ms,
                shader_graph_ms=shader_graph_ms, shader_bound_ms=shader_bound,
                fusion_ms=fusion_ms)


def parse_args():
    parser = argparse.ArgumentParser(
        description="Chip smoke run of semantic_meshes_torch on one card.")
    parser.add_argument(
        "--against", action="append", default=[], metavar="DIR",
        help="a checkout of an earlier commit (its semantic_meshes_torch/ "
             "at least) whose kernels are timed in turns with this one's; "
             "labelled by the directory's name; repeatable")
    return parser.parse_args()


def main():
    args = parse_args()
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py: torch.cuda.is_available() is False; "
                 "this run needs a CUDA card")
    sys.path.insert(0, HERE)
    try:
        from semantic_meshes_torch import _build
    except ImportError as e:
        sys.exit(f"chip_smoke.py: semantic_meshes_torch not importable "
                 f"beside this script ({e})")
    device = torch.device("cuda", 0)
    t0 = time.monotonic()

    card = card_line()
    phase(f"phase 1: card: {card}")

    against = {}
    for i, path in enumerate(args.against):
        label = os.path.basename(os.path.normpath(path))
        if label in against or label == "current":
            sys.exit(f"chip_smoke.py: two --against directories named "
                     f"{label!r}")
        against[label] = load_against(path, i)
    builds = {"": _build, **{k: a.build for k, a in against.items()}}
    with ThreadPoolExecutor(len(builds)) as pool:
        list(pool.map(lambda b: b.build("raster_tile", "raster_dense"),
                      builds.values()))
    for label, build in builds.items():
        for name in ("raster_tile", "raster_dense"):
            report = [ln.strip() for ln in build.build_log(name).splitlines()
                      if "ptxas info" in ln and ("Used" in ln
                                                 or "Compiling" in ln)]
            phase(f"phase 2: built {name}{' of ' + label if label else ''}"
                  ": " + " | ".join(report))

    tile_err = tile_vs_plain(device)
    dense_err = max(dense_vs_plain(device), texel_dense_vs_plain(device))
    clip_err = clipped_vs_plain(device)
    tile_err, dense_err = max(tile_err, clip_err), max(dense_err, clip_err)

    with tempfile.TemporaryDirectory() as workdir:
        large = main_path("large", device, workdir)
        scannet = main_path("scannet", device, workdir)
        texel_setup_check(device)
        texels = {name: texel_main_path(name, device, workdir)
                  for name in ("texels", "texels01")}
        scannet_lens = distorted_scannet(device, workdir)
    default_texels = texel_tile_check(device)
    dense_ctx = dense_preset(device)
    large_lens = distorted_large(device)
    texel_lens = distorted_texels(device)
    grid_card_vs_cpu(device, card)
    with tempfile.TemporaryDirectory() as workdir:
        indoor = {name: indoor_main_path(name, device, workdir)
                  for name in ("scannet", "large")}
    indoor["texels01"] = indoor_texels01(device)
    indoor_lens = indoor_scannet_lens(device)

    tile_times("default", device, card, against)
    tile_row = tile_times("large", device, card, against)
    dense_row = dense_times(scannet, device, card, against)
    dense_kernel_row("default forced dense",
                     [a for a, _ in dense_inputs("default", device,
                                                 "dense")[1]],
                     against, card)
    large_times(large, device, card)
    batch_throughput("large", large, device, card)
    batch_throughput("scannet", scannet, device, card)
    by_path = {
        "raster_tile": {"large": large["launches"],
                        "default texels": default_texels["raster_tile"]},
        "raster_dense": {"scannet": scannet["launches"],
                         "dense": dense_ctx["launches"]["raster_dense"]}}
    for name, ctx in texels.items():
        for kernel, n in ctx["launches"].items():
            by_path[kernel][name] = n
    by_path["raster_dense"]["scannet + SIMPLE_RADIAL"] = \
        scannet_lens["launches"]["raster_dense"]
    by_path["raster_tile"]["large + lenses"] = \
        large_lens["launches"]["raster_tile"]
    by_path["raster_tile"]["default texels + lenses"] = \
        texel_lens["tile"]["launches"]["raster_tile"]
    by_path["raster_dense"]["default texels + lenses, forced dense"] = \
        texel_lens["dense"]["launches"]["raster_dense"]
    for name, ctx in indoor.items():
        kernel = "raster_tile" if name == "large" else "raster_dense"
        by_path[kernel][f"{name} indoor + clip"] = ctx["launches"][kernel]
    by_path["raster_dense"]["scannet indoor + clip + SIMPLE_RADIAL"] = \
        indoor_lens["launches"]["raster_dense"]
    del large, scannet
    batch_throughput("dense", dense_ctx, device, card)
    del dense_ctx
    for name, ctx in texels.items():
        texel_times(name, ctx, device, card)
        batch_throughput(name, ctx, device, card)
    del texels
    lens_times(large_lens, scannet_lens, device, card)
    batch_throughput("scannet", scannet_lens, device, card,
                     "scannet + SIMPLE_RADIAL")
    batches_in_turns("scannet", scannet_lens["pinhole_batch"],
                     "scannet + SIMPLE_RADIAL", scannet_lens["batch"], card)
    batch_throughput("large", large_lens, device, card, "large + lenses")
    batch_throughput("default", texel_lens["tile"], device, card,
                     "default texels + lenses")
    del scannet_lens, large_lens, texel_lens
    for name, ctx in indoor.items():
        batch_throughput(name, ctx, device, card, f"{name} indoor + clip")
    batches_in_turns("scannet indoor, culled", indoor["scannet"]["cull_batch"],
                     "scannet indoor + clip", indoor["scannet"]["batch"],
                     card)
    clip_times(indoor["scannet"], device, card)
    tile_indoor = tile_times("large", device, card, against, clip=True)
    ctx = indoor["scannet"]
    fv = face_vertices(ctx["vertices"], ctx["faces"], device)
    dense_indoor = dense_kernel_row(
        "scannet indoor + clip",
        [dense_view_inputs(fv, cam, ctx["plan"].dense_e_cap, device,
                           clip_near=True)[0] for cam in ctx["cams"]],
        against, card)
    del indoor, ctx, fv

    def indoor_row(path, row):
        keys = ("ms", "launched_ms", "plain_ms", "bound_ms", "bound_by",
                "heaviest_tile_ms", "culled_share")
        return {"indoor": {"path": path,
                           **{k: row[k] for k in keys if k in row}}}

    kernels = [{
        "name": "raster_tile",
        "route": "cuda",
        "source": "semantic_meshes_torch/csrc/raster_tile.cu",
        "replaces": "semantic_meshes/rasterize/pallas_kernel.py:92",
        "launches": by_path["raster_tile"]["large"],
        "launches_by_path": by_path["raster_tile"],
        "max_abs_err": tile_err,
        **tile_row,
        # no single PyTorch call rasterizes triangles
        "library_ms": None,
        **indoor_row("large indoor + clip", tile_indoor),
    }, {
        "name": "raster_dense",
        "route": "cuda",
        "source": "semantic_meshes_torch/csrc/raster_dense.cu",
        "replaces": "semantic_meshes/rasterize/dense.py:530",
        "launches": by_path["raster_dense"]["scannet"],
        "launches_by_path": by_path["raster_dense"],
        "max_abs_err": dense_err,
        **dense_row,
        "library_ms": None,
        **indoor_row("scannet indoor + clip", dense_indoor),
    }]
    phase(f"done in {time.monotonic() - t0:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
