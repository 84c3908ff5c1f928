#!/usr/bin/env python3
"""Chip smoke run of semantic_meshes_torch on one CUDA card (sm_90a).

    python3 chip_smoke.py

Drives the port's main paths through their public entry points, at three
of bench.py's presets (random probabilities from a seed, made on the
card), in phases; each phase prints a line and raises on failure:

1. the card's name and power limit (nvidia-smi);
2. build of both CUDA kernels from csrc/ (one nvcc per source, started
   together) and their -Xptxas -v register / shared-memory reports;
3. every kernel against its plain PyTorch version on the card: raster_tile
   on every view of `default` and `large`, raster_dense on every view of
   `scannet` and of `default` forced through the dense rasterizer (ids
   equal, depths bit-equal, overflow 0), at the budgets the main path
   probes;
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
5. times with CUDA events (medians after warm-up): each kernel and its
   plain version, the bound of each kernel's work from this run's inputs,
   the pieces of a dense view at `scannet`, the routing cost model's
   coefficients they give, one fuse_views_planned batch per preset as
   `rasterize_fuse_throughput`, and one traced batch per preset (idle
   share, top device kernels).

The line before the last is the kernel table as one JSON object; the last
line is {"ok": true, "device": {...}}. Without a CUDA card, or without the
repository beside it, the script exits non-zero and prints no result.
"""

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# (subdivisions, views, width, height, classes) as in bench.py's PRESETS
SCENES = {
    "default": (9, 8, 1024, 768, 19),
    "large": (16, 8, 2048, 1536, 19),
    "dense": (204, 4, 1024, 768, 19),
    "scannet": (91, 8, 1296, 968, 40),
}
IEW = 0.5
SEED = 0
# H100 SXM peaks (NVIDIA data sheet): non-tensor fp32 and HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_S = 3.35e12
# flops per (candidate, pixel): four affine forms a*px + b*py + c, a
# multiply and two adds each once a*px is taken out of the pixel loop (a
# thread's pixels share a column)
FLOPS_PER_TEST = 12


def phase(msg):
    print(msg, flush=True)


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


def view_inputs(fv, cam, device):
    """Setup + binning of one view for the tile kernel from device face
    vertices `fv`, as the renderer runs it: (resolve_tiles arguments,
    overflow)."""
    from semantic_meshes_torch.rasterize import tile_kernel

    return tile_kernel.resolve_inputs(None, None, *cam_args(cam),
                                      face_vertices=fv, device=device,
                                      **cam_kw(cam))


def dense_budget(vertices, faces, cams, device, backend=None):
    """The dense budget tuple the renderer probes for this camera set."""
    import semantic_meshes_torch as smt
    from types import SimpleNamespace

    r = smt.render.TrianglesRenderer(
        SimpleNamespace(vertices=vertices, faces=faces), backend=backend,
        device=device)
    r.prepare(cams)
    return r.dense_cap_policy._cap[(cams[0].resolution[1],
                                    cams[0].resolution[0])]


def dense_view_inputs(fv, cam, cap, device):
    """Everything of one dense view before the kernel, at budget `cap`:
    (resolve_dense arguments, micro key, overflow)."""
    from semantic_meshes_torch import rasterize as rast

    return rast.dense.resolve_inputs(None, None, *cam_args(cam),
                                     face_vertices=fv, device=device,
                                     **cam_kw(cam),
                                     **rast.dense_kwargs(cap))


def cuda_time_ms(fn, reps, warmup=2):
    """Median over `reps` of fn()'s device time in ms (CUDA events)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


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
    """Phase 3, raster_tile at `default` and `large`."""
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
    return max_err


def dense_vs_plain(device):
    """Phase 3, raster_dense at `scannet` (auto dispatch) and at `default`
    forced dense, at the budgets the renderer probes."""
    from semantic_meshes_torch.rasterize import dense_kernel

    max_err = 0.0
    for name, backend in (("scannet", None), ("default", "dense")):
        vertices, faces, cams = scene(name)
        fv = face_vertices(vertices, faces, device)
        cap = dense_budget(vertices, faces, cams, device, backend)
        shapes = []
        for k, cam in enumerate(cams):
            args, _, overflow = dense_view_inputs(fv, cam, cap, device)
            if args is None:
                raise AssertionError(f"{name}: zero pair budget {cap}")
            zk, ik = dense_kernel.resolve_dense_cuda(*args)
            zp, ip = dense_kernel.resolve_dense_plain(*args)
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
        phase(f"phase 3: raster_dense == plain at {name} (budget {cap}): "
              f"{len(cams)} views, ids equal, depths bit-equal, overflow 0; "
              f"(global bucket, heaviest own range) per view {shapes}")
    return max_err


def reset_launches():
    from semantic_meshes_torch.rasterize import dense_kernel, tile_kernel

    tile_kernel.launches = 0
    dense_kernel.launches = 0


def read_launches():
    from semantic_meshes_torch.rasterize import dense_kernel, tile_kernel

    return {"raster_tile": tile_kernel.launches,
            "raster_dense": dense_kernel.launches}


def fuse_and_save(name, mesh, rendered, probs, classes, workdir, device):
    """MeshAggregator sum/summax/mul over rendered (W, H) id images ->
    get -> palette colours -> Ply.save -> reload. Returns the sum state."""
    import semantic_meshes_torch as smt

    T = len(mesh.faces)
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
        out_path = os.path.join(workdir, f"{name}_{agg_name}.ply")
        mesh.save(out_path, colors)
        back = smt.io.ply.read_ply(out_path)["face"].data
        got = np.stack([back["red"], back["green"], back["blue"]], -1)
        if not np.array_equal(got, colors) or not np.array_equal(
                smt.data.Ply(out_path).faces, mesh.faces):
            raise AssertionError(f"{name} {agg_name}: PLY round trip differs")
    return fused


def planned_twice(name, plan, vertices, cams, probs, classes, device):
    """Two fuse_views_planned batches; both overflow 0 and bit-identical."""
    import semantic_meshes_torch as smt

    _, n_views, width, height, _ = SCENES[name]
    rot, trans, fl, pp = smt.data.stack_cameras(cams)
    runs = []
    for _ in range(2):
        acc, ov = smt.distributed.fuse_views_planned(
            plan, vertices, rot, trans, fl, pp, probs, IEW,
            num_primitives=len(plan.faces), aggregator="sum", height=height,
            width=width, device=device)
        if int(ov) != 0:
            raise AssertionError(f"{name}: fuse_views_planned overflow "
                                 f"{int(ov)}")
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


def bound(ops, nbytes):
    ops_ms = ops / PEAK_FP32_FLOPS * 1e3
    bytes_ms = nbytes / PEAK_BYTES_S * 1e3
    return (max(ops_ms, bytes_ms), "operations" if ops_ms >= bytes_ms
            else "bytes", ops_ms, bytes_ms)


def tile_times(name, device, card):
    """raster_tile and its plain version at scene `name`: ms per view (CUDA
    events, median over repetitions of all views back to back), with the
    bound of one view's work computed from this run's inputs."""
    from semantic_meshes_torch.rasterize import tile_kernel

    vertices, faces, cams = scene(name)
    n_views = len(cams)
    width, height = cams[0].resolution
    fv = face_vertices(vertices, faces, device)
    inputs = [view_inputs(fv, cam, device)[0] for cam in cams]
    sum_counts = [int(a[2].sum()) for a in inputs]
    max_counts = [int(a[2].max()) for a in inputs]

    def all_views(fn):
        return lambda: [fn(*a) for a in inputs]

    kernel_ms = cuda_time_ms(all_views(tile_kernel.resolve_tiles_cuda),
                             reps=20) / n_views
    plain_ms = cuda_time_ms(all_views(tile_kernel.resolve_tiles_plain),
                            reps=5) / n_views
    # the mean view's candidate tests at the fp32 peak, against the bytes
    # it must move: the counts, the sum(counts) candidate ids the tiles
    # hold, one read of each table row those ids name, and one write of
    # the (H, W) depth + id images
    mean_counts = statistics.mean(sum_counts)
    ops = mean_counts * tile_kernel.TILE_H * tile_kernel.TILE_W * \
        FLOPS_PER_TEST
    view_bytes = []
    for table, cand, counts in (a[:3] for a in inputs):
        slot = torch.arange(cand.shape[1], device=cand.device)
        live = slot < counts[:, None]
        rows = int(torch.unique(cand[live]).numel())
        view_bytes.append(counts.numel() * 4 + int(counts.sum()) * 4
                          + rows * table.shape[1] * 4 + width * height * 8)
    bound_ms, bound_by, ops_ms, bytes_ms = bound(ops,
                                                 statistics.mean(view_bytes))
    phase(
        f"phase 5 [{card}]: {name} ({n_views} views {width}x{height}), per "
        f"view: raster_tile {kernel_ms:.6f} ms, plain {plain_ms:.6f} ms; "
        f"sum(counts) per view {sum_counts} (mean {mean_counts}), heaviest "
        f"tile per view {max_counts}, bound {bound_ms:.6f} ms ({bound_by}: "
        f"ops {ops_ms:.6f} ms, bytes {bytes_ms:.6f} ms)"
    )
    return dict(ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by)


def dense_times(ctx, device, card):
    """Per-view pieces of the dense path at `scannet`: setup + classify +
    binning + table, the micro path, raster_dense (and its plain version,
    and its bound from this run's starts), fusion. Returns the kernel's
    row and the routing cost model's coefficients these times give."""
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

    def all_views(fn):
        return lambda: [fn(*a) for a in inputs]

    kernel_ms = cuda_time_ms(all_views(dense_kernel.resolve_dense_cuda),
                             reps=20) / n_views
    plain_ms = cuda_time_ms(all_views(dense_kernel.resolve_dense_plain),
                            reps=3) / n_views
    ids = [dense_kernel.resolve_dense_cuda(*a)[1] for a in inputs]
    fusion_ms = cuda_time_ms(
        lambda: [fusion._accumulate_view(ids[k], ctx["probs"][k], None, IEW,
                                         num_primitives=T, aggregator="sum")
                 for k in range(n_views)],
        reps=10) / n_views

    # bound of the mean view from this run's starts: every tile tests the
    # first min(global, n_global) global ids and its own range, each at
    # 2048 pixels x 12 flops; the bytes are one read of the starts, of the
    # ids read (the global ids once, the own ranges once), of each table
    # row they name and of the micro key image, and one write of the
    # 8-byte-per-pixel image
    tests, view_bytes, pairs = [], [], []
    for table, sorted_ids, starts, n_global, key, *_ in inputs:
        s = starts.long()
        B = s.numel() - 2
        g = min(int(s[B + 1] - s[B]), n_global)
        own = int(s[B] - s[0]) if B else 0
        tests.append(B * g + own)
        pairs.append(int(s[B + 1] - s[0]))
        rows = torch.cat([sorted_ids[int(s[B]):int(s[B]) + g],
                          sorted_ids[:int(s[B])]])
        view_bytes.append((B + 2) * 4 + (g + own) * 4
                          + int(torch.unique(rows).numel()) * 64
                          + key.numel() * 8 + width * height * 8)
    ops = statistics.mean(tests) * dense.TILE_H * dense.TILE_W * \
        FLOPS_PER_TEST
    bound_ms, bound_by, ops_ms, bytes_ms = bound(ops,
                                                 statistics.mean(view_bytes))
    frag_rows = micro_max * micro_max * micro_cap
    coeffs = dict(alpha=kernel_ms * 1e6 / statistics.mean(pairs),
                  beta=micro_ms * 1e6 / frag_rows,
                  gamma=bin_ms * 1e6 / (dense.K_SPAN * T))
    phase(
        f"phase 5 [{card}]: scannet ({n_views} views {width}x{height}, {T} "
        f"triangles, budget {cap}), per view: setup {setup_ms:.6f} ms, "
        f"classify + sort binning + table {bin_ms:.6f} ms, micro path "
        f"{micro_ms:.6f} ms ({frag_rows} fragment rows), raster_dense "
        f"{kernel_ms:.6f} ms, plain {plain_ms:.6f} ms, fusion (sum, "
        f"{classes} classes) {fusion_ms:.6f} ms; pairs per view {pairs}, "
        f"candidate tests per view {tests}, bound {bound_ms:.6f} ms "
        f"({bound_by}: ops {ops_ms:.6f} ms, bytes {bytes_ms:.6f} ms)"
    )
    phase(
        f"phase 5 [{card}]: routing cost model at scannet, ns: alpha "
        f"(raster_dense per pair) {coeffs['alpha']:.6f}, beta (micro path "
        f"per fragment row) {coeffs['beta']:.6f}, gamma (classify + binning "
        f"per sort row) {coeffs['gamma']:.6f}; in use: alpha "
        f"{dense.ROUTE_ALPHA}, beta {dense.ROUTE_BETA}, gamma "
        f"{dense.ROUTE_GAMMA}"
    )
    return dict(ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by)


def device_busy(label, fn, batch_ms, card):
    """One traced batch: the device's busy time (sum of the kernels' own
    device times, from torch.profiler), its share of the untraced batch
    time, and the kernels that take the most. Diagnostic only: a profiler
    that sees no device time reports "not measured"."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    try:
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
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
        events = [e for e in prof.key_averages()
                  if getattr(e, "device_type", None) is not None
                  and "CUDA" in str(e.device_type)]
    except RuntimeError as e:
        phase(f"phase 5 [{card}]: {label} device busy share: not measured "
              f"({e})")
        return
    if not events:
        phase(f"phase 5 [{card}]: {label} device busy share: not measured "
              "(the profiler saw no device time)")
        return
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:8]
    phase(
        f"phase 5 [{card}]: {label}, one traced fuse_views_planned batch: "
        f"device busy {busy_ms:.6f} ms of the untraced {batch_ms:.6f} ms "
        f"(idle share {1 - busy_ms / batch_ms:.6f}); top device time: "
        + "; ".join(f"{e.key[:60]} {e.self_device_time_total / 1e3:.6f} ms "
                    f"x{e.count}" for e in top)
    )


def batch_throughput(name, ctx, device, card):
    """rasterize_fuse_throughput of one fuse_views_planned batch, and one
    traced batch."""
    import semantic_meshes_torch as smt

    _, n_views, width, height, classes = SCENES[name]
    T = len(ctx["faces"])

    def fused_batch():
        return smt.distributed.fuse_views_planned(
            ctx["plan"], ctx["vertices"], ctx["rot"], ctx["trans"],
            ctx["fl"], ctx["pp"], ctx["probs"], IEW, num_primitives=T,
            aggregator="sum", height=height, width=width, device=device)

    batch_ms = cuda_time_ms(fused_batch, reps=5)
    mpix_s = n_views * width * height / 1e6 / (batch_ms / 1e3)
    phase(f"phase 5 [{card}]: {name}, fuse_views_planned batch "
          f"{batch_ms:.6f} ms for {n_views} views")
    device_busy(name, fused_batch, batch_ms, card)
    phase(json.dumps({
        "metric": "rasterize_fuse_throughput", "value": mpix_s,
        "unit": "MPix/s", "card": card,
        "detail": {"preset": name, "views": n_views,
                   "resolution": [width, height], "triangles": T,
                   "classes": classes, "batch_ms": batch_ms,
                   "dense_e_cap": ctx["plan"].dense_e_cap},
    }))


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


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py: torch.cuda.is_available() is False; "
                 "this run needs a CUDA card")
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    try:
        from semantic_meshes_torch import _build
    except ImportError as e:
        sys.exit(f"chip_smoke.py: semantic_meshes_torch not importable "
                 f"beside this script ({e})")
    device = torch.device("cuda", 0)
    t0 = time.monotonic()

    card = card_line()
    phase(f"phase 1: card: {card}")

    _build.build("raster_tile", "raster_dense")
    for name in ("raster_tile", "raster_dense"):
        report = [ln.strip() for ln in _build.build_log(name).splitlines()
                  if "ptxas info" in ln and ("Used" in ln
                                             or "Compiling" in ln)]
        phase(f"phase 2: built {name}: " + " | ".join(report))

    tile_err = tile_vs_plain(device)
    dense_err = dense_vs_plain(device)

    with tempfile.TemporaryDirectory() as workdir:
        large = main_path("large", device, workdir)
        scannet = main_path("scannet", device, workdir)
    dense_ctx = dense_preset(device)

    tile_times("default", device, card)
    tile_row = tile_times("large", device, card)
    dense_row = dense_times(scannet, device, card)
    large_times(large, device, card)
    batch_throughput("large", large, device, card)
    batch_throughput("scannet", scannet, device, card)
    launches = {"raster_tile": large["launches"],
                "raster_dense": scannet["launches"]}
    del large, scannet
    batch_throughput("dense", dense_ctx, device, card)

    kernels = [{
        "name": "raster_tile",
        "route": "cuda",
        "source": "semantic_meshes_torch/csrc/raster_tile.cu",
        "replaces": "semantic_meshes/rasterize/pallas_kernel.py:92",
        "launches": launches["raster_tile"],
        "max_abs_err": tile_err,
        **tile_row,
        # no single PyTorch call rasterizes triangles
        "library_ms": None,
    }, {
        "name": "raster_dense",
        "route": "cuda",
        "source": "semantic_meshes_torch/csrc/raster_dense.cu",
        "replaces": "semantic_meshes/rasterize/dense.py:530",
        "launches": launches["raster_dense"],
        "max_abs_err": dense_err,
        **dense_row,
        "library_ms": None,
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
