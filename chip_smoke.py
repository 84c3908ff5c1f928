#!/usr/bin/env python3
"""Chip smoke run of semantic_meshes_torch on one CUDA card (sm_90a).

    python3 chip_smoke.py

Drives the port's main path (mesh -> tile-kernel rasterizer -> fusion ->
colours -> PLY) through its public entry points at the `large` scene of
bench.py (cube s=16, 3072 triangles, 8 ring views of 2048x1536, 19
classes, random probabilities from a seed), in phases; each phase prints
one line and raises on failure:

1. the card's name and power limit (nvidia-smi);
2. build of the CUDA kernel from csrc/ and its -Xptxas -v register /
   shared-memory report;
3. every kernel against its plain PyTorch version on the card, for every
   view of the `default` and `large` scenes (ids equal, depths bit-equal);
4. the main path at `large`, with every launch counter set to 0 just
   before and read just after: render -> MeshAggregator (sum, summax,
   mul) -> get -> palette colours -> Ply.save -> reload; overflow 0;
   launches == views rasterized; fuse_views_planned equals the per-view
   path; a repeated fusion is bit-identical;
5. times with CUDA events (median of >= 5 after warm-up) at `large`.

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
SCENES = {"default": (9, 8, 1024, 768, 19), "large": (16, 8, 2048, 1536, 19)}
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


def scene(name, device):
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


def view_inputs(fv, cam, device):
    """Setup + binning of one view from device face vertices `fv`, as
    the renderer runs it: (resolve_tiles arguments, overflow)."""
    from semantic_meshes_torch.rasterize import tile_kernel

    return tile_kernel.resolve_inputs(
        None, None, cam.rotation, cam.translation, cam.focal_lengths,
        cam.principal_point, face_vertices=fv, height=cam.resolution[1],
        width=cam.resolution[0], device=device,
    )


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


def kernel_vs_plain(device):
    """Phase 3: kernel == plain version for every view of both scenes.
    Returns the largest |depth difference| seen (finite pixels)."""
    from semantic_meshes_torch.rasterize import tile_kernel

    max_err = 0.0
    for name in SCENES:
        vertices, faces, cams = scene(name, device)
        fv = face_vertices(vertices, faces, device)
        for k, cam in enumerate(cams):
            args, _ = view_inputs(fv, cam, device)
            zk, ik = tile_kernel.resolve_tiles_cuda(*args)
            zp, ip = tile_kernel.resolve_tiles_plain(*args)
            torch.cuda.synchronize()
            if not torch.equal(ik, ip):
                bad = int((ik != ip).sum())
                raise AssertionError(f"{name} view {k}: {bad} ids differ")
            fin = torch.isfinite(zp)
            if not torch.equal(fin, torch.isfinite(zk)):
                raise AssertionError(f"{name} view {k}: empty masks differ")
            if not torch.equal(zk.view(torch.int32), zp.view(torch.int32)):
                err = float((zk[fin] - zp[fin]).abs().max())
                raise AssertionError(
                    f"{name} view {k}: depths not bit-equal (max |err| {err})"
                )
            max_err = max(max_err, float((zk[fin] - zp[fin]).abs().max())
                          if fin.any() else 0.0)
        phase(f"phase 3: raster_tile == plain at {name}: {len(cams)} views, "
              "ids equal, depths bit-equal")
    return max_err


def main_path(device, workdir):
    """Phase 4 at `large`, through the public API. Returns what phase 5
    reuses."""
    import semantic_meshes_torch as smt
    from semantic_meshes_torch.rasterize import tile_kernel

    sub, n_views, width, height, classes = SCENES["large"]
    vertices, faces = smt.testing.make_cube(subdivisions=sub)
    path = os.path.join(workdir, "cube.ply")
    smt.io.ply.write_mesh(path, vertices, faces)
    mesh = smt.data.Ply(path)
    cams = smt.testing.make_ring_cameras(num_views=n_views, width=width,
                                         height=height)
    probs = device_probs(n_views, height, width, classes, device)  # (N,H,W,C)
    rot, trans, fl, pp = smt.data.stack_cameras(cams)
    T = len(faces)

    tile_kernel.launches = 0
    rasterized = 0
    renderer = smt.render.triangles(mesh, device=device)
    rendered = [renderer.render(cam) for cam in cams]
    rasterized += len(cams)
    for ids, depth in rendered:
        if ids.dtype != torch.uint32 or tuple(ids.shape) != (width, height):
            raise AssertionError(f"render() gave {ids.dtype} {ids.shape}")
    overflow = renderer.overflow_total()
    if overflow != 0:
        raise AssertionError(f"overflow {overflow} at large")
    palette = smt.utils.class_palette(classes)
    fused = {}
    for agg_name in ("sum", "summax", "mul"):
        agg = smt.fusion.MeshAggregator(T, classes, agg_name, IEW,
                                        device=device)
        for k, (ids, _) in enumerate(rendered):
            agg.add(ids, probs[k].transpose(0, 1))
        out = agg.get()
        if tuple(out.shape) != (T, classes) or not torch.isfinite(out).all():
            raise AssertionError(f"{agg_name}: bad fused output")
        seen = agg.state.abs().sum(-1) > 0
        sums = out[seen].sum(-1)
        if not seen.any() or not torch.allclose(
                sums, torch.ones_like(sums), atol=1e-5):
            raise AssertionError(f"{agg_name}: rows not normalised")
        fused[agg_name] = agg.state.clone()
        colors = palette[out.argmax(-1).cpu().numpy()]
        colors[~seen.cpu().numpy()] = 0
        out_path = os.path.join(workdir, f"cube_{agg_name}.ply")
        mesh.save(out_path, colors)
        back = smt.io.ply.read_ply(out_path)["face"].data
        got = np.stack([back["red"], back["green"], back["blue"]], -1)
        if not np.array_equal(got, colors) or not np.array_equal(
                smt.data.Ply(out_path).faces, mesh.faces):
            raise AssertionError(f"{agg_name}: PLY round trip differs")

    plan = smt.distributed.plan_fuse(vertices, faces, rot, trans, fl, pp,
                                     height=height, width=width,
                                     device=device)
    runs = []
    for _ in range(2):
        acc, ov = smt.distributed.fuse_views_planned(
            plan, vertices, rot, trans, fl, pp, probs, IEW,
            num_primitives=T, aggregator="sum", height=height, width=width,
            device=device,
        )
        rasterized += n_views
        runs.append(acc)
        if int(ov) != 0:
            raise AssertionError(f"fuse_views_planned overflow {int(ov)}")
    torch.cuda.synchronize()
    launches = tile_kernel.launches
    if launches != rasterized:
        raise AssertionError(
            f"raster_tile launched {launches} times for {rasterized} views"
        )
    if not torch.allclose(runs[0], fused["sum"], rtol=1e-6, atol=0.0):
        err = float((runs[0] - fused["sum"]).abs().max())
        raise AssertionError(f"planned != per-view (max |err| {err})")
    bit_equal_paths = torch.equal(runs[0], fused["sum"])
    if not torch.equal(runs[0], runs[1]):
        raise AssertionError("repeated fusion is not bit-identical")
    phase(
        f"phase 4: main path at large ok: {n_views} views {width}x{height}, "
        f"{T} triangles, {classes} classes, sum/summax/mul fused, PLY saved "
        f"and reloaded, overflow 0, raster_tile launches {launches} == "
        f"{rasterized} views rasterized, planned == per-view (bit-equal: "
        f"{bit_equal_paths}), repeated fusion bit-identical"
    )
    return dict(vertices=vertices, faces=faces, cams=cams, probs=probs,
                plan=plan, rot=rot, trans=trans, fl=fl, pp=pp,
                launches=launches)


def resolve_times(name, device, card):
    """raster_tile and its plain version at scene `name`: ms per view (CUDA
    events, median over repetitions of all views back to back), with the
    bound of one view's work computed from this run's inputs."""
    from semantic_meshes_torch.rasterize import tile_kernel

    vertices, faces, cams = scene(name, device)
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
    # bound of the mean view, from this run's inputs: its candidate tests
    # at the fp32 peak, against the bytes it must move: the counts, the
    # sum(counts) candidate ids the tiles hold, one read of each table row
    # those ids name, and one write of the (H, W) depth + id images
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
    ops_ms = ops / PEAK_FP32_FLOPS * 1e3
    bytes_ms = statistics.mean(view_bytes) / PEAK_BYTES_S * 1e3
    bound_ms = max(ops_ms, bytes_ms)
    bound_by = "operations" if ops_ms >= bytes_ms else "bytes"
    phase(
        f"phase 5 [{card}]: {name} ({n_views} views {width}x{height}), per "
        f"view: raster_tile {kernel_ms:.6f} ms, plain {plain_ms:.6f} ms; "
        f"sum(counts) per view {sum_counts} (mean {mean_counts}), heaviest "
        f"tile per view {max_counts}, bound "
        f"{bound_ms:.6f} ms ({bound_by}: ops {ops_ms:.6f} ms, bytes "
        f"{bytes_ms:.6f} ms)"
    )
    return dict(ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by)


def device_busy(fn, batch_ms, card):
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
        phase(f"phase 5 [{card}]: device busy share: not measured ({why})")
        return
    try:
        prof.stop()
        events = [e for e in prof.key_averages()
                  if getattr(e, "device_type", None) is not None
                  and "CUDA" in str(e.device_type)]
    except RuntimeError as e:
        phase(f"phase 5 [{card}]: device busy share: not measured ({e})")
        return
    if not events:
        phase(f"phase 5 [{card}]: device busy share: not measured (the "
              "profiler saw no device time)")
        return
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:8]
    phase(
        f"phase 5 [{card}]: large, one traced fuse_views_planned batch: "
        f"device busy {busy_ms:.6f} ms of the untraced {batch_ms:.6f} ms "
        f"(idle share {1 - busy_ms / batch_ms:.6f}); top device time: "
        + "; ".join(f"{e.key[:60]} {e.self_device_time_total / 1e3:.6f} ms "
                    f"x{e.count}" for e in top)
    )


def timings(device, ctx, card):
    """Phase 5: CUDA-event times. The kernel at both scenes; setup +
    binning, fusion and the batched pipeline at `large`. Returns the
    kernel's numbers at `large`."""
    import semantic_meshes_torch as smt
    from semantic_meshes_torch import fusion
    from semantic_meshes_torch.rasterize import tile_kernel

    resolve_times("default", device, card)
    row = resolve_times("large", device, card)

    sub, n_views, width, height, classes = SCENES["large"]
    vertices, faces, cams, probs = (ctx["vertices"], ctx["faces"],
                                    ctx["cams"], ctx["probs"])
    T = len(faces)
    fv = face_vertices(vertices, faces, device)
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

    def fused_batch():
        return smt.distributed.fuse_views_planned(
            ctx["plan"], vertices, ctx["rot"], ctx["trans"], ctx["fl"],
            ctx["pp"], probs, IEW, num_primitives=T, aggregator="sum",
            height=height, width=width, device=device)

    batch_ms = cuda_time_ms(fused_batch, reps=5)
    mpix_s = n_views * width * height / 1e6 / (batch_ms / 1e3)
    phase(
        f"phase 5 [{card}]: large, per view: setup+binning {setup_ms:.6f} "
        f"ms, fusion (sum) {fusion_ms:.6f} ms, fuse_views_planned batch "
        f"{batch_ms:.6f} ms for {n_views} views"
    )
    device_busy(fused_batch, batch_ms, card)
    phase(json.dumps({
        "metric": "rasterize_fuse_throughput", "value": mpix_s,
        "unit": "MPix/s", "card": card,
        "detail": {"preset": "large", "views": n_views,
                   "resolution": [width, height], "triangles": T,
                   "classes": classes, "batch_ms": batch_ms},
    }))
    return row


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

    _build.build("raster_tile")
    report = [ln.strip() for ln in _build.build_log("raster_tile").splitlines()
              if "ptxas info" in ln and ("Used" in ln or "Compiling" in ln)]
    phase("phase 2: built raster_tile: " + " | ".join(report))

    max_err = kernel_vs_plain(device)

    with tempfile.TemporaryDirectory() as workdir:
        ctx = main_path(device, workdir)
    row = timings(device, ctx, card)

    kernels = [{
        "name": "raster_tile",
        "route": "cuda",
        "source": "semantic_meshes_torch/csrc/raster_tile.cu",
        "replaces": "semantic_meshes/rasterize/pallas_kernel.py:92",
        "launches": ctx["launches"],
        "max_abs_err": max_err,
        "ms": row["ms"],
        "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"],
        # no single PyTorch call rasterizes triangles
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
