"""The port's benchmark: rasterize + fuse throughput (MPix/s) on one card.

    python -m semantic_meshes_torch.bench [--preset NAME] [--repeats N]
        [--no-extra] [--budget SECONDS] [--device cuda|cpu]

Counterpart of the repository's `bench.py`, with its CLI and its JSON
lines: the headline `rasterize_fuse_throughput` line right after the
preset's measurement, then on the `default` preset one re-print per
sub-preset of SUB_PRESETS (in that order; the headline fields unchanged,
`detail` grown by that sub-preset), each sub-preset isolated (a failure
lands in `detail["skipped"]`) and the tail cut by the wall-clock budget
(`--budget`, default SM_BENCH_BUDGET_S or 1500 s, counted from the
import of this module). `--preset e2e` prints one `e2e_image_time` line.

What is timed is the public batched pipeline, as bench.py times it: one
`distributed.plan_fuse` per scene outside the timed region (its probes
synchronize the host), then `fuse_views_planned` (or `fuse_views_texels`
at the texel presets) over the preset's views.

The headline's definition (PERF.md section 2): `seconds_per_batch` is the
median over `--repeats` batches of the time of one batch between CUDA
events, after two warm-up batches; `value` is views x width x height /
1e6 over it. On `--device cpu` the time of one batch is the host's clock
around it (the CPU's own time). bench.py's own reading, three regions of
`--repeats` batches queued back to back with one synchronize each, stays
in `detail["region_seconds_per_batch"]`: the host queues the work, so the
two readings differ by what the card waits for the host. `vs_baseline` is
bench.py's fixed divisor (value / 10; 2000 / ms for e2e), attached to no
device. `detail["launches"]` counts each kernel's launches in the first
warm-up batch (the first batch also builds the kernels when
build/torch_kernels/ is cold, so no timed batch pays a build).

The probabilities are softmaxed normal logits made on the device from a
seed (bench.py makes them on the host with numpy; at `large` that is 1.9
GB), so making a scene costs set-up time only.

With `--device cuda` (the default) and no card, the bench prints why to
stderr and exits 2; it never runs on the CPU unless asked.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

_T0 = time.monotonic()

PRESETS = {
    # (subdivisions, views, width, height, classes)
    "small": (5, 4, 256, 192, 19),
    "default": (9, 8, 1024, 768, 19),
    "large": (16, 8, 2048, 1536, 19),
    # ScanNet-scale mesh density: 500k triangles (dense rasterizer path)
    "dense": (204, 4, 1024, 768, 19),
    # ScanNet eval frame: ~100k tris, 1296x968 color, 40 NYU classes
    "scannet": (91, 8, 1296, 968, 40),
    # the paper's texel mode at scale: 49k triangles subdivided into ~810k
    # texel primitives
    "texels": (64, 4, 1024, 768, 19),
    # texel mode at the reference's default texels_per_pixel = 0.1 on the
    # scannet preset's mesh and frames
    "texels01": (91, 8, 1296, 968, 40),
}

# texels_per_pixel by preset (texel presets only)
TPP = {"texels": 2.0, "texels01": 0.1}

# sub-presets measured on the default run, in priority order (the budget
# cuts from the tail)
SUB_PRESETS = ("dense", "scannet", "texels", "texels01")

# bench.py's e2e preset (bench.py:317-400): the bundled UNet's softmax
# inside the batch, texels at 0.1 a pixel on the cube s=64 (49152
# triangles), 4 ring views at Cityscapes' 2048x1024, 19 classes
E2E = dict(subdivisions=64, views=4, width=2048, height=1024, classes=19,
           tpp=0.1, widths=(64, 128, 256, 512))

SEED = 0
IEW = 0.5
WARMUP = 2
# bench.py's fixed divisors: 10 MPix/s and 2000 ms/image
BASELINE_MPIX_S = 10.0
BASELINE_MS_PER_IMAGE = 2000.0


def _elapsed():
    return time.monotonic() - _T0


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="rasterize + fuse throughput of semantic_meshes_torch")
    parser.add_argument("--preset", default="default",
                        choices=list(PRESETS) + ["e2e"])
    parser.add_argument("--repeats", type=int, default=5)
    parser.add_argument("--no-extra", action="store_true",
                        help="skip the sub-preset measurements on the "
                             "default preset")
    parser.add_argument("--budget", type=float, default=float(
        os.environ.get("SM_BENCH_BUDGET_S", "1500")),
        help="wall-clock budget in seconds (from process start); the "
             "remaining sub-presets are skipped, never the headline")
    parser.add_argument("--device", default="cuda",
                        help="torch device (cuda, or cpu)")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if (torch.device(args.device).type == "cuda"
            and not torch.cuda.is_available()):
        print("semantic_meshes_torch.bench: --device cuda but "
              "torch.cuda.is_available() is False; not benchmarking (pass "
              "--device cpu for the CPU)", file=sys.stderr)
        sys.exit(2)

    if args.preset == "e2e":
        return bench_e2e(args.repeats, args.device)

    value, detail = measure_preset(args.preset, args.repeats, args.device)

    def emit():
        print(json.dumps({
            "metric": "rasterize_fuse_throughput",
            "value": value,
            "unit": "MPix/s",
            "vs_baseline": round(value / BASELINE_MPIX_S, 3),
            "detail": detail,
        }), flush=True)

    if args.preset != "default" or args.no_extra:
        emit()
        return
    # the headline first: sub-presets can only add detail after it
    emit()
    detail["skipped"] = []
    sub_repeats = max(2, args.repeats // 2)
    for i, sub in enumerate(SUB_PRESETS):
        if _elapsed() > args.budget:
            rest = list(SUB_PRESETS[i:])
            detail["skipped"] += rest
            print(f"# budget exhausted ({_elapsed():.0f}s > "
                  f"{args.budget:.0f}s): skipping {rest}",
                  file=sys.stderr, flush=True)
            emit()  # the last line records the skips
            break
        try:
            sub_value, sub_detail = measure_preset(sub, sub_repeats,
                                                   args.device)
        except Exception as e:  # noqa: BLE001 — each sub-preset isolated
            detail["skipped"].append(sub)
            print(f"# sub-preset {sub} failed: {e!r}", file=sys.stderr,
                  flush=True)
            emit()  # record the skip even when it is the last sub-preset
            continue
        finally:
            _free(args.device)
        detail[f"{sub}_MPix_s"] = sub_value
        detail[f"{sub}_overflow"] = sub_detail["overflow"]
        detail[f"{sub}_seconds_per_batch"] = sub_detail["seconds_per_batch"]
        detail[f"{sub}_launches"] = sub_detail["launches"]
        emit()  # re-print with the grown detail (headline unchanged)


def _free(device):
    """Hand a preset's freed tensors back to the card before the next."""
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def device_label(device):
    """The card's name and power limit as nvidia-smi reports them, or
    "cpu"."""
    device = torch.device(device)
    if device.type != "cuda":
        return "cpu"
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", str(index)],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def device_probs(views, height, width, classes, device):
    """(N, H, W, C) softmax probabilities of normal logits, made on
    `device` from SEED."""
    gen = torch.Generator(device=device).manual_seed(SEED)
    logits = torch.randn((views, height, width, classes), generator=gen,
                         device=device)
    return torch.softmax(logits, dim=-1)


def counted(fn, device):
    """fn() with every launch counter set to 0 just before it and read
    just after: (result, launches per kernel)."""
    from .rasterize import dense_kernel, tile_kernel

    _sync(device)
    tile_kernel.launches = dense_kernel.launches = 0
    out = fn()
    _sync(device)
    return out, {"raster_tile": tile_kernel.launches,
                 "raster_dense": dense_kernel.launches}


def _texel_renderer(vertices, faces, cams, tpp, device, **kwargs):
    from . import render
    from .data import Ply
    from .io.ply import write_mesh

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "m.ply")
        write_mesh(path, vertices, faces)
        return render.texels(Ply(path), cams, tpp, device=device, **kwargs)


def measure_preset(preset, repeats, device="cuda"):
    """(value, detail) of one preset: the scene as bench.py builds it, one
    plan outside the timed region, then the batches. See the module's
    docstring for the definitions."""
    from . import distributed, testing
    from .data import resolve_device, stack_cameras
    from .profiling import times_ms

    device = resolve_device(device)
    sub, n_views, width, height, classes = PRESETS[preset]
    vertices, faces = testing.make_cube(subdivisions=sub)
    cams = testing.make_ring_cameras(num_views=n_views, width=width,
                                     height=height)
    probs = device_probs(n_views, height, width, classes, device)
    host_cams = stack_cameras(cams)
    cam_arrays = [torch.as_tensor(a, dtype=torch.float32, device=device)
                  for a in host_cams]

    texel_params = None
    num_primitives = len(faces)
    if preset in TPP:
        renderer = _texel_renderer(vertices, faces, cams, TPP[preset],
                                   device)
        vertices, faces = renderer.vertices, renderer.faces  # reordered
        texel_params = (renderer.resolutions, renderer.first_texel_index)
        num_primitives = renderer.getPrimitivesNum()
        del renderer

    # one plan per scene, as bench.py:250-254: the texel tables are per
    # face, so texel plans never split; SM_MICRO_SPLIT=0 opts the split
    # out for A/Bs
    plan = distributed.plan_fuse(
        vertices, faces, *host_cams, height=height, width=width,
        allow_split=(texel_params is None
                     and os.environ.get("SM_MICRO_SPLIT", "1") == "1"),
        device=device)
    if plan.dense_e_cap is not None:
        print(f"# plan: dense_e_cap={plan.dense_e_cap} "
              f"split_k={plan.split_k} micro_max={plan.micro_max}",
              file=sys.stderr, flush=True)
    vertices = torch.as_tensor(vertices, dtype=torch.float32, device=device)
    kw = dict(num_primitives=num_primitives, aggregator="sum",
              height=height, width=width, device=device)

    def run_batch():
        if texel_params is not None:
            return distributed.fuse_views_texels(
                vertices, plan.faces, *texel_params, *cam_arrays, probs, IEW,
                dense_e_cap=plan.dense_e_cap, **kw)
        return distributed.fuse_views_planned(plan, vertices, *cam_arrays,
                                              probs, IEW, **kw)

    t = time.perf_counter()
    (_, overflow), launches = counted(run_batch, device)
    first_batch_s = time.perf_counter() - t
    batch_ms = times_ms(run_batch, repeats, device, warmup=WARMUP - 1)
    dt = statistics.median(batch_ms) / 1e3

    # bench.py's reading: `repeats` batches queued back to back, one
    # synchronize, three regions
    region_dts = []
    for _ in range(3):
        t = time.perf_counter()
        for _ in range(repeats):
            _, overflow = run_batch()
        _sync(device)
        region_dts.append((time.perf_counter() - t) / repeats)

    mpix = n_views * width * height / 1e6
    return round(mpix / dt, 3), {
        "region_seconds_per_batch": region_dts,
        "preset": preset,
        "triangles": int(len(faces)),
        "primitives": int(num_primitives),
        "views": n_views,
        "resolution": [width, height],
        "classes": classes,
        "seconds_per_batch": dt,
        "batch_ms": batch_ms,
        "first_batch_seconds": first_batch_s,
        "split_k": int(plan.split_k),
        "micro_max": plan.micro_max,
        # dropped candidate pairs and micro rows of the last batch;
        # nonzero means less than the full mesh was rendered: never
        # accept a throughput with overflow > 0
        "overflow": int(overflow),
        "launches": launches,
        "device": device_label(device),
    }


def bench_e2e(repeats, device="cuda"):
    """bench.py's e2e preset on the port (E2E): texels rendered, the
    bundled UNet's softmax as fuse_views_texels' predict_fn on uint8 views
    from SEED, sum fusion, under torch.inference_mode(). Prints one
    `e2e_image_time` line: the minimum over max(repeats, 3) batches, each
    timed between CUDA events after two warm-ups, over the views."""
    from . import distributed, testing
    from .data import resolve_device, stack_cameras
    from .models.segmentation import load_predictor
    from .profiling import times_ms

    device = resolve_device(device)
    W, H, C, n = E2E["width"], E2E["height"], E2E["classes"], E2E["views"]
    vertices, faces = testing.make_cube(subdivisions=E2E["subdivisions"])
    cams = testing.make_ring_cameras(num_views=n, width=W, height=H)
    renderer = _texel_renderer(vertices, faces, cams, E2E["tpp"], device,
                               bucket=True)
    P = renderer.getPrimitivesNum()
    model = load_predictor(classes=C, input_hw=(H, W), widths=E2E["widths"],
                           device=device).model
    rng = np.random.default_rng(SEED)
    imgs = torch.from_numpy(
        rng.integers(0, 255, (n, H, W, 3), np.uint8)).to(device)
    cam_arrays = [torch.as_tensor(a, dtype=torch.float32, device=device)
                  for a in stack_cameras(cams)]

    def predict_fn(img):
        x = img.to(torch.float32) / 255.0
        return torch.softmax(model(x[None])[0], dim=-1)

    @torch.inference_mode()
    def run_batch():
        return distributed.fuse_views_texels(
            renderer.vertices, renderer.faces, renderer.resolutions,
            renderer.first_texel_index, *cam_arrays, imgs, IEW,
            num_primitives=P, aggregator="sum", height=H, width=W,
            predict_fn=predict_fn, device=device)

    (_, overflow), launches = counted(run_batch, device)
    times = times_ms(run_batch, max(repeats, 3), device, warmup=WARMUP - 1)
    ms = min(times) / n
    print(json.dumps({
        "metric": "e2e_image_time",
        "value": round(ms, 3),
        "unit": "ms/image",
        "vs_baseline": round(BASELINE_MS_PER_IMAGE / ms, 2),
        "detail": {
            "preset": "e2e",
            "pipeline": "fuse_views_texels(predict_fn=softmax(UNet)) "
                        "(texels render + UNet + fuse, view by view)",
            "triangles": int(len(faces)),
            "texels": P,
            "resolution": [W, H],
            "classes": C,
            "widths": list(E2E["widths"]),
            "overflow": int(overflow),
            "batch_ms": times,
            "ms_per_image": ms,
            "launches": launches,
            "device": device_label(device),
        },
    }), flush=True)
    return ms


if __name__ == "__main__":
    main()
