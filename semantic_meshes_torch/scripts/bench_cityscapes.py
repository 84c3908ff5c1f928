"""Port of scripts/bench_cityscapes.py: end-to-end timing of the Cityscapes
demo (the colorize_cityscapes_mesh module) at Cityscapes size.

    python -m semantic_meshes_torch.scripts.bench_cityscapes [--views 20]
        [--subdivisions 64] [--width 2048] [--height 1024]
        [--aggregator sum] [--leg probs|unet] [--probs_store f16|u8|topkK]
        [--probs_dtype f32|f16|u8] [--timings] [--chunk N]
        [--cam_model PINHOLE|SIMPLE_RADIAL|OPENCV_FISHEYE|THIN_PRISM_FISHEYE]
        [--keep DIR] [--device cuda|cpu]

Builds a synthetic scene (cube mesh, ring cameras in a COLMAP text
workspace, one random RGB PNG per view, and for the probs leg 19-class
probability maps made on `--device` from per-view seeds and saved from
pinned memory) and times `python -m
semantic_meshes_torch.scripts.colorize_cityscapes_mesh` over it in a
subprocess on `--device` (default "cuda"; raises without a card): the
whole demo, process start, PLY and COLMAP parsing, per-image PNG and map
IO, render, fusion and the PLY write. `--leg unet` runs the bundled UNet
on the PNGs instead. Prints one JSON line, `cityscapes_demo_s_per_image`
(wall / views) with its detail: the one-time seconds and the steady
s/image (median x calls of the frame-loop phases, from the demo's
--timings_json). The reference reports ~2 s/image for its demo with its
PSPNet on an RTX 6000 (its README); `vs_reference_2s` is 2 over this
run's s/image.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# lens parameters per COLMAP model for the distorted workspaces;
# SIMPLE_RADIAL is COLMAP's default output model
CAM_DISTORTION = {
    "PINHOLE": None,
    "SIMPLE_RADIAL": [0.08, 0, 0, 0],
    "OPENCV_FISHEYE": [0.03, -0.011, 0.002, -0.0005, 0, 0, 0, 0, 1.0],
    "THIN_PRISM_FISHEYE": [0.03, -0.011, 0.002, -0.0015, 0.0008,
                           -0.0002, 0.001, -0.0007, 3.0],
}
CLASSES = 19
LOOP_PHASES = ("wait prefetch", "fuse chunk (render+fuse scan)", "render",
               "fuse")


def write_workspace(root, *, views, width, height, cam_model):
    """(Re)write the COLMAP text workspace root/ws (cheap, so a reused
    --keep scene takes the camera model asked for). The quaternions are
    taken in every branch: the JAX bench's w-only formula divides by
    w = 0 for the ring's camera turned by 180 degrees (view 16 of 20)."""
    from .. import testing
    from ..io import colmap as cio
    from .run_colmap_on_scannet import rotation_to_quaternion

    cams = testing.make_ring_cameras(num_views=views, width=width,
                                     height=height)
    ws = os.path.join(root, "ws")
    os.makedirs(ws, exist_ok=True)
    dist = CAM_DISTORTION[cam_model]
    cameras = {1: cio.ColmapCamera(
        1, cam_model, width, height,
        np.array([0.9 * height, 0.9 * height]),
        np.array([width / 2, height / 2]),
        None if dist is None else np.asarray(dist, np.float64),
    )}
    images = {
        i: cio.ColmapImage(
            i, rotation_to_quaternion(c.rotation),
            np.asarray(c.translation, np.float64), 1, f"v{i:03d}.png")
        for i, c in enumerate(cams, 1)
    }
    cio.write_cameras_txt(os.path.join(ws, "cameras.txt"), cameras)
    cio.write_images_txt(os.path.join(ws, "images.txt"), images)


def build_scene(root, *, views, subdivisions, width, height):
    """Cube mesh root/mesh.ply and one random RGB PNG per view (the same
    image, written once and copied) under root/images. Returns the face
    count."""
    from .. import testing
    from ..io.image import imwrite
    from ..io.ply import write_mesh

    os.makedirs(root, exist_ok=True)
    vertices, faces = testing.make_cube(subdivisions)
    write_mesh(os.path.join(root, "mesh.ply"), vertices, faces)
    imgdir = os.path.join(root, "images")
    os.makedirs(imgdir, exist_ok=True)
    rng = np.random.default_rng(0)
    first = os.path.join(imgdir, "v001.png")
    imwrite(first, rng.integers(0, 255, (height, width, 3), np.uint8))
    for i in range(2, views + 1):
        shutil.copyfile(first, os.path.join(imgdir, f"v{i:03d}.png"))
    return len(faces)


def ensure_probs(root, store, *, views, width, height, classes=CLASSES,
                 device="cuda"):
    """The maps of every view in one store format (f16, u8, or topk<K>:
    u8 values and indices) under root/probs-<store>/, made on `device` and
    saved from pinned host memory; an existing store is reused. View i's
    map is the softmax of 2 N(0, 1) logits from seed 1000 + i (peaked
    distributions, as a model emits), the same float32 map in every
    format."""
    import torch

    from ..data import resolve_device
    from ..probs_io import quantize_u8
    from .precompute_probs import top_k

    device = resolve_device(device)
    probsdir = os.path.join(root, f"probs-{store}")
    marker = os.path.join(
        probsdir,
        f"v{views:03d}" + (".npz" if store.startswith("topk") else ".npy"))
    if os.path.exists(marker):
        return probsdir
    os.makedirs(probsdir, exist_ok=True)
    k = int(store[4:]) if store.startswith("topk") else None
    dtype = torch.float16 if store == "f16" else torch.float32
    host = torch.empty((height, width, classes), dtype=dtype,
                       pin_memory=device.type == "cuda")
    for i in range(1, views + 1):
        gen = torch.Generator(device=device).manual_seed(1000 + i)
        probs = torch.softmax(2.0 * torch.randn(
            (height, width, classes), generator=gen, device=device), dim=-1)
        if store == "u8":
            probs = torch.round(probs * 255.0)
        host.copy_(probs.to(dtype))
        base = os.path.join(probsdir, f"v{i:03d}")
        if k is not None:
            vals, idx = top_k(host.numpy(), k)
            np.savez(base + ".npz", values=quantize_u8(vals), indices=idx,
                     classes=np.int32(classes))
        elif store == "u8":
            np.save(base + ".npy", host.numpy().astype(np.uint8))
        else:
            np.save(base + ".npy", host.numpy())
    del host
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return probsdir


def steady_detail(phases, wall, views):
    """One-time and steady-state split of the demo's phase timings: the
    frame loop's median call x calls is the steady cost; the rest of the
    wall clock is one-time."""
    first_call_s = sum(
        max(0.0, p["total_s"] - p["median_s"] * p["calls"])
        for name, p in phases.items() if name != "device acquire")
    steady_s = sum(phases[n]["median_s"] * phases[n]["calls"]
                   for n in LOOP_PHASES if n in phases)
    return {
        "device_acquire_s": round(
            phases.get("device acquire", {}).get("total_s", 0.0), 1),
        "first_call_overhead_s": round(first_call_s, 1),
        "one_time_s": round(max(0.0, wall - steady_s), 1),
        "steady_s_per_image": round(steady_s / views, 3),
        "phases": phases,
    }


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--views", type=int, default=20)
    ap.add_argument("--subdivisions", type=int, default=64)
    ap.add_argument("--width", type=int, default=2048)
    ap.add_argument("--height", type=int, default=1024)
    ap.add_argument("--aggregator", default="sum")
    ap.add_argument("--leg", default="probs", choices=["probs", "unet"],
                    help="probs: fuse precomputed maps from disk (pays the "
                    "map read and upload); unet: the bundled UNet on the "
                    "PNGs on the device")
    ap.add_argument("--probs_store", default="f16",
                    help="probs leg: on-disk format, f16, u8 or topk<K>")
    ap.add_argument("--probs_dtype", default=None,
                    choices=["f32", "f16", "u8"],
                    help="probs leg: wire dtype for dense maps (default: "
                    "the store's own; top-k stores ship as stored)")
    ap.add_argument("--timings", action="store_true",
                    help="pass --timings to the demo and echo its "
                    "per-phase breakdown on stderr")
    ap.add_argument("--chunk", type=int, default=0,
                    help="pass through to the demo: views per batched "
                    "render+fuse call (0 = auto, 1 = per-view)")
    ap.add_argument("--cam_model", default="PINHOLE",
                    choices=sorted(CAM_DISTORTION),
                    help="COLMAP camera model of the workspace")
    ap.add_argument("--keep", help="scene directory (reused if populated)")
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device of the demo and of the map "
                    "generation (cuda, or cpu)")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from ..data import resolve_device

    resolve_device(args.device)
    root = args.keep or tempfile.mkdtemp(prefix="sm_cityscapes_")
    marker = os.path.join(root, "images", f"v{args.views:03d}.png")
    t0 = time.time()
    if not os.path.exists(marker):
        faces = build_scene(root, views=args.views,
                            subdivisions=args.subdivisions,
                            width=args.width, height=args.height)
    else:
        faces = 12 * args.subdivisions**2
    write_workspace(root, views=args.views, width=args.width,
                    height=args.height, cam_model=args.cam_model)
    cmd = [sys.executable, "-m",
           "semantic_meshes_torch.scripts.colorize_cityscapes_mesh",
           "--colmap", os.path.join(root, "ws"),
           "--input_ply", os.path.join(root, "mesh.ply"),
           "--images", os.path.join(root, "images"),
           "--output_ply", os.path.join(root, "colorized.ply"),
           "--aggregator", args.aggregator, "--device", args.device]
    if args.leg == "probs":
        wire = args.probs_dtype or ("u8" if args.probs_store == "u8"
                                    else "f16")
        probsdir = ensure_probs(root, args.probs_store, views=args.views,
                                width=args.width, height=args.height,
                                device=args.device)
        cmd += ["--probs", probsdir, "--probs_dtype", wire]
        if args.probs_store.startswith("topk"):
            wire_mb = args.width * args.height * int(args.probs_store[4:]) \
                * 2 / 1e6
        else:
            wire_mb = (args.width * args.height * CLASSES
                       * {"f32": 4, "f16": 2, "u8": 1}[wire] / 1e6)
        detail = {"probs_store": args.probs_store, "probs_dtype": wire,
                  "probs_wire_mb_per_image": round(wire_mb, 1)}
    else:
        cmd += ["--model", "jax-unet"]
        detail = {"image_wire_mb_per_image": round(
            args.width * args.height * 3 / 1e6, 1)}
    if args.timings:
        cmd.append("--timings")
    if args.chunk:
        cmd += ["--chunk", str(args.chunk)]
    timings_json = os.path.join(root, "phase_timings.json")
    if os.path.exists(timings_json):
        os.remove(timings_json)
    cmd += ["--timings_json", timings_json]
    build_s = time.time() - t0

    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (ROOT, env.get("PYTHONPATH")) if p)
    t0 = time.time()
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True)
    wall = time.time() - t0
    if proc.returncode != 0:
        sys.stderr.write(proc.stdout + proc.stderr)
        sys.exit(1)
    if not os.path.exists(os.path.join(root, "colorized.ply")):
        sys.stderr.write("no output PLY\n")
        sys.exit(1)
    if args.timings:
        sys.stderr.write(proc.stdout[proc.stdout.find("phase timings:"):]
                         + "\n")
    phase_detail = {}
    if os.path.exists(timings_json):
        with open(timings_json) as f:
            phase_detail = steady_detail(json.load(f), wall, args.views)

    print(json.dumps({
        "metric": "cityscapes_demo_s_per_image",
        "value": round(wall / args.views, 3),
        "unit": "s/image (end-to-end incl. process start + IO)",
        "vs_reference_2s": round(2.0 / (wall / args.views), 1),
        "detail": {
            "leg": args.leg,
            "cam_model": args.cam_model,
            "views": args.views,
            "resolution": [args.width, args.height],
            "triangles": faces,
            "total_wall_s": round(wall, 1),
            "scene_build_s": round(build_s, 1),
            "chunk": args.chunk,
            "device": args.device,
            **detail,
            **phase_detail,
            "scene_dir": root,
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
