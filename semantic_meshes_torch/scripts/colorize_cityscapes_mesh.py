"""Port of scripts/colorize_cityscapes_mesh.py: annotate a COLMAP mesh with
Cityscapes classes and save it as a colourized PLY (the flagship demo).

    python -m semantic_meshes_torch.scripts.colorize_cityscapes_mesh
        --colmap WS --input_ply MESH.ply --images DIR --output_ply OUT.ply
        [--probs DIR [--probs_dtype f32|f16|u8]]
        [--model jax-unet|tfcv] [--params FILE] [--sliding H W]
        [--sliding_overlap F] [--multi_scale S ...] [--input_hw H W]
        [--widths W ...] [--aggregator sum|summax|mul] [--clip_near]
        [--chunk N] [--timings] [--timings_json FILE] [--device cuda|cpu]

Per image one of: `--probs`, a folder of precomputed (H, W, 19) `.npy`
maps or top-k `.npz` stores (probs_io.load, uploaded on `--probs_dtype`);
`--model jax-unet`, the bundled UNet (models.segmentation.load_predictor,
random weights from seed 0 unless `--params` names a flax msgpack); or
`--model tfcv`, the reference's TensorFlow PSPNet where tfcv is
installed. A prefetch thread reads and predicts the next image while the
card renders and fuses the current one. `--chunk` N > 1 (0 = auto, 4)
fuses N views at once through distributed.plan_fuse +
fuse_views_planned, a ragged tail padded with all-zero probability views
(which fail the don't-care test and add nothing); `--chunk 1` is the
per-view render -> add path. Distorted COLMAP cameras and `--clip_near`
ride both. Everything runs on `--device` (default "cuda"; raises
without a card). `--timings` prints the profiling.PhaseTimers split, a
synchronize ending each device phase; `--timings_json` writes it as
{phase: {total_s, calls, median_s}}. Dropped rasterizer candidates are
reported on stderr.
"""

from __future__ import annotations

import time

_MODULE_T0 = time.time()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from concurrent.futures import ThreadPoolExecutor  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

CLASSES = 19
DONT_CARE_THRESHOLD = 0.9


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Annotate a colmap mesh with cityscapes classes and "
        "save as colorized ply."
    )
    parser.add_argument("--colmap", type=str, required=True)
    parser.add_argument("--input_ply", type=str, required=True)
    parser.add_argument("--images", type=str, required=True,
                        help="Folder with the reconstructed images")
    parser.add_argument("--output_ply", type=str, required=True)
    parser.add_argument("--probs", type=str, default=None,
                        help="Folder with precomputed (H, W, 19) .npy prob "
                        "maps (or top-k .npz stores)")
    parser.add_argument("--probs_dtype", type=str, default="f16",
                        choices=["f32", "f16", "u8"],
                        help="With --probs: wire dtype for the host->device "
                        "upload of dense maps; fusion stays f32 on the "
                        "device; u8 quantizes to p*255")
    parser.add_argument("--model", type=str, default="jax-unet",
                        choices=["jax-unet", "tfcv"])
    parser.add_argument("--params", type=str, default=None,
                        help="flax msgpack checkpoint for the bundled model")
    parser.add_argument("--aggregator", type=str, default="sum",
                        choices=["sum", "summax", "mul"])
    parser.add_argument("--clip_near", action="store_true",
                        help="Near-plane clip instead of culling triangles "
                        "that cross z=0 (for cameras inside the scene)")
    parser.add_argument("--sliding", type=int, nargs=2, default=None,
                        metavar=("H", "W"),
                        help="Sliding-window inference window for the "
                        "bundled model (the reference demo uses 713 713); "
                        "an image's windows run as one batch")
    parser.add_argument("--sliding_overlap", type=float, default=0.2)
    parser.add_argument("--multi_scale", type=float, nargs="+", default=None,
                        help="Average predictions over these input scales "
                        "(reference demo: 0.5)")
    parser.add_argument("--input_hw", type=int, nargs=2, default=(512, 512),
                        metavar=("H", "W"),
                        help="bundled model input resolution")
    parser.add_argument("--widths", type=int, nargs="+",
                        default=(64, 128, 256, 512),
                        help="bundled model channel widths")
    parser.add_argument("--timings", action="store_true",
                        help="print a per-phase wall-clock breakdown at exit")
    parser.add_argument("--timings_json", type=str, default=None,
                        help="write the per-phase breakdown as JSON "
                        "({phase: {total_s, calls, median_s}}) to this "
                        "path at exit")
    parser.add_argument("--chunk", type=int, default=0,
                        help="views per batched render+fuse call "
                        "(distributed.fuse_views_planned); 0 = auto (4), "
                        "1 = per-view path")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device (cuda, or cpu for the plain "
                        "PyTorch path)")
    return parser.parse_args(argv)


def _process_age():
    """Seconds since this process started (Linux /proc), else since this
    module was imported."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time() - _MODULE_T0


def build_predictor(args, device):
    """predict(image, image_file) -> a dense (H, W, 19) map (tensor or
    numpy) or a probs_io.TopKProbs, for the worker thread."""
    if args.probs is not None:
        from .. import probs_io

        def predict(image, image_file):
            base = os.path.join(
                args.probs, os.path.splitext(os.path.basename(image_file))[0])
            loaded = probs_io.load(base, wire=args.probs_dtype,
                                   device=device)
            shape = (loaded.values if isinstance(loaded, probs_io.TopKProbs)
                     else loaded).shape
            if tuple(shape[:2]) != image.shape[:2]:
                raise ValueError(
                    f"{base}: probs {tuple(shape)} vs image {image.shape}")
            return loaded
        return predict
    if args.model == "tfcv":
        import tensorflow as tf
        import tfcv

        psp = tfcv.model.pretrained.vladkryvoruchko.\
            pspnet_resnet_v1s_101_cityscapes
        pre = psp.preprocess
        predictor = tfcv.predict.sliding(psp.create(), (713, 713), 0.2)
        predictor = tfcv.predict.multi_scale(predictor, [0.5])
        predictor = tf.function(predictor)

        def predict(image, image_file):
            x = np.expand_dims(pre(image), 0)
            return np.asarray(predictor(x))[0]
        return predict
    from ..models import segmentation

    model = segmentation.load_predictor(
        classes=CLASSES, params_path=args.params,
        input_hw=tuple(args.input_hw), widths=tuple(args.widths),
        sliding=tuple(args.sliding) if args.sliding else None,
        sliding_overlap=args.sliding_overlap,
        multi_scale=args.multi_scale, device=device,
    )

    def predict(image, image_file):
        return model(image)  # stays on the device
    return predict


def run(args):
    """The demo. Returns {"colors": (T, 3) uint8, "fused": (T, 19)
    float32, "overflow": int, "timers": PhaseTimers, "views": int}."""
    from .. import data, distributed, fusion, probs_io, render
    from ..data import resolve_device, stack_cameras, stack_distortions
    from ..io.image import imread
    from ..profiling import PhaseTimers
    from ..utils import CLASS_TO_COLOR

    timers = PhaseTimers()
    # everything before this line: interpreter start, imports, argparse
    timers.record("process start (imports)", _process_age())
    device = resolve_device(args.device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    @contextlib.contextmanager
    def device_phase(name):
        """A phase that ends when the card has finished its work."""
        with timers.phase(name):
            yield
            sync()

    with device_phase("device acquire"):
        # the CUDA context: created by the first operation on the card
        (torch.zeros(8, device=device) + 1.0).cpu()

    print("Loading segmentation predictor...")
    with device_phase("build predictor"):
        predict = build_predictor(args, device)

    print("Creating mesh...")
    with device_phase("setup (mesh+renderer+colmap)"):
        mesh = data.Ply(args.input_ply)
        renderer = render.triangles(mesh, clip_near=args.clip_near,
                                    device=device)
        workspace = data.Colmap(args.colmap)
        aggregator = fusion.MeshAggregator(
            primitives=renderer.getPrimitivesNum(), classes=CLASSES,
            aggregator=args.aggregator, device=device,
        )
    if device.type == "cuda":
        from .. import _build
        from ..rasterize import uses_dense

        with timers.phase("build kernels"):
            # nvcc at first use (a no-op once the library exists)
            _build.build("raster_dense" if uses_dense(
                None, renderer.getPrimitivesNum()) else "raster_tile")

    print("Annotating mesh...")
    image_files = sorted(os.path.join(args.images, f)
                         for f in os.listdir(args.images))
    if not image_files:
        sys.exit(f"no images in {args.images}")
    all_cameras = [workspace.getCamera(f) for f in image_files]

    def load_frame(image_file):
        """Read and predict one frame on the prefetch worker (the upload
        of a map is asynchronous, so it overlaps the card's work)."""
        with timers.phase("load+predict (worker)"):
            image = imread(image_file)
            return predict(image, image_file)  # (H, W, 19)

    chunk = args.chunk if args.chunk > 0 else min(4, len(image_files))
    distorted = render._has_distortion(all_cameras)

    with device_phase("prepare budgets"):
        plans = {}
        if chunk > 1:
            for cam in all_cameras:
                plans.setdefault(tuple(int(x) for x in cam.resolution),
                                 []).append(cam)
            for (w_r, h_r), group in plans.items():
                rot, trans, fl, pp = stack_cameras(group)
                plans[(w_r, h_r)] = distributed.plan_fuse(
                    renderer.vertices, renderer.faces, rot, trans, fl, pp,
                    height=h_r, width=w_r, clip_near=renderer.clip_near,
                    distortions=stack_distortions(group) if distorted
                    else None, device=device,
                )
        else:
            renderer.prepare(all_cameras)

    densify_topk = probs_io.TopKDensify(CLASSES)
    overflows = []

    def dense(pred):
        if torch.is_tensor(pred):
            return pred.to(device)
        return torch.from_numpy(np.ascontiguousarray(pred)).to(device)

    def fuse_chunk(preds, cams, n_pad):
        """Render and fuse a chunk of views in one fuse_views_planned
        call; a ragged tail is padded with its last camera and all-zero
        probabilities, which contribute nothing."""
        if n_pad:
            cams = cams + [cams[-1]] * n_pad
        rot, trans, fl, pp = stack_cameras(cams)
        dists = stack_distortions(cams) if distorted else None
        if isinstance(preds[0], probs_io.TopKProbs):
            zv = torch.zeros_like(preds[0].values)
            zi = torch.zeros_like(preds[0].indices)
            vals = torch.stack([p.values for p in preds] + [zv] * n_pad)
            idxs = torch.stack([p.indices for p in preds] + [zi] * n_pad)
            probs_arg, predict_fn = (vals, idxs), densify_topk
        else:
            arrs = [dense(p) for p in preds]
            arrs += [torch.zeros_like(arrs[0])] * n_pad
            probs_arg, predict_fn = torch.stack(arrs), probs_io.densify
        lead = probs_arg[0] if isinstance(probs_arg, tuple) else probs_arg
        height, width = int(lead.shape[1]), int(lead.shape[2])
        acc, overflow = distributed.fuse_views_planned(
            plans[(width, height)], renderer.vertices, rot, trans, fl, pp,
            probs_arg, aggregator.images_equal_weight, None,
            distortions=dists, num_primitives=renderer.getPrimitivesNum(),
            aggregator=aggregator.aggregator, height=height, width=width,
            max_tris_per_tile=renderer.max_tris_per_tile,
            clip_near=renderer.clip_near, predict_fn=predict_fn,
            device=device,
        )
        aggregator.merge(acc)
        overflows.append(overflow)  # summed once, at the end

    with ThreadPoolExecutor(max_workers=1) as pool:
        if chunk > 1:
            chunks = [image_files[i:i + chunk]
                      for i in range(0, len(image_files), chunk)]
            pending = pool.submit(lambda fs: [load_frame(f) for f in fs],
                                  chunks[0])
            for ci, files in enumerate(chunks):
                with timers.phase("wait prefetch"):
                    preds = pending.result()
                if ci + 1 < len(chunks):
                    pending = pool.submit(
                        lambda fs: [load_frame(f) for f in fs],
                        chunks[ci + 1])
                with device_phase("fuse chunk (render+fuse scan)"):
                    fuse_chunk(preds,
                               [workspace.getCamera(f) for f in files],
                               chunk - len(files))
        else:
            pending = pool.submit(load_frame, image_files[0])
            for i, image_file in enumerate(image_files):
                with timers.phase("wait prefetch"):
                    prediction = pending.result()
                if i + 1 < len(image_files):
                    pending = pool.submit(load_frame, image_files[i + 1])
                with device_phase("render"):
                    ids, _ = renderer.render(workspace.getCamera(image_file))
                with device_phase("fuse"):
                    prediction = probs_io.densify(prediction, device)
                    aggregator.add(ids, prediction.transpose(0, 1))

    dropped = int(sum(int(o) for o in overflows)) if overflows else \
        renderer.overflow_total()
    if dropped:
        print(f"WARNING: {dropped} candidate pairs dropped by the "
              "rasterizer's budgets — geometry is missing from the "
              "fusion; re-run after renderer.prepare() on these cameras",
              file=sys.stderr)

    print("Computing primitive colors...")
    with device_phase("get"):
        annotations = aggregator.get().cpu().numpy()
    without = annotations.sum(-1) < DONT_CARE_THRESHOLD
    colors = np.where(without[:, None], np.uint8(0),
                      CLASS_TO_COLOR[annotations.argmax(-1)])

    print("Saving colorized mesh...")
    with timers.phase("colorize+save ply"):
        mesh.save(args.output_ply, colors)
    if args.timings:
        print(timers.report())
    if args.timings_json:
        with open(args.timings_json, "w") as f:
            json.dump(timers.as_dict(), f)
    return {"colors": colors, "fused": annotations, "overflow": dropped,
            "timers": timers, "views": len(image_files)}


def main(argv=None):
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
