"""Port of scripts/precompute_probs.py: per-image class-probability maps
(.npy, or top-k .npz) for the fusion pipelines' --probs inputs.

    python -m semantic_meshes_torch.scripts.precompute_probs --images DIR
        --out DIR [--classes 19] [--arch unet|pspnet] [--params FILE]
        [--dtype float32|float16|uint8] [--topk K] [--device cuda|cpu]

Runs the bundled predictor (models.segmentation.load_predictor: weights
from a flax msgpack `--params`, or flax's initialisation from seed 0) on
`--device` (default "cuda"; raises without a card) and writes the files
`probs_io.load` reads, in the JAX script's layout: `<stem>.npy` (H, W, C)
in `--dtype` (uint8 stores rint(p * 255)), or with `--topk K` `<stem>.npz`
{values (H, W, K) descending in `--dtype`, indices (H, W, K) uint8,
classes}.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

IMAGE_EXTENSIONS = (".png", ".jpg", ".jpeg", ".bmp", ".tiff")


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Precompute (H, W, classes) probability maps for a "
        "folder of images"
    )
    parser.add_argument("--images", type=str, required=True)
    parser.add_argument("--out", type=str, required=True)
    parser.add_argument("--classes", type=int, default=19)
    parser.add_argument("--arch", type=str, default="unet",
                        choices=["unet", "pspnet"])
    parser.add_argument("--params", type=str, default=None,
                        help="flax msgpack checkpoint")
    parser.add_argument("--dtype", type=str, default="float16",
                        choices=["float32", "float16", "uint8"],
                        help="storage dtype for the .npy maps; uint8 stores "
                        "rint(p*255) (<=1/510 abs error per class), which "
                        "the fusion loaders dequantize on the device")
    parser.add_argument("--topk", type=int, default=None,
                        help="store only the K most probable classes per "
                        "pixel as a .npz {values, indices} instead of the "
                        "dense map (values in --dtype, indices uint8); "
                        "loaders rebuild the dense map on the device")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device (cuda, or cpu for the plain "
                        "PyTorch path)")
    return parser.parse_args(argv)


def store(probs, dtype):
    """Cast for storage; integer dtypes quantize p in [0, 1] to the full
    integer range (plain astype would truncate everything to 0)."""
    dt = np.dtype(dtype)
    if np.issubdtype(dt, np.integer):
        scale = float(np.iinfo(dt).max)
        return np.rint(probs.astype(np.float32) * scale).astype(dt)
    return probs.astype(dt)


def top_k(probs, k):
    """(values, indices uint8) of the k most probable classes per pixel,
    descending, picked as the JAX script picks them (argpartition, then a
    sort of the k)."""
    part = np.argpartition(probs, -k, axis=-1)[..., -k:]
    vals = np.take_along_axis(probs, part, axis=-1)
    order = np.argsort(-vals, axis=-1)
    idx = np.take_along_axis(part, order, axis=-1).astype(np.uint8)
    return np.take_along_axis(vals, order, axis=-1), idx


def write_probs(out, base, probs, dtype, topk=None):
    """Write one (H, W, C) float32 map as `<out>/<base>.npy`, or as a
    top-k `.npz`."""
    if topk is not None:
        if not 0 < topk <= probs.shape[-1] or probs.shape[-1] > 255:
            raise SystemExit(
                f"--topk {topk} invalid for {probs.shape[-1]} classes"
            )
        vals, idx = top_k(probs, topk)
        np.savez(os.path.join(out, base + ".npz"),
                 values=store(vals, dtype), indices=idx,
                 classes=np.int32(probs.shape[-1]))
    else:
        np.save(os.path.join(out, base + ".npy"), store(probs, dtype))


def main(argv=None):
    args = parse_args(argv)
    from ..io.image import imread
    from ..models import segmentation

    predict = segmentation.load_predictor(
        classes=args.classes, params_path=args.params, arch=args.arch,
        device=args.device,
    )
    os.makedirs(args.out, exist_ok=True)
    files = sorted(f for f in os.listdir(args.images)
                   if f.lower().endswith(IMAGE_EXTENSIONS))
    for name in files:
        image = imread(os.path.join(args.images, name))
        probs = predict(image).cpu().numpy()
        write_probs(args.out, os.path.splitext(name)[0], probs, args.dtype,
                    args.topk)
    print(f"Wrote {len(files)} probability maps to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
