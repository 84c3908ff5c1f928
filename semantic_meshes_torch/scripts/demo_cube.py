"""Port of scripts/demo_cube.py: a self-contained demo on the synthetic cube
scene, writing its visual artifacts.

    python -m semantic_meshes_torch.scripts.demo_cube [--out demo_out]
        [--views 6] [--size 512] [--subdivisions 9]
        [--aggregator sum|summax|mul] [--device cuda|cpu]

Fuses one-hot masks (six classes, one per block of faces) from ring views
and writes, into `--out`:

  cube.ply                     the mesh
  cube_colorized.ply           the fused classes as face colours
  view{k}_depth.png            depth renders (near = bright)
  view{k}_annotation.png       the fused annotations re-rendered per view

and prints the texel count of a texel renderer at 0.2 texels a pixel.
Runs on `--device` (default "cuda"; raises without a card).
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

CLASSES = 6


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--out", type=str, default="demo_out")
    parser.add_argument("--views", type=int, default=6)
    parser.add_argument("--size", type=int, default=512)
    parser.add_argument("--subdivisions", type=int, default=9)
    parser.add_argument("--aggregator", type=str, default="sum",
                        choices=["sum", "summax", "mul"])
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device (cuda, or cpu for the plain "
                        "PyTorch path)")
    return parser.parse_args(argv)


def depth_image(depth_wh):
    """uint8 (H, W) depth image: 255 at the nearest depth, 0 at the
    farthest and where nothing was drawn (the JAX script's arithmetic)."""
    d = depth_wh.cpu().numpy().T
    d = np.where(np.isfinite(d), d, np.nan)
    lo, hi = np.nanmin(d), np.nanmax(d)
    return np.where(
        np.isnan(d), 0, (255 * (1 - (d - lo) / max(hi - lo, 1e-6)))
    ).astype(np.uint8)


def main(argv=None):
    args = parse_args(argv)
    from .. import data, fusion, render, testing
    from ..data import resolve_device
    from ..io.image import imwrite
    from ..io.ply import write_mesh
    from ..utils import class_palette

    device = resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    W = H = args.size

    print("Building cube scene...")
    vertices, faces = testing.make_cube(args.subdivisions)
    mesh_path = os.path.join(args.out, "cube.ply")
    write_mesh(mesh_path, vertices, faces)
    mesh = data.Ply(mesh_path)
    cams = testing.make_ring_cameras(num_views=args.views, width=W, height=H)

    renderer = render.triangles(mesh, device=device)
    T = renderer.getPrimitivesNum()
    tri_class = torch.from_numpy(
        (np.arange(T) // (T // CLASSES)).clip(max=CLASSES - 1)).to(device)
    palette = class_palette(CLASSES)
    aggregator = fusion.MeshAggregator(primitives=T, classes=CLASSES,
                                       aggregator=args.aggregator,
                                       device=device)

    print(f"Fusing {args.views} views...")
    for k, cam in enumerate(cams):
        ids, depth = renderer.render(cam)
        ids_wh = ids.view(torch.int32)
        covered = ids_wh >= 0
        mask = torch.where(covered, tri_class[ids_wh.clamp(min=0).long()],
                           torch.zeros_like(ids_wh, dtype=torch.int64))
        probs = torch.nn.functional.one_hot(mask, CLASSES).to(torch.float32)
        probs = probs * covered[..., None]  # (W, H, C); uncovered all 0
        aggregator.add(ids, probs)
        imwrite(os.path.join(args.out, f"view{k}_depth.png"),
                depth_image(depth))

    print("Saving colorized mesh...")
    fused = aggregator.get().cpu().numpy()
    seen = fused.sum(-1) >= 0.5
    colors = palette[fused.argmax(-1)]
    colors[~seen] = 0
    mesh.save(os.path.join(args.out, "cube_colorized.ply"), colors)

    print("Re-rendering fused annotations...")
    model_renderer = aggregator.renderer()
    for k, cam in enumerate(cams):
        ids, _ = renderer.render(cam)
        ann = model_renderer.render(ids.t()).cpu().numpy()  # (H, W, C)
        img = palette[ann.argmax(-1)]
        img[ann.sum(-1) < 0.5] = 255  # white background
        imwrite(os.path.join(args.out, f"view{k}_annotation.png"),
                img.astype(np.uint8))

    print("Texel-mode stats...")
    tex = render.texels(mesh, cams, 0.2, device=device)
    print(f"triangles={T}, texels={tex.getPrimitivesNum()}, "
          f"views={args.views}, out={args.out}")
    print("Done.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
