"""Port of scripts/debug_render_texels.py: render the texels of one
triangle for all six vertex orderings and save depth and checkerboard
PNGs.

    python -m semantic_meshes_torch.scripts.debug_render_texels
        --output DIR [--size 1000] [--texels_per_pixel 0.04]
        [--device cuda|cpu]

For each ordering o of the triangle's vertices it writes mesh-<o>.ply
(ASCII), depth-<o>.png (depth scaled to its maximum) and color-<o>.png
(a two-tone checkerboard over the triangular texel grid, white
background), and prints the texel count and the grid's side length. Runs
on `--device` (default "cuda"; raises without a card).
"""

from __future__ import annotations

import argparse
import math
import os
import sys

import numpy as np
import torch

ORDERS = ([0, 1, 2], [0, 2, 1], [1, 0, 2], [1, 2, 0], [2, 0, 1], [2, 1, 0])


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Visual texel-renderer harness: one triangle, all 6 "
        "vertex orderings, depth + checkerboard texel PNGs"
    )
    parser.add_argument("--output", type=str, required=True,
                        help="Directory to write the PNG/PLY outputs into")
    parser.add_argument("--size", type=int, default=1000,
                        help="Image sidelength (reference used 4000)")
    parser.add_argument("--texels_per_pixel", type=float, default=0.04)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device (cuda, or cpu for the plain "
                        "PyTorch path)")
    return parser.parse_args(argv)


def camera(size):
    """The harness's camera: at (-0.5, -0.5, 4) looking at (-0.5, -0.5,
    0), a 45 degree vertical field of view."""
    from .. import data
    from ..geometry import look_at

    rotation, translation = look_at(
        [-0.5, -0.5, 4.0], [-0.5, -0.5, 0.0], [0.0, 1.0, 0.0])
    resolution = np.asarray([size, size])
    principal_point = resolution.astype("float32") / 2.0
    fov_y = math.radians(45.0)
    focal_lengths = np.asarray([
        principal_point[0]
        / (resolution[0] / resolution[1] * math.tan(fov_y / 2.0)),
        principal_point[1] / math.tan(fov_y / 2.0),
    ])
    return data.Camera(rotation, translation,
                       np.asarray([resolution[1], resolution[0]]),
                       focal_lengths, principal_point)


def checkerboard(classes_num):
    """(classes_num + 1, 3) palette: texel k of the lower-triangular
    row-major grid sits at row r = floor((sqrt(8k+1)-1)/2), column
    c = k - r(r+1)/2 and takes tone (r + c) % 2; the last row is the
    white background."""
    k = np.arange(classes_num, dtype=np.int64)
    row = ((np.sqrt(8.0 * k + 1.0) - 1.0) / 2.0).astype(np.int64)
    col = k - row * (row + 1) // 2
    tones = np.array([[255, 201, 14], [0, 162, 232]], np.uint8)
    return np.concatenate(
        [tones[(row + col) % 2], np.full((1, 3), 255, np.uint8)])


def main(argv=None):
    args = parse_args(argv)
    from .. import data, render
    from ..data import resolve_device
    from ..io.image import imwrite
    from ..io.ply import write_mesh

    device = resolve_device(args.device)
    os.makedirs(args.output, exist_ok=True)
    vertex = np.array([(0.4, 0, 0), (0.5, 1, 0), (0.6, 0, 0)], np.float32)
    cam = camera(args.size)
    for order in ORDERS:
        name = "-".join(str(s) for s in order)
        mesh_file = os.path.join(args.output, f"mesh-{name}.ply")
        write_mesh(mesh_file, vertex, np.asarray([order], np.int32),
                   binary=False)
        mesh = data.Ply(mesh_file)
        renderer = render.texels(mesh, [cam], args.texels_per_pixel,
                                 device=device)
        ids, depth = renderer.render(cam)
        depth = depth.cpu().numpy().T
        ids = ids.view(torch.int32).cpu().numpy().T.astype(np.int64)

        classes_num = int(ids.max() + 1)
        sidelength = int(-0.5 + math.sqrt(0.25 + 2 * classes_num))
        print(f"Has {classes_num} texels and sidelength {sidelength}")
        ids = np.where(ids >= 0, ids, classes_num)

        depth_img = np.where(np.isinf(depth), 0.0, depth)
        imwrite(os.path.join(args.output, f"depth-{name}.png"),
                (depth_img / max(depth_img.max(), 1e-6) * 255).astype(
                    np.uint8))
        imwrite(os.path.join(args.output, f"color-{name}.png"),
                checkerboard(classes_num)[ids])
    return 0


if __name__ == "__main__":
    sys.exit(main())
