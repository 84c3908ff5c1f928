"""Port of scripts/colorize_mesh.py: fuse per-image segmentation masks onto
a COLMAP-reconstructed mesh and write it as a per-face coloured PLY.

    python -m semantic_meshes_torch.scripts.colorize_mesh --colmap WS
        --input_ply MESH.ply --masks DIR --classes C --output_ply OUT.ply
        [--remap] [--aggregator sum|summax|mul] [--images_equal_weight W]
        [--clip_near] [--device cuda|cpu]

mask PNG -> (--remap: colour -> class on first sight) -> one-hot
probabilities -> render primitive ids -> fuse -> argmax -> palette -> PLY,
on `--device` (default "cuda"; raises without a card). The observed mask
is the JAX script's (:114-123): a face whose raw accumulator is all zero
counts as never observed and stays black, which under `mul` also blacks
out a face whose every observation was certain in every class (a fault of
the reference, kept for parity; ROADMAP Queue 3).
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

MASK_EXTENSIONS = (".png", ".jpg", ".jpeg", ".tiff", ".bmp", ".gif")
DONT_CARE_THRESHOLD = 0.9


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Project 2D segmentation masks onto the triangles of a "
        "COLMAP mesh and write the fused result as a per-face-colored PLY."
    )
    parser.add_argument("--colmap", type=str, required=True,
                        help="COLMAP workspace directory (must hold "
                        "cameras/images/points3D as .bin or .txt)")
    parser.add_argument("--input_ply", type=str, required=True,
                        help="Mesh to annotate (PLY)")
    parser.add_argument("--masks", type=str, required=True,
                        help="Directory of mask images, one per "
                        "reconstructed view, named like the COLMAP image "
                        "entries")
    parser.add_argument("--classes", type=int, required=True,
                        help="Class count of the segmentation")
    parser.add_argument("--output_ply", type=str, required=True,
                        help="Where to write the colorized mesh (PLY)")
    parser.add_argument("--remap", action="store_true",
                        help="Treat masks as color images and assign each "
                        "distinct color a class index on first sight")
    parser.add_argument("--aggregator", type=str, default="sum",
                        choices=["sum", "summax", "mul"])
    parser.add_argument("--images_equal_weight", type=float, default=0.5)
    parser.add_argument("--clip_near", action="store_true",
                        help="Near-plane clip instead of culling triangles "
                        "that cross z=0 (for cameras inside the scene)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device (cuda, or cpu for the plain "
                        "PyTorch path)")
    return parser.parse_args(argv)


def face_colors(fused, state, palette):
    """(T, 3) uint8 colours: the palette colour of each face's argmax,
    black where the fused mass is under 0.9 or the raw state is all zero
    (the JAX script's observed mask)."""
    annotations = fused.cpu().numpy()
    without = annotations.sum(-1) < DONT_CARE_THRESHOLD
    without |= ~np.any(state.cpu().numpy() != 0.0, axis=1)
    colors = palette[annotations.argmax(-1)]
    return np.where(without[:, None], np.uint8(0), colors)


def main(argv=None):
    args = parse_args(argv)
    from .. import data, fusion, render
    from ..data import resolve_device
    from ..io.image import imread
    from ..utils import class_palette, palette_from_color_map, \
        remap_mask_colors

    device = resolve_device(args.device)
    # color tuple -> class index, grown in first-sight order across masks
    color_to_class = {}

    print("Loading mesh + COLMAP workspace")
    mesh = data.Ply(args.input_ply)
    workspace = data.Colmap(args.colmap)
    renderer = render.triangles(mesh, clip_near=args.clip_near,
                                device=device)
    aggregator = fusion.MeshAggregator(
        primitives=renderer.getPrimitivesNum(), classes=args.classes,
        aggregator=args.aggregator,
        images_equal_weight=args.images_equal_weight, device=device,
    )

    print("Fusing masks")
    mask_files = sorted(
        os.path.join(args.masks, f) for f in os.listdir(args.masks)
        if f.lower().endswith(MASK_EXTENSIONS)
    )
    # one budget probe over the whole camera set
    renderer.prepare([workspace.getCamera(f) for f in mask_files])
    for mask_file in mask_files:
        mask = imread(mask_file)
        if args.remap:
            assert mask.ndim in (2, 3)
            assert (mask.shape[2] if mask.ndim == 3 else 1) in (1, 3)
            mask = remap_mask_colors(mask, color_to_class)
        assert mask.ndim == 2
        assert np.all(0 <= mask) and np.all(mask < args.classes)
        labels = torch.from_numpy(mask.astype(np.int64)).to(device)
        probs = torch.nn.functional.one_hot(labels, args.classes).to(
            torch.float32)  # (H, W, C)
        ids, _ = renderer.render(workspace.getCamera(mask_file))
        aggregator.add(ids, probs.transpose(0, 1))

    if args.remap:
        class_to_color = palette_from_color_map(color_to_class, args.classes)
        print(
            f"Remapped {len(color_to_class)} distinct mask colors: "
            f"{[class_to_color[c].tolist() for c in sorted(color_to_class.values())]}"
        )
    else:
        class_to_color = class_palette(args.classes)
        print(f"Using a generated {args.classes}-color palette")

    print("Assigning face colors")
    colors = face_colors(aggregator.get(), aggregator.state, class_to_color)
    print(f"Writing {args.output_ply}")
    mesh.save(args.output_ply, colors)
    return 0


if __name__ == "__main__":
    sys.exit(main())
