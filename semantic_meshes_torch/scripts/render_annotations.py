"""Port of scripts/render_annotations.py: fuse masks into a mesh (or load
fused distributions) and re-render them as per-view annotation images.

    python -m semantic_meshes_torch.scripts.render_annotations --colmap WS
        --input_ply MESH.ply --classes C --output_dir OUT
        (--masks DIR | --fused_npz FUSED.npz) [--save_fused FUSED.npz]
        [--remap] [--aggregator sum|summax|mul] [--images_equal_weight W]
        [--texels_per_pixel TPP] [--clip_near] [--dont_care_threshold T]
        [--device cuda|cpu]

The paper's second output mode: every view reads the fused distribution
of the primitive under each pixel (fusion.ModelRenderer), so the label
images are consistent across views by construction. Per view it writes

  <output_dir>/labels/<image>.png  uint8 class ids (255 = unlabeled)
  <output_dir>/color/<image>.png   palette-coloured annotation

keeping nested COLMAP image names ('cam0/000123.jpg') as directories.
Never-observed primitives (all-zero raw state) get zero fused rows.
Labels are stored as uint8 as in the JAX script (:185-186), so a class of
256 or more wraps (256 is written as 0): a fault of the reference, kept
for parity (ROADMAP Queue 3).
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

MASK_EXTENSIONS = (".png", ".jpg", ".jpeg", ".tiff", ".bmp")


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Fuse 2D masks into a mesh (or load fused "
        "distributions) and re-render consistent per-view annotation "
        "images."
    )
    parser.add_argument("--colmap", type=str, required=True,
                        help="COLMAP workspace directory")
    parser.add_argument("--input_ply", type=str, required=True,
                        help="Mesh the workspace reconstructs (PLY)")
    parser.add_argument("--classes", type=int, required=True)
    parser.add_argument("--output_dir", type=str, required=True)
    parser.add_argument("--masks", type=str, default=None,
                        help="Directory of per-view mask images (named like "
                        "the COLMAP image entries); required unless "
                        "--fused_npz points at an existing file")
    parser.add_argument("--fused_npz", type=str, default=None,
                        help="Load fused per-primitive distributions from "
                        "this .npz (key 'fused') instead of fusing masks")
    parser.add_argument("--save_fused", type=str, default=None,
                        help="Also write the fused per-primitive "
                        "distributions to this .npz (key 'fused')")
    parser.add_argument("--remap", action="store_true",
                        help="Treat masks as color images; assign each "
                        "distinct color a class index on first sight "
                        "(colorize_mesh semantics)")
    parser.add_argument("--aggregator", type=str, default="sum",
                        choices=["sum", "summax", "mul"])
    parser.add_argument("--images_equal_weight", type=float, default=0.5)
    parser.add_argument("--texels_per_pixel", type=float, default=None,
                        help="Render/fuse in texel mode at this resolution "
                        "factor (default: triangle mode)")
    parser.add_argument("--clip_near", action="store_true")
    parser.add_argument("--dont_care_threshold", type=float, default=0.5,
                        help="Primitives whose fused mass is at or below "
                        "this render as unlabeled (the fusion don't-care "
                        "rule, ref: include/semantic_meshes/fusion/"
                        "Mesh.h:98)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device (cuda, or cpu for the plain "
                        "PyTorch path)")
    return parser.parse_args(argv)


def find_masks(root):
    """{stem: path} of the mask images under `root`, keyed by the
    workspace-relative stem and, as a fallback, by the flat basename."""
    mask_files = {}
    for dirpath, _dirs, files in os.walk(root):
        for fn in files:
            if not fn.lower().endswith(MASK_EXTENSIONS):
                continue
            full = os.path.join(dirpath, fn)
            rel = os.path.relpath(full, root)
            mask_files[os.path.splitext(rel)[0]] = full
            mask_files.setdefault(os.path.splitext(fn)[0], full)
    return mask_files


def annotation_images(probs_hwc, palette, threshold):
    """(labels (H, W) uint8 with 255 unlabeled, colour (H, W, 3) uint8) of
    one view's re-rendered distributions; labels wrap past 255 as the
    JAX script's uint8 cast does."""
    labeled = probs_hwc.sum(-1) > threshold
    cls = probs_hwc.argmax(-1).to(torch.uint8)
    labels = torch.where(labeled, cls, torch.full_like(cls, 255))
    color = torch.where(labeled[..., None], palette[cls.long()],
                        torch.zeros((), dtype=torch.uint8,
                                    device=palette.device))
    return labels.cpu().numpy(), color.cpu().numpy()


def main(argv=None):
    args = parse_args(argv)
    from .. import data, fusion, render
    from ..data import resolve_device
    from ..io.image import imread, imwrite
    from ..utils import class_palette, palette_from_color_map, \
        remap_mask_colors

    device = resolve_device(args.device)
    print("Loading mesh + COLMAP workspace")
    mesh = data.Ply(args.input_ply)
    workspace = data.Colmap(args.colmap)
    view_names = [workspace.getImageName(i)
                  for i in range(workspace.getImageNum())]
    all_cams = [workspace.getCamera(n) for n in view_names]
    if args.texels_per_pixel is not None:
        renderer = render.texels(mesh, all_cams, args.texels_per_pixel,
                                 clip_near=args.clip_near, device=device)
    else:
        renderer = render.triangles(mesh, clip_near=args.clip_near,
                                    device=device)
    P = renderer.getPrimitivesNum()
    renderer.prepare(all_cams)  # one budget probe for every view

    color_to_class = {}

    def mask_to_probs(path):
        m = imread(path)
        if args.remap:
            cls = remap_mask_colors(m, color_to_class)
        else:
            cls = m if m.ndim == 2 else m[..., 0]
        if cls.max() >= args.classes:
            raise SystemExit(
                f"{path}: mask class {cls.max()} >= --classes {args.classes}"
            )
        labels = torch.from_numpy(cls.astype(np.int64)).to(device)
        return torch.nn.functional.one_hot(labels, args.classes).to(
            torch.float32)  # (H, W, C)

    if args.fused_npz and os.path.exists(args.fused_npz):
        print(f"Loading fused distributions from {args.fused_npz}")
        fused = np.load(args.fused_npz)["fused"]
        if fused.shape != (P, args.classes):
            raise SystemExit(
                f"{args.fused_npz}: fused shape {fused.shape} does not "
                f"match (primitives, classes) = ({P}, {args.classes})"
            )
        fused = torch.from_numpy(np.ascontiguousarray(fused)).to(device)
    else:
        if not args.masks:
            raise SystemExit("--masks is required unless --fused_npz exists")
        aggregator = fusion.MeshAggregator(
            primitives=P, classes=args.classes, aggregator=args.aggregator,
            images_equal_weight=args.images_equal_weight, device=device,
        )
        mask_files = find_masks(args.masks)
        print(f"Fusing masks for {len(view_names)} views "
              f"({args.aggregator})")
        for name in view_names:
            stem = os.path.splitext(name)[0]
            if stem not in mask_files:
                stem = os.path.splitext(os.path.basename(name))[0]
            if stem not in mask_files:
                continue
            probs = mask_to_probs(mask_files[stem])
            ids, _ = renderer.render(workspace.getCamera(name))
            aggregator.add(ids, probs.transpose(0, 1))
        fused = aggregator.get()  # (P, C), L1-normalized
        # never-observed primitives stay don't-care: the raw accumulator
        # is exactly zero iff untouched (mul's untouched rows normalize to
        # a uniform distribution of mass 1)
        observed = (aggregator.state != 0.0).any(dim=1)
        fused = torch.where(observed[:, None], fused,
                            torch.zeros_like(fused))

    if args.save_fused:
        np.savez_compressed(args.save_fused, fused=fused.cpu().numpy())
        print(f"Wrote fused distributions to {args.save_fused}")

    if args.remap and color_to_class:
        palette = palette_from_color_map(color_to_class, args.classes)
    else:
        palette = class_palette(args.classes)
    palette = torch.from_numpy(palette).to(device)

    os.makedirs(os.path.join(args.output_dir, "labels"), exist_ok=True)
    os.makedirs(os.path.join(args.output_dir, "color"), exist_ok=True)
    model_renderer = fusion.ModelRenderer(fused, device=device)
    print(f"Rendering {len(view_names)} annotation views")
    for name in view_names:
        ids, _ = renderer.render(workspace.getCamera(name))
        probs_img = model_renderer.render(ids).transpose(0, 1)  # (H, W, C)
        labels, color = annotation_images(probs_img, palette,
                                          args.dont_care_threshold)
        stem = os.path.splitext(name)[0]
        lab_path = os.path.join(args.output_dir, "labels", stem + ".png")
        col_path = os.path.join(args.output_dir, "color", stem + ".png")
        os.makedirs(os.path.dirname(lab_path), exist_ok=True)
        os.makedirs(os.path.dirname(col_path), exist_ok=True)
        imwrite(lab_path, labels)
        imwrite(col_path, color)
    print(f"Wrote {args.output_dir}/labels and {args.output_dir}/color")
    return 0


if __name__ == "__main__":
    sys.exit(main())
