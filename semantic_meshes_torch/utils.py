"""Class palettes and mask colour helpers.

Own copy of the JAX package's `semantic_meshes/utils.py` (numpy only):
`distinct_colors`, `class_palette`, `remap_mask_colors` and
`palette_from_color_map`, plus the Cityscapes train-id palette
`CLASS_TO_COLOR` of the JAX `scripts/colorize_cityscapes_mesh.py`, which
the demo, its bench and the tests share. The reference scripts use the
external `distinctipy` package for class palettes
(ref: python/scripts/colorize_mesh.py:78); this is a dependency-free
equivalent that prefers distinctipy when it is installed.
"""

from __future__ import annotations

import colorsys

import numpy as np


def distinct_colors(n, seed=0):
    """n visually-distinct RGB uint8 colors.

    Golden-ratio hue stepping with alternating saturation/value bands —
    deterministic, fast, and distinct enough for class palettes.
    """
    phi = (np.sqrt(5) - 1) / 2
    colors = np.empty((n, 3), np.uint8)
    h = (seed * phi) % 1.0
    for i in range(n):
        h = (h + phi) % 1.0
        s = (0.95, 0.65, 0.8)[i % 3]
        v = (0.95, 0.75, 0.55)[(i // 3) % 3]
        colors[i] = np.round(
            np.asarray(colorsys.hsv_to_rgb(h, s, v)) * 255.0
        )
    return colors


def class_palette(classes_num, seed=0):
    """Palette for `classes_num` classes; prefers distinctipy when present
    (bit-compatible with reference scripts), falls back to distinct_colors."""
    try:
        from distinctipy import distinctipy

        return (
            np.asarray(distinctipy.get_colors(classes_num)) * 255.0
        ).astype(np.uint8)
    except ImportError:
        return distinct_colors(classes_num, seed)


# Cityscapes train-id palette (JAX scripts/colorize_cityscapes_mesh.py:28-37)
CLASS_TO_COLOR = np.asarray(
    [
        (128, 64, 128), (244, 35, 232), (70, 70, 70), (102, 102, 156),
        (190, 153, 153), (153, 153, 153), (250, 170, 30), (220, 220, 0),
        (107, 142, 35), (152, 251, 152), (70, 130, 180), (220, 20, 60),
        (255, 0, 0), (0, 0, 142), (0, 0, 70), (0, 60, 100), (0, 80, 100),
        (0, 0, 230), (119, 11, 32),
    ],
    dtype=np.uint8,
)


def remap_mask_colors(mask, color_to_class):
    """Map a colour (or grey) mask image to class indices, giving each
    distinct colour a class id on first sight (the reference's
    colorize_mesh remap). `color_to_class` is the dict carried across
    masks; returns an (H, W) int class map."""
    mask = np.asarray(mask)
    channels = mask.shape[2] if mask.ndim == 3 else 1
    shape = mask.shape[:2]
    flat = mask.reshape(-1, channels)
    if channels == 1 or (mask.dtype == np.uint8 and channels <= 4):
        # one sortable key a pixel, the first channel most significant, so
        # the colours come out in np.unique(axis=0)'s row order (a row
        # sort of a full-HD mask took seconds)
        key = flat[:, 0]
        if channels > 1:
            key = np.zeros(len(flat), np.uint32)
            for c in range(channels):
                key = (key << 8) | flat[:, c]
        _, first, inv = np.unique(key, return_index=True,
                                  return_inverse=True)
        unique_colors = flat[first]
    else:
        unique_colors, inv = np.unique(flat, axis=0, return_inverse=True)
    for c in map(tuple, unique_colors.tolist()):
        color_to_class.setdefault(c, len(color_to_class))
    unique_classes = np.array(
        [color_to_class[tuple(c.tolist())] for c in unique_colors]
    )
    return unique_classes[inv].reshape(shape)


def palette_from_color_map(color_to_class, classes_num):
    """The (classes, 3) uint8 palette of a first-sight colour -> class
    map (grey colours broadcast to grey RGB)."""
    palette = np.zeros((classes_num, 3), np.uint8)
    for color, class_index in color_to_class.items():
        palette[class_index] = (
            color if len(color) == 3 else (color[0],) * 3
        )
    return palette
