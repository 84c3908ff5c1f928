"""Class palettes.

Own copy of `distinct_colors` and `class_palette` from the JAX package's
`semantic_meshes/utils.py` (numpy only). The reference scripts use the
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
