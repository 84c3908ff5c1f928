"""Synthetic scenes for tests, the chip smoke run and benchmarks.

Counterpart of `make_cube`, `make_ring_cameras` and `random_probs` in
`semantic_meshes/testing.py` (numpy only, so both packages build the very
same scene from the same arguments): a subdivided cube viewed by pinhole
cameras on a ring, fused with random class probabilities.
"""

from __future__ import annotations

import numpy as np

from .data import Camera
from .geometry import look_at


def make_cube(subdivisions=9, size=1.0):
    """Axis-aligned cube centered at origin, each face an s x s quad grid.

    Returns (vertices (V, 3) f32, faces (T, 3) i32) with
    T = 12 * subdivisions**2 (s=9 -> 972 triangles).
    """
    s = int(subdivisions)
    half = size / 2.0
    verts = []
    faces = []
    # each face: origin corner, u axis, v axis
    face_frames = [
        ([-half, -half, half], [size, 0, 0], [0, size, 0]),   # +z
        ([half, -half, -half], [-size, 0, 0], [0, size, 0]),  # -z
        ([half, -half, half], [0, 0, -size], [0, size, 0]),   # +x
        ([-half, -half, -half], [0, 0, size], [0, size, 0]),  # -x
        ([-half, half, half], [size, 0, 0], [0, 0, -size]),   # +y
        ([-half, -half, -half], [size, 0, 0], [0, 0, size]),  # -y
    ]
    for origin, u, v in face_frames:
        base = len(verts)
        origin, u, v = np.asarray(origin), np.asarray(u), np.asarray(v)
        for j in range(s + 1):
            for i in range(s + 1):
                verts.append(origin + u * (i / s) + v * (j / s))
        for j in range(s):
            for i in range(s):
                a = base + j * (s + 1) + i
                b = a + 1
                c = a + (s + 1)
                d = c + 1
                faces.append([a, b, d])
                faces.append([a, d, c])
    return (
        np.asarray(verts, np.float32),
        np.asarray(faces, np.int32),
    )


def make_ring_cameras(num_views=4, width=256, height=192, radius=3.0,
                      elevation=0.35, focal=None, target=(0, 0, 0)):
    """Cameras on a horizontal ring looking at `target`."""
    if focal is None:
        focal = 0.9 * min(width, height)
    cams = []
    for k in range(num_views):
        ang = 2 * np.pi * k / num_views
        eye = np.array(
            [radius * np.cos(ang), elevation * radius, radius * np.sin(ang)]
        )
        rotation, translation = look_at(eye, target, [0, 1, 0])
        cams.append(
            Camera(
                rotation,
                translation,
                np.array([width, height]),
                np.array([focal, focal], np.float32),
                np.array([width / 2, height / 2], np.float32),
            )
        )
    return cams


def random_probs(rng, height, width, classes, dont_care_frac=0.0):
    """Random softmax class-probability image (H, W, C) float32."""
    logits = rng.normal(size=(height, width, classes)).astype(np.float32)
    e = np.exp(logits - logits.max(-1, keepdims=True))
    probs = e / e.sum(-1, keepdims=True)
    if dont_care_frac > 0:
        dc = rng.random((height, width)) < dont_care_frac
        probs[dc] = 0.0
    return probs
