"""Pinhole geometry: rotations, rigid transforms, projection.

Counterpart of the pinhole subset of `semantic_meshes/geometry.py`:
`quaternion_to_rotation` and `look_at` run in numpy on the host (they build
camera parameters); `rigid_transform` and `pinhole_project` run in torch on
whatever device their inputs live on. The `LENS_*` selector constants are
kept because `io/colmap.py` writes them into the extended lens wire; the
distortion models themselves are not ported yet.

Precision: the 3x3 transform is written out elementwise (as
`semantic_meshes/rasterize/xla.py::_face_vertices_cam` does), so no matmul
and hence no TF32 ever enters the geometry that feeds the rasterizer. The
port never turns `torch.backends.cuda.matmul.allow_tf32` on (its default is
False).
"""

from __future__ import annotations

import numpy as np
import torch

# lens-model selectors of the extended (9,) distortion wire (slot 8)
LENS_RADTAN = 0.0
LENS_FISHEYE = 1.0
LENS_FOV = 2.0
LENS_THIN_PRISM = 3.0
LENS_EXTENDED_DIM = 9


def quaternion_to_rotation(q):
    """COLMAP-convention (w, x, y, z) unit quaternion(s) -> rotation matrix.

    q: (..., 4) -> (..., 3, 3) numpy array.
    """
    q = np.asarray(q)
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r = np.stack(
        [
            1 - 2 * (y * y + z * z),
            2 * (x * y - w * z),
            2 * (x * z + w * y),
            2 * (x * y + w * z),
            1 - 2 * (x * x + z * z),
            2 * (y * z - w * x),
            2 * (x * z - w * y),
            2 * (y * z + w * x),
            1 - 2 * (x * x + y * y),
        ],
        axis=-1,
    )
    return r.reshape(q.shape[:-1] + (3, 3))


def look_at(eye, target, up):
    """Right-handed look-at -> (rotation, translation) world->camera, with the
    camera looking down +z (the projection convention used by the renderer).
    """
    eye = np.asarray(eye, np.float64)
    target = np.asarray(target, np.float64)
    up = np.asarray(up, np.float64)
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, up)
    right = right / np.linalg.norm(right)
    down = np.cross(fwd, right)
    # rows: camera axes expressed in world coords (x=right, y=down, z=forward)
    rotation = np.stack([right, down, fwd], axis=0)
    translation = -rotation @ eye
    return rotation.astype(np.float32), translation.astype(np.float32)


def rigid_transform(rotation, translation, points):
    """p_cam = R @ p_world + t, elementwise (no matmul, no TF32).

    rotation (3, 3), translation (3,), points (..., 3) -> (..., 3).
    """
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    r, t = rotation, translation
    cx = r[0, 0] * x + r[0, 1] * y + r[0, 2] * z + t[0]
    cy = r[1, 0] * x + r[1, 1] * y + r[1, 2] * z + t[1]
    cz = r[2, 0] * x + r[2, 1] * y + r[2, 2] * z + t[2]
    return torch.stack([cx, cy, cz], dim=-1)


def pinhole_project(focal_lengths, principal_point, points_cam):
    """Pinhole projection: pixel = f * (x/z, y/z) + c.

    focal_lengths (2,), principal_point (2,), points_cam (..., 3) ->
    (..., 2) pixel coordinates (x, y). Division by z == 0 yields inf;
    callers mask on z > 0.
    """
    px = focal_lengths[0] * (points_cam[..., 0] / points_cam[..., 2]) + \
        principal_point[0]
    py = focal_lengths[1] * (points_cam[..., 1] / points_cam[..., 2]) + \
        principal_point[1]
    return torch.stack([px, py], dim=-1)
