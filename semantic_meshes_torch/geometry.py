"""Pinhole geometry: rotations, rigid transforms, projection, texel grid.

Counterpart of the pinhole and texel subset of `semantic_meshes/geometry.py`:
`quaternion_to_rotation` and `look_at` run in numpy on the host (they build
camera parameters); `rigid_transform`, `pinhole_project`, the barycentric
helpers, the texel grid (`texel_count`, `texel_index(_uv)`) and
`reorder_faces_for_texels` run in torch on whatever device their inputs
live on. The `LENS_*` selector constants are kept because `io/colmap.py`
writes them into the extended lens wire; the distortion models themselves
are not ported yet.

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


# ---------------------------------------------------------------- triangles


def signed_area2(a, b, c):
    """Twice the signed area of screen-space triangle (a, b, c); (..., 2)
    inputs."""
    return (b[..., 0] - a[..., 0]) * (c[..., 1] - a[..., 1]) - (
        b[..., 1] - a[..., 1]
    ) * (c[..., 0] - a[..., 0])


def triangle_screen_area(projected):
    """Absolute screen-space area of projected triangles (..., 3, 2), the
    texel sizing formula (ref: TexturedTriangleRenderer.h:121-123)."""
    p0, p1, p2 = projected[..., 0, :], projected[..., 1, :], projected[..., 2, :]
    return 0.5 * torch.abs(
        p0[..., 0] * (p1[..., 1] - p2[..., 1])
        + p1[..., 0] * (p2[..., 1] - p0[..., 1])
        + p2[..., 0] * (p0[..., 1] - p1[..., 1])
    )


def barycentric_2d(p, a, b, c):
    """Screen-space barycentrics (..., 3) of points p wrt triangle (a, b,
    c), all (..., 2); degenerate triangles give nan."""
    denom = signed_area2(a, b, c)
    w0 = signed_area2(b, c, p)
    w1 = signed_area2(c, a, p)
    w2 = signed_area2(a, b, p)
    return torch.stack([w0, w1, w2], dim=-1) / denom[..., None]


def perspective_correct(bary2d, z_cam):
    """Screen-space barycentrics (..., 3) and vertex camera depths (..., 3)
    -> (perspective-correct barycentrics (..., 3), surface depth (...,))."""
    inv_z = bary2d / z_cam
    denom = inv_z.sum(dim=-1)
    depth = 1.0 / denom
    bary3d = inv_z * depth[..., None]
    return bary3d, depth


# --------------------------------------------------------------- texel grid
# The unit uv-triangle {u>=0, v>=0, u+v<=1} is cut into an r x r grid; the
# r(r+1)/2 cells with iu+iv <= r-1 are the triangle's texels, indexed in
# diagonal bands k = iu+iv of k+1 texels: index = k(k+1)/2 + iv
# (ref: TexturedTriangleRenderer.h:31-47, debug_render_texels.py:71-73).


def texel_count(resolution):
    """Number of texels of a triangle with grid resolution r: r(r+1)/2."""
    r = torch.as_tensor(resolution)
    return r * (r + 1) // 2


TEXEL_UV_EPS = 1e-6  # ref: TexturedTriangleRenderer.h:38 subtracts 1e-6


def _grid_cell(x, r, rf):
    """clip(int32(floor((x - eps) * r)), 0, r - 1) in f32, with XLA's
    saturating, NaN-to-0 float -> int32 conversion (a float clamped to
    [-1, r] first converts to the same clipped cell)."""
    f = torch.nan_to_num(torch.floor((x - TEXEL_UV_EPS) * rf), nan=0.0)
    f = torch.minimum(f, rf).clamp(min=-1.0)
    return torch.minimum(f.to(torch.int32).clamp(min=0), r - 1)


def texel_index_uv(u, v, resolution):
    """Texel index within a triangle of grid resolution r (>= 1) from its
    raw uv parameter coordinates (u = bary1, v = bary2), in f32 / int32."""
    r = torch.as_tensor(resolution, dtype=torch.int32, device=u.device)
    rf = r.to(torch.float32)
    iu = _grid_cell(u, r, rf)
    iv = _grid_cell(v, r, rf)
    k = torch.minimum(iu + iv, r - 1)
    iv = torch.minimum(iv, k)
    return (k * (k + 1)) // 2 + iv


def texel_index(bary3d, resolution):
    """Texel index of perspective-correct barycentrics (..., 3): vertex 0
    maps to uv (0, 0), vertex 1 to (1, 0), vertex 2 to (0, 1)
    (ref: TexturedTriangleRenderer.h:34-37). Returns int32 in
    [0, r(r+1)/2)."""
    return texel_index_uv(bary3d[..., 1], bary3d[..., 2], resolution)


def reorder_faces_for_texels(vertices, faces):
    """Reorder each face so its most right-angled vertex maps to uv (0, 0)
    (ref: TexturedTriangleRenderer.h:129-146): diffs[i] = |angle at vertex i
    - 90 deg| (inf at a degenerate vertex); swap position 0 with the first
    argmin, then swap positions 1 and 2 if diffs[1] >= diffs[2].

    vertices (V, 3) f32, faces (T, 3) integer tensors on one device ->
    reordered (T, 3) faces of the same dtype. The ops follow
    `semantic_meshes.geometry.reorder_faces_for_texels` one by one: on
    right-isosceles faces the two 45 degree angles tie or differ in the
    last bits, and the order of those bits decides the swap."""
    p = vertices[faces.long()]  # (T, 3, 3)

    def norm(e):
        return torch.sqrt(e[:, 0] * e[:, 0] + e[:, 1] * e[:, 1]
                          + e[:, 2] * e[:, 2])

    def angle_diff(i):
        a, b, c = p[:, i % 3], p[:, (i + 1) % 3], p[:, (i + 2) % 3]
        e1 = b - a
        e2 = c - a
        denom = norm(e1) * norm(e2)
        dot = e1[:, 0] * e2[:, 0] + e1[:, 1] * e2[:, 1] + e1[:, 2] * e2[:, 2]
        cosang = dot / torch.clamp(denom, min=1e-20)
        ang = torch.arccos(torch.clamp(cosang, -1.0, 1.0))
        return torch.where(denom > 0, torch.abs(ang - np.float32(np.pi / 2)),
                           torch.full_like(ang, float("inf")))

    diffs = torch.stack([angle_diff(0), angle_diff(1), angle_diff(2)], -1)
    best = torch.argmin(diffs, dim=-1)  # the first minimum
    f = faces
    f0 = f.gather(1, best[:, None])[:, 0]
    f1 = torch.where(best == 1, f[:, 0], f[:, 1])
    f2 = torch.where(best == 2, f[:, 0], f[:, 2])
    d1 = torch.where(best == 1, diffs[:, 0], diffs[:, 1])
    d2 = torch.where(best == 2, diffs[:, 0], diffs[:, 2])
    swap12 = d1 >= d2
    return torch.stack([f0, torch.where(swap12, f2, f1),
                        torch.where(swap12, f1, f2)], dim=-1)
