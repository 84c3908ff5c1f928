"""Geometry: rotations, rigid transforms, projection, lens models, texels.

Counterpart of `semantic_meshes/geometry.py`: `quaternion_to_rotation`
and `look_at` run in numpy on the host (they build camera parameters);
`rigid_transform`, `pinhole_project`, the COLMAP lens models
(`distort_normalized`, `undistort_normalized`, `max_monotonic_radius` on
the classic (..., 4) and the extended (..., 9) wire), the barycentric
helpers, the near-plane clipper `clip_triangles_near`, the texel grid
(`texel_count`, `texel_index(_uv)`) and `reorder_faces_for_texels` run in
torch on whatever device their inputs live on.

Precision: the 3x3 transform is written out elementwise (as
`semantic_meshes/rasterize/xla.py::_face_vertices_cam` does), so no matmul
and hence no TF32 ever enters the geometry that feeds the rasterizer. The
port never turns `torch.backends.cuda.matmul.allow_tf32` on (its default is
False).
"""

from __future__ import annotations

import numpy as np
import torch
from torch.func import jvp

# Lens models (COLMAP camera_models.h Distortion()) on normalized camera
# coordinates (x/z, y/z). The classic (..., 4) wire is (k1, k2, p1, p2),
# the OPENCV model (SIMPLE_RADIAL = (k1, 0, 0, 0), RADIAL = (k1, k2, 0, 0)).
# The extended (..., 9) wire is 8 parameter slots + a model selector in
# slot 8:
#   LENS_RADTAN (0): (k1, k2, p1, p2, k3, k4, k5, k6), FULL_OPENCV's
#       rational radial polynomial + OpenCV tangential terms (k3..k6 = 0
#       is OPENCV, so a zero-padded classic vector is the same model);
#   LENS_FISHEYE (1): (k1, k2, k3, k4, 0, ...), equidistant fisheye
#       theta_d = theta (1 + k1 th2 + k2 th4 + k3 th6 + k4 th8),
#       theta = atan(r) (OPENCV_FISHEYE, SIMPLE_RADIAL_FISHEYE,
#       RADIAL_FISHEYE); zero ks is NOT the identity;
#   LENS_FOV (2): (omega, 0, ...), r_d = atan(2 r tan(omega/2)) / omega;
#   LENS_THIN_PRISM (3): (k1, k2, p1, p2, k3, k4, sx1, sy1),
#       THIN_PRISM_FISHEYE: the equidistant projection, then radial +
#       tangential + thin-prism terms; zero params is NOT the identity.
LENS_RADTAN = 0.0
LENS_FISHEYE = 1.0
LENS_FOV = 2.0
LENS_THIN_PRISM = 3.0
LENS_EXTENDED_DIM = 9
# samples of the extended wire's radial response: undistorted radii
# tan(theta) on a uniform theta grid out to ~88.8 degrees
RESPONSE_SAMPLES = 512


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


# -------------------------------------------------------------- lens models
# Every jnp op of the JAX functions is one torch op here, in the same order
# and with the same `where` nesting; divisions are true divisions (a python
# scalar over a tensor would be a reciprocal times a multiply).


def _rdiv(c, x):
    """c / x for a python scalar c, as a true division."""
    return torch.div(torch.full_like(x, c), x)


def _distort_extended(xy, dist):
    """Forward distortion on the extended (..., 9) wire
    (`semantic_meshes.geometry._distort_extended`): all four families
    computed branch-free, then selected by slot 8. The `where`s at r < 1e-8
    also mask the NaN tangent of sqrt at r = 0, which the Newton Jacobian
    (torch.func.jvp) would otherwise carry to the principal point."""
    x, y = xy[..., 0], xy[..., 1]
    s = [dist[..., i] for i in range(8)]
    sel = dist[..., 8]
    x2, y2, xyp = x * x, y * y, x * y
    r2 = x2 + y2

    # radial-tangential, rational polynomial (FULL_OPENCV)
    k1, k2, p1, p2, k3, k4, k5, k6 = s
    num = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    den = 1.0 + r2 * (k4 + r2 * (k5 + r2 * k6))
    rad = num / torch.where(den == 0.0, 1.0, den)
    xt = x * rad + 2.0 * p1 * xyp + p2 * (r2 + 2.0 * x2)
    yt = y * rad + p1 * (r2 + 2.0 * y2) + 2.0 * p2 * xyp

    # equidistant fisheye (OPENCV_FISHEYE family): slots 0..3 are k1..k4
    fk1, fk2, fk3, fk4 = s[0], s[1], s[2], s[3]
    r = torch.sqrt(r2)
    theta = torch.atan(r)
    t2 = theta * theta
    theta_d = theta * (
        1.0 + t2 * (fk1 + t2 * (fk2 + t2 * (fk3 + t2 * fk4)))
    )
    safe_r = torch.clamp(r, min=1e-8)
    # r -> 0: theta ~ r and t2 -> 0, so the scale limit is exactly 1
    fish = torch.where(r < 1e-8, 1.0, theta_d / safe_r)

    # FOV model: slot 0 is omega
    w = s[0]
    tw = torch.tan(0.5 * w)
    safe_w = torch.where(torch.abs(w) < 1e-6, 1.0, w)
    fov_gen = torch.atan(2.0 * safe_r * tw) / (safe_r * safe_w)
    fov = torch.where(r < 1e-8, 2.0 * tw / safe_w, fov_gen)
    fov = torch.where(torch.abs(w) < 1e-6, 1.0, fov)

    # thin-prism fisheye: the equidistant projection, then radial (slots
    # 0, 1, 4, 5) + tangential (2, 3) + thin prism (6, 7) on the projected
    # coords, COLMAP's order (k1, k2, p1, p2, k3, k4, sx1, sy1)
    eq = torch.where(r < 1e-8, 1.0, theta / safe_r)
    uu, vv = x * eq, y * eq
    u2, v2, uv = uu * uu, vv * vv, uu * vv
    q2 = u2 + v2
    tk1, tk2, tp1, tp2 = s[0], s[1], s[2], s[3]
    tk3, tk4, sx1, sy1 = s[4], s[5], s[6], s[7]
    t_rad = q2 * (tk1 + q2 * (tk2 + q2 * (tk3 + q2 * tk4)))
    du = uu * t_rad + 2.0 * tp1 * uv + tp2 * (q2 + 2.0 * u2) + sx1 * q2
    dv = vv * t_rad + tp1 * (q2 + 2.0 * v2) + 2.0 * tp2 * uv + sy1 * q2
    out_tpf = torch.stack([uu + du, vv + dv], dim=-1)

    scale = torch.where(sel == LENS_FISHEYE, fish,
                        torch.where(sel == LENS_FOV, fov, 1.0))
    out_scaled = xy * scale[..., None]
    out_radtan = torch.stack([xt, yt], dim=-1)
    return torch.where(
        (sel == LENS_RADTAN)[..., None], out_radtan,
        torch.where((sel == LENS_THIN_PRISM)[..., None], out_tpf,
                    out_scaled),
    )


def _undistort_extended(xy_distorted, dist, iters=30):
    """Newton inversion of _distort_extended
    (`semantic_meshes.geometry._undistort_extended`): the 2x2 Jacobian's
    columns are jvps of the forward map along x and y (one
    torch.func.jvp of the point stacked twice, the two tangents side by
    side: the same elementwise values as two jvps, for half the launches),
    a Jacobian with |det| <= 1e-12 takes no step, and every iterate is
    clamped to the ball of radius 100, so a pixel outside the invertible
    domain cannot run to inf/nan (render._undistort_grid clamps those
    afterwards)."""
    def fwd(xy):
        return _distort_extended(xy, dist)

    tangents = torch.zeros((2,) + xy_distorted.shape,
                           dtype=xy_distorted.dtype,
                           device=xy_distorted.device)
    tangents[0, ..., 0] = 1.0
    tangents[1, ..., 1] = 1.0
    xy = xy_distorted
    for _ in range(iters):
        fxy, jac = jvp(fwd, (torch.stack([xy, xy]),), (tangents,))
        fxy = fxy[0]
        a, c = jac[0, ..., 0], jac[0, ..., 1]
        b, d = jac[1, ..., 0], jac[1, ..., 1]
        rx = fxy[..., 0] - xy_distorted[..., 0]
        ry = fxy[..., 1] - xy_distorted[..., 1]
        det = a * d - b * c
        inv_det = torch.where(torch.abs(det) > 1e-12, _rdiv(1.0, det), 0.0)
        nx = xy[..., 0] - (d * rx - b * ry) * inv_det
        ny = xy[..., 1] - (a * ry - c * rx) * inv_det
        nrm = torch.sqrt(nx * nx + ny * ny)
        shrink = torch.clamp(_rdiv(100.0, torch.clamp(nrm, min=1e-8)),
                             max=1.0)
        xy = torch.stack([nx * shrink, ny * shrink], dim=-1)
    return xy


def distort_normalized(xy, dist):
    """Forward lens distortion of normalized camera coords (x/z, y/z)
    (`semantic_meshes.geometry.distort_normalized`).

    xy (..., 2) f32; dist (..., 4) = (k1, k2, p1, p2) or the extended
    (..., 9) wire, broadcastable against xy's batch shape. For the 4-wide
    wire:
        r2 = x^2 + y^2;  radial = k1 r2 + k2 r2^2
        x' = x (1 + radial) + 2 p1 x y + p2 (r2 + 2 x^2)
        y' = y (1 + radial) + p1 (r2 + 2 y^2) + 2 p2 x y
    """
    if dist.shape[-1] == LENS_EXTENDED_DIM:
        return _distort_extended(xy, dist)
    x, y = xy[..., 0], xy[..., 1]
    k1, k2, p1, p2 = (dist[..., i] for i in range(4))
    x2, y2, xyp = x * x, y * y, x * y
    r2 = x2 + y2
    radial = k1 * r2 + k2 * r2 * r2
    dx = x * radial + 2.0 * p1 * xyp + p2 * (r2 + 2.0 * x2)
    dy = y * radial + p1 * (r2 + 2.0 * y2) + 2.0 * p2 * xyp
    return xy + torch.stack([dx, dy], dim=-1)


def undistort_normalized(xy_distorted, dist, iters=20):
    """Invert distort_normalized by Newton iteration on the 2x2 Jacobian
    (`semantic_meshes.geometry.undistort_normalized`; COLMAP's
    IterativeUndistortion with a fixed iteration count). The classic wire
    takes `iters` steps of the closed-form Jacobian; the extended wire
    max(iters, 30) steps of _undistort_extended. Elementwise over (..., 2)
    f32 points."""
    if dist.shape[-1] == LENS_EXTENDED_DIM:
        return _undistort_extended(xy_distorted, dist, iters=max(iters, 30))
    k1, k2, p1, p2 = (dist[..., i] for i in range(4))
    xy = xy_distorted
    for _ in range(iters):
        x, y = xy[..., 0], xy[..., 1]
        x2, y2, xyp = x * x, y * y, x * y
        r2 = x2 + y2
        radial = k1 * r2 + k2 * r2 * r2
        dradial = 2.0 * k1 + 4.0 * k2 * r2  # d(radial)/d(r2) * 2
        fx = x * (1.0 + radial) + 2.0 * p1 * xyp + p2 * (r2 + 2.0 * x2) \
            - xy_distorted[..., 0]
        fy = y * (1.0 + radial) + p1 * (r2 + 2.0 * y2) + 2.0 * p2 * xyp \
            - xy_distorted[..., 1]
        jxx = 1.0 + radial + x2 * dradial + 2.0 * p1 * y + 6.0 * p2 * x
        jxy = xyp * dradial + 2.0 * p1 * x + 2.0 * p2 * y
        jyy = 1.0 + radial + y2 * dradial + 6.0 * p1 * y + 2.0 * p2 * x
        det = jxx * jyy - jxy * jxy
        inv_det = torch.where(torch.abs(det) > 1e-12, _rdiv(1.0, det), 0.0)
        nx = x - (jyy * fx - jxy * fy) * inv_det
        ny = y - (jxx * fy - jxy * fx) * inv_det
        xy = torch.stack([nx, ny], dim=-1)
    return xy


def max_monotonic_radius(dist):
    """Largest undistorted radius within the lens's invertible (monotonic)
    range, or +inf (`semantic_meshes.geometry.max_monotonic_radius`).

    Classic wire: r (1 + k1 r^2 + k2 r^4) folds where its derivative
    1 + 3 k1 r^2 + 5 k2 r^4 is zero; the fold is the square root of the
    smallest positive root x of 5 k2 x^2 + 3 k1 x + 1 (the tangential
    terms are ignored). The extended wire uses the monotone prefix of the
    sampled radial response (_max_monotonic_radius_extended)."""
    if dist.shape[-1] == LENS_EXTENDED_DIM:
        return _max_monotonic_radius_extended(dist)
    k1, k2 = dist[..., 0], dist[..., 1]
    disc = 9.0 * k1 * k1 - 20.0 * k2
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    quad_ok = (k2 != 0) & (disc >= 0)
    denom_q = torch.where(k2 == 0, 1.0, 10.0 * k2)
    lin_ok = (k2 == 0) & (k1 < 0)
    denom_l = torch.where(k1 == 0, 1.0, 3.0 * k1)

    def pos_or_inf(x, ok):
        return torch.where(ok & (x > 0), x, float("inf"))

    x_min = torch.minimum(
        torch.minimum(
            pos_or_inf((-3.0 * k1 - sq) / denom_q, quad_ok),
            pos_or_inf((-3.0 * k1 + sq) / denom_q, quad_ok),
        ),
        pos_or_inf(_rdiv(-1.0, denom_l), lin_ok),
    )
    return torch.sqrt(x_min)


def _radial_only_wire(dist):
    """An extended wire with its non-radial terms zeroed, for the radial
    response (`semantic_meshes.geometry._radial_only_wire`): slots 2, 3
    (tangential p1, p2) of the radtan and thin-prism families (fisheye
    keeps them: they are its k3, k4) and the thin prism's sx1, sy1 (slots
    6, 7), which shift even on-axis samples."""
    sel = dist[..., 8]
    tang = ((sel == LENS_RADTAN) | (sel == LENS_THIN_PRISM))[..., None]
    prism = (sel == LENS_THIN_PRISM)[..., None]
    return torch.cat([
        dist[..., :2],
        torch.where(tang, 0.0, dist[..., 2:4]),
        dist[..., 4:6],
        torch.where(prism, 0.0, dist[..., 6:8]),
        dist[..., 8:],
    ], dim=-1)


def _response_radii(device):
    """The undistorted radii r = tan(theta) of the radial response, theta
    on RESPONSE_SAMPLES uniform steps of [1e-3, 1.55] (~88.8 degrees). The
    JAX package takes jnp.tan of an f32 jnp.linspace; here the table is
    rounded once from float64, so the card and the CPU read the same
    radii."""
    theta = np.linspace(1e-3, 1.55, RESPONSE_SAMPLES)
    return torch.as_tensor(np.tan(theta).astype(np.float32), device=device)


def _radial_response(dist):
    """Sampled forward radial response of an extended-wire lens
    (`semantic_meshes.geometry._radial_response`): (r, rd, good) with the
    radii r of _response_radii, the distorted radius rd(r) on the x-axis
    under _radial_only_wire, and the mask of the strictly increasing
    (invertible) prefix. dist (..., 9); rd and good (..., samples)."""
    r = _response_radii(dist.device)
    pts = torch.stack([r, torch.zeros_like(r)], dim=-1)
    rd = _distort_extended(pts, _radial_only_wire(dist)[..., None, :])[..., 0]
    inc = (rd[..., 1:] > rd[..., :-1]).to(torch.float32)
    good = torch.cat([torch.ones_like(inc[..., :1]),
                      torch.cumprod(inc, dim=-1)], dim=-1) > 0
    return r, rd, good


def _max_monotonic_radius_extended(dist):
    """The largest sampled radius whose response prefix is strictly
    increasing, or +inf when the whole sampled response is
    (`semantic_meshes.geometry._max_monotonic_radius_extended`)."""
    r, _, good = _radial_response(dist)
    count = good.sum(dim=-1) - 1  # increasing steps of the prefix
    return torch.where(count == RESPONSE_SAMPLES - 1, float("inf"),
                       r[count])


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


def clip_triangles_near(cam_verts, znear):
    """Clip camera-space triangles (T, 3, 3) against the plane z = znear
    (`semantic_meshes.geometry.clip_triangles_near`, op for op).

    Each triangle gives up to two pieces: a triangle with two vertices in
    front clips to a quad, cut along (A, BC). Returns (pieces (T, 2, 3, 3),
    valid (T, 2) bool): where valid, every piece vertex lies at z >= znear
    (the cut vertices exactly on the plane), and each piece keeps the
    input's cyclic orientation. Invalid pieces hold whatever the selects
    give; callers mask them."""
    z = cam_verts[..., 2]
    in_front = z > znear
    bits = in_front.to(torch.int64)
    pattern = bits[:, 0] + 2 * bits[:, 1] + 4 * bits[:, 2]
    # JAX's perm table as a cyclic shift, so the in-front vertices come
    # first: patterns 2 and 6 shift by 1, patterns 4 and 5 by 2 (no host
    # table, so the clipper can be captured in a CUDA graph)
    shift = torch.where((pattern == 2) | (pattern == 6), 1,
                        torch.where((pattern == 4) | (pattern == 5), 2, 0))
    perm = (torch.arange(3, device=cam_verts.device)[None, :]
            + shift[:, None]) % 3
    p = torch.gather(cam_verts, 1, perm[..., None].expand(-1, -1, 3))
    a, b, c = p[:, 0], p[:, 1], p[:, 2]
    za, zb, zc = a[..., 2], b[..., 2], c[..., 2]
    plane = torch.full_like(za, znear)

    def isect(p0, p1, z0, z1):
        t = (plane - z0) / torch.where(z1 == z0, torch.ones_like(z1),
                                       z1 - z0)
        t = torch.clamp(t, 0.0, 1.0)[..., None]
        out = p0 + t * (p1 - p0)
        # z pinned to the plane (no rounding residue below znear)
        return torch.cat([out[..., :2], plane[..., None]], dim=-1)

    ab = isect(a, b, za, zb)
    ac = isect(a, c, za, zc)
    bc = isect(b, c, zb, zc)

    n_in = in_front.sum(dim=-1)
    full = (n_in == 3)[:, None, None]
    one = (n_in == 1)[:, None, None]
    # piece 0: the whole triangle | (A, AB, AC) | (A, B, BC)
    p0 = torch.where(full, p, torch.where(one,
                                          torch.stack([a, ab, ac], dim=1),
                                          torch.stack([a, b, bc], dim=1)))
    # piece 1, for two vertices in front only: (A, BC, AC)
    p1 = torch.stack([a, bc, ac], dim=1)
    return (torch.stack([p0, p1], dim=1),
            torch.stack([n_in >= 1, n_in == 2], dim=1))


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
