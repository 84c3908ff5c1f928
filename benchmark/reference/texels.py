"""Texel mode, worked out again in float64: each triangle's grid
resolution from the cameras, its corner order, and the texel cell of a
pixel (the reference's TexturedTriangleRenderer.h:31-41 and 93-146).

r = ceil(tpp * sqrt(a)), a the largest screen area over the cameras that
have a vertex in front (z > 0) and all three projected vertices inside the
box [-W/2, 3W/2) x [-H/2, 3H/2); a triangle of r has r (r + 1) / 2 texels,
numbered after those of every triangle before it. Its corners are
reordered so that the one whose angle lies nearest 90 degrees maps to uv
(0, 0), the first such on a tie, and the other two are swapped when the
second's angle lies no nearer 90 degrees than the third's. A pixel's cell
follows from its perspective-correct (u, v) = (b1, b2).
"""

from __future__ import annotations

import math

import torch

from . import raster
from .raster import ViewRaster

UV_EPS = 1e-6  # the reference subtracts 1e-6 before it floors u r, v r
# the (u, v) rounding a float32 shader may make
UV_BAND = 2.0 ** -14
# two angles closer than this may be ordered either way in float32
ANGLE_BAND = 1e-5
CAMERA_CHUNK = 16


def resolutions(vertices, faces, rotations, translations, focals,
                principals, *, height, width, texels_per_pixel):
    """(r (T,) int64, the count of triangles whose r a float32
    computation could round the other way)."""
    flat = vertices.to(torch.float64)[faces.reshape(-1)]
    best = torch.zeros(faces.shape[0], dtype=torch.float64,
                       device=flat.device)
    for k in range(0, rotations.shape[0], CAMERA_CHUNK):
        r = rotations[k:k + CAMERA_CHUNK].to(torch.float64)
        t = translations[k:k + CAMERA_CHUNK].to(torch.float64)
        f = focals[k:k + CAMERA_CHUNK].to(torch.float64)
        c = principals[k:k + CAMERA_CHUNK].to(torch.float64)
        cam = torch.einsum("cij,nj->cni", r, flat) + t[:, None, :]
        z = cam[..., 2]
        x = f[:, 0, None] * (cam[..., 0] / z) + c[:, 0, None]
        y = f[:, 1, None] * (cam[..., 1] / z) + c[:, 1, None]
        inside = ((x >= -0.5 * width) & (x < 1.5 * width)
                  & (y >= -0.5 * height) & (y < 1.5 * height))
        inside = inside.reshape(len(r), -1, 3).all(-1)
        front = (z > 0).reshape(len(r), -1, 3).any(-1)
        x = x.reshape(len(r), -1, 3)
        y = y.reshape(len(r), -1, 3)
        area = 0.5 * torch.abs(
            x[..., 0] * (y[..., 1] - y[..., 2])
            + x[..., 1] * (y[..., 2] - y[..., 0])
            + x[..., 2] * (y[..., 0] - y[..., 1]))
        area = torch.where(inside & front, area, torch.zeros_like(area))
        best = torch.maximum(best, torch.nan_to_num(area, nan=0.0).amax(0))
    q = texels_per_pixel * torch.sqrt(best)
    res = torch.ceil(q).to(torch.int64)
    near_int = (q - torch.round(q)).abs() <= 1e-5 * torch.clamp(q, min=1.0)
    return res, int((near_int & (best > 0)).sum())


def first_texel(res):
    """(first texel id (T,) int64, total texels)."""
    counts = res * (res + 1) // 2
    first = torch.cumsum(counts, 0) - counts
    return first, int(counts.sum())


def corner_orders(vertices, faces):
    """(orders (2, T, 3) int64, ambiguous (T,) bool): the reordered
    corners of each triangle, and a second order that a float32
    computation could have picked where two angles tie within
    ANGLE_BAND (equal to the first elsewhere)."""
    p = vertices.to(torch.float64)[faces]

    def diff(i):
        a, b, c = p[:, i], p[:, (i + 1) % 3], p[:, (i + 2) % 3]
        e1, e2 = b - a, c - a
        den = e1.norm(dim=1) * e2.norm(dim=1)
        cos = (e1 * e2).sum(1) / torch.clamp(den, min=1e-300)
        ang = torch.arccos(torch.clamp(cos, -1.0, 1.0))
        return torch.where(den > 0, (ang - math.pi / 2).abs(),
                           torch.full_like(ang, math.inf))

    d = torch.stack([diff(0), diff(1), diff(2)], -1)

    def order(best, flip):
        f0 = faces.gather(1, best[:, None])[:, 0]
        f1 = torch.where(best == 1, faces[:, 0], faces[:, 1])
        f2 = torch.where(best == 2, faces[:, 0], faces[:, 2])
        d1 = torch.where(best == 1, d[:, 0], d[:, 1])
        d2 = torch.where(best == 2, d[:, 0], d[:, 2])
        swap = (d1 >= d2) ^ (flip & ((d1 - d2).abs() <= ANGLE_BAND))
        return torch.stack([f0, torch.where(swap, f2, f1),
                            torch.where(swap, f1, f2)], -1)

    best = torch.argmin(d, dim=1)
    lowest = d.gather(1, best[:, None])[:, 0]
    # the last of the angles tied with the first minimum
    tied = (d - lowest[:, None]).abs() <= ANGLE_BAND
    alt_best = 2 - torch.argmax(tied.flip(1).to(torch.int64), dim=1)
    first = order(best, torch.zeros_like(best, dtype=torch.bool))
    second = order(alt_best, torch.ones_like(best, dtype=torch.bool))
    ambiguous = (first != second).any(1)
    return torch.stack([first, second]), ambiguous


def _cell(u, v, r):
    rf = r.to(torch.float64)

    def grid(w):
        f = torch.floor((w - UV_EPS) * rf)
        f = torch.nan_to_num(f, nan=0.0)
        return torch.minimum(torch.clamp(f, min=0.0), rf - 1).to(torch.int64)

    iu, iv = grid(u), grid(v)
    k = torch.minimum(iu + iv, r - 1)
    iv = torch.minimum(iv, k)
    return k * (k + 1) // 2 + iv


def texel_candidates(vertices, orders, res, first, pix, tri, camera, *,
                     width):
    """(N, K) int64 texel ids that a float32 shader could give pixel
    `pix` on triangle `tri` (-1 where the triangle has no texel): every
    corner order of `orders` at (u, v) and at (u, v) moved by UV_BAND."""
    x, y, z = raster.project(vertices, *camera)
    px = (pix % width).to(torch.float64) + 0.5
    py = (pix // width).to(torch.float64) + 0.5
    r = torch.clamp(res[tri], min=1)
    out = []
    for o in orders:
        f = o[tri]
        fx, fy, fz = x[f], y[f], z[f]
        w = []
        for j, k in ((1, 2), (2, 0), (0, 1)):
            w.append(((fx[:, k] - fx[:, j]) * (py - fy[:, j])
                      - (fy[:, k] - fy[:, j]) * (px - fx[:, j])))
        w = torch.stack(w, -1) / fz
        s = w.sum(-1)
        u, v = w[:, 1] / s, w[:, 2] / s
        for du in (-UV_BAND, 0.0, UV_BAND):
            for dv in (-UV_BAND, 0.0, UV_BAND):
                out.append(first[tri] + _cell(u + du, v + dv, r))
    ids = torch.stack(out, -1)
    return torch.where((res[tri] > 0)[:, None], ids, torch.full_like(ids, -1))


def shade(view, vertices, orders, res, first, camera, *, width):
    """The ViewRaster of texel ids of a ViewRaster of triangle ids: the
    centre cell of the first corner order is the owner; a pixel whose
    candidates differ becomes fragile with each of them."""
    covered = torch.nonzero(view.ids >= 0).reshape(-1)
    cand = texel_candidates(vertices, orders, res, first, covered,
                            view.ids[covered], camera, width=width)
    ids = torch.full_like(view.ids, -1)
    ids[covered] = cand[:, 4]
    split = (cand != cand[:, :1]).any(1)
    fp = [covered[split][:, None].expand(-1, cand.shape[1])]
    fi = [cand[split]]
    if view.fragile_pix.numel():
        fc = texel_candidates(vertices, orders, res, first, view.fragile_pix,
                              view.fragile_ids, camera, width=width)
        fp.append(view.fragile_pix[:, None].expand(-1, fc.shape[1]))
        fi.append(fc)
    pix = torch.cat([p.reshape(-1) for p in fp])
    tex = torch.cat([i.reshape(-1) for i in fi])
    pairs = torch.unique(torch.stack([pix, tex]), dim=1)
    pairs = pairs[:, pairs[1] >= 0]
    return ViewRaster(ids, pairs[0], pairs[1])
