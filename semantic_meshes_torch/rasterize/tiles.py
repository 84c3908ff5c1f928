"""Triangle setup and screen-tile binning, in torch.

Counterpart of the setup and binning half of
`semantic_meshes/rasterize/xla.py` (`_setup_from_projected`,
`setup_from_face_vertices`, `setup_clipped`, `_triangle_setup`,
`_make_setup`, `_bin_triangles`) and the texel shader's oracle
`barycentrics_at_pixels`. Each op is written in the JAX code's order, so
the per-triangle coefficients round the same way on the CPU and the card.

Determinism: per tile, candidates are the tile's overlapping triangle ids
in ascending order, so the z-resolve (rasterize/tile_kernel.py) keeps the
lowest id on a depth tie.

Near plane: by default any triangle with a vertex at z <= Z_NEAR is culled.
With clip_near, `setup_clipped` cuts each triangle at z = CLIP_Z_NEAR into
up to two pieces, setup rows 2i and 2i + 1 of triangle i; the rasterizers
map a winning row back to its triangle with id >> 1, which is monotone, so
the lowest triangle id still wins a depth tie.
"""

from __future__ import annotations

import math

import torch

from .. import geometry
from ..data import resolve_device

Z_NEAR = 1e-6
# the clipping plane of clip_near (xla.CLIP_Z_NEAR)
CLIP_Z_NEAR = 1e-4

# Tile shape of the z-resolve: one CUDA block per (32, 128) tile
TILE_H = 32
TILE_W = 128


def _cdiv(a, b):
    return -(-a // b)


def project_vertices(vertices, rotation, translation, focal_lengths,
                     principal_point):
    """World-space vertices -> (pixel xy (V, 2), camera z (V,))."""
    cam = geometry.rigid_transform(rotation, translation, vertices)
    pix = geometry.pinhole_project(focal_lengths, principal_point, cam)
    return pix, cam[..., 2]


def _triangle_setup(pix, z_cam, faces):
    """Per-triangle affine coefficients (gather path: pix/z per vertex)."""
    return _setup_from_projected(pix[faces], z_cam[faces])


def setup_from_face_vertices(face_vertices, rotation, translation,
                             focal_lengths, principal_point):
    """Gather-free setup from pre-expanded (T, 3, 3) face-vertex positions
    (the renderer expands the faces once, so per view there is no
    vertex->face gather)."""
    cam = geometry.rigid_transform(rotation, translation, face_vertices)
    pix = geometry.pinhole_project(focal_lengths, principal_point, cam)
    return _setup_from_projected(pix, cam[..., 2])


def setup_clipped(face_vertices, rotation, translation, focal_lengths,
                  principal_point):
    """Setup of the near-plane-clipped pieces of (T, 3, 3) face-vertex
    positions: 2T rows, piece ids 2i and 2i + 1 for triangle i (ascending
    piece order keeps the lowest-triangle-id tie-break; callers map a
    winning id back with id >> 1). A piece that does not exist is invalid.
    Pieces pinned to the plane project up to ~1e4 x the focal length."""
    cam = geometry.rigid_transform(rotation, translation, face_vertices)
    pieces, valid = geometry.clip_triangles_near(cam, CLIP_Z_NEAR)
    t = cam.shape[0]
    cam2 = pieces.reshape(2 * t, 3, 3)
    pix2 = geometry.pinhole_project(focal_lengths, principal_point, cam2)
    setup = _setup_from_projected(pix2, cam2[..., 2])
    setup["valid"] = setup["valid"] & valid.reshape(2 * t)
    return setup


def _setup_from_projected(p, z):
    """Core setup from projected vertices p (T, 3, 2) and camera z (T, 3).

    Returns dict of (T,) tensors: edge coeffs (a_i, b_i, c_i for i in 0..2
    with w_i(x, y) = a_i x + b_i y + c_i), denom (signed 2*area), inv-z
    plane coeffs, bbox, and validity.
    """
    px, py = p[..., 0], p[..., 1]

    def edge(i, j):
        # w = signed_area2(p_i, p_j, pixel) = a x + b y + c
        ax, ay = px[:, i], py[:, i]
        bx, by = px[:, j], py[:, j]
        a = -(by - ay)
        b = bx - ax
        c = (by - ay) * ax - (bx - ax) * ay
        return a, b, c

    a0, b0, c0 = edge(1, 2)
    a1, b1, c1 = edge(2, 0)
    a2, b2, c2 = edge(0, 1)
    denom = a0 * px[:, 0] + b0 * py[:, 0] + c0  # w0 at p0 == 2*signed area
    denom = denom + 0.0  # -0.0 -> +0.0

    safe_denom = torch.where(denom == 0, torch.ones_like(denom), denom)
    inv_z_v = torch.reciprocal(torch.clamp(z, min=Z_NEAR))
    iz0, iz1, iz2 = inv_z_v[:, 0], inv_z_v[:, 1], inv_z_v[:, 2]
    az = (a0 * iz0 + a1 * iz1 + a2 * iz2) / safe_denom
    bz = (b0 * iz0 + b1 * iz1 + b2 * iz2) / safe_denom
    cz = (c0 * iz0 + c1 * iz1 + c2 * iz2) / safe_denom

    valid = torch.all(z > Z_NEAR, dim=-1) & (denom != 0)
    return dict(
        a=torch.stack([a0, a1, a2], -1),
        b=torch.stack([b0, b1, b2], -1),
        c=torch.stack([c0, c1, c2], -1),
        denom=denom,
        az=az,
        bz=bz,
        cz=cz,
        valid=valid,
        xmin=px.amin(-1),
        xmax=px.amax(-1),
        ymin=py.amin(-1),
        ymax=py.amax(-1),
    )


def _make_setup(vertices, faces, rotation, translation, focal_lengths,
                principal_point, face_vertices, clip_near=False):
    """Setup dispatch: gather-free when pre-expanded face vertices exist;
    clip_near goes through the near-plane clipper (2 rows a triangle). All
    inputs are f32 tensors on one device."""
    if clip_near:
        if face_vertices is None:
            face_vertices = vertices[faces]
        return setup_clipped(face_vertices, rotation, translation,
                             focal_lengths, principal_point)
    if face_vertices is not None:
        return setup_from_face_vertices(
            face_vertices, rotation, translation, focal_lengths,
            principal_point,
        )
    pix, z_cam = project_vertices(
        vertices, rotation, translation, focal_lengths, principal_point
    )
    return _triangle_setup(pix, z_cam, faces)


def setup_inputs(vertices, faces, rotation, translation, focal_lengths,
                 principal_point, face_vertices=None, device="cuda",
                 clip_near=False):
    """Triangle setup of one view from host or device inputs (numpy
    arrays or tensors): the gather-free path when `face_vertices` is given,
    which then reads neither `vertices` nor `faces`; with clip_near the 2T
    rows of the clipped pieces (setup_clipped)."""
    device = resolve_device(device)

    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=device)

    if face_vertices is None:
        vertices = f32(vertices)
        faces = torch.as_tensor(faces, dtype=torch.int64, device=device)
    else:
        face_vertices = f32(face_vertices)
    return _make_setup(
        vertices, faces, f32(rotation), f32(translation),
        f32(focal_lengths), f32(principal_point), face_vertices, clip_near,
    )


def pixel_centres(height, width, y_offset, device):
    """(py, px) f32 (H, W) pixel-centre coordinates: row + 0.5 + y_offset
    and column + 0.5, as the JAX package's broadcasted iotas."""
    py = (torch.arange(height, dtype=torch.float32, device=device) + 0.5
          + float(y_offset))
    px = torch.arange(width, dtype=torch.float32, device=device) + 0.5
    return (py[:, None].expand(height, width),
            px[None, :].expand(height, width))


def barycentrics_at_pixels(vertices, faces, rotation, translation,
                           focal_lengths, principal_point, tri_index,
                           y_offset=0):
    """Perspective-correct barycentrics (H, W, 3) of each pixel's winning
    triangle; tri_index (H, W) int32 with -1 empty (garbage there). The
    direct formulation, the texel shader's test oracle. Runs on
    tri_index's device."""
    device = tri_index.device

    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=device)

    pix, z_cam = project_vertices(f32(vertices), f32(rotation),
                                  f32(translation), f32(focal_lengths),
                                  f32(principal_point))
    height, width = tri_index.shape
    f = torch.as_tensor(faces, device=device).long()[
        tri_index.clamp(min=0).long()]  # (H, W, 3)
    p = pix[f]  # (H, W, 3, 2)
    z = z_cam[f]  # (H, W, 3)
    yy, xx = pixel_centres(height, width, y_offset, device)
    pt = torch.stack([xx, yy], dim=-1)
    b2 = geometry.barycentric_2d(pt, p[..., 0, :], p[..., 1, :], p[..., 2, :])
    b3, _ = geometry.perspective_correct(b2, torch.clamp(z, min=Z_NEAR))
    return b3


def _tile_range(lo, hi, size, n):
    """Inclusive tile range [floor(lo/size), floor(hi/size)] clipped to
    [0, n-1]. The float is clamped before the int cast, so a coordinate far
    off screen saturates (as XLA's convert does) instead of wrapping."""
    def tile(v):
        return torch.clamp(torch.floor(v / size), -1.0, float(n)).to(
            torch.int32
        ).clamp(0, n - 1)

    return tile(lo), tile(hi)


def _tile_bounds(setup, height, width, y_offset):
    """Each row's inclusive tile ranges (bx0, bx1, by0, by1) and whether it
    is binned at all (valid and on screen); the tensors may carry leading
    camera axes. `y_offset` shifts the screen window vertically (a row band
    of a taller image)."""
    nby = _cdiv(height, TILE_H)
    nbx = _cdiv(width, TILE_W)
    ymin = setup["ymin"] - y_offset
    ymax = setup["ymax"] - y_offset
    bx0, bx1 = _tile_range(setup["xmin"], setup["xmax"], TILE_W, nbx)
    by0, by1 = _tile_range(ymin, ymax, TILE_H, nby)
    onscreen = (
        (setup["xmax"] >= 0)
        & (setup["xmin"] < width)
        & (ymax >= 0)
        & (ymin < height)
    )
    return bx0, bx1, by0, by1, setup["valid"] & onscreen


def _bin_triangles(setup, height, width, max_tris_per_tile, y_offset):
    """Build per-tile candidate triangle lists (static shapes).

    Returns (cand (B, N) int32 triangle ids ascending, padded with T;
    counts (B,) int32 candidates per tile, capped at N; overflow int32
    total dropped (tile, tri) pairs). B = tiles_y * tiles_x. `y_offset`
    shifts the screen window vertically (a row band of a taller image).
    """
    T = setup["denom"].shape[0]
    nby = _cdiv(height, TILE_H)
    nbx = _cdiv(width, TILE_W)
    device = setup["denom"].device
    bx0, bx1, by0, by1, valid = _tile_bounds(setup, height, width, y_offset)

    tile_y = torch.arange(nby, dtype=torch.int32, device=device)
    tile_x = torch.arange(nbx, dtype=torch.int32, device=device)
    # overlap: (nby, nbx, T) -> (B, T)
    oy = (by0[None, :] <= tile_y[:, None]) & (tile_y[:, None] <= by1[None, :])
    ox = (bx0[None, :] <= tile_x[:, None]) & (tile_x[:, None] <= bx1[None, :])
    overlap = (oy[:, None, :] & ox[None, :, :] & valid[None, None, :]).reshape(
        nby * nbx, T
    )

    tri_ids = torch.arange(T, dtype=torch.int32, device=device)
    keys = torch.where(overlap, tri_ids[None, :], T)
    n = min(max_tris_per_tile, T)
    # the N smallest keys per tile, ascending: VALUES, never the indices
    # (ties among the padding keys T make the indices arbitrary)
    cand = torch.topk(keys, n, dim=1, largest=False, sorted=True).values
    counts = overlap.sum(dim=1)
    overflow = torch.clamp(counts - n, min=0).sum().to(torch.int32)
    return cand.to(torch.int32), torch.clamp(counts, max=n).to(
        torch.int32
    ), overflow


def tile_counts(setup, height, width, y_offset=0.0):
    """(..., B) int64 candidates of each tile, `_bin_triangles`' counts
    before its cap, from a setup whose tensors may carry leading camera
    axes (..., T). Each binned row adds one over its tile rectangle of a
    (tiles_y + 1, tiles_x + 1) difference array, and two prefix sums give
    the counts: no (tiles x rows) tensor."""
    nby = _cdiv(height, TILE_H)
    nbx = _cdiv(width, TILE_W)
    bx0, bx1, by0, by1, valid = _tile_bounds(setup, height, width, y_offset)
    # an empty range bins nowhere in _bin_triangles, and must add nothing
    valid = valid & (bx0 <= bx1) & (by0 <= by1)
    lead = valid.shape[:-1]
    views = math.prod(lead)
    stride = nbx + 1
    cells = (nby + 1) * stride
    x0, x1 = bx0.long(), bx1.long() + 1
    y0, y1 = by0.long() * stride, (by1.long() + 1) * stride
    corners = torch.stack([y0 + x0, y0 + x1, y1 + x0, y1 + x1], dim=-1)
    base = torch.arange(views, device=valid.device) * cells
    corners = corners.reshape(views, -1) + base[:, None]
    sign = torch.tensor([1, -1, -1, 1], dtype=torch.int64,
                        device=valid.device)
    step = (valid.reshape(views, -1, 1).long() * sign).reshape(views, -1)
    diff = torch.zeros(views * cells, dtype=torch.int64, device=valid.device)
    diff.index_add_(0, corners.reshape(-1), step.reshape(-1))
    counts = diff.view(views, nby + 1, stride).cumsum(1).cumsum(2)
    return counts[:, :nby, :nbx].reshape(*lead, nby * nbx)


# views whose tile counts max_tile_rows stacks at once
PROBE_CHUNK = 64


def max_tile_rows(face_vertices, rotations, translations, focal_lengths,
                  principal_points, *, height, width, clip_near=False,
                  device="cuda"):
    """The largest tile list over a camera batch (leading axis), an int64
    device scalar, no host sync: each view's setup as `setup_inputs` makes
    it from the (T, 3, 3) face vertices, then `tile_counts` of PROBE_CHUNK
    views at a time. It equals the largest `_bin_triangles` count before
    the cap over the views."""
    keys = ("xmin", "xmax", "ymin", "ymax", "valid")
    device = resolve_device(device)
    best = torch.zeros((), dtype=torch.int64, device=device)
    chunk = []
    n = len(rotations)
    for i in range(n):
        setup = setup_inputs(None, None, rotations[i], translations[i],
                             focal_lengths[i], principal_points[i],
                             face_vertices, device, clip_near)
        chunk.append([setup[k] for k in keys])
        if len(chunk) == PROBE_CHUNK or i == n - 1:
            stacked = dict(zip(keys, map(torch.stack, zip(*chunk))))
            best = torch.maximum(best, tile_counts(stacked, height,
                                                   width).max())
            chunk = []
    return best
