"""Frozen plain rasterizer, float64, one view at a time.

Every triangle emits one fragment per pixel centre of its bounding box
(widened by MARGIN_PX, so that a centre within rounding of the box is
tested too), in blocks of at most MAX_FRAGMENTS; the winners and the
fragile pixels are reduced per pixel with scatters, so the result does
not depend on the order of the triangles. See the package docstring for
the semantics and for what "fragile" means.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

Z_NEAR = 1e-6
# the rounding a float32 implementation may make, as a share of the sum
# of the magnitudes of the terms of an edge function or an inverse depth
# (32 float32 ulps)
BAND = 2.0 ** -19
MARGIN_PX = 1.0 / 64
MAX_FRAGMENTS = 1 << 22
_NONE = torch.iinfo(torch.int64).max


class ViewRaster(NamedTuple):
    """ids: (H * W,) int64 owner of each pixel, -1 where empty.
    fragile_pix, fragile_ids: int64 pairs (pixel, possible owner) of the
    fragile pixels; `ids` is one of a fragile pixel's possible owners, or
    -1 where it may stay empty."""

    ids: torch.Tensor
    fragile_pix: torch.Tensor
    fragile_ids: torch.Tensor


class Setup(NamedTuple):
    x: torch.Tensor  # (T, 3) projected vertex x, float64
    y: torch.Tensor
    z: torch.Tensor  # (T, 3) camera depth
    denom: torch.Tensor  # (T,) twice the signed area
    ix0: torch.Tensor  # (T,) int64 first pixel column of the box
    iy0: torch.Tensor
    nx: torch.Tensor  # (T,) int64 box columns (0: no fragment)
    ny: torch.Tensor


def project(vertices, rotation, translation, focal, principal):
    """World points (V, 3) -> (x, y, z) float64: camera = R p + t, pixel =
    f (x / z, y / z) + c."""
    v = vertices.to(torch.float64)
    r = rotation.to(torch.float64)
    cam = v @ r.T + translation.to(torch.float64)
    f = focal.to(torch.float64)
    c = principal.to(torch.float64)
    z = cam[:, 2]
    return f[0] * (cam[:, 0] / z) + c[0], f[1] * (cam[:, 1] / z) + c[1], z


def setup(vertices, faces, rotation, translation, focal, principal, height,
          width):
    """Per-triangle projection and pixel box of one view."""
    x, y, z = project(vertices, rotation, translation, focal, principal)
    fx, fy, fz = x[faces], y[faces], z[faces]
    denom = ((fx[:, 2] - fx[:, 1]) * (fy[:, 0] - fy[:, 1])
             - (fy[:, 2] - fy[:, 1]) * (fx[:, 0] - fx[:, 1]))
    valid = (fz > Z_NEAR).all(dim=1) & (denom != 0) & torch.isfinite(denom)

    def box(lo, hi, n):
        lo = torch.nan_to_num(lo, nan=0.0, posinf=n, neginf=-1.0)
        hi = torch.nan_to_num(hi, nan=-1.0, posinf=n, neginf=-1.0)
        first = torch.ceil(lo - 0.5 - MARGIN_PX).clamp(0, n)
        last = torch.floor(hi - 0.5 + MARGIN_PX).clamp(-1, n - 1)
        return first.to(torch.int64), (last - first + 1).clamp(min=0).to(
            torch.int64)

    ix0, nx = box(fx.amin(1), fx.amax(1), width)
    iy0, ny = box(fy.amin(1), fy.amax(1), height)
    nx = torch.where(valid, nx, torch.zeros_like(nx))
    ny = torch.where(valid, ny, torch.zeros_like(ny))
    return Setup(fx, fy, fz, denom, ix0, iy0, nx, ny)


def _blocks(counts):
    """Triangle ranges [lo, hi) whose fragments number at most
    MAX_FRAGMENTS each (a single larger triangle gets a range alone)."""
    ends = torch.cumsum(counts, 0).cpu().tolist()
    lo, base = 0, 0
    for i, end in enumerate(ends):
        if end - base > MAX_FRAGMENTS and i > lo:
            yield lo, i
            lo, base = i, ends[i - 1]
    if ends and ends[-1] > base:
        yield lo, len(ends)


def fragments(s, width, lo, hi):
    """The fragments of triangles [lo, hi): (tri, pix, edge values e (3, F)
    signed so inside is >= 0, their bands (3, F), inverse depth, its
    band), all float64 but the int64 ids and pixels."""
    device = s.denom.device
    counts = s.nx[lo:hi] * s.ny[lo:hi]
    tri = torch.repeat_interleave(
        torch.arange(lo, hi, device=device), counts)
    start = torch.cumsum(counts, 0) - counts
    local = torch.arange(tri.numel(), device=device) - start[tri - lo]
    nx = s.nx[tri]
    qx = s.ix0[tri] + local % nx
    qy = s.iy0[tri] + local // nx
    px = qx.to(torch.float64) + 0.5
    py = qy.to(torch.float64) + 0.5
    x, y, z = s.x[tri], s.y[tri], s.z[tri]
    denom = s.denom[tri]
    sgn = torch.sign(denom)
    e, band, acc, accb = [], [], 0.0, 0.0
    for i, (j, k) in enumerate(((1, 2), (2, 0), (0, 1))):
        dx = x[:, k] - x[:, j]
        dy = y[:, k] - y[:, j]
        ei = dx * (py - y[:, j]) - dy * (px - x[:, j])
        mag = (dy.abs() * (px.abs() + x[:, j].abs())
               + dx.abs() * (py.abs() + y[:, j].abs()))
        e.append(ei * sgn)
        band.append(BAND * mag)
        acc = acc + ei / z[:, i]
        accb = accb + mag / z[:, i]
    invz = acc / denom
    bandz = BAND * accb / denom.abs()
    return (tri, qy * width + qx, torch.stack(e), torch.stack(band), invz,
            bandz)


def rasterize(vertices, faces, rotation, translation, focal, principal, *,
              height, width):
    """ViewRaster of one view. vertices (V, 3), faces (T, 3) int64 and the
    camera on one device; any float dtype (computed in float64)."""
    s = setup(vertices, faces, rotation, translation, focal, principal,
              height, width)
    device = s.denom.device
    hw = height * width
    blocks = list(_blocks(s.nx * s.ny))
    best = torch.full((hw,), -1.0, dtype=torch.float64, device=device)
    floor = torch.zeros(hw, dtype=torch.float64, device=device)
    for lo, hi in blocks:
        _, pix, e, band, invz, bandz = fragments(s, width, lo, hi)
        strict = (e >= 0).all(0) & (invz > 0)
        robust = (e >= band).all(0) & (invz > 0)
        best.scatter_reduce_(0, pix[strict], invz[strict], "amax")
        floor.scatter_reduce_(0, pix[robust], (invz - bandz)[robust],
                              "amax")
    win = torch.full((hw,), _NONE, dtype=torch.int64, device=device)
    near_n = torch.zeros(hw, dtype=torch.int64, device=device)
    marginal = torch.zeros(hw, dtype=torch.int64, device=device)
    pairs_pix, pairs_id = [], []
    for lo, hi in blocks:
        tri, pix, e, band, invz, bandz = fragments(s, width, lo, hi)
        strict = (e >= 0).all(0) & (invz > 0)
        robust = (e >= band).all(0) & (invz > 0)
        maybe = (e >= -band).all(0) & (invz + bandz > 0)
        top = strict & (invz == best[pix])
        win.scatter_reduce_(0, pix[top], tri[top], "amin")
        near = maybe & (invz + bandz >= floor[pix])
        near_n.index_add_(0, pix[near], torch.ones_like(pix[near]))
        marginal.scatter_reduce_(0, pix[near], (~robust[near]).to(
            torch.int64), "amax")
        pairs_pix.append(pix[near])
        pairs_id.append(tri[near])
    fragile = (near_n >= 2) | ((near_n == 1) & (marginal > 0))
    pp = torch.cat(pairs_pix) if pairs_pix else win[:0]
    pi = torch.cat(pairs_id) if pairs_id else win[:0]
    keep = fragile[pp]
    ids = torch.where(win == _NONE, torch.full_like(win, -1), win)
    return ViewRaster(ids, pp[keep], pi[keep])
