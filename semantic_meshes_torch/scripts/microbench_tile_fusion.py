"""Port of scripts/microbench_tile_fusion.py: the flat per-pixel segment
sum against a two-level reduce over the dense rasterizer's tiles, at the
`scannet` preset.

    python -m semantic_meshes_torch.scripts.microbench_tile_fusion
        [--subdivisions 91] [--width 1296] [--height 968] [--classes 40]
        [--ktile 256] [--repeats 20] [--device cuda|cpu]

Fusion's segment sum reduces one row a pixel (1296 x 968 rows of C + 1
columns at `scannet`). The dense binning already knows which candidates
can own each (16, 128) tile, so the sum can run in two levels: per tile,
a one-hot of the tile's candidate ids against its id image contracted
with its pixel rows (one `torch.bmm` a chunk of tiles), then one segment
sum of the candidate rows. Two variants: every tile padded to the
largest candidate count (kmax), and two classes (tiles of at most KTILE
candidates through the bmm, the heavier tiles' pixel rows straight into
the segment sum). On view 0 of the scene it prints JSON lines: the
per-tile candidate counts (max, p99, mean, tiles, heavy tiles), the
median ms of the flat sum and of each variant, and each variant's
largest difference from its oracle (the flat sum on the rows of binned
candidates; for the two-class reduce the flat sum of the pixels it
accounts for). Runs with TF32 off (the JAX script's Precision.HIGHEST).
"""

from __future__ import annotations

import argparse
import contextlib

import numpy as np
import torch

from . import _microbench as mb

KTILE = 256
# bytes of one-hot a bmm chunk may hold (the kmax variant's (tiles, kmax,
# 2048) float32 one-hot is several GB at `scannet`)
CHUNK_BYTES = 1 << 30


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--subdivisions", type=int, default=91)
    ap.add_argument("--width", type=int, default=1296)
    ap.add_argument("--height", type=int, default=968)
    ap.add_argument("--classes", type=int, default=40)
    ap.add_argument("--ktile", type=int, default=KTILE)
    mb.add_common_args(ap, repeats=20)
    return ap.parse_args(argv)


@contextlib.contextmanager
def no_tf32():
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def tile_view(img, fill):
    """(H, W, ...) -> (B, TILE_H * TILE_W, ...), tiles in row-major
    order, the image padded with `fill` to whole tiles."""
    from ..rasterize.dense import TILE_H, TILE_W

    H, W = img.shape[:2]
    nby, nbx = -(-H // TILE_H), -(-W // TILE_W)
    x = torch.full((nby * TILE_H, nbx * TILE_W) + tuple(img.shape[2:]),
                   fill, dtype=img.dtype, device=img.device)
    x[:H, :W] = img
    x = x.reshape((nby, TILE_H, nbx, TILE_W) + tuple(img.shape[2:]))
    x = x.transpose(1, 2)
    return x.reshape((nby * nbx, TILE_H * TILE_W) + tuple(img.shape[2:]))


def tile_slots(sorted_ids, starts, num_tiles, k, skip=None):
    """The (B, k) table of each tile's first k candidate ids (-2 where
    empty, which matches no pixel) and, per entry of sorted_ids, its tile
    and slot and whether it is in the table. skip: (B,) bool of tiles
    left out."""
    B = num_tiles
    pos = torch.arange(sorted_ids.shape[0], device=sorted_ids.device)
    tile_of = torch.searchsorted(starts[1:B + 1].to(torch.int64), pos,
                                 right=True)
    slot = pos - starts.to(torch.int64)[tile_of]
    in_tile = (tile_of < B) & (slot < k)
    if skip is not None:
        in_tile &= ~skip[tile_of.clamp(max=B - 1)]
    table = torch.full((B, k), -2, dtype=torch.int32,
                       device=sorted_ids.device)
    table[tile_of[in_tile], slot[in_tile]] = sorted_ids[in_tile]
    return table, tile_of, slot, in_tile


def _partials(table, idxt, datat):
    """Per tile, the one-hot (table == ids) times the tile's rows:
    (B, k, D), in chunks of tiles of at most CHUNK_BYTES of one-hot."""
    B, k = table.shape
    out = datat.new_empty((B, k, datat.shape[-1]))
    step = max(1, CHUNK_BYTES // (k * idxt.shape[1] * 4))
    for b in range(0, B, step):
        onehot = (table[b:b + step, :, None]
                  == idxt[b:b + step, None, :]).to(datat.dtype)
        torch.bmm(onehot, datat[b:b + step], out=out[b:b + step])
    return out


def flat_sum(idx_img, data, P):
    """Fusion's reduce: one segment sum of every pixel row by its id."""
    from .. import ops

    return ops.segment_sum(data.reshape(-1, data.shape[-1]),
                           idx_img.reshape(-1), P)


def tile_reduce(idx_img, data, sorted_ids, starts, P, kmax):
    """The two-level reduce with every tile padded to kmax candidates:
    per-tile partial rows, back to the sorted candidate layout, one
    segment sum of the candidate rows. Pixels whose winner is no binned
    candidate of their tile (micro or global-bucket triangles) drop out."""
    from .. import ops

    B = starts.shape[0] - 2
    table, tile_of, slot, in_tile = tile_slots(sorted_ids, starts, B, kmax)
    partials = _partials(table, tile_view(idx_img, -1), tile_view(data, 0.0))
    rows = partials[tile_of[in_tile], slot[in_tile]]
    return ops.segment_sum(rows, sorted_ids[in_tile], P)


def _heavy(starts, ktile):
    B = starts.shape[0] - 2
    return (starts[1:B + 1] - starts[:B]) > ktile


def tile_reduce_two_class(idx_img, data, sorted_ids, starts, P, ktile):
    """Tiles of at most ktile candidates through the one-hot bmm; the
    heavier tiles' pixel rows straight into the same segment sum."""
    from .. import ops

    B = starts.shape[0] - 2
    heavy = _heavy(starts, ktile)
    table, _, _, _ = tile_slots(sorted_ids, starts, B, ktile, skip=heavy)
    idxt, datat = tile_view(idx_img, -1), tile_view(data, 0.0)
    partials = _partials(table, idxt, datat)
    D = data.shape[-1]
    rows = torch.cat([partials.reshape(-1, D), datat[heavy].reshape(-1, D)])
    ids = torch.cat([table.reshape(-1), idxt[heavy].reshape(-1)])
    return ops.segment_sum(rows, ids, P)


def two_class_oracle(idx_img, data, sorted_ids, starts, P, ktile):
    """The flat sum over the pixels tile_reduce_two_class accounts for: a
    light tile's pixels whose winner is in its table, every pixel of a
    heavy tile."""
    from .. import ops

    B = starts.shape[0] - 2
    heavy = _heavy(starts, ktile)
    table, _, _, _ = tile_slots(sorted_ids, starts, B, ktile, skip=heavy)
    idxt, datat = tile_view(idx_img, -1), tile_view(data, 0.0)
    covered = heavy[:, None].expand_as(idxt).clone()
    step = max(1, CHUNK_BYTES // (ktile * idxt.shape[1]))
    for b in range(0, B, step):
        covered[b:b + step] |= (table[b:b + step, :, None]
                                == idxt[b:b + step, None, :]).any(1)
    ids = torch.where(covered, idxt, -1)
    return ops.segment_sum(datat.reshape(-1, data.shape[-1]),
                           ids.reshape(-1), P)


def binned_rows(sorted_ids, starts, P):
    """The ids of the per-tile candidates (small triangles): every pixel
    such a triangle wins lies in a tile that lists it."""
    B = starts.shape[0] - 2
    ids = sorted_ids[:int(starts[B])]
    return torch.unique(ids[(ids >= 0) & (ids < P)]).to(torch.int64)


def max_gap(got, want):
    """(largest |got - want|, largest relative gap over |want| >= 1e-3)."""
    err = (got - want).abs()
    rel = err / want.abs().clamp(min=1e-3)
    return float(err.max()) if err.numel() else 0.0, \
        float(rel.max()) if rel.numel() else 0.0


def main(argv=None):
    args = parse_args(argv)
    from ..data import resolve_device
    from ..rasterize import dense, tiles

    device = resolve_device(args.device)
    H, W, C = args.height, args.width, args.classes
    sc = mb.scene(args.subdivisions, 1, W, H, device)
    cam, P = sc.cams[0], sc.T
    gen = torch.Generator(device=device).manual_seed(0)
    # probabilities and the count column, already weighted
    data = torch.rand((H, W, C + 1), generator=gen, device=device)
    kw = dict(face_vertices=sc.fv, height=H, width=W, device=device)
    pairs, micro = dense.candidate_stats(None, None, *cam, **kw).tolist()
    e_cap = 2 * pairs
    idx_img = dense.rasterize(None, None, *cam, e_cap_rows=e_cap,
                              micro_cap_rows=2 * micro, **kw)[0]
    rounded = dense._cdiv(max(e_cap, dense.CHUNK), dense.CHUNK) * dense.CHUNK
    setup = tiles.setup_inputs(None, None, *cam, sc.fv, device)
    sorted_ids, starts, _, _ = dense._build_sorted_bins(
        setup, H, W, 0.0, rounded, dense.N_GLOBAL)
    B = starts.shape[0] - 2
    counts = (starts[1:B + 1] - starts[:B]).cpu().numpy()
    kmax = int(counts.max())
    kmax_r = -(-max(kmax, 1) // 8) * 8
    heavy = int((counts > args.ktile).sum())
    mb.emit(pairs=pairs, micro_tris=micro, P=P, tiles=B,
            tile_candidates_max=kmax,
            tile_candidates_p99=float(np.percentile(counts, 99)),
            tile_candidates_mean=float(counts.mean()),
            ktile=args.ktile, heavy_tiles=heavy)

    def timed(name, fn, **extra):
        mb.emit(phase=name, ms=mb.median_ms(fn, args.repeats, device),
                **extra)

    with no_tf32():
        timed("flat segment sum", lambda: flat_sum(idx_img, data, P))
        timed("tile bmm + candidate-row segment sum",
              lambda: tile_reduce(idx_img, data, sorted_ids, starts, P,
                                  kmax_r), kmax=kmax_r)
        timed("two-class tile reduce", lambda: tile_reduce_two_class(
            idx_img, data, sorted_ids, starts, P, args.ktile),
            ktile=args.ktile)
        ref = flat_sum(idx_img, data, P)
        rows = binned_rows(sorted_ids, starts, P)
        got = tile_reduce(idx_img, data, sorted_ids, starts, P, kmax_r)
        abs_err, rel_err = max_gap(got[rows], ref[rows])
        mb.emit(check="tile reduce vs flat on binned rows", rows=len(rows),
                max_abs=abs_err, max_rel=rel_err)
        got2 = tile_reduce_two_class(idx_img, data, sorted_ids, starts, P,
                                     args.ktile)
        ref2 = two_class_oracle(idx_img, data, sorted_ids, starts, P,
                                args.ktile)
        abs_err, rel_err = max_gap(got2, ref2)
        mb.emit(check="two-class vs its masked flat sum", max_abs=abs_err,
                max_rel=rel_err)
    seen = torch.nonzero(ref.abs().sum(1) > 0).flatten()
    mb.emit(rows_needing_micro_or_global_legs=int(
        (~torch.isin(seen, rows)).sum()))


if __name__ == "__main__":
    main()
