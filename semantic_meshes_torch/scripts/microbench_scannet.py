"""Port of scripts/microbench_scannet.py: where a `scannet` view's time
goes.

    python -m semantic_meshes_torch.scripts.microbench_scannet
        [--subdivisions 91] [--views 8] [--width 1296] [--height 968]
        [--classes 40] [--repeats 20] [--device cuda|cpu]

At bench.py's `scannet` preset (cube s=91, 99372 triangles, 1296x968,
40 classes; probabilities made on the device from seed 0) it prints JSON
lines: the candidate pairs and micro triangles of view 0, the routing
curve (pairs and micro triangles at micro_max 1, 2, 3, 4 and 6), and
the median time in ms of each piece of view 0 (`{"phase", "ms"}`):

- `full planned step`: render_and_accumulate under the scene's
  plan_fuse budget (the bench's per-view step);
- `fuse_views_planned per view`: the bench's batch over the views, over
  the views;
- `dense.rasterize`: the whole rasterizer at twice the view's pairs;
- `setup + classify + sorted binning`, then `+ table`: the steps before
  the kernel (dense._build_sorted_bins, tile_kernel.candidate_table);
- `setup + micro path`: dense._micro_key of the view's micro triangles;
- `fusion`: fusion._accumulate_view on the view's rendered ids.

Each is timed between CUDA events (profiling.times_ms) on a card.
"""

from __future__ import annotations

import argparse
import dataclasses

from . import _microbench as mb

ROUTING = (1, 2, 3, 4, 6)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--subdivisions", type=int, default=91)
    ap.add_argument("--views", type=int, default=8)
    ap.add_argument("--width", type=int, default=1296)
    ap.add_argument("--height", type=int, default=968)
    ap.add_argument("--classes", type=int, default=40)
    mb.add_common_args(ap, repeats=20)
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from .. import distributed, fusion
    from ..bench import IEW, device_probs
    from ..data import resolve_device
    from ..rasterize import dense, tile_kernel, tiles

    device = resolve_device(args.device)
    H, W = args.height, args.width
    sc = mb.scene(args.subdivisions, args.views, W, H, device)
    cam = sc.cams[0]
    probs = device_probs(args.views, H, W, args.classes, device)
    kw = dict(face_vertices=sc.fv, height=H, width=W, device=device)

    pairs, micro, _ = dense.candidate_stats(None, None, *cam,
                                            **kw).tolist()
    mb.emit(triangles=sc.T, pairs=pairs, micro_tris=micro,
            micro_max=dense.MICRO_MAX)
    for m in ROUTING:
        p, mu, _ = dense.candidate_stats(None, None, *cam, micro_max=m,
                                         **kw).tolist()
        mb.emit(routing_micro_max=m, pairs=p, micro_tris=mu,
                fragment_rows=m * m * mu)

    def timed(name, fn):
        mb.emit(phase=name, ms=mb.median_ms(fn, args.repeats, device))

    # the dense rasterizer's plan (auto dispatch picks it at 16384 faces
    # or more; a smaller --subdivisions still measures the dense path)
    plan = distributed.plan_fuse(sc.vertices, sc.faces, *sc.host_cams,
                                 height=H, width=W, backend="dense",
                                 device=device)
    vertices = fusion._as_f32(sc.vertices, device)
    plan_fv = vertices[plan.faces]
    mb.emit(plan_dense_e_cap=dataclasses.asdict(plan.dense_e_cap))
    fuse_kw = dict(num_primitives=sc.T, aggregator="sum", height=H,
                   width=W, device=device)
    timed("full planned step", lambda: distributed.render_and_accumulate(
        vertices, plan.faces, cam, probs[0], None, IEW,
        face_vertices=plan_fv, dense_e_cap=plan.dense_e_cap,
        tri_ids=plan.remap, backend="dense", **fuse_kw))
    batch_ms = mb.median_ms(lambda: distributed.fuse_views_planned(
        plan, vertices, *sc.arrays, probs, IEW, **fuse_kw),
        max(2, args.repeats // 4), device)
    mb.emit(phase="fuse_views_planned per view", ms=batch_ms / args.views,
            views=args.views)

    e_cap = 2 * pairs
    rounded = dense._cdiv(max(e_cap, dense.CHUNK), dense.CHUNK) * dense.CHUNK

    def rasterize():
        return dense.rasterize(None, None, *cam, e_cap_rows=e_cap, **kw)

    def setup():
        return tiles.setup_inputs(None, None, *cam, sc.fv, device)

    def bins(s):
        return dense._build_sorted_bins(s, H, W, 0.0, rounded,
                                        dense.N_GLOBAL)

    def bins_table():
        s = setup()
        return bins(s), tile_kernel.candidate_table(s)

    def micro_path():
        s = setup()
        return dense._micro_key(s, dense._classify(s, H, W, 0.0)[0], H, W,
                                0.0)

    timed("dense.rasterize", rasterize)
    timed("setup + classify + sorted binning", lambda: bins(setup()))
    timed("setup + classify + sorted binning + table", bins_table)
    timed("setup + micro path", micro_path)
    ids = rasterize()[0]
    timed("fusion", lambda: fusion._accumulate_view(
        ids, probs[0], None, IEW, num_primitives=sc.T, aggregator="sum"))


if __name__ == "__main__":
    main()
