"""Port of scripts/microbench_dense.py: the pieces of a `dense` view.

    python -m semantic_meshes_torch.scripts.microbench_dense
        [--subdivisions 204] [--width 1024] [--height 768] [--repeats 8]
        [--device cuda|cpu]

At bench.py's `dense` preset (cube s=204, 499392 triangles, the first of
4 ring views of 1024x768) it prints JSON lines: the triangle count, the
view's candidate pairs, then the median ms of each piece of the dense
rasterizer (`{"phase", "ms"}`): the triangle setup, the sorted binning
(dense._build_sorted_bins at twice the pairs), the micro path
(dense._rasterize_micro of the view's micro triangles) and the whole
dense.rasterize. Each is timed between CUDA events on a card.
"""

from __future__ import annotations

import argparse

from . import _microbench as mb

VIEWS = 4


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--subdivisions", type=int, default=204)
    ap.add_argument("--width", type=int, default=1024)
    ap.add_argument("--height", type=int, default=768)
    mb.add_common_args(ap, repeats=8)
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from ..data import resolve_device
    from ..rasterize import dense, tiles

    device = resolve_device(args.device)
    H, W = args.height, args.width
    sc = mb.scene(args.subdivisions, VIEWS, W, H, device)
    cam = sc.cams[0]
    mb.emit(triangles=sc.T)
    pairs = int(dense.candidate_count(None, None, *cam, face_vertices=sc.fv,
                                      height=H, width=W, device=device))
    mb.emit(candidate_rows=pairs)
    e_cap_rows = 2 * pairs
    e_cap = dense._cdiv(max(e_cap_rows, dense.CHUNK),
                        dense.CHUNK) * dense.CHUNK

    def setup():
        return tiles.setup_inputs(None, None, *cam, sc.fv, device)

    def timed(name, fn):
        mb.emit(phase=name, ms=mb.median_ms(fn, args.repeats, device))

    timed("setup", setup)
    s = setup()
    timed("build_sorted_bins", lambda: dense._build_sorted_bins(
        s, H, W, 0.0, e_cap, dense.N_GLOBAL))
    micro = dense._classify(s, H, W, 0.0)[0]
    timed("rasterize_micro", lambda: dense._rasterize_micro(
        s, micro, H, W, 0.0))
    timed("full_dense_rasterize", lambda: dense.rasterize(
        None, None, *cam, face_vertices=sc.fv, height=H, width=W,
        e_cap_rows=e_cap_rows, device=device))


if __name__ == "__main__":
    main()
