"""Port of scripts/microbench_microrows.py: the marginal cost of a micro
fragment row at the `dense` preset.

    python -m semantic_meshes_torch.scripts.microbench_microrows
        [--subdivisions 204] [--width 1024] [--height 768] [--repeats 8]
        [--device cuda|cpu]

Renders the 4 ring views of 1024x768 of the cube s=204 (499392
triangles) on the pure micro path (e_cap_rows = 0: no binning, no
kernel) with the micro-row budget `micro_cap_rows` at T, 3T/4 and T/2
(below T the rows are compacted first and the rest dropped: a timing
probe, not a render). Prints one JSON line per budget (ms a view, the
fragment rows 4 min(cap, T) + H W) and the marginal ns a row between T
and T/2. The uni-slot split (dense.split_wins) pays when removing rows
saves time at this rate.
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
    from ..rasterize import dense

    device = resolve_device(args.device)
    H, W = args.height, args.width
    sc = mb.scene(args.subdivisions, VIEWS, W, H, device)
    T = sc.T
    per_slot = dense.MICRO_MAX * dense.MICRO_MAX
    results = {}
    for cap in (T, 3 * T // 4, T // 2):
        def render_views(cap=cap):
            return [dense.rasterize(None, None, *cam, face_vertices=sc.fv,
                                    height=H, width=W, e_cap_rows=0,
                                    micro_cap_rows=cap, device=device)
                    for cam in sc.cams]

        ms = mb.median_ms(render_views, args.repeats, device) / VIEWS
        rows = per_slot * min(cap, T) + H * W
        results[cap] = (ms, rows)
        mb.emit(micro_cap=cap, ms_per_view=ms, rows=rows,
                exact=cap >= T)
    (ms_full, rows_full), (ms_half, rows_half) = results[T], results[T // 2]
    mb.emit(triangles=T, views=VIEWS,
            ns_per_row=(ms_full - ms_half) * 1e6 / (rows_full - rows_half))


if __name__ == "__main__":
    main()
