"""Port of the segment-sum probes scripts/microbench_scatter.py,
microbench_scatter2.py, microbench_scatter3.py, microbench_scatter4.py,
microbench_exact16.py and microbench_mxu_crossover.py.

    python -m semantic_meshes_torch.scripts.microbench_segment_sum
        --probe {scatter,scatter2,scatter3,scatter4,exact16,mxu_crossover}
        [--repeats 6] [--scale 1.0] [--device cuda|cpu]

Each JAX script probes a route of the TPU's segment sum that the port
does not keep (int16 and bf16 scatters, exact16's fixed-point limbs, the
one-hot MXU matmul, the f32 scatter's P cliff). The port has one route,
`ops.segment_sum` (a stable sort by segment, then one segmented sum), so
each probe sweeps its script's own shapes (rows, segments P, columns)
through that route, with the scripts' `coherent_ids` (ids roughly
monotone in pixel order with a jitter of +-3, as a render gives) and
random rows in [0, 1) made on the device from seed 0. One JSON line a
shape: the median ms (CUDA events), ns a row and bytes a second (each
row, its id and each output row moved once). `scatter` and `exact16`
also print the largest relative error against a float64 sum, their
accuracy question; `exact16` also times the route's steps. Beside each
shape a line with "route": "index_add_" times `Tensor.index_add_` on the
same inputs, a reference only: its float atomics add in a run-dependent
order, and the port never uses it. --scale multiplies every row and
segment count (a quick run at small sizes).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from . import _microbench as mb

ROWS = 786_432  # 1024 x 768
ROWS_2M = 2_097_152  # 2048 x 1024
SEGS = 500_000

# (rows, P, columns[, ids]) of each probe: the JAX script's shapes
PROBES = {
    # microbench_scatter.py: the column count at P 500k (f32 x 20, 8, 4;
    # its bf16 / int16 widths 20 and 63), coherent and shuffled ids, and
    # its exactness check (1000 rows of one column into one segment)
    "scatter": [(ROWS, SEGS, c, ids) for c in (20, 8, 4, 63)
                for ids in ("coherent", "random")] + [(1000, 1, 1,
                                                       "coherent")],
    # microbench_scatter2.py: wide rows (exact16's 105-275 int16 limb
    # columns) and a small-row scatter
    "scatter2": [(ROWS, SEGS, c) for c in (105, 168, 275)]
    + [(49_152, SEGS, 63)],
    # microbench_scatter3.py: cost against P at two row counts, f32 x 21
    # and exact16's 252 limb columns
    "scatter3": [(rows, P, c) for rows in (ROWS, ROWS_2M)
                 for P in (10_000, 49_152, 100_000, SEGS) for c in (21, 252)],
    # microbench_scatter4.py: bracketing the TPU's P cliff, and whether
    # it tracks the accumulator's bytes
    "scatter4": [(ROWS, P, 21) for P in (131_072, 196_608, 262_144,
                                         393_216)]
    + [(ROWS, 393_216, 10), (ROWS, 196_608, 41), (ROWS, SEGS, 10),
       (ROWS, 100_000, 41)],
    # microbench_exact16.py: the dense preset's fusion shape
    "exact16": [(ROWS, SEGS, 21)],
    # microbench_mxu_crossover.py: the mid-P sweep of the one-hot route
    "mxu_crossover": [(ROWS, P, 21) for P in (3_072, 6_144, 12_288,
                                              24_576, 49_152)],
}
ACCURACY = {"scatter": 20, "exact16": 21}  # columns whose error is printed


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--probe", required=True, choices=list(PROBES))
    ap.add_argument("--scale", type=float, default=1.0,
                    help="multiply every row and segment count")
    mb.add_common_args(ap, repeats=6)
    return ap.parse_args(argv)


def coherent_ids(rows, segs, rng):
    """Render-like ids: roughly monotone in pixel order with local jitter
    (the JAX scripts' coherent_ids)."""
    base = (np.arange(rows, dtype=np.int64) * segs) // rows
    jitter = rng.integers(-3, 4, rows)
    return np.clip(base + jitter, 0, segs - 1).astype(np.int32)


def oracle(data, idx, P):
    """The float64 segment sums of the rows, on the host."""
    data = data.double().cpu().numpy()
    idx = idx.cpu().numpy()
    return np.stack([np.bincount(idx, weights=data[:, j], minlength=P)
                     for j in range(data.shape[1])], 1)


def max_rel_error(got, want):
    """Largest |got - want| / |want| over the segments that got rows."""
    seen = np.abs(want).sum(1) > 0
    got = got.double().cpu().numpy()[seen]
    want = want[seen]
    return float((np.abs(got - want) / np.maximum(np.abs(want), 1e-30))
                 .max()) if seen.any() else 0.0


def route_steps(data, idx, P, reps, device):
    """ms of each step of ops.segment_sum on these inputs."""
    key = idx.to(torch.int64)
    order = torch.sort(key, stable=True).indices
    counts = torch.bincount(key, minlength=P + 1)[:P]
    offsets = torch.zeros(P + 1, dtype=torch.int64, device=data.device)
    torch.cumsum(counts, dim=0, out=offsets[1:])
    rows = data[order]
    return {
        "sort": mb.median_ms(lambda: torch.sort(key, stable=True), reps,
                             device),
        "bincount + cumsum": mb.median_ms(lambda: torch.cumsum(
            torch.bincount(key, minlength=P + 1)[:P], 0), reps, device),
        "gather": mb.median_ms(lambda: data[order], reps, device),
        "segment_reduce": mb.median_ms(lambda: torch.segment_reduce(
            rows, "sum", offsets=offsets, axis=0, unsafe=True), reps,
            device),
    }


def main(argv=None):
    args = parse_args(argv)
    from .. import ops
    from ..data import resolve_device

    device = resolve_device(args.device)
    rng = np.random.default_rng(0)
    gen = torch.Generator(device=device).manual_seed(0)
    for shape in PROBES[args.probe]:
        rows, P = (max(1, int(n * args.scale)) for n in shape[:2])
        cols = shape[2]
        order = shape[3] if len(shape) > 3 else "coherent"
        ids = coherent_ids(rows, P, rng)
        if order == "random":
            ids = rng.permutation(ids)
        idx = torch.from_numpy(ids).to(device)
        data = torch.rand((rows, cols), generator=gen, device=device)
        nbytes = rows * cols * 4 + rows * 4 + P * cols * 4
        line = dict(probe=args.probe, rows=rows, P=P, cols=cols, ids=order)
        for route, fn in (
                ("ops.segment_sum", lambda: ops.segment_sum(data, idx, P)),
                ("index_add_", lambda: torch.zeros(
                    (P, cols), device=device).index_add_(0, idx, data))):
            ms = mb.median_ms(fn, args.repeats, device)
            extra = {}
            if route == "index_add_":
                extra["note"] = ("reference only: float atomics, "
                                 "run-dependent order; not used by the port")
            elif cols == ACCURACY.get(args.probe):
                extra["max_rel_error_vs_float64"] = max_rel_error(
                    ops.segment_sum(data, idx, P), oracle(data, idx, P))
            mb.emit(**line, route=route, ms=ms, ns_per_row=ms * 1e6 / rows,
                    bytes_per_s=nbytes / (ms / 1e3), **extra)
        if args.probe == "exact16":
            mb.emit(**line, route="ops.segment_sum steps",
                    ms=route_steps(data, idx, P, args.repeats, device))
        del data, idx


if __name__ == "__main__":
    main()
