"""The comparison that decides `correct`.

`BatchReference` works out a batch of the window again from the scene
(mesh, poses and probability pool, as the harness handed them to the
program) and `row_gap` judges the program's fused accumulator of that
batch against it, row by row: each row's L1 gap less the slack that its
fragile pixels allow, over the row's L1 norm plus that slack (at least
a thousandth of the median covered row's norm). Every number compared
has its limit in `limits.json`.
"""

from __future__ import annotations

import json
from pathlib import Path

import torch

from . import fusion, raster, texels

LIMITS = Path(__file__).with_name("limits.json")


def limits():
    with open(LIMITS) as f:
        return json.load(f)


def row_gap(acc, ref, slack):
    """Largest relative excess of |acc - ref| over the slack, any row."""
    gap = (acc.to(torch.float64) - ref).abs().sum(1)
    norm = ref.abs().sum(1)
    covered = norm[norm > 0]
    floor = 1e-3 * float(covered.median()) if covered.numel() else 1.0
    excess = torch.clamp(gap - slack, min=0.0) / torch.clamp(norm + slack,
                                                             min=floor)
    return float(excess.max())


def judge(numbers):
    """(correct, [(name, value, limit)]): each number at most its limit."""
    table = limits()
    rows = [(name, float(value), float(table[name]))
            for name, value in numbers.items()]
    return all(v <= lim for _, v, lim in rows), rows


class BatchReference:
    """The reference's result of batch b: views (b * V + j) mod frames
    of the trajectory, probabilities from pool slots (b * V + j) mod
    pool_frames, j < V.

    vertices (V, 3), faces (T, 3) int64 and the camera arrays of every
    frame (R (F, 3, 3), t (F, 3), f (F, 2), c (F, 2)) on one device;
    `pool` the probability pool. In texel mode the resolutions, first
    texel ids and corner orders are worked out here from all frames."""

    def __init__(self, vertices, faces, cameras, pool, *, config, traffic):
        self.vertices = vertices
        self.faces = faces.to(torch.int64)
        self.cameras = cameras
        self.pool = pool
        self.height, self.width = int(config["height"]), int(config["width"])
        self.frames = int(config["frames"])
        self.pool_frames = int(config["pool_frames"])
        self.views = int(traffic["views_per_batch"])
        self.aggregator = config["aggregator"]
        self.iew = float(config["images_equal_weight"])
        self.texels = traffic["mode"] == "texels"
        self.ambiguous_sizing = 0
        self.num_primitives = int(self.faces.shape[0])
        if self.texels:
            self.res, self.ambiguous_sizing = texels.resolutions(
                vertices, self.faces, *cameras, height=self.height,
                width=self.width,
                texels_per_pixel=float(traffic["texels_per_pixel"]))
            self.first, self.num_primitives = texels.first_texel(self.res)
            self.orders, _ = texels.corner_orders(vertices, self.faces)

    def view(self, frame):
        """ViewRaster of primitive ids of trajectory frame `frame`."""
        cam = tuple(a[frame] for a in self.cameras)
        v = raster.rasterize(self.vertices, self.faces, *cam,
                             height=self.height, width=self.width)
        if self.texels:
            v = texels.shade(v, self.vertices, self.orders, self.res,
                             self.first, cam, width=self.width)
        return v

    def frames_of(self, batch):
        first = batch * self.views
        return [((first + j) % self.frames, (first + j) % self.pool_frames)
                for j in range(self.views)]

    def batch(self, batch):
        """(accumulator (P, C) float64, slack (P,) float64)."""
        acc = slack = None
        for frame, slot in self.frames_of(batch):
            d, s = fusion.view_delta(
                self.view(frame), self.pool[slot],
                aggregator=self.aggregator, images_equal_weight=self.iew,
                num_primitives=self.num_primitives)
            acc = d if acc is None else acc + d
            slack = s if slack is None else slack + s
        return acc, slack

    def control(self, batch):
        """The control's accumulator of the batch (fusion.control_delta
        over the reference's own owners), float32."""
        acc = None
        for frame, slot in self.frames_of(batch):
            d = fusion.control_delta(
                self.view(frame), self.pool[slot],
                aggregator=self.aggregator, images_equal_weight=self.iew,
                num_primitives=self.num_primitives)
            acc = d if acc is None else acc + d
        return acc
