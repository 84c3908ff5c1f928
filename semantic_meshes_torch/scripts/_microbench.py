"""Pieces the microbenches share: the cube scene on the device, the timer
and the JSON lines they print."""

from __future__ import annotations

import json
import statistics
from types import SimpleNamespace

import torch


def add_common_args(ap, repeats):
    ap.add_argument("--repeats", type=int, default=repeats,
                    help="timed calls per measurement (the median is "
                         "printed)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, or cpu)")


def scene(subdivisions, views, width, height, device):
    """The cube of `subdivisions` seen by `views` ring cameras of width x
    height: host arrays (vertices, faces, host_cams as stack_cameras
    gives them) and on `device` the face vertices `fv`, the stacked
    (rotations, translations, focal_lengths, principal_points) in
    `arrays` and each view's slices of them in `cams`."""
    from .. import testing
    from ..data import stack_cameras

    vertices, faces = testing.make_cube(subdivisions=subdivisions)
    host_cams = stack_cameras(testing.make_ring_cameras(
        num_views=views, width=width, height=height))
    arrays = tuple(torch.as_tensor(a, dtype=torch.float32, device=device)
                   for a in host_cams)
    fv = torch.as_tensor(vertices, dtype=torch.float32, device=device)[
        torch.as_tensor(faces, dtype=torch.int64, device=device)]
    return SimpleNamespace(
        vertices=vertices, faces=faces, host_cams=host_cams, fv=fv,
        T=len(faces), arrays=arrays, cams=[tuple(a[i] for a in arrays)
                            for i in range(views)])


def median_ms(fn, reps, device):
    """Median of `reps` timed calls of fn() after one untimed call (CUDA
    events on a card, profiling.times_ms)."""
    from ..profiling import times_ms

    return statistics.median(times_ms(fn, reps, device, warmup=1))


def emit(**fields):
    """One JSON line on stdout."""
    print(json.dumps(fields), flush=True)
