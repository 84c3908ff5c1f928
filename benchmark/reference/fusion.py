"""Fusion of one view, float64 (the reference's Mesh.h:45-133 and
Fusion.cu:46-92).

A pixel of owner p in [0, P) and probabilities q (C,) adds, for "sum",
w q and, for "mul", w max(log q, -1e30), with w = 0 where sum(q) <= 0.5
(don't care) and 1 elsewhere. Per view, row p of the delta is
    (iew / n_p + (1 - iew)) * S_p,
n_p the pixels of p (don't care included) and S_p the sum of p's pixel
values. The slack of a row bounds what the fragile pixels of the view can
change it by, whichever of their possible owners the program picked.
"""

from __future__ import annotations

import torch

DONT_CARE = 0.5
NEG_LARGE = -1e30


def pixel_values(probs, aggregator, dtype=torch.float64):
    """(N, C) values of (N, C) probabilities, computed in `dtype`."""
    q = probs.to(dtype)
    keep = (q.sum(-1, keepdim=True) > DONT_CARE).to(dtype)
    if aggregator == "sum":
        return q * keep
    if aggregator == "mul":
        return torch.clamp(torch.log(torch.clamp(q, min=0.0)),
                           min=NEG_LARGE) * keep
    raise ValueError(f"the reference fuses 'sum' and 'mul', not "
                     f"{aggregator!r}")


def view_delta(view, probs, *, aggregator, images_equal_weight,
               num_primitives):
    """(delta (P, C) float64, slack (P,) float64) of one view: view is a
    ViewRaster of primitive ids, probs the (H, W, C) probabilities."""
    P = num_primitives
    iew = float(images_equal_weight)
    C = probs.shape[-1]
    flat = probs.reshape(-1, C)
    device = flat.device
    ids = view.ids
    own = (ids >= 0) & (ids < P)
    idx = ids[own]
    values = pixel_values(flat[own], aggregator)
    sums = torch.zeros((P, C), dtype=torch.float64, device=device)
    sums.index_add_(0, idx, values)
    n = torch.bincount(idx, minlength=P).to(torch.float64)
    mix = iew / torch.clamp(n, min=1.0) + (1.0 - iew)
    delta = mix[:, None] * sums

    fp, fi = view.fragile_pix, view.fragile_ids
    ok = (fi >= 0) & (fi < P)
    fp, fi = fp[ok], fi[ok]
    l1 = pixel_values(flat[fp], aggregator).abs().sum(-1)
    moved = torch.zeros(P, dtype=torch.float64, device=device)
    moved.index_add_(0, fi, l1)
    k = torch.bincount(fi, minlength=P).to(torch.float64)
    dmix = iew * (1.0 / torch.clamp(n - k, min=1.0) - 1.0 / torch.clamp(
        n + k, min=1.0))
    slack = dmix * (sums.abs().sum(-1) + moved) + moved
    return delta, slack


def control_delta(view, probs, *, aggregator, images_equal_weight,
                  num_primitives, dtype=torch.bfloat16):
    """The control: the delta of view_delta with every pixel value
    computed in `dtype` (the next precision below the configuration's
    float32) and summed in float32; returned as float32."""
    P = num_primitives
    iew = float(images_equal_weight)
    C = probs.shape[-1]
    flat = probs.reshape(-1, C)
    own = (view.ids >= 0) & (view.ids < P)
    idx = view.ids[own]
    values = pixel_values(flat[own].to(dtype), aggregator, dtype)
    sums = torch.zeros((P, C), dtype=torch.float32, device=flat.device)
    sums.index_add_(0, idx, values.to(torch.float32))
    n = torch.bincount(idx, minlength=P).to(torch.float32)
    mix = iew / torch.clamp(n, min=1.0) + (1.0 - iew)
    return mix[:, None] * sums
