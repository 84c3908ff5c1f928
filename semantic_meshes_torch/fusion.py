"""Fusion: per-primitive class-distribution aggregation as segment sums.

Counterpart of `semantic_meshes/fusion.py` (reference:
include/semantic_meshes/fusion/Mesh.h:45-133,
python/semantic_meshes/src/Fusion.cu:46-92). Fusion runs on the device
that holds the accumulator; each `add` is one deterministic segment sum,
by the hand-written kernels of fusion_kernel on the card and by a chain of
PyTorch ops (ops.segment_sum) on the CPU, so render -> fuse never leaves
device memory.

Aggregator semantics (all per Fusion.cu):
- "sum":    acc += probs * w;                get: L1-normalize, nan/inf->0
- "summax": keep only the argmax component of each pixel's probs (times w),
            then sum; same post-chain (Fusion.cu:46-64)
- "mul":    Bayesian product accumulated in log space: acc_log += w*log(probs)
            with a finite -1e30 in place of log(0); get: exp(acc - max),
            then L1-normalize, nan/inf->0.

Per-pixel weight mix (Mesh.h:90-103): pixels_per_face counts *all* pixels of
a primitive in the image (don't-care included); then
  weight = images_equal_weight * (1 / pixels_per_face) + (1 - iew) * 1
times the optional per-pixel weights image. Pixels with sum(probs) <= 0.5
(don't-care, Mesh.h:98) and out-of-range primitive ids (Mesh.h:95, includes
the 0xFFFFFFFF background) are skipped.

Primitive images may be uint32 (0xFFFFFFFF background), int32 (-1
background) or int64 tensors, or numpy arrays of those types; uint32 is
read through an int32 bit view, so its background lands out of range.
"""

from __future__ import annotations

import numpy as np
import torch

from . import fusion_kernel, ops
from .data import resolve_device
from .profiling import span

AGGREGATORS = ("sum", "summax", "mul")

DONT_CARE_THRESHOLD = 0.5  # ref: Mesh.h:98
_NEG_LARGE = -1e30  # finite stand-in for log(0); keeps segment sums NaN-free


def as_ids(primitive_indices, device):
    """Primitive-id image as a signed integer tensor on `device`: uint32
    (numpy or torch) becomes its int32 bit view, so ids >= 2^31 and the
    0xFFFFFFFF background read negative, i.e. out of range."""
    p = primitive_indices
    if isinstance(p, np.ndarray) or not torch.is_tensor(p):
        p = np.asarray(p)
        if p.dtype == np.uint32:
            p = p.view(np.int32)
        elif p.dtype == np.uint64:
            p = p.view(np.int64)
        p = torch.from_numpy(_writable(p))
    elif p.dtype == torch.uint32:
        p = p.contiguous().view(torch.int32)
    elif p.dtype == torch.uint64:
        p = p.contiguous().view(torch.int64)
    if p.dtype.is_floating_point or p.dtype == torch.bool:
        raise ValueError(f"primitive ids must be integers, got {p.dtype}")
    return p.to(device)


def _writable(a):
    """A contiguous array torch may wrap: read-only arrays (e.g. exported
    from jax) are copied."""
    a = np.ascontiguousarray(a)
    return a if a.flags.writeable else a.copy()


def _as_f32(x, device):
    if torch.is_tensor(x):
        return x.to(device=device, dtype=torch.float32)
    return torch.from_numpy(_writable(np.asarray(x, np.float32))).to(device)


def _flatten_inputs(primitive_indices, probs, weights, classes, device):
    prim = as_ids(primitive_indices, device)
    probs = _as_f32(probs, device)
    if prim.ndim != 2:
        raise ValueError(f"primitive image must be rank 2, got {tuple(prim.shape)}")
    if probs.ndim != 3:
        raise ValueError(f"probs image must be rank 3, got {tuple(probs.shape)}")
    if probs.shape[:2] != prim.shape:
        raise ValueError(
            f"Primitive image {tuple(prim.shape)} and probs image "
            f"{tuple(probs.shape)} must have the same width and height"
        )
    if probs.shape[-1] != classes:
        raise ValueError(
            f"probs image has {probs.shape[-1]} classes, aggregator expects "
            f"{classes}"
        )
    if weights is not None:
        weights = _as_f32(weights, device)
        if weights.shape != prim.shape:
            raise ValueError(
                f"Primitive image {tuple(prim.shape)} and weights image "
                f"{tuple(weights.shape)} must have the same width and height"
            )
    return prim, probs, weights


def _pixel_values(probs_flat, base_w, aggregator):
    """Per-pixel contribution rows (weight mix NOT applied — it is linear,
    so it is applied after the segment sum; see _accumulate_view)."""
    if aggregator == "sum":
        return probs_flat * base_w[:, None]
    if aggregator == "summax":
        # keep only the argmax component (Fusion.cu:51-55)
        max_val = probs_flat.amax(dim=-1, keepdim=True)
        is_max = probs_flat == max_val
        # exactly one winner per pixel: the first max index
        first_max = torch.cumsum(is_max.to(torch.int32), dim=-1) == 1
        kept = torch.where(is_max & first_max, probs_flat,
                           torch.zeros_like(probs_flat))
        return kept * base_w[:, None]
    if aggregator == "mul":
        # acc_log += w * log(probs); log(0) -> large negative, kept finite so
        # masked pixels (w == 0) contribute exactly 0
        logp = torch.clamp(torch.log(torch.clamp(probs_flat, min=0.0)),
                           min=_NEG_LARGE)
        return logp * base_w[:, None]
    raise ValueError(f"unknown aggregator {aggregator!r}")


def _segment_sums_plain(prim, probs, weights, *, num_primitives,
                        aggregator):
    """The segment sums of one view as a chain of PyTorch ops, the CPU
    implementation and the card kernels' oracle (fusion_kernel): (P, C + 1),
    per primitive p
      S[p]     = sum over p's pixels of (pixel_w * value)
      count[p] = all pixels whose primitive is p (don't-care included)
    in the last column, as ONE segment sum over (values | count column)."""
    P = num_primitives
    prim_flat = prim.reshape(-1)
    npix = prim_flat.shape[0]
    C = probs.shape[-1]
    in_range = (prim_flat >= 0) & (prim_flat < P)
    idx = torch.where(in_range, prim_flat, P)

    probs_flat = probs.reshape(npix, C)
    not_dont_care = probs_flat.sum(dim=-1) > DONT_CARE_THRESHOLD
    pixel_w = (
        torch.ones(npix, dtype=torch.float32, device=probs.device)
        if weights is None else weights.reshape(npix)
    )
    base_w = torch.where(in_range & not_dont_care, pixel_w,
                         torch.zeros_like(pixel_w))
    values = _pixel_values(probs_flat, base_w, aggregator)
    # trailing column: pixels_per_face over ALL in-range pixels
    # (Mesh.h:90-93)
    data = torch.cat([values, in_range.to(torch.float32)[:, None]], dim=1)
    return ops.segment_sum(data, idx, P)


def _mix(seg, images_equal_weight):
    """(P, C) contributions from the (P, C + 1) sums and counts:
    delta[p] = (iew / count[p] + (1 - iew)) * S[p]."""
    C = seg.shape[1] - 1
    counts = torch.clamp(seg[:, C], min=1.0)
    # a true division (python's `iew / tensor` is reciprocal-then-multiply)
    mix = torch.div(torch.full_like(counts, images_equal_weight),
                    counts) + (1.0 - images_equal_weight)
    return mix[:, None] * seg[:, :C]


def _accumulate_view(prim, probs, weights, images_equal_weight, *,
                     num_primitives, aggregator, group=None):
    """Fusion contribution (P, C) of one view.

    Every aggregator's accumulation is linear in the pixel weight, and the
    weight mix is constant within a primitive, so the view needs one
    segment sum of the weighted values and the pixel counts, then the mix
    (_segment_sums_plain, _mix). CUDA tensors go through the hand-written
    kernels (fusion_kernel), CPU tensors through the plain chain.
    prim: signed integer ids (H, W); probs: prim.shape + (C,).
    group: None, or the distributed.MeshAxis the image's rows are split
    over: S and the counts are summed over its ranks before the mix, since
    the counts need the whole image (the JAX package's psum over
    `pixels`).
    """
    with span("smt.fusion"):
        kw = dict(num_primitives=num_primitives, aggregator=aggregator)
        if not probs.is_cuda:
            seg = _segment_sums_plain(prim, probs, weights, **kw)
        elif group is None:
            return fusion_kernel.segment_sums(prim, probs, weights,
                                              images_equal_weight, **kw)
        else:
            seg = fusion_kernel.segment_sums(prim, probs, weights,
                                             images_equal_weight, raw=True,
                                             **kw)
        if group is not None:
            seg = group.all_reduce(seg)
        return _mix(seg, images_equal_weight)


def _get(acc, *, aggregator):
    """Read out fused distributions: post-chain per Fusion.cu:46-92."""
    if aggregator == "mul":
        # logprob_normalize: p / max_el(p) in log space (Fusion.h:97-104)
        probs = torch.exp(acc - acc.amax(dim=-1, keepdim=True))
    else:
        probs = acc
    probs = probs / probs.sum(dim=-1, keepdim=True)  # may be nan/inf
    return torch.where(torch.isfinite(probs), probs, torch.zeros_like(probs))


def _model_render(annotations, prim, background):
    P = annotations.shape[0]
    in_range = (prim >= 0) & (prim < P)
    idx = torch.where(in_range, prim, torch.zeros_like(prim)).long()
    out = annotations[idx]  # (..., C)
    bg = torch.broadcast_to(background, (annotations.shape[-1],))
    return torch.where(in_range[..., None], out, bg)


class ModelRenderer:
    """Render fused annotations back into an image by primitive lookup
    (ref: Mesh.h:10-43)."""

    def __init__(self, annotations, device="cuda"):
        """annotations: (P, C) tensor or array, moved to `device`."""
        if not torch.is_tensor(annotations):
            annotations = torch.from_numpy(_writable(np.asarray(annotations)))
        self.annotations = annotations.to(resolve_device(device))

    def render(self, primitive_indices, background=0.0):
        """primitive_indices: (...,) integer image -> (..., classes) image.

        Out-of-range ids (including the 0xFFFFFFFF background sentinel) get
        `background` (scalar or (classes,) vector).
        """
        dev = self.annotations.device
        prim = as_ids(primitive_indices, dev)
        bg = torch.as_tensor(background, dtype=self.annotations.dtype,
                             device=dev)
        return _model_render(self.annotations, prim, bg)


class MeshAggregator:
    """Per-primitive class-probability aggregator.

    Constructor matches the reference factory:
    `MeshAggregator(primitives, classes, aggregator="sum",
    images_equal_weight=0.5)` (ref: Fusion.cu:130-151), plus `device`
    (default "cuda") for the accumulator and every add().
    """

    def __init__(self, primitives, classes, aggregator="sum",
                 images_equal_weight=0.5, device="cuda"):
        aggregator = str(aggregator).lower()
        if aggregator not in AGGREGATORS:
            raise ValueError(
                f"unknown aggregator {aggregator!r}; expected one of "
                f"{AGGREGATORS}"
            )
        self.primitives = int(primitives)
        self.classes = int(classes)
        self.aggregator = aggregator
        self.images_equal_weight = float(images_equal_weight)
        self.device = resolve_device(device)
        self.reset()

    def add(self, primitive_indices, probs, weights=None):
        """Fuse one view's predictions: (W, H) ids + (W, H, C) probs.

        Pixels are summed in (H, W) row-major order, the order of the
        batched pipeline (distributed.fuse_views), so the two give
        bit-identical accumulators."""
        with span("smt.add"):
            prim, probs, weights = _flatten_inputs(
                primitive_indices, probs, weights, self.classes, self.device
            )
            self._acc = self._acc + _accumulate_view(
                prim.t(), probs.transpose(0, 1),
                None if weights is None else weights.t(),
                self.images_equal_weight,
                num_primitives=self.primitives, aggregator=self.aggregator,
            )

    def add_many(self, primitive_indices, probs, weights=None):
        """Fuse a batch of views: primitive_indices (N, W, H), probs
        (N, W, H, C), optional weights (N, W, H). Same result as N
        sequential add() calls."""
        n = len(primitive_indices)
        if len(probs) != n or (weights is not None and len(weights) != n):
            raise ValueError(
                f"add_many expects batches of equal length, got {n} id "
                f"images and {len(probs)} probs images"
            )
        for i in range(n):
            self.add(primitive_indices[i], probs[i],
                     None if weights is None else weights[i])

    def reset(self):
        self._acc = torch.zeros((self.primitives, self.classes),
                                dtype=torch.float32, device=self.device)

    def get(self):
        """Fused (primitives, classes) distributions on the device."""
        return _get(self._acc, aggregator=self.aggregator)

    def renderer(self) -> ModelRenderer:
        """Snapshot into a ModelRenderer (ref: Mesh.h:124-129)."""
        return ModelRenderer(self.get(), device=self.device)

    @property
    def state(self):
        """The raw (primitives, classes) accumulator (resume / merge)."""
        return self._acc

    @state.setter
    def state(self, value):
        value = _as_f32(value, self.device)
        if tuple(value.shape) != (self.primitives, self.classes):
            raise ValueError(
                f"state must be ({self.primitives}, {self.classes}), "
                f"got {tuple(value.shape)}"
            )
        self._acc = value

    def merge(self, other_state):
        """Merge a partial accumulator from another shard: elementwise +
        for every aggregator (mul accumulates in log space)."""
        with span("smt.add"):
            self._acc = self._acc + _as_f32(other_state, self.device)
