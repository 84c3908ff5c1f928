"""Wire formats for precomputed class-probability maps.

Own copy of the JAX package's `semantic_meshes/probs_io.py`, with the
same files, wires and densify arithmetic. The reference treats the 2D
segmentation model as external (ref: README.md:24-29 step 2); when maps
arrive from disk (the --probs legs of the reference's cityscapes and
ScanNet eval scripts), the host -> device upload dominates on slow
links: a 2048x1024x19 float32 map is 160 MB a frame.

  dense  <base>.npy  (H, W, C) float32/float16/uint8
         uint8 stores rint(p*255): <= 1/510 abs error per class.
  top-k  <base>.npz  {values (H, W, K) f16/u8 descending, indices
         (H, W, K) uint8, classes ()} (the layout of the JAX package's
         scripts/precompute_probs.py --topk K). Dropped mass per pixel
         is bounded by K * p_(K+1) <= (1 - sum(values)).

         Densify spreads the residual mass (1 - sum(values)) uniformly
         over the dropped classes instead of writing exact zeros: with
         aggregator="mul" a zero is log-space -inf (fusion.py), so a
         class outside the top-K in even ONE view would be permanently
         vetoed. The spread applies ONLY where the retained sum exceeds
         the don't-care threshold (sum > 0.5, ref: fusion/Mesh.h:98):
         don't-care pixels, including all-zero padding views, keep their
         shrunken sum and stay skipped.

`load(base, wire, device)` reads either file and starts the upload: from
pinned host memory with `non_blocking=True` on a CUDA device, so the copy
is asynchronous as JAX's `device_put` is (the caching host allocator keeps
the pinned buffer until the copy's stream has read it). `densify(loaded)`
turns it into the dense float32 (H, W, C) map on its device: K passes
over (H, W, C) in K order, never an (H, W, K, C) tensor (0.6 GB a view at
1296x968x40 with K = 3). Where a pixel's K indices are distinct, only one
term per class is nonzero, so the sum equals the JAX package's bit for
bit. The bf16 wire casts on the host with torch (numpy has no bf16); both
round to nearest even.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Union

import numpy as np
import torch

from .data import resolve_device


class TopKProbs(NamedTuple):
    """Device-resident top-K probability map (values descending)."""

    values: torch.Tensor   # (H, W, K) float16 or uint8
    indices: torch.Tensor  # (H, W, K) uint8
    classes: int


WIRE_DTYPES = {
    "f32": np.float32,
    "f16": np.float16,
    "bf16": None,  # cast by torch at load time (numpy has no bf16)
    "u8": np.uint8,
}


def quantize_u8(probs: np.ndarray) -> np.ndarray:
    """rint(p*255): the storage/wire quantization for uint8 maps."""
    return np.rint(probs.astype(np.float32) * 255.0).astype(np.uint8)


def _cast_wire(probs: np.ndarray, wire: str) -> torch.Tensor:
    """The map `probs` in the wire's dtype, as a host tensor."""
    if wire == "u8":
        if probs.dtype != np.uint8:
            probs = quantize_u8(probs)  # else already quantized on disk
        return torch.from_numpy(np.ascontiguousarray(probs))
    if probs.dtype == np.uint8:
        # stored quantized, wider wire requested: undo the quantization
        # (plain astype would drop the /255 scale)
        probs = probs.astype(np.float32) * np.float32(1.0 / 255.0)
    if wire == "bf16":
        # float32 -> bfloat16 on the host, round to nearest even
        return torch.from_numpy(
            np.ascontiguousarray(probs, np.float32)).to(torch.bfloat16)
    dt = WIRE_DTYPES[wire]
    return torch.from_numpy(np.ascontiguousarray(probs, dt))


def _upload(host: torch.Tensor, device: torch.device) -> torch.Tensor:
    """Start the host -> `device` copy of a host tensor: pinned and
    asynchronous on a CUDA device; the CPU keeps the host tensor."""
    if device.type != "cuda":
        return host
    return host.pin_memory().to(device, non_blocking=True)


def load(base: str, wire: str = "f16",
         device="cuda") -> Union[torch.Tensor, TopKProbs]:
    """Load `<base>.npz` (top-k) or `<base>.npy` (dense) and start the
    upload to `device`. `wire` re-casts DENSE maps for the wire (top-k
    maps ship in their stored dtype, already compact). Call from a
    prefetch worker so the transfer overlaps compute."""
    device = resolve_device(device)
    npz = base + ".npz"
    if os.path.exists(npz):
        with np.load(npz) as z:
            vals, idx = z["values"], z["indices"]
            classes = int(z["classes"])
        return TopKProbs(
            _upload(torch.from_numpy(np.ascontiguousarray(vals)), device),
            _upload(torch.from_numpy(np.ascontiguousarray(idx)), device),
            classes,
        )
    probs = np.load(base + ".npy")
    return _upload(_cast_wire(probs, wire), device)


def _densify_topk(values: torch.Tensor, indices: torch.Tensor,
                  classes: int) -> torch.Tensor:
    """(H, W, K) values and indices -> dense float32 (H, W, classes) on
    their device (JAX probs_io.py:103-135)."""
    vals = values.to(torch.float32)
    if values.dtype == torch.uint8:
        vals = vals * float(np.float32(1.0 / 255.0))
    cls = torch.arange(classes, dtype=torch.int32, device=values.device)
    k = values.shape[-1]
    # one-hot times value, summed over K in K order, one (H, W, C) pass
    # per rank (values * onehot: inf * 0 is NaN, as in the JAX product)
    dense = None
    s = None
    for r in range(k):
        term = vals[..., r, None] * (
            indices[..., r, None].to(torch.int32) == cls).to(torch.float32)
        dense = term if dense is None else dense + term
        s = vals[..., r:r + 1] if s is None else s + vals[..., r:r + 1]
    if k >= classes:
        return dense
    # residual spread (see module docstring): dropped classes get the
    # uniform floor (1-s)/(C-K), only where the pixel passes the don't-care
    # test (retained sum > 0.5); max(residual, 0) guards u8 sums slightly
    # above 1
    floor = torch.clamp(1.0 - s, min=0.0) * float(
        np.float32(1.0 / (classes - k)))
    # max, not where-on-retained: a RETAINED class stored as 0 (one-hot
    # maps keep zero-valued ranks) would otherwise still veto under mul
    return torch.where(s <= 0.5, dense, torch.maximum(dense, floor))


class TopKDensify:
    """Stable `predict_fn` for the batched fusions: densify one view's
    top-k `(values, indices)` pair to a dense float32 (H, W, C) map inside
    `distributed.fuse_views(predict_fn=...)`. Instances with equal
    `classes` compare and hash equal, as the JAX package's do (there a
    static jit argument)."""

    __slots__ = ("classes", "__weakref__")

    def __init__(self, classes: int):
        self.classes = int(classes)

    def __call__(self, t):
        return _densify_topk(t[0], t[1], self.classes)

    def __eq__(self, other):
        return (
            isinstance(other, TopKDensify) and other.classes == self.classes
        )

    def __hash__(self):
        return hash(("probs_io.TopKDensify", self.classes))


def _dequant_dense(probs: torch.Tensor) -> torch.Tensor:
    p = probs.to(torch.float32)
    if probs.dtype == torch.uint8:
        p = p * float(np.float32(1.0 / 255.0))
    return p


def densify(loaded, device="cuda") -> torch.Tensor:
    """Dense float32 (H, W, C) map from any wire format: a tensor or a
    TopKProbs on its own device, a numpy array on `device`."""
    if isinstance(loaded, TopKProbs):
        return _densify_topk(loaded.values, loaded.indices, loaded.classes)
    if not torch.is_tensor(loaded):
        loaded = torch.from_numpy(np.array(loaded)).to(
            resolve_device(device))
    return _dequant_dense(loaded)
